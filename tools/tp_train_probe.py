"""Phase 8's K2 start checks and phases 37o-p of ``chip_smoke.py`` alone, on
one GPU: build the kernels, hold K2's ``start`` variant (``k2_start_checks``:
olmo-1b's column-parallel dA chained over two ranks' N, the row-parallel
dgamma rows over their K, a ragged three-rank case) against the unsplit
launch and the plain chain and time it, then train tensor-parallel on the
(1, 2) mesh (two ranks) olmo-1b at its published widths and
``TP_TRAIN_LAYERS`` layers (37o (a)), whisper-large-v3 at its published
widths and ``ENCDEC_TP_TRAIN_LAYERS`` encoder and decoder layers (37p (a))
and internvl2-76b's smoke config (37p (b)), and the olmo-1b, internvl2-76b
and whisper-large-v3 smoke configs on the (2, 2) mesh (37o (b), 37p (c),
four ranks), each against one rank, with their gates.  Details go to
``chiprun_out/tp_train_probe.json``.

    python3 tools/tp_train_probe.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _tp_rank(rank):
    """37o (a), 37p (a) and (b) on one of the two ranks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    return {key: cs._tp_train(rank, dev, key) for key in cs._tp_cells()}


def main():
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.parallel import collectives

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.compile_all([K.SOURCE, KG.SOURCE])
    K.build()
    KG.build()
    for src, kern in _build.RESOURCES.items():
        print(f"ptxas {src}: {json.dumps(kern)}")
    times = {"build": time.perf_counter() - t0}
    detail = {}
    try:
        t0 = time.perf_counter()
        cs.phase("8 K2's start variant")
        detail["k2_start_variant"] = cs.k2_start_checks(
            dev, torch.Generator(device=dev).manual_seed(1))[0]
        times["phase8_start"] = time.perf_counter() - t0
        cs.phase("37o (a), 37p (a-b) tensor-parallel training on (1, 2)")
        t0 = time.perf_counter()
        ranks = collectives.spawn(_tp_rank, 2, device="cuda")
        times["phase37op_1x2"] = time.perf_counter() - t0
        cs.phase("37o (b), 37p (c) tensor-parallel smoke training on (2, 2)")
        failures = []
        detail["multi_gpu_tp"] = cs.tp_training(ranks, failures)
        times["phase37op_2x2"] = detail["multi_gpu_tp"]["two_by_two_spawn_s"]
        for key in cs._tp_cells():
            peak = sum(res[key]["peak_gib"] for res in ranks)
            print(f"37{key} (1, 2) peak, both ranks summed: {peak:.2f} GiB", flush=True)
            if peak >= cs.MULTI_PEAK_GIB:
                failures.append(f"37{key}: the ranks' summed peak {peak:.2f} GiB")
        if failures:
            raise SystemExit("; ".join(failures))
    finally:
        print("TIME", json.dumps(times), flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "tp_train_probe.json").write_text(
            json.dumps(detail, indent=1, default=str))
    print("PROBE OK")


if __name__ == "__main__":
    main()
