"""Phase 8's K2 start checks and phase 37o of ``chip_smoke.py`` alone, on one
GPU: build the kernels, hold K2's ``start`` variant (``k2_start_checks``:
olmo-1b's column-parallel dA chained over two ranks' N, the row-parallel
dgamma rows over their K, a ragged three-rank case) against the unsplit
launch and the plain chain and time it, then train olmo-1b tensor-parallel
on the (1, 2) mesh at its published widths and ``TP_TRAIN_LAYERS`` layers
(37o (a), two ranks) and its smoke config on the (2, 2) mesh (37o (b),
four ranks), each against one rank, with 37o's gates.  Details go to
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
    """37o (a) on one of the two ranks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    t0 = time.perf_counter()
    row = cs._tp_train(rank, dev)
    row["seconds"] = time.perf_counter() - t0
    return {"o": row}


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
        cs.phase("37o (a) tensor-parallel olmo-1b on (1, 2)")
        t0 = time.perf_counter()
        ranks = collectives.spawn(_tp_rank, 2, device="cuda")
        times["phase37o_a"] = time.perf_counter() - t0
        cs.phase("37o (b) tensor-parallel smoke olmo-1b on (2, 2)")
        failures = []
        detail["multi_gpu_o"] = cs.tp_training(ranks, failures)
        times["phase37o_b"] = detail["multi_gpu_o"]["two_by_two"]["spawn_s"]
        peak = sum(res["o"]["peak_gib"] for res in ranks)
        print(f"37o (a) peak, both ranks summed: {peak:.2f} GiB", flush=True)
        if peak >= cs.MULTI_PEAK_GIB:
            failures.append(f"37o: the ranks' summed peak {peak:.2f} GiB")
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
