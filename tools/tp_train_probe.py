"""Phase 8's K2 start checks and phases 37o-q of ``chip_smoke.py`` alone, on
one GPU: build the kernels, hold K2's ``start`` variant (``k2_start_checks``:
olmo-1b's column-parallel dA chained over two ranks' N, the row-parallel
dgamma rows over their K, a ragged three-rank case) against the unsplit
launch and the plain chain and time it, then train tensor-parallel on the
(1, 2) mesh (two ranks) olmo-1b at its published widths and
``TP_TRAIN_LAYERS`` layers (37o (a)), whisper-large-v3 at its published
widths and ``ENCDEC_TP_TRAIN_LAYERS`` encoder and decoder layers (37p (a)),
internvl2-76b's smoke config (37p (b)) and the MoE cells of 37q (b), take
llama4-scout-17b-a16e's first step at its published widths under EP (37q
(a): one rank alone first, then the two), and the smoke configs of
``TP_SMOKE_ARCHS`` on the (2, 2) mesh (37o (b), 37p (c), 37q (c), four
ranks), each against one rank, with their gates.  ``--moe`` runs 37q
alone.  Details go to ``chiprun_out/tp_train_probe.json``.

    python3 tools/tp_train_probe.py [--moe]
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


def _cells(moe):
    return [k for k in cs._tp_cells() if k.startswith("q") or not moe]


def _tp_rank(rank, moe):
    """The (1, 2) cells (37o (a), 37p (a) and (b), 37q (b); with ``moe``
    37q's alone) and 37q (a) on one of the two ranks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    res = {key: cs._tp_train(rank, dev, key) for key in _cells(moe)}
    res["q"] = cs._moe_tp_first_step(rank, dev)
    return res


def _moe_smoke_rank(rank):
    """37q (c) alone: the MoE smoke configs on one of the four ranks."""
    cs.TP_SMOKE_ARCHS = tuple(cs.TP_SMOKE_SEQS)
    return cs._tp_smoke_rank(rank)


def main():
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.parallel import collectives

    moe = "--moe" in sys.argv[1:]
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
        if not moe:
            t0 = time.perf_counter()
            cs.phase("8 K2's start variant")
            detail["k2_start_variant"] = cs.k2_start_checks(
                dev, torch.Generator(device=dev).manual_seed(1))[0]
            times["phase8_start"] = time.perf_counter() - t0
        cs.phase("37q (a) one rank alone")
        t0 = time.perf_counter()
        one = collectives.spawn(cs._moe_tp_one_rank, 1, device="cpu")[0]
        times["phase37q_one_rank"] = time.perf_counter() - t0
        cs.phase("37o (a), 37p (a-b), 37q (a-b) tensor-parallel training on (1, 2)")
        t0 = time.perf_counter()
        ranks = collectives.spawn(_tp_rank, 2, moe, device="cuda")
        times["phase37opq_1x2"] = time.perf_counter() - t0
        cs.phase("37o (b), 37p (c), 37q (c) tensor-parallel smoke training on (2, 2)")
        failures = []
        if moe:
            t0 = time.perf_counter()
            ranks4 = collectives.spawn(_moe_smoke_rank, 4, device="cuda", threads=2)
            tp = {key: cs._check_tp_run(key, "37q", [res[key] for res in ranks], failures)
                  for key in _cells(moe)}
            tp["two_by_two"] = {a: cs._check_tp_smoke(a, "37q", ranks4, failures)
                                for a in cs.TP_SMOKE_SEQS}
            tp["two_by_two_spawn_s"] = time.perf_counter() - t0
        else:
            tp = cs.tp_training(ranks, failures)
        tp["q"] = cs._check_moe_tp(one, [res["q"] for res in ranks], failures)
        detail["multi_gpu_tp"] = tp
        times["phase37opq_2x2"] = tp["two_by_two_spawn_s"]
        for key in (*_cells(moe), "q"):
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
