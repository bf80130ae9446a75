"""Phase 8's K2 start checks and phases 37o-r of ``chip_smoke.py`` alone, on
one GPU: build the kernels, hold K2's ``start`` variant (``k2_start_checks``:
olmo-1b's column-parallel dA chained over two ranks' N, the row-parallel
dgamma rows over their K, a ragged three-rank case) against the unsplit
launch and the plain chain and time it, then train tensor-parallel on the
(1, 2) mesh (two ranks) the cells of ``_tp_cells`` (37o (a), 37p (a-b),
37q (b), 37r (c)), take the first steps of ``FIRST_STEP_CELLS`` at their
published widths (37q (a) llama4-scout-17b-a16e under EP, 37r (a)
mamba2-2.7b, (b) recurrentgemma-2b: the two ranks, and one rank on rank
0 of the four-rank world before its cells), and the smoke configs of
``TP_SMOKE_ARCHS`` on the (2, 2) mesh (37o (b), 37p (c), 37q (c), 37r
(d), four ranks), each against one rank, with their gates.  ``--moe`` runs 37q alone; ``--recurrent`` runs 37r alone, after a
check of a property its whole mixers do not rely on: a per-channel sum
over the batch and sequence (a depthwise conv's, a bias's or ``lam``'s
gradient) at a rank's channel count against the same channels of the
whole one's.  Details go to ``tp_train_probe.json`` in the output
directory that ``main`` writes to.

    python3 tools/tp_train_probe.py [--moe | --recurrent]
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


RECURRENT = ("mamba2-2.7b", "recurrentgemma-2b")


def _cells(only):
    """The (1, 2) cells of ``_tp_cells`` to run: all, or 37q's ('q') or
    37r's ('r') alone."""
    return [k for k in cs._tp_cells() if only is None or k.startswith(only)]


def _first_steps(only):
    """The cells of ``FIRST_STEP_CELLS`` to run (37q (a), 37r (a-b))."""
    return {k: v for k, v in cs.FIRST_STEP_CELLS.items() if only is None or k.startswith(only)}


def _tp_rank(rank, only):
    """The (1, 2) cells (``_cells(only)``), then ``_first_steps(only)`` on
    one of the two ranks."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_grad as KG
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    KG.build()
    res = {key: cs._tp_train(rank, dev, key) for key in _cells(only)}
    for key in _first_steps(only):
        res[key] = cs._first_step_rank(rank, dev, key)
    return res


def _smoke_rank(rank, archs, only):
    """37q (c) or 37r (d) alone: ``archs``' smoke configs on one of the
    four ranks, after ``_first_steps(only)``'s one rank on rank 0."""
    cs.TP_SMOKE_ARCHS = archs
    cs.FIRST_STEP_CELLS = _first_steps(only)
    return cs._tp_smoke_rank(rank)


def _channel_sum_check(dev):
    """A per-channel sum over (batch, sequence) of a (B, S, C) f32 tensor
    (the gradient of a depthwise conv's taps, of its bias or of the
    RG-LRU's ``lam``), at a rank's C / 2 channels against the same
    channels of the sum at C: recurrentgemma-2b's RG-LRU (2 x 512, 2560)
    and mamba2-2.7b's conv channels (4 x 512, 5120 + 256, a rank's x
    channels and B and C)."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, (b, s, c, mine) in {
            "recurrentgemma-2b RG-LRU": (2, 512, 2560, list(range(1280))),
            "mamba2-2.7b conv": (4, 512, 5376, list(range(2560)) + list(range(5120, 5376)))
    }.items():
        x = torch.randn((b, s, c), generator=gen, device=dev)
        idx = torch.tensor(mine, device=dev)
        whole = x.sum((0, 1))[idx]
        part = x[..., idx].contiguous().sum((0, 1))
        out[name] = dict(bit_equal=bool(torch.equal(whole, part)),
                         differing=int((whole != part).sum()), channels=len(mine),
                         max_abs=float((whole - part).abs().max()))
    return out


def main():
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, potq_grad as KG
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.parallel import collectives

    only = "q" if "--moe" in sys.argv[1:] else "r" if "--recurrent" in sys.argv[1:] else None
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
        if only is None:
            t0 = time.perf_counter()
            cs.phase("8 K2's start variant")
            detail["k2_start_variant"] = cs.k2_start_checks(
                dev, torch.Generator(device=dev).manual_seed(1))[0]
            times["phase8_start"] = time.perf_counter() - t0
        if only == "r":
            detail["channel_sums"] = _channel_sum_check(dev)
            print("per-channel sums, a rank's channels against the whole's:",
                  json.dumps(detail["channel_sums"]), flush=True)
        cs.FIRST_STEP_CELLS = _first_steps(only)
        cs.phase("37o (a), 37p (a-b), 37q (a-b), 37r (a-c) tensor-parallel training on (1, 2)")
        t0 = time.perf_counter()
        ranks = collectives.spawn(_tp_rank, 2, only, device="cuda")
        times["phase37_1x2"] = time.perf_counter() - t0
        cs.phase(f"{', '.join(cs.FIRST_STEP_CELLS.values())} one rank, then 37o (b), 37p (c), "
                 "37q (c), 37r (d) tensor-parallel smoke training on (2, 2)")
        failures = []
        if only is not None:
            archs = RECURRENT if only == "r" else tuple(cs.TP_SMOKE_SEQS)
            t0 = time.perf_counter()
            ranks4 = collectives.spawn(_smoke_rank, 4, archs, only, device="cuda", threads=2)
            tp = {key: cs._check_tp_run(key, "37" + only, [res[key] for res in ranks],
                                        failures)
                  for key in _cells(only)}
            tp["two_by_two"] = {a: cs._check_tp_smoke(a, "37" + only, ranks4, failures)
                                for a in archs}
            tp["two_by_two_spawn_s"] = time.perf_counter() - t0
            one = ranks4[0]["first_steps"]
            times["phase37_one_rank"] = ranks4[0]["first_steps_s"]
        else:
            tp, one = cs.tp_training(ranks, failures)
            times["phase37_one_rank"] = tp["first_steps_s"]
        tp.update(cs._check_first_steps(one, ranks, failures))
        detail["multi_gpu_tp"] = tp
        times["phase37_2x2"] = tp["two_by_two_spawn_s"]
        for key in (*_cells(only), *cs.FIRST_STEP_CELLS):
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
