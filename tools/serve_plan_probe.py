"""Phase 37s of ``chip_smoke.py`` alone, on one GPU: build the kernels, then
serve llama3-8b at its published widths on two gloo ranks spawned on the
card through ``chip_smoke._option_cells_rank`` ((a) the 3-bit self-draft
over ``KV_PINNED`` pages on (1, 2), (b) the n-gram drafter on (2, 1) over
one-token prompts, (c) ``quantize_attention`` and (d) the FP32 baseline on
(1, 2)), each against one rank in the same world, with
``chip_smoke._check_options``' gates.
Prints each cell's row and the card's name and power limit; the rows go
to ``serve_plan_probe.json`` in ``chiprun_out/``.

    python3 tools/serve_plan_probe.py
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


def _rank(rank):
    from repro_torch.device import resolve_device
    from repro_torch.kernels import potq_matmul as K

    dev = resolve_device(torch.device("cuda", torch.cuda.current_device()))
    K.build()
    return cs._option_cells_rank(rank, dev)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serve_plan_probe: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.parallel import collectives

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.compile_all([K.SOURCE])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ranks = collectives.spawn(_rank, 2, device="cuda")
    spawn_s = time.perf_counter() - t0
    failures = []
    rows = cs._check_options(ranks, failures, card)
    print(f"37s: spawn to exit {spawn_s:.1f} s; seconds a cell (rank 0) "
          f"{ {k: round(ranks[0][k][1]['seconds'], 1) for k in cs.OPTION_CELLS} }", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_plan_probe.json").write_text(json.dumps(
        dict(card=card, spawn_s=spawn_s, rows=rows,
             ranks=[{k: res[k][1] for k in cs.OPTION_CELLS} for res in ranks]),
        indent=1, default=str))
    if failures:
        raise SystemExit("37s: " + "; ".join(failures))
    print("PROBE OK")


if __name__ == "__main__":
    main()
