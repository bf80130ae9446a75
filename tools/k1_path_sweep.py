"""K1's path choice, measured on the card: the numbers behind
``repro_torch.kernels.potq_matmul.plan``.

    python3 tools/k1_path_sweep.py [--json sweep.json]

For each M of ``MS`` and each llama3-8b serving shape (random PoT weights
and activations from seed 0), K1 runs on the path ``plan`` picks, on the
other path at that path's own split (``split_groups``), and on the picked
path unsplit; each run must equal ``potq_matmul_plain`` bit for bit.  The
times are summed over one weight pass (``chip_smoke.PASS_COUNTS``, 225
calls).  Each call is timed on the device alone: CUDA events around it, L2
flushed before it, and a ~0.5 ms device-side wait queued before the start
event so that the host has enqueued the whole call before the device gets
there.  The host's own time per call is the same on every path but for
the fold kernel's launch, and is not in these numbers.  Needs one CUDA
card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from chip_smoke import PASS_COUNTS  # noqa: E402

MS = (4, 16, 32, 64, 128)
SLEEP_CYCLES = 1_000_000  # ~0.5 ms of device time


def device_ms(fn, iters, flush):
    """Mean device time of ``fn``, L2 flushed and the device held back
    before each call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def run_on(K, aq, wq, path, groups):
    """K1 on ``path`` with ``groups`` chunk ranges, whatever ``plan`` says."""
    plan = K.plan
    K.plan = lambda m, n, k, sms=132: (path, groups)
    try:
        return K.potq_matmul_cuda(aq, wq)
    finally:
        K.plan = plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the sums here as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_path_sweep needs a CUDA card")
    from repro_torch.core import potq
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.serve import quantized_weights as qw

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    K.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    weights = {kn: qw.quantize_leaf("w", torch.randn(*kn, generator=gen, device=dev) * 0.02
                                    + 1e-3, PAPER_FAITHFUL) for kn in PASS_COUNTS}
    out = {}
    for m in MS:
        sums = {}
        for (kk, nn), c in PASS_COUNTS.items():
            wq = weights[(kk, nn)]
            a = torch.randn(m, kk, generator=gen, device=dev)
            aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, (1,))).to(torch.bfloat16)
            want = K.potq_matmul_plain(aq, wq)
            path, g = K.plan(m, nn, kk)
            other = "tc" if path == "decode" else "decode"
            runs = {path: (path, g), other: (other, K.split_groups(other, m, nn, kk)),
                    f"{path} unsplit": (path, 1)}
            times = {}
            for label, run in runs.items():
                if run not in times:
                    if not torch.equal(run_on(K, aq, wq, *run), want):
                        raise SystemExit(f"K1 {run} differs from its plain version at "
                                         f"{(m, kk, nn)}")
                    times[run] = device_ms(lambda: run_on(K, aq, wq, *run),
                                           3 if m * kk * nn > 1e10 else 5, flush)
                sums[label] = sums.get(label, 0.0) + c * times[run]
        sums["plan"] = path
        print(f"M={m}: ms per weight pass {json.dumps(sums)}", flush=True)
        out[m] = sums
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
