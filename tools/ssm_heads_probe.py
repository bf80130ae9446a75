"""Do the recurrent families' per-head products keep their bits when a
rank runs half the heads, or half the batch?  On one GPU, at published
widths, with the port's own functions:

* mamba2-2.7b's SSD (``models/ssm._ssd_chunked``: 80 heads of 64, state
  128, a 512-token prompt in two chunks of 256) over the first and the
  last 40 heads alone, against the same heads cut from the 80-head run,
  and over 40 heads placed in zeros of the 80-head shape (the padding a
  model rank would do); the same for decode's ``C . h`` contraction
  (``ssm._contract_c``, one row at a time as ``_rows`` runs it);
* the SSD and the norms over a batch of 2 x 512 against each row alone
  (data-parallel training's half batch a rank);
* recurrentgemma-2b's attention (``transformer._sdpa``: 10 q heads of 256,
  one K/V head, window 2048) over 5 heads against the 10-head run's.

Prints whether each pair is equal bit for bit, and the device ms of each
form (CUDA events, median of 5).  Details go to
``chiprun_out/ssm_heads_probe.json``.

    python3 tools/ssm_heads_probe.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

H, P, N, S, Q = 80, 64, 128, 512, 256


def _ms(fn, iters=5):
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _eq(a, b):
    return bool(torch.equal(a, b))


def main():
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.device import resolve_device
    from repro_torch.models import common, ssm, transformer
    from repro_torch import configs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    out = {"card": card}
    # the SSD over a solo prefill's prompt (batch 1) and a training batch (2)
    for b in (1, 2):
        x, dt = rnd(b, S, H, P), rnd(b, S, H, scale=0.5)
        a_log, d_skip = rnd(H, scale=0.3), rnd(H)
        bb, cc = rnd(b, S, N, scale=0.3), rnd(b, S, N, scale=0.3)

        def ssd(lo=0, hi=H, pad=False, rows=slice(None)):
            xs, dts = x[rows, :, lo:hi], dt[rows, :, lo:hi]
            al, ds = a_log[lo:hi], d_skip[lo:hi]
            if pad:
                def whole(t, dim):
                    shape = list(t.shape)
                    shape[dim] = H
                    z = t.new_zeros(shape)
                    z.narrow(dim, lo, hi - lo).copy_(t)
                    return z
                xs, dts, al, ds = whole(xs, 2), whole(dts, 2), whole(al, 0), whole(ds, 0)
            return ssm._ssd_chunked(xs, dts, al, bb[rows], cc[rows], ds, Q, with_final=True)

        y, fin = ssd()
        res = {}
        for lo, hi in ((0, H // 2), (H // 2, H)):
            yh, fh = ssd(lo, hi)
            yp, fp = ssd(lo, hi, pad=True)
            res[f"heads_{lo}_{hi}"] = dict(
                half_equal=_eq(yh, y[:, :, lo:hi]) and _eq(fh, fin[:, lo:hi]),
                padded_equal=_eq(yp[:, :, lo:hi], y[:, :, lo:hi]) and _eq(fp[:, lo:hi],
                                                                          fin[:, lo:hi]))
        res["ms"] = dict(whole=_ms(lambda: ssd()), half=_ms(lambda: ssd(0, H // 2)),
                         padded=_ms(lambda: ssd(0, H // 2, pad=True)))
        if b == 2:
            rows = [ssd(rows=slice(i, i + 1)) for i in range(2)]
            res["rows_alone_equal"] = all(_eq(r[0], y[i:i + 1]) and _eq(r[1], fin[i:i + 1])
                                          for i, r in enumerate(rows))
            h = rnd(2, S, 2560)
            scale = rnd(2560)
            whole_n = common.rms_norm(h, scale)
            res["rms_norm_rows_alone_equal"] = all(
                _eq(common.rms_norm(h[i:i + 1], scale), whole_n[i:i + 1]) for i in range(2))
            conv_w, conv_b = rnd(4, 5376, scale=0.2), rnd(5376)
            ci = rnd(2, S, 5376)
            cw = ssm._causal_conv(ci, conv_w, conv_b)
            res["conv_rows_alone_equal"] = all(
                _eq(ssm._causal_conv(ci[i:i + 1], conv_w, conv_b), cw[i:i + 1]) for i in range(2))
        out[f"ssd_batch{b}"] = res
        print(f"SSD batch {b}:", json.dumps(res), flush=True)

    # decode's C . h, one row at a time, 4 slots
    cc1, st = rnd(4, N), rnd(4, H, N, P)
    y = transformer._rows(ssm._contract_c, cc1, st)
    res = {}
    for lo, hi in ((0, H // 2), (H // 2, H)):
        yh = transformer._rows(ssm._contract_c, cc1, st[:, lo:hi].contiguous())
        z = torch.zeros_like(st)
        z[:, lo:hi] = st[:, lo:hi]
        yp = transformer._rows(ssm._contract_c, cc1, z)
        res[f"heads_{lo}_{hi}"] = dict(half_equal=_eq(yh, y[:, lo:hi]),
                                       padded_equal=_eq(yp[:, lo:hi], y[:, lo:hi]))
    res["ms"] = dict(whole=_ms(lambda: transformer._rows(ssm._contract_c, cc1, st)),
                     half=_ms(lambda: transformer._rows(ssm._contract_c, cc1,
                                                        st[:, :H // 2].contiguous())))
    out["contract_c"] = res
    print("C . h (decode, 4 rows):", json.dumps(res), flush=True)

    # recurrentgemma's attention: 10 q heads against 5
    cfg = configs.get_config("recurrentgemma-2b")
    res = {}
    for sq in (128, 1):
        q = rnd(1, sq, 10, 256).to(torch.float32)
        k, v = rnd(1, 128, 1, 256), rnd(1, 128, 1, 256)
        qpos = torch.arange(128 - sq, 128, device=dev)
        kpos = torch.arange(128, device=dev)
        full = transformer._sdpa(cfg, PAPER_FAITHFUL, q, k, v, qpos, kpos, cfg.window)
        half = transformer._sdpa(cfg, PAPER_FAITHFUL, q[:, :, 5:].contiguous(), k, v, qpos,
                                 kpos, cfg.window)
        res[f"sq{sq}"] = dict(half_equal=_eq(half, full[:, :, 5:]))
    out["hybrid_attention"] = res
    print("recurrentgemma attention, 5 of 10 heads:", json.dumps(res), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ssm_heads_probe.json").write_text(json.dumps(out, indent=1))
    print("PROBE OK")


if __name__ == "__main__":
    main()
