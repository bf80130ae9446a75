"""Same-process A/B of two checkouts' serving engines on one card.

    python3 tools/serving_ab.py --base DIR [--rounds 4] [--variant pageable_upload]

``DIR`` is a checkout of another commit (for instance a ``git archive`` of
the parent unpacked under ``build/``).  Its ``src/repro_torch`` and this
checkout's are both imported into one process (each under the package's
own name, swapped in ``sys.modules`` around its runs), so both serve from
the same weights on the same card, in turns.  The engine is phase 19's of
``chip_smoke.py``: chunked prefill (32) over pages of 16, 4 slots,
llama3-8b at full width (weights from seed 0), on the serve trace
(``poisson_trace(8 requests, prompt 128, lam 2.0, 8-32 new, seed 0)``).
Each side is warmed up once; then every round runs each side once, the
order rotating from round to round.  A run reports its wall time
(synchronized at both ends), tokens/s and mean TTFT; every run must give
the same tokens.

``--variant`` adds a side: this checkout with one change undone by a
patch for the run (``pageable_upload``: ``device.to_device`` copies from
pageable memory instead of staging in pinned memory).

``--device cpu --smoke`` rehearses the script on the CPU at the config's
smoke width (the kernel's plain version).  Results go to
``chiprun_out/serving_ab.json``, rewritten after every run.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pkgutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = "repro_torch"


def _own(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


def _clear():
    for name in [n for n in sys.modules if _own(n)]:
        del sys.modules[name]


def load_tree(src: Path) -> dict:
    """Every module of ``src/repro_torch``, imported fresh; ``sys.modules``
    is left without the package.  A lazy import inside a function later
    finds the module of the tree that :func:`activate` put back."""
    _clear()
    sys.path.insert(0, str(src))
    try:
        pkg = importlib.import_module(PKG)
        for info in pkgutil.walk_packages(pkg.__path__, PKG + "."):
            importlib.import_module(info.name)
    finally:
        sys.path.remove(str(src))
    mods = {n: m for n, m in sys.modules.items() if _own(n)}
    stray = [n for n, m in mods.items()
             if getattr(m, "__file__", None) and not Path(m.__file__).is_relative_to(src)]
    if stray:
        raise SystemExit(f"modules of {src} loaded from elsewhere: {stray}")
    _clear()
    return mods


def activate(mods: dict):
    _clear()
    sys.modules.update(mods)


def _pageable_upload(mods):
    """Patch: ``to_device`` copies from pageable memory (a blocking copy)."""
    dev_mod = mods[PKG + ".device"]
    staged = dev_mod.to_device

    def to_device(x, device, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(device)

    users = [m for m in mods.values() if getattr(m, "to_device", None) is staged]
    for m in users:
        m.to_device = to_device
    return lambda: [setattr(m, "to_device", staged) for m in users]


VARIANTS = {"pageable_upload": _pageable_upload}


@dataclasses.dataclass
class Side:
    label: str
    mods: dict
    patch: object = None  # mods -> undo callable
    engine: object = None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_once(side, reqs, dev):
    activate(side.mods)
    undo = side.patch(side.mods) if side.patch else None
    try:
        _sync(dev)
        t0 = time.perf_counter()
        out = side.engine.run(reqs)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if undo:
            undo()
    st = side.engine.last_stats
    return out, dict(wall_s=wall, tokens_per_s=st.emitted_tokens / wall,
                     mean_ttft_s=st.mean_ttft_s, weight_passes=st.weight_passes,
                     emitted_tokens=st.emitted_tokens)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path, required=True, help="checkout of the other commit")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the config's smoke width")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "serving_ab.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(card)
    head = load_tree(ROOT / "src")
    base = load_tree(args.base.resolve() / "src")
    sides = [Side("base", base), Side("head", head)]
    sides += [Side(f"head+{v}", head, VARIANTS[v]) for v in args.variant]

    # weights, config and trace from this checkout, made once
    activate(head)
    configs = importlib.import_module(PKG + ".configs")
    spec = importlib.import_module(PKG + ".models.spec")
    registry = importlib.import_module(PKG + ".models.registry")
    qw = importlib.import_module(PKG + ".serve.quantized_weights")
    policy_mod = importlib.import_module(PKG + ".core.policy")
    serve = importlib.import_module(PKG + ".serve")
    importlib.import_module(PKG + ".device").resolve_device(dev)
    if dev.type == "cuda":
        kmod = importlib.import_module(PKG + ".kernels.potq_matmul")
        kmod.build()
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    pf = policy_mod.PAPER_FAITHFUL
    t0 = time.perf_counter()
    params = spec.materialize(registry.param_specs(cfg), gen,
                              transform=lambda name, x: qw.quantize_leaf(name, x, pf))
    print(f"weights made in {time.perf_counter() - t0:.1f} s")
    reqs = serve.poisson_trace(cfg, n_requests=8, prompt_len=128, lam=2.0, new_lo=8,
                               new_hi=32, seed=0)
    reqs = [dataclasses.replace(r, tokens=np.asarray(r.tokens)) for r in reqs]
    warm = [dataclasses.replace(reqs[0], uid="warm-up", max_new_tokens=2)]

    for side in sides:
        activate(side.mods)
        if dev.type == "cuda":
            importlib.import_module(PKG + ".kernels.potq_matmul").build()
        tcfg = (importlib.import_module(PKG + ".configs").smoke_config(args.arch) if args.smoke
                else importlib.import_module(PKG + ".configs").get_config(args.arch))
        policy = dataclasses.replace(
            importlib.import_module(PKG + ".core.policy").PAPER_FAITHFUL,
            weights_prequantized=True)
        engine_cls = importlib.import_module(PKG + ".serve").PoolEngine
        side.engine = engine_cls(tcfg, policy, params, max_slots=4, max_len=160,
                                 prefill_chunk=32, page_size=16, device=dev)
        run_once(side, warm, dev)

    runs = {s.label: [] for s in sides}
    ref = None
    args.out.parent.mkdir(parents=True, exist_ok=True)

    def medians():
        return {label: {k: statistics.median(row[k] for row in rows)
                        for k in ("wall_s", "tokens_per_s", "mean_ttft_s")}
                for label, rows in runs.items() if rows}

    def dump():
        args.out.write_text(json.dumps(dict(card=card, base=str(args.base),
                                            rounds=args.rounds, runs=runs,
                                            median=medians()), indent=1))
    for r in range(args.rounds):
        order = sides[r % len(sides):] + sides[:r % len(sides)]
        for side in order:
            out, row = run_once(side, reqs, dev)
            row["round"] = r
            runs[side.label].append(row)
            print(side.label, json.dumps(row), flush=True)
            dump()
            toks = {u: np.asarray(t).tolist() for u, t in out.items()}
            if ref is None:
                ref = toks
            elif toks != ref:
                raise SystemExit(f"{side.label}: tokens differ from the first run's")
    for label, med in medians().items():
        print(f"median {label}: {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
