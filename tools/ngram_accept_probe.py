"""Which prompts get the n-gram drafter's tokens accepted at llama3-8b's
published widths (2 layers, seed-0 random weights) on one GPU: one rank
serves phase 37s's engine (``chip_smoke.OPTION_ENGINE``, ``KV_PINNED``
pages, ``NgramDrafter(max_draft=3)``) over ``chip_smoke.OPTION_TRACE``'s
requests with their prompts replaced by: the random prompts themselves;
a random pattern of 1, 2, 4, 8 or 16 tokens repeated to the prompt's
length (several seeds); echo prompts (a prompt's first 28 or 20 tokens,
the model's greedy continuation of them, the same tokens again, as
``chip_smoke._echo_requests``); and 40 new tokens on the random and on a
one-token prompt.  Prints each trace's accepted and emitted tokens, its
wall seconds and the served tokens.  ``PROBE_CPU=1`` runs it on the CPU
at llama3-8b's smoke width instead (a dry run of the script).

    python3 tools/ngram_accept_probe.py
"""
import dataclasses
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from repro_torch import configs
    from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.models import registry, spec
    from repro_torch.serve import NgramDrafter, PoolEngine, poisson_trace
    from repro_torch.serve import quantized_weights as qw

    if os.environ.get("PROBE_CPU"):
        dev = torch.device("cpu")
        cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=2)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("ngram_accept_probe: no CUDA device")
        _build.compile_all([K.SOURCE])
        K.build()
        dev = resolve_device(torch.device("cuda", 0))
        cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=2)
    policy = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    params = spec.materialize(registry.param_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0),
                              transform=lambda n, x: qw.quantize_leaf(n, x, PAPER_FAITHFUL, None))
    base = poisson_trace(cfg, **cs.OPTION_TRACE)

    def run(name, reqs):
        eng = PoolEngine(cfg, policy, params, device=dev, spec=NgramDrafter(max_draft=3),
                         kv_quant=KV_PINNED, **cs.OPTION_ENGINE)
        t = time.perf_counter()
        out = eng.run(reqs)
        wall = time.perf_counter() - t
        print(name, "accepted", eng.last_stats.accepted_tokens, "emitted",
              eng.last_stats.emitted_tokens, "wall", round(wall, 2),
              {str(u): v.tolist() for u, v in out.items()}, flush=True)

    def pattern(period, seed):
        rng = np.random.default_rng(seed)
        out = []
        for r in base:
            p = rng.integers(0, cfg.vocab, period)
            toks = np.tile(p, 64 // period + 1)[:64][None].astype(np.int32)
            out.append(dataclasses.replace(r, tokens=toks))
        return out

    run("base", base)
    for period in (1, 2, 4, 8, 16):
        for seed in range(3 if period > 1 else 8):
            run(f"period{period}/seed{seed}", pattern(period, seed))
    for plen in (28, 20):
        short = [dataclasses.replace(r, tokens=r.tokens[:, :plen], max_new_tokens=64 - 2 * plen)
                 for r in base]
        eng = PoolEngine(cfg, policy, params, device=dev, kv_quant=KV_PINNED, **cs.OPTION_ENGINE)
        said = eng.run(short)
        echo = [dataclasses.replace(r, tokens=np.concatenate(
            [r.tokens[0, :plen], np.asarray(said[r.uid].tolist()).reshape(-1)[:64 - 2 * plen],
             r.tokens[0, :plen]])[None].astype(np.int32)) for r in base]
        print("g", {str(u): v.tolist() for u, v in said.items()})
        run(f"echo{plen}", echo)
        run(f"echo{plen}/16", [dataclasses.replace(r, max_new_tokens=16) for r in echo])
    run("base40", [dataclasses.replace(r, max_new_tokens=40) for r in base])
    run("period1/seed0/40", [dataclasses.replace(r, max_new_tokens=40) for r in pattern(1, 0)])


if __name__ == "__main__":
    main()
