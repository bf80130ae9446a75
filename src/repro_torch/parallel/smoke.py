"""Multi-process smoke driver for the sharded serving pool (port of
``repro/parallel/smoke.py``).

``main`` spawns ``--world`` ranks joined over ``torch.distributed``
(on the card by default: NCCL when every rank has a card of its own,
gloo when they share one; gloo on the CPU with ``--device cpu``), lays the ``--mesh DxM``
(data, model) mesh over them, plans the pool on it
(``planner.plan_for(..., pool_slots=...)``) and drives the smoke trace
through :class:`repro_torch.serve.PoolEngine` with that plan; rank 0
prints the reference's JSON keys (``arch``, ``devices``, ``mesh``,
``data_shards``, ``model_shards``, ``num_pages``, ``weight_passes``,
``tokens``):

    PYTHONPATH=src python -m repro_torch.parallel.smoke --world 2 --mesh 2x1
    PYTHONPATH=src python -m repro_torch.parallel.smoke --world 2 --device cpu

The weights are drawn from seed 0 on the port's generator, or read from
``--params`` (an ``.npz`` of ``/``-named leaves, e.g. the reference's
seed-0 weights), so the served tokens can be held against the
reference's single-device run of the same trace.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

MAX_LEN = 24


def smoke_requests(cfg, n: int, *, seed: int = 0):
    """The deterministic smoke trace: ``n`` requests with heterogeneous
    prompt lengths, budgets and arrivals, from the reference's numpy
    draws (the same prompts, budgets and arrivals).  An encdec request's
    frames are normal draws of the port's generator (seed ``1000 + i``),
    not the reference's."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, 9))
        toks = rng.integers(0, cfg.vocab, (1, plen)).astype(np.int32)
        extras = {}
        if cfg.family == "encdec":
            gen = torch.Generator().manual_seed(1000 + i)
            extras["frames"] = torch.randn((1, cfg.enc_seq, cfg.frame_dim),
                                           generator=gen).numpy()
        reqs.append(Request(uid=i, tokens=toks, max_new_tokens=int(rng.integers(2, 6)),
                            arrival=i, extras=extras))
    return reqs


def load_params(path: str, device):
    """A parameter tree from an ``.npz`` of ``/``-named leaves."""
    from repro_torch.models import spec as pspec

    with np.load(path) as f:
        return pspec.params_from_numpy({k: f[k] for k in f.files}, device)


def run_smoke(arch: str = "llama3-8b", *, slots: int = 2, chunk: int = 4,
              n_requests: int = 4, sharded: bool = True, num_pages=None,
              mesh=(1, 1), params=None, device="cuda") -> dict:
    """Serve the smoke trace; returns a JSON-ready result dict.  The
    attention families admit by ``chunk``-token chunked prefill into one
    page a slot; the ssm and the hybrid by solo prefill into their
    slot-row pool (no pages: ``num_pages`` None; the trace's 3-8 token
    prompts fit mamba2's smoke SSD chunk of 8).

    ``sharded=True`` plans the pool on the (data, model) ``mesh`` over the
    launched world and runs the plan-carrying engine; ``sharded=False``
    is the plan-less single-rank run.  ``num_pages`` is honoured as given
    (the planner rounds the default up per data axis)."""
    from repro_torch import configs as C
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, spec as pspec
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.serve import PoolEngine

    dev = resolve_device(device)
    cfg = C.smoke_config(arch)
    if params is None:
        params = pspec.materialize(registry.param_specs(cfg),
                                   torch.Generator(device=dev).manual_seed(0))
    if cfg.family not in registry.CHUNKED_FAMILIES:
        chunk = None  # the recurrent families admit by solo prefill
    m = (meshes.make_mesh(mesh, ("data", "model")) if sharded
         else meshes.make_abstract_mesh((1, 1), ("data", "model")))
    shape = C.ShapeConfig("serve", MAX_LEN, slots, "decode")
    plan = planner.plan_for(cfg, m, shape=shape, pool_slots=slots, num_pages=num_pages)
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=slots, max_len=MAX_LEN,
                     prefill_chunk=chunk, page_size=plan.page_size, num_pages=plan.num_pages,
                     plan=plan if sharded else None, device=dev)
    out = eng.run(smoke_requests(cfg, n_requests))
    stats = eng.last_stats
    return {
        "arch": arch,
        "devices": collectives.world_size() if sharded else 1,
        "mesh": plan.mesh_shape(),
        "data_shards": stats.data_shards,
        "model_shards": stats.model_shards,
        "num_pages": plan.num_pages,
        "weight_passes": stats.weight_passes,
        "tokens": {str(uid): [int(t) for t in toks] for uid, toks in out.items()},
    }


def _rank_main(rank: int, kw: dict, params_path: Optional[str]):
    params = None
    if params_path:
        from repro_torch.device import resolve_device

        params = load_params(params_path, resolve_device(kw["device"]))
    return run_smoke(params=params, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--world", type=int, default=2, help="ranks to spawn")
    ap.add_argument("--mesh", default=None, help="DxM (data x model); default Nx1")
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--params", default="", help=".npz of /-named weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.parallel import collectives, meshes

    mesh = meshes.parse_mesh(args.mesh) if args.mesh else (args.world, 1)
    if mesh[0] * mesh[1] != args.world:
        print(f"mesh {args.mesh} needs {mesh[0] * mesh[1]} ranks, --world is {args.world}",
              file=sys.stderr)
        return 2
    kw = dict(arch=args.arch, slots=args.slots, chunk=args.chunk,
              n_requests=args.requests, mesh=mesh, num_pages=args.num_pages,
              device=args.device)
    results = collectives.spawn(_rank_main, args.world, kw, args.params or None,
                                device=args.device)
    if any(r["tokens"] != results[0]["tokens"] for r in results):
        print("ranks disagree on the served tokens", file=sys.stderr)
        return 1
    json.dump(results[0], sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
