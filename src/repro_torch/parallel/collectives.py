"""The collectives of the port's multi-device runtime, on
``torch.distributed`` (the port's counterpart of what GSPMD inserts for
the reference).

Backend.  Chosen from the topology, explicitly, and printed by
:func:`init`:

* ``nccl`` when every rank has a card of its own;
* ``gloo`` when ranks share a card (two ranks on one H100), or on the CPU.

A failure of NCCL is never caught to fall back to gloo, and a rank that
was asked for CUDA and finds none raises.  gloo moves CUDA tensors
through the host, and not every gloo op takes them: :func:`init` tries
each op this module uses on a CUDA tensor once (the start-up check,
printed) and runs the ops that fail there through the host explicitly
(a copy to the CPU, the op, a copy back).

The ops, each over a process group (None: an axis of size 1, where each
op is the identity):

* :func:`all_reduce_max` of an amax (a quantizer's global scale);
* :func:`all_reduce_sum` (gradients, token counts, norms);
* :func:`all_gather` in rank order;
* :func:`broadcast`;
* :func:`reduce_scatter` along a dim (an all-reduce, then this rank's
  slice);
* :func:`ordered_fold`: K1's fold continued across the ranks of a
  row-parallel product.  K1's spec (``kernels/ref.py``) left-folds f32
  chunk sums in ascending chunk order from 0; with the contraction split
  at whole 128-chunks, rank r continues the fold from rank r-1's running
  sum (K1's ``start``), so the chain 0 -> ... -> R-1 reproduces one
  rank's adds in one rank's order, bit for bit.  Each hop is a broadcast
  of the (M, N) f32 running sum from its rank; the last one hands the
  result to every rank: R broadcasts of M*N*4 bytes, and the ranks'
  products run one after another.

:data:`stats` counts calls, bytes and host seconds spent in the ops.
:func:`spawn` runs a function on N ranks of a fresh world (the CPU tests,
``parallel/smoke.py``, the card's two-rank phases).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: calls, bytes moved and host seconds spent in this module's ops since
#: the last :func:`reset_stats`
stats: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0, "folds": 0}
_STATE: Dict = {"backend": None, "cuda_ops": None}
_GROUPS: Dict = {}
_OPS = ("all_reduce", "all_gather", "broadcast")


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0, folds=0)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend() -> Optional[str]:
    return _STATE["backend"]


def choose_backend(device: torch.device, world: int) -> str:
    """``nccl`` when every one of ``world`` ranks gets a card of its own,
    else ``gloo``.  Raises when CUDA is asked for and there is none."""
    if device.type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("a rank was asked for CUDA and finds no CUDA device")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def init(rank_: int, world: int, init_method: str, device="cuda",
         timeout_s: float = 600.0) -> str:
    """Join the world as ``rank_`` of ``world`` (``init_method`` a
    ``file://`` or ``tcp://localhost:<port>`` address); returns and prints
    the backend.  On a card the rank takes card ``rank % count`` (one card
    a rank under NCCL; every rank on card 0 under gloo when they share).
    A collective that waits longer than ``timeout_s`` raises instead of
    hanging."""
    dev = torch.device(device)
    be = choose_backend(dev, world)
    if dev.type == "cuda":
        idx = rank_ % torch.cuda.device_count() if be == "nccl" else 0
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    dist.init_process_group(be, init_method=init_method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(backend=be, cuda_ops=None)
    _GROUPS.clear()
    if be == "gloo" and dev.type == "cuda":
        _STATE["cuda_ops"] = _probe_cuda_ops(dev)
    if rank_ == 0:
        staged = sorted(set(_OPS) - set(_STATE["cuda_ops"] or _OPS))
        where = (f", CUDA tensors direct for {sorted(_STATE['cuda_ops'])}, through the host "
                 f"for {staged}" if _STATE["cuda_ops"] is not None else "")
        print(f"collectives: backend {be}, world {world}, device {dev.type}{where}",
              flush=True)
    return be


def _probe_cuda_ops(dev: torch.device) -> set:
    """The start-up check: which of gloo's ops take CUDA tensors here."""
    ok = set()
    t = torch.ones(4, device=dev)
    for op in _OPS:
        try:
            if op == "all_reduce":
                dist.all_reduce(t)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(t) for _ in range(world_size())], t)
            else:
                dist.broadcast(t, 0)
            torch.cuda.synchronize(dev)
            ok.add(op)
        except (RuntimeError, ValueError):
            pass
    dist.barrier()
    return ok


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, cuda_ops=None)
    _GROUPS.clear()


def axis_group(sizes: Sequence[int], axis: int):
    """The process group of the ranks that share this rank's coordinates
    on every axis but ``axis`` of a row-major mesh of ``sizes`` (None when
    that axis has size 1).  Every rank builds every group, in one order."""
    from repro_torch.parallel.meshes import coords_of, rank_of

    sizes = tuple(sizes)
    if sizes[axis] == 1 or world_size() == 1:
        return None
    key = (sizes, axis)
    if key not in _GROUPS:
        mine = None
        others = [range(s) for i, s in enumerate(sizes) if i != axis]
        for rest in _product(others):
            ranks = []
            for c in range(sizes[axis]):
                co = list(rest)
                co.insert(axis, c)
                ranks.append(rank_of(co, sizes))
            g = dist.new_group(ranks)
            if rank() in ranks:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [p + (i,) for p in out for i in r]
    return out


def _staged(op: str, t: torch.Tensor) -> bool:
    ok = _STATE["cuda_ops"]
    return t.is_cuda and ok is not None and op not in ok


def _count(t: torch.Tensor, t0: float, n: int = 1) -> None:
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size() * n
    stats["seconds"] += time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is None:
        return t
    t0 = time.perf_counter()
    out = t.clone()
    if _staged("all_reduce", out):
        host = out.cpu()
        dist.all_reduce(host, op=op, group=group)
        out.copy_(host)
    else:
        dist.all_reduce(out, op=op, group=group)
    _count(out, t0)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (a new tensor; ``t`` untouched)."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group (a new tensor)."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in group-rank order."""
    if group is None:
        return [t]
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    t = t.contiguous()
    if _staged("all_gather", t):
        host = t.cpu()
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        outs = [o.to(t.device) for o in outs]
    else:
        outs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(outs, t, group=group)
    _count(t, t0, n)
    return outs


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank, written into ``t``
    (which must have the source's shape and dtype); returns ``t``."""
    if group is None:
        return t
    t0 = time.perf_counter()
    gsrc = dist.get_global_rank(group, src)
    if _staged("broadcast", t):
        host = t.cpu()
        dist.broadcast(host, gsrc, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, gsrc, group=group)
    _count(t, t0)
    return t


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's elementwise sum
    (``t.shape[dim]`` divisible by the group size): an all-reduce, then
    the slice."""
    if group is None:
        return t
    n, r = dist.get_world_size(group), dist.get_rank(group)
    part = t.shape[dim] // n
    return all_reduce_sum(t, group).narrow(dim, r * part, part).clone()


def ordered_fold(partial: Callable[[Optional[torch.Tensor]], torch.Tensor], shape,
                 device, group) -> torch.Tensor:
    """The group's chained fold: group rank r runs ``partial(start)``, its
    K1 product continued from ``start`` (None on rank 0: the fold's 0),
    once rank r-1's running sum has arrived; each running sum is
    broadcast from its rank, the last one to every rank.  Returns the
    full fold (f32, ``shape``) on every rank."""
    if group is None:
        return partial(None)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    stats["folds"] += 1
    start = None
    for src in range(n):
        buf = partial(start) if src == r else torch.empty(shape, dtype=torch.float32,
                                                          device=device)
        start = broadcast(buf.contiguous(), src, group)
    return start


# ---------------------------------------------------------------------------
# Launching a world
# ---------------------------------------------------------------------------

def _entry(rank_: int, world: int, init_method: str, device: str, threads: int,
           fn, args, queue):
    if threads:
        torch.set_num_threads(threads)
    init(rank_, world, init_method, device)
    # a rank that raises exits at once (its peers are then stopped by
    # spawn): a barrier here would wait on peers stuck in a collective
    res = fn(rank_, *args)
    queue.put((rank_, res))
    dist.barrier()
    shutdown()


def spawn(fn: Callable, world: int, *args, device: str = "cuda", threads: int = 0) -> List:
    """Run ``fn(rank, *args)`` on ``world`` fresh processes joined as one
    world (``file://`` rendezvous in a temporary directory); returns the
    ranks' results in rank order.  ``fn`` and its results must pickle
    (``fn`` importable by name).  ``threads`` > 0 caps each rank's CPU
    threads.  Raises if any rank fails."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        context = mp.start_processes(
            _entry, args=(world, init_method, device, threads, fn, args, queue),
            nprocs=world, join=False, start_method="spawn")
        out = {}

        def drain():  # a rank's large result blocks its exit until read
            while not queue.empty():
                r, res = queue.get()
                out[r] = res

        while not context.join(timeout=0.2):
            drain()
        drain()
    return [out[r] for r in range(world)]


def world_from_env():
    """(rank, world, init_method) of a world launched by ``torchrun`` (its
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), or None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), f"tcp://{addr}:{port}"

