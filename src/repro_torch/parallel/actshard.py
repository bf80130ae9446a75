"""The active sharding plan (port of ``repro/parallel/actshard.py``).

The reference pins activations to its plan inside traced model code; the
port's runtime reads the plan the same way, through a module-level
context the launcher and the serving engine set around their steps:

    with actshard.use_plan(plan):
        loss = step(...)

:func:`shard_tokens` is where a (B, S, ...) batch tensor meets the plan:
under a plan built on a concrete mesh it returns this rank's rows of the
data axes (in rank order, the batch split evenly), and it is a no-op when
no plan is active, the plan's mesh is abstract, or B does not divide.
:func:`shard_batch` does it to a whole batch dict: a vlm's
``patch_embeds`` and an encdec's ``frames`` split by rows with the tokens
(the reference's ``data_pspecs``: batch over the data axes).
Model code asks :func:`active_plan` for the plan (the decoder's
model-axis layout, ``planner.ShardingPlan.layout``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACTIVE = None


def active_plan():
    """The active :class:`~repro_torch.parallel.planner.ShardingPlan`, or None."""
    return _ACTIVE


@contextlib.contextmanager
def use_plan(plan):
    """Activate ``plan`` for the runtime (None deactivates)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield
    finally:
        _ACTIVE = prev


def data_rank_and_size(plan=None):
    """(this rank's index, size) along the plan's data axes (pod x data),
    (0, 1) without an active concrete plan."""
    plan = plan if plan is not None else _ACTIVE
    if plan is None or not getattr(plan.mesh, "is_concrete", False):
        return 0, 1
    from repro_torch.parallel import sharding as shd

    idx, size = 0, 1
    for a in shd.fsdp_axes(plan.mesh):
        n = plan.mesh.shape[a]
        idx, size = idx * n + plan.mesh.coord(a), size * n
    return idx, size


def batch_group():
    """The data axis's process group when the active plan splits batch
    rows over it (a training plan on a concrete mesh of data size > 1),
    else None: the group a per-tensor statistic of the batch (an
    activation's amax, max|G|, the loss's token count) is reduced over."""
    plan = _ACTIVE
    if (plan is None or plan.pool_slots is not None
            or not getattr(plan.mesh, "is_concrete", False)):
        return None
    return plan.mesh.group("data")


def batch_shards() -> int:
    """How many data ranks the active plan splits batch rows over: the
    size of :func:`batch_group`'s axes, 1 where it is None."""
    return 1 if batch_group() is None else data_rank_and_size()[1]


def shard_tokens(x: torch.Tensor, *, batch_dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch tensor along the data axes (a view), or
    ``x`` itself when no concrete plan is active or the rows do not split
    evenly (the plan's rule replicates a ragged batch)."""
    idx, size = data_rank_and_size()
    if size == 1 or x.dim() == 0 or x.shape[batch_dim] % size:
        return x
    n = x.shape[batch_dim] // size
    return x.narrow(batch_dim, idx * n, n)


def shard_batch(batch: dict) -> dict:
    """This rank's rows of every leaf of a batch dict (tokens, labels,
    mask and a family's extras: ``frames``, ``patch_embeds``), each split
    as :func:`shard_tokens` splits it."""
    return {k: shard_tokens(v) for k, v in batch.items()}
