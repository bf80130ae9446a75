"""Optimizers, from scratch (port of ``repro/optim/optimizers.py``).

SGD with momentum (the paper's CNN recipe) and Adam(W) (its Transformer
recipe), over nested trees (dicts, and tuples) of tensors shaped like the
parameters.  Master
weights and optimizer state are float32; only the linear layers' MACs
are quantized, the update itself is full precision.

An :class:`Optimizer` is a pair of functions:
  init(params) -> state
  update(grads, state, params, step) -> (params, state)

Unlike the reference's pure functions, ``update`` (and
:func:`clip_by_global_norm`) work IN PLACE on the given tensors and
return them: at olmo-1b's full width a functional update would hold a
second copy of the weights and both moments (~15 GB).  The arithmetic is
the reference's, step for step, in float32; schedules are computed in
float32 tensors as the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.spec import named_leaves, tree_map  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def tree_leaves(tree):
    """Leaves in the order JAX flattens the tree (dict keys sorted, tuple
    entries by index)."""
    for _, v in named_leaves(tree):
        yield v


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def step_decay_schedule(base_lr: float, boundaries, factor: float = 0.1):
    """Paper Appendix D: step decay at epoch boundaries."""
    bs = torch.as_tensor(boundaries)

    def lr(step):
        n = int((int(step) >= bs).sum())
        return _f32(base_lr) * _f32(factor) ** n

    return lr


def warmup_cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        s = _f32(step)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted key order) of sum(g^2)."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient (in place) by min(1, max_norm / (|g| + 1e-9));
    returns the tree and the norm before clipping."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, gn


def sgd_momentum(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0):
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)

        def one(p, g, mu):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p
            mu.mul_(momentum).add_(g)
            p.sub_(lr * mu)

        tree_map(one, params, grads, state["mu"])
        return params, state

    return Optimizer(init, update)


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def one(p, g, m, v):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p
            p.sub_(lr * delta)

        tree_map(one, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)
