"""Training step: microbatched gradient accumulation + optimizer update
(port of ``repro/train/step.py``, one device).

``make_train_step`` returns a function
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
that updates ``params`` and ``opt_state`` in place (optim/optimizers.py)
and returns them.  Microbatching is a Python loop over the leading batch
split; gradients are summed in float32 and divided by the count, as the
reference's ``lax.scan`` does.

Weight shadow and STE.  Every linear weight is quantized ONCE per step
(WBC + ALS-PoTQ, per layer for a stacked leaf) outside the layers, and
the loss runs under ``weights_prequantized``; the gradient taken with
respect to the shadow updates the float32 master (Algorithm 1, line 17).
The reference keeps the shadow in bf16 and gets float32 gradients from
its custom VJP; PyTorch's autograd would cast a bf16 leaf's gradient to
bf16, so the port holds the shadow as float32 tensors of the same exact
PoT values (mf_linear casts them to bf16 without loss).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import registry
from repro_torch.models.spec import named_leaves, unflatten
from repro_torch.optim import Optimizer, clip_by_global_norm, global_norm
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields that the port runs: the microbatch count and
    the global-norm clip (``None``: no clipping, the norm is still
    reported).  Its ``grad_compression`` (multi-GPU) is not ported, and the
    weight shadow is always on for quantized policies."""

    microbatches: int = 1
    clip_norm: Optional[float] = 1.0


def _quantize_shadow(params, policy: QuantPolicy):
    """WBC + ALS-PoTQ every linear weight (a ``w`` leaf of rank >= 2) to its
    exact PoT values in float32; stacked (L, K, N) leaves per layer (mean
    and beta over the last two axes).  Other leaves are returned as they
    are (embed, norm scales, gamma)."""
    def one(name, x):
        if name.split("/")[-1] != "w" or x.dim() < 2:
            return x
        axes = (x.dim() - 2, x.dim() - 1) if x.dim() > 2 else None
        return mfmac._quantize_w(x, policy, axes).to(torch.float32)

    return unflatten((name, one(name, x)) for name, x in named_leaves(params))


def loss_and_grads(cfg: ModelConfig, policy: QuantPolicy, params, batch):
    """(loss, grads) of ``registry.loss_fn`` at ``params`` (not modified).
    Every gradient is float32 and shaped like its parameter."""
    leaves = []

    def lift(x):
        leaves.append(x.detach().requires_grad_(True))
        return leaves[-1]

    tree = tree_map(lift, params)
    with torch.enable_grad():
        loss = registry.loss_fn(cfg, policy, tree, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    pairs = iter(zip(leaves, got))

    def grad(_):
        x, g = next(pairs)  # tree_map walks the tree in the order lift did
        return torch.zeros_like(x, dtype=torch.float32) if g is None else g

    return loss.detach(), tree_map(grad, tree)


def make_train_step(cfg: ModelConfig, policy: QuantPolicy, optimizer: Optimizer,
                    tc: TrainConfig = TrainConfig()):
    use_shadow = policy.enabled
    loss_policy = (dataclasses.replace(policy, weights_prequantized=True)
                   if use_shadow else policy)

    def grads_of(params, batch):
        """Mean loss and gradients over the microbatches."""
        with torch.no_grad():
            inputs = _quantize_shadow(params, policy) if use_shadow else params
        m = tc.microbatches
        if m == 1:
            return loss_and_grads(cfg, loss_policy, inputs, batch)
        b = next(iter(batch.values())).shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")
        micros = [dict(zip(batch, parts))
                  for parts in zip(*(v.chunk(m) for v in batch.values()))]
        loss_sum, acc = loss_and_grads(cfg, loss_policy, inputs, micros[0])
        for micro in micros[1:]:
            loss, grads = loss_and_grads(cfg, loss_policy, inputs, micro)
            loss_sum = loss_sum + loss
            tree_map(lambda s, g: s.add_(g), acc, grads)
            del grads
        tree_map(lambda s: s.div_(m), acc)
        return loss_sum / m, acc

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            if tc.clip_norm is not None:
                grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
            else:
                gnorm = global_norm(grads)
            # STE: gradients taken w.r.t. the shadow update the f32 masters
            params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "step": step + 1}

    train_step.grads = grads_of
    return train_step
