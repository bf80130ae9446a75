"""Training step: microbatched gradient accumulation + optimizer update
(port of ``repro/train/step.py``), on one device or data-parallel.

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
PoT values (mf_linear casts them to bf16 without loss).  With
``TrainConfig(weight_shadow=False)`` each ``mf_linear`` quantizes its
float32 master at use instead (the same WBC and scale per stacked layer).

Data-parallel (``make_train_step(..., plan=)``, a training plan on a
concrete (data, 1) mesh; :class:`DataParallel`).  Masters and optimizer
state are held split as the plan's ``embed``-over-data rule says (each
rank 1/D of every leaf whose dim divides; the rest whole), and the batch
rows split over the data ranks in order (``actshard.shard_tokens``).
Each step all-gathers the f32 masters before ``_quantize_shadow``, so
WBC's mean and every weight scale are one rank's; runs the forward and
backward on its rows with global maxima (``core/mfmac.py``) and the loss
over the global token count; reduce-scatters the gradients; clips by
the global norm of the whole tree; and updates its shards.  Activations,
weight and gradient scales and the forward's losses are one rank's bit
for bit; a gradient is a sum over ranks of partial MAC folds, so it
agrees with one rank's to rounding.  The dense decoder only; a model
axis > 1 and microbatching are refused (tensor-parallel training is
later work).
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
from repro_torch.parallel import actshard, collectives


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields that the port runs: the microbatch count, the
    global-norm clip (``None``: no clipping, the norm is still reported)
    and the weight shadow (``False``: every ``mf_linear`` quantizes its
    float32 master at use, as Algorithm 1 writes it).  Its
    ``grad_compression`` is declared by the reference and read nowhere
    there: the port refuses it rather than wire ``core.compress`` into
    training, a feature the reference lacks."""

    microbatches: int = 1
    clip_norm: Optional[float] = 1.0
    weight_shadow: bool = True
    grad_compression: bool = False

    def __post_init__(self) -> None:
        if self.grad_compression:
            raise NotImplementedError(
                "TrainConfig.grad_compression: the reference declares this flag and reads "
                "it nowhere (its step all-reduces plain gradients), so the port refuses "
                "it; the compressor itself is core.compress.compressed_psum")


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


def value_and_grad(fn, params):
    """(fn(params), its gradients) at ``params`` (not modified); ``fn``
    maps a parameter tree to a scalar loss.  Every gradient is float32 and
    shaped like its parameter (zero where the loss does not reach it)."""
    leaves = []

    def lift(x):
        leaves.append(x.detach().requires_grad_(True))
        return leaves[-1]

    tree = tree_map(lift, params)
    with torch.enable_grad():
        loss = fn(tree)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    pairs = iter(zip(leaves, got))

    def grad(_):
        x, g = next(pairs)  # tree_map walks the tree in the order lift did
        return torch.zeros_like(x, dtype=torch.float32) if g is None else g

    return loss.detach(), tree_map(grad, tree)


def loss_and_grads(cfg: ModelConfig, policy: QuantPolicy, params, batch):
    """(loss, grads) of ``registry.loss_fn`` at ``params`` (not modified)."""
    return value_and_grad(lambda p: registry.loss_fn(cfg, policy, p, batch), params)


class DataParallel:
    """The data-parallel side of a training plan: which dim of each leaf
    is split over the data ranks (``plan.data_split_dim``), and the
    shard / gather / gradient reduction of whole trees."""

    def __init__(self, plan):
        from repro_torch.parallel.planner import is_dense_decoder

        if not is_dense_decoder(plan.cfg):
            raise NotImplementedError(
                f"data-parallel training runs the dense decoder only; {plan.cfg.family!r}"
                f"{' (MoE)' if plan.cfg.moe else ''} on a plan is not ported yet (ROADMAP)")
        if plan.model_shards > 1:
            raise NotImplementedError(
                "training on a model axis > 1 (tensor-parallel K2/K3) is not ported yet "
                "(ROADMAP); train on a (D, 1) mesh")
        self.plan = plan
        self.group = plan.mesh.group("data")
        self.rank, self.size = actshard.data_rank_and_size(plan)

    def _dims(self, tree, strip: int):
        return [(n, x, self.plan.data_split_dim("/".join(n.split("/")[strip:])))
                for n, x in named_leaves(tree)]

    def shard(self, tree, strip: int = 0):
        """This rank's slices of a whole tree (``strip`` leading name
        components: 1 for an optimizer state's ``m/...`` trees)."""
        def one(x, dim):
            if dim is None:
                return x
            n = x.shape[dim] // self.size
            return x.narrow(dim, self.rank * n, n).clone()

        return unflatten((n, one(x, d)) for n, x, d in self._dims(tree, strip))

    def gather(self, tree, strip: int = 0):
        """The whole tree from every rank's slices (all-gather in rank order)."""
        return unflatten((n, x if d is None else torch.cat(
            collectives.all_gather(x, self.group), dim=d)) for n, x, d in self._dims(tree, strip))

    def reduce(self, grads):
        """Each rank's gradient slices of the sum over ranks (a
        reduce-scatter on split leaves, an all-reduce on whole ones)."""
        return unflatten((n, collectives.all_reduce_sum(g, self.group) if d is None
                          else collectives.reduce_scatter(g, self.group, d))
                         for n, g, d in self._dims(grads, 0))

    def global_norm(self, grads) -> torch.Tensor:
        """The whole tree's gradient norm from the ranks' slices: the split
        leaves' sums of squares are summed over the ranks."""
        split, whole = [], []
        for _, g, d in self._dims(grads, 0):
            (whole if d is None else split).append(torch.sum(g.to(torch.float32) ** 2))
        total = sum(whole) if whole else 0.0
        if split:
            total = collectives.all_reduce_sum(torch.stack(split), self.group).sum() + total
        return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, policy: QuantPolicy, optimizer: Optimizer,
                    tc: TrainConfig = TrainConfig(), plan=None):
    """The step function; with ``plan`` (a training plan on a concrete
    mesh of more than one rank) the data-parallel step (module docstring),
    which takes and returns this rank's shards of params and optimizer
    state and the whole batch (each rank keeps its rows).  The step has
    ``.grads(params, batch)`` and ``.token_losses(params, batch)`` (the
    per-token losses of the step's forward, this rank's rows)."""
    use_shadow = tc.weight_shadow and policy.enabled
    loss_policy = (dataclasses.replace(policy, weights_prequantized=True)
                   if use_shadow else policy)
    dp = None
    if plan is not None and getattr(plan.mesh, "is_concrete", False) and plan.mesh.size > 1:
        dp = DataParallel(plan)
        if tc.microbatches != 1:
            raise NotImplementedError("data-parallel training takes microbatches=1 (a "
                                      "microbatch's scale groups would span ranks)")
    run_plan = plan if dp is not None else None

    def inputs_of(params):
        with torch.no_grad():
            if dp is not None:
                params = dp.gather(params)
            return _quantize_shadow(params, policy) if use_shadow else params

    def local(batch):
        return {k: actshard.shard_tokens(v) for k, v in batch.items()}

    def grads_of(params, batch):
        """Mean loss and gradients over the microbatches (the data-parallel
        step: this rank's share of the loss, its rows' partial gradients
        of the whole tree)."""
        inputs = inputs_of(params)
        batch = local(batch)
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
        with actshard.use_plan(run_plan):
            loss, grads = grads_of(params, batch)
            with torch.no_grad():
                if dp is not None:
                    loss = collectives.all_reduce_sum(loss, dp.group)
                    grads = dp.reduce(grads)
                    gnorm = dp.global_norm(grads)
                else:
                    gnorm = global_norm(grads)
                if tc.clip_norm is not None:
                    grads, _ = clip_by_global_norm(grads, tc.clip_norm, norm=gnorm)
                # STE: gradients taken w.r.t. the shadow update the f32 masters
                params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "step": step + 1}

    def grads_planned(params, batch):
        with actshard.use_plan(run_plan):
            return grads_of(params, batch)

    def token_losses(params, batch):
        """Per-token losses (B_local, S) of the step's forward."""
        from repro_torch.models import transformer

        with actshard.use_plan(run_plan), torch.no_grad():
            inputs = inputs_of(params)
            b = local(batch)
            logits = transformer.forward(cfg, loss_policy, inputs, b["tokens"],
                                         patch_embeds=b.get("patch_embeds"))
            if "patch_embeds" in b:
                logits = logits[:, b["patch_embeds"].shape[1]:]
            return transformer.token_losses(cfg, logits, b["labels"])

    train_step.grads = grads_planned
    train_step.token_losses = token_losses
    train_step.data_parallel = dp
    return train_step
