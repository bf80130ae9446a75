"""Training step: microbatched gradient accumulation + optimizer update
(port of ``repro/train/step.py``), on one device or on a (data, model)
mesh.

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
concrete (data, model) mesh; :class:`DataParallel`, the sharded side of
any such plan).  Masters and optimizer state are held split as the
plan's ``embed``-over-data rule says (each rank 1/D of every leaf whose
dim divides; the rest whole), and the batch rows split over the data
ranks in order (``actshard.shard_batch``; the model ranks of one data
group take the same rows).  Each step all-gathers the f32 masters, a
leaf at a time, before quantizing the shadow, so WBC's mean and every
weight scale are one rank's; runs the forward and
backward on its rows with global maxima (``core/mfmac.py``) and the loss
over the global token count; reduce-scatters the gradients; clips by
the global norm of the whole tree; and updates its shards.  Activations,
weight and gradient scales and the forward's losses are one rank's bit
for bit; a gradient is a sum over ranks of partial MAC folds, so it
agrees with one rank's to rounding.  The decoder, dense or MoE: a MoE
layer's dispatch groups are the global batch's (``transformer._moe_apply``
sizes them from the global token count and refuses a batch whose groups
would straddle two ranks) and its experts' scales are global maxima
(``core/mfmac.py``).  The vlm and the encdec train the same way: a
batch's ``patch_embeds`` / ``frames`` rows split with its tokens
(``actshard.shard_batch``), so ``patch_proj``'s and ``frame_proj``'s
activation scales, like every other per-tensor one, are the global
batch's.  The ssm and the hybrid (a tuple of per-layer dicts, split
leaf by leaf, ``layers/<i>/...``) train the same way too.

Tensor-parallel (a (D, M) mesh with M > 1; every family).  Each rank
holds its model shard of every leaf the runtime splits
(``plan.shard_leaf``: q and the K/V heads, the MLP's hidden width, the
vocabulary; ``wo`` and the down projection along their contraction; a
MoE layer's experts under EP (``experts_local`` whole experts of gate,
up and down) or, under TP, gate's and up's hidden width (down whole); an
encdec's ``enc_layers/...`` and ``dec_layers/...`` by the same rules, its
cross attention's ``cq``/``ck``/``cv``/``co`` as ``wq``/``wk``/``wv``/
``wo``; an ssm's SSD heads: in_proj's and the conv's index-set pieces,
B and C whole in them, ``A_log``, ``D``, ``dt_bias``, out_proj along its
contraction; a hybrid's RG-LRU channels: ``wx``, ``wy``, the gates'
columns, the conv, ``lam``, ``wout`` along its contraction), split in
turn over the data ranks as above; leaves replicated on the model axis
stay whole there: each linear's ``gamma``, the norms, the router, TP's
down projection, K/V heads selected from a whole product (``kv ==
'select'``), a vlm's ``patch_proj``, an encdec's ``frame_proj``,
``enc_pos`` and tied embedding.  The shadow quantizes each matrix whole,
one leaf at a time: gathered over the data and model ranks (a shard of
several pieces placed by every rank's cut, ``ShardingPlan.untake``),
quantized (the reference's WBC mean and scale, a matrix at a time for a
stacked leaf), and this rank's shard kept; a leaf split along its stack
of matrices (EP's experts) is quantized on its shard, whose matrices are
whole.  The forward and backward run with the plan's local config
through the model-axis hooks (``models/transformer.py``,
``models/encdec.py``, ``models/ssm.py``, ``models/recurrent.py``; K2
chained across the ranks, ``core/mfmac.py``; a MoE layer's owner
selections, ``parallel/collectives.py``; an ssm's or a hybrid's mixer
run whole on every rank), so every rank computes the same loss and the
same replicated gradients; a split leaf's gradient is this rank's slice
of one rank's.  The gradients are summed over the data group only (a
replicated leaf's, or piece's, is the same on every model rank), and
``global_norm`` sums the split leaves' squares over the groups they are
split over, counting a replicated leaf or piece once.  On (1, M) the
losses and every gradient are one rank's bit for bit.  Refused on a
model axis: microbatches > 1 and ``weight_shadow=False`` (ROADMAP item
9.4).  Microbatching is refused on any sharded plan.
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


def _is_weight(name: str, x: torch.Tensor) -> bool:
    """A linear weight: a ``w`` leaf of rank >= 2."""
    return name.split("/")[-1] == "w" and x.dim() >= 2


def _quantize_leaf(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """One whole linear weight's shadow: WBC + ALS-PoTQ to its exact PoT
    values in float32; a stacked (L, K, N) or (L, E, K, N) leaf per
    matrix, one matrix at a time, as ``mf_linear`` quantizes a layer's
    matrix at use: a matrix's bits never depend on the stack around it
    (so a rank's experts quantize on their shard as in the whole leaf),
    and the temporaries stay one matrix's."""
    if x.dim() == 2:
        return mfmac._quantize_w(x, policy).to(torch.float32)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for m, q in zip(x.reshape((-1,) + x.shape[-2:]), out.view((-1,) + x.shape[-2:])):
        q.copy_(mfmac._quantize_w(m, policy))
    return out


def _quantize_shadow(params, policy: QuantPolicy):
    """:func:`_quantize_leaf` of every linear weight; other leaves are
    returned as they are (embed, norm scales, gamma)."""
    return unflatten((name, _quantize_leaf(x, policy) if _is_weight(name, x) else x)
                     for name, x in named_leaves(params))


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
    """The sharded side of a training plan on a concrete (D, M) mesh: which
    dim of each leaf is split over the data ranks (``plan.data_split_dim``)
    and over the model ranks (``plan.model_split_dim``), and the shard /
    gather / shadow / gradient reduction of whole trees (module
    docstring)."""

    def __init__(self, plan):
        self.plan = plan
        self.group = plan.mesh.group("data")
        self.rank, self.size = actshard.data_rank_and_size(plan)
        self.model_group = plan.mesh.group("model") if plan.model_shards > 1 else None

    def _dims(self, tree, strip: int):
        """(name, leaf, data dim, model dim, param path) of each leaf."""
        out = []
        for n, x in named_leaves(tree):
            path = "/".join(n.split("/")[strip:])
            d = self.plan.data_split_dim(path)
            m = self.plan.model_split_dim(path) if self.model_group is not None else None
            if d is not None and d == m:
                raise ValueError(f"param {path}: dim {d} is split over both data and model")
            out.append((n, x, d, m, path))
        return out

    def _narrow(self, x, dim):
        if dim is None:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n).clone()

    def _whole(self, x, d, m, path):
        """A leaf whole from every rank's slices (all-gathers in rank order,
        over data, then over model; a model shard of several pieces, an
        ssm's packed in_proj and conv, placed by every rank's cut, the
        inverse of ``ShardingPlan.take``)."""
        if d is not None:
            x = torch.cat(collectives.all_gather(x, self.group), dim=d)
        if m is not None:
            x = self.plan.untake(collectives.all_gather(x.contiguous(), self.model_group),
                                 self.plan.model_cuts(path))
        return x

    def shard(self, tree, strip: int = 0):
        """This rank's slices of a whole tree (``strip`` leading name
        components: 1 for an optimizer state's ``m/...`` trees): its model
        shard of each leaf, then its data slice of that."""
        def one(n, x, d):
            if self.model_group is not None:
                x = self.plan.shard_leaf("/".join(n.split("/")[strip:]), x)
            return self._narrow(x, d)

        return unflatten((n, one(n, x, d)) for n, x, d, _, _ in self._dims(tree, strip))

    def gather(self, tree, strip: int = 0):
        """The whole tree from every rank's slices, a leaf at a time."""
        return unflatten((n, self._whole(x, d, m, path))
                         for n, x, d, m, path in self._dims(tree, strip))

    def inputs(self, params, policy: Optional[QuantPolicy]):
        """The step's inputs from this rank's masters, a leaf at a time: each
        leaf whole over the data ranks (this rank's model shard); with
        ``policy`` (the weight shadow) every linear weight quantized whole
        (:func:`_quantize_shadow`'s rule, gathered over the model ranks
        too) and this rank's shard of it kept.  A leaf split over the model
        ranks along its stack of matrices (a MoE layer's experts under EP)
        is quantized on its shard: its quantizer groups are per matrix."""
        def one(n, x, d, m):
            if d is not None:
                x = torch.cat(collectives.all_gather(x, self.group), dim=d)
            if policy is None or not _is_weight(n, x):
                return x
            if m is None or m < x.dim() - 2:
                return _quantize_leaf(x, policy)
            return self.plan.shard_leaf(n, _quantize_leaf(self._whole(x, None, m, n), policy))

        return unflatten((n, one(n, x, d, m)) for n, x, d, m, _ in self._dims(params, 0))

    def reduce(self, grads):
        """Each rank's gradient slices of the sum over the data ranks (a
        reduce-scatter on split leaves, an all-reduce on whole ones); a
        model shard's gradient is this rank's already."""
        return unflatten((n, collectives.all_reduce_sum(g, self.group) if d is None
                          else collectives.reduce_scatter(g, self.group, d))
                         for n, g, d, _, _ in self._dims(grads, 0))

    def _pieces(self, g, m, path):
        """(piece, split over the model ranks) of a leaf's model shard: its
        split segments and the ones every model rank holds (an ssm's B and
        C columns), or the leaf as one piece."""
        if m is None:
            return [(g, False)]
        dim, segments = self.plan.shard_segments(path)
        out, off = [], 0
        for _, n, split in segments:
            out.append((g.narrow(dim, off, n), split))
            off += n
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The whole tree's gradient norm from the ranks' slices: each
        leaf's sum of squares is summed over the groups it is split over
        (a leaf, or a piece of a model shard, replicated on a group counts
        once)."""
        sums = {}
        for _, g, d, m, path in self._dims(grads, 0):
            for piece, split in self._pieces(g, m, path):
                sums.setdefault((d is not None, split), []).append(
                    torch.sum(piece.to(torch.float32) ** 2))
        total = 0.0
        for (over_data, over_model), parts in sorted(sums.items()):
            part = torch.stack(parts)
            if over_data:
                part = collectives.all_reduce_sum(part, self.group)
            if over_model:
                part = collectives.all_reduce_sum(part, self.model_group)
            total = part.sum() + total
        return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, policy: QuantPolicy, optimizer: Optimizer,
                    tc: TrainConfig = TrainConfig(), plan=None):
    """The step function; with ``plan`` (a training plan on a concrete
    mesh of more than one rank) the sharded step (module docstring:
    data-parallel, and tensor-parallel on a model axis), which takes and
    returns this rank's shards of params and optimizer
    state and the whole batch (each rank keeps its rows).  The step has
    ``.grads(params, batch)`` and ``.token_losses(params, batch)`` (the
    per-token losses of the step's forward, this rank's rows)."""
    use_shadow = tc.weight_shadow and policy.enabled
    loss_policy = (dataclasses.replace(policy, weights_prequantized=True)
                   if use_shadow else policy)
    dp = None
    run_cfg = cfg
    if plan is not None and getattr(plan.mesh, "is_concrete", False) and plan.mesh.size > 1:
        dp = DataParallel(plan)
        if plan.model_shards > 1:
            if tc.microbatches != 1 or not use_shadow:
                raise NotImplementedError(
                    "tensor-parallel training takes microbatches=1 and the weight shadow "
                    "(each matrix quantized whole before its shards are used); the rest is "
                    "ROADMAP item 9.4")
            run_cfg = plan.local_config()
        if tc.microbatches != 1:
            raise NotImplementedError("data-parallel training takes microbatches=1 (a "
                                      "microbatch's scale groups would span ranks)")
    run_plan = plan if dp is not None else None

    def inputs_of(params):
        with torch.no_grad():
            if dp is not None:
                return dp.inputs(params, policy if use_shadow else None)
            return _quantize_shadow(params, policy) if use_shadow else params

    def grads_of(params, batch):
        """Mean loss and gradients over the microbatches (the data-parallel
        step: this rank's share of the loss, its rows' partial gradients
        of the whole tree)."""
        inputs = inputs_of(params)
        batch = actshard.shard_batch(batch)
        m = tc.microbatches
        if m == 1:
            return loss_and_grads(run_cfg, loss_policy, inputs, batch)
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
            b = actshard.shard_batch(batch)
            logits = registry.forward(run_cfg, loss_policy, inputs_of(params), b)
            return transformer.token_losses(cfg, logits, b["labels"])

    train_step.grads = grads_planned
    train_step.token_losses = token_losses
    train_step.data_parallel = dp
    return train_step
