"""Decoder-only transformer LM, dense or MoE, and the vlm family's backbone
(port of ``repro/models/transformer.py``: specs, forward, loss, prefill,
lockstep decode and per-slot decode over the paged or contiguous pool
cache, the fused chunk step and the speculative verify step).

A vlm config adds ``patch_proj``: precomputed patch embeddings (the stub
of its vision frontend) are projected by one ``mf_linear`` and prefix the
token embeddings (:func:`embed_inputs`) in the forward, the loss (whose
logits start after the patches) and prefill.  Decode, chunk and verify
steps take tokens only, as in the reference: the patches sit in the
cache after prefill.

Layers are stacked along a leading 'layer' axis, as in the reference, and
run as a Python loop over it.  Every weight matmul is ``mf_linear``, and
``mf_expert_linear`` for the experts of a MoE layer (:func:`_moe_apply`).

Training.  :func:`lm_loss` runs the batched :func:`forward` (never the
row-by-row decode reductions below) with per-layer recomputation, the
reference's ``jax.checkpoint`` around its layer scan: each layer's
activations are rebuilt in the backward, so only the layer inputs stay
live (``torch.utils.checkpoint``, non-reentrant; numerically a no-op, the
forward is deterministic).  The stacked leaves are unbound once per
forward, so the backward stacks each leaf's per-layer gradients once
instead of writing a full (L, ...) zero gradient per layer.

Batch invariance on the card.  Decode rows must not depend on their pool
neighbours (the serving engine's pool-vs-solo identity).  K1 is
row-independent by construction and the quantizer's groups are per row,
but PyTorch picks the reduction split of a norm, a softmax or a batched
attention product from the whole tensor's shape.  So decode runs its
row reductions one row at a time (:func:`_rows`): a row in a pool of
four then runs the very same (1, ...) programs as a request served alone.
:func:`chunk_step` runs each slot's norms and attention on their own in
the same way (a decode row at decode's shapes, a chunk at (1, C, ·)).
A MoE layer dispatches per slot in every serving step (``per_slot``), so
routing, capacity and expert scales never couple pool rows; its router
softmax sums each row in a fixed order (:func:`_softmax_rows`).

On a model axis (a sharded plan active, ``parallel/actshard.py``; the
decoder, dense or MoE, and the vlm's backbone,
``parallel/planner.decoder_layout``; ``models/encdec.py``,
``models/ssm.py`` and ``models/recurrent.py`` take the same hooks) the step
bodies run with the plan's local config (this rank's q and K/V heads)
over this rank's weight shards: q/k/v heads split at whole heads (the
K/V heads selected from a whole product where they do not split,
:func:`_qkv`), attention on the rank over the whole head count with the
other ranks' heads zero (:func:`_heads_whole`: the card's batched
products round by the batch's size), norms and rope on every rank,
``wo`` and the MLP's (the shared expert's) down projection row-parallel
(K1's fold chained across the ranks) or over the all-gathered input
where a rank's slice is not whole 128-chunks (:func:`_out_proj`), the
embedding rows of a vocab shard gathered and selected (never summed with
zeros, :func:`_embed`) and the head's logits all-gathered in rank order
(:func:`_lm_head`).  A MoE layer routes whole on every rank; under EP
each rank runs its own experts and each token slot takes its output from
the rank that owns its expert, under TP every rank runs every expert's
slice of the hidden width (:func:`_moe_apply`).  A vlm's patch rows go
through ``patch_proj`` whole on every rank and prefix the tokens'
gathered embeddings (:func:`embed_inputs`), so a patch request's solo
prefill runs the backbone's hooks over them.  Every scale that spans
the split heads is a max over the model ranks (:func:`head_group`): the
attention products' under ``quantize_attention`` and a token's
``KV_PINNED`` page beta.  Unquantized (the FP32 baseline) a folded ``wo``
or down projection adds the ranks' partial products in rank order.
Without a plan every hook is the identity.

Under autograd (tensor-parallel training of the decoder, dense or MoE,
the vlm and, through the same hooks, the encdec, the ssm and the
hybrid) the hooks keep the
replicated-compute convention: every model rank holds the same
replicated activations and computes the same loss from the gathered
logits.  The gathers (the embedding's lookups, the head's logits, an input
gathered for a whole product) take this rank's slice of the gradient
(``collectives.gather_replicated``); the column-parallel linears (q and
the split K/V heads, the MLP's gate and up projections, the vocab-split
head) mark their input, whose gradient K2 chains across the ranks
(``mfmac.mf_linear(col_group=)``); the row-parallel ``wo`` and down
projection chain their dgamma rows.  A vocab shard's embedding rows take
the gradient of the tokens it owns only (:class:`_ShardLookup`).  K/V
heads selected from a whole product (``kv == 'select'``) stay whole
under autograd, and every rank attends with the whole q over them, its
heads cut from the output (:func:`_heads_whole`, :func:`_mine`): the
attention's backward is one rank's on every rank, and wk and wv take one
rank's gradient, replicated.  A vlm's ``patch_proj`` runs whole on every rank,
its gradient replicated.  A MoE layer's router runs whole, its gradient
replicated; under EP each token slot enters its expert's cells through
``collectives.grad_from_owner`` and its ungated output is selected from
its expert's rank (``collectives.select_from_owner``) before the gate,
so the slots' and the gate's gradients are one rank's on every rank;
under TP gate and up are column-parallel per expert (K2 chained across
the ranks) and down runs whole over the gathered hidden state
(:func:`_moe_apply`).

Under data-parallel training (``parallel/actshard.batch_group``) a MoE
layer's dispatch groups are the global batch's: the group size comes
from the global token count, and each rank's rows must hold whole
groups.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compress, mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import to_device
from repro_torch.kernels.ref import halves_fold
from repro_torch.models import common
from repro_torch.models.spec import ParamSpec
from repro_torch.parallel import actshard, collectives


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _linear(shape, axes, std, gamma_init=0.95):
    # PRC gamma: one scalar per layer instance (stacked along 'layer').
    if axes and axes[0] == "layer":
        gshape, gaxes = (shape[0],), ("layer",)
    else:
        gshape, gaxes = (), ()
    return {
        "w": ParamSpec(shape, axes, std=std),
        "gamma": ParamSpec(gshape, gaxes, init="value", value=gamma_init),
    }


def _norm_specs(cfg: ModelConfig, L: Optional[int] = None):
    lead = () if L is None else (L,)
    laxes = () if L is None else ("layer",)
    if cfg.norm == "nonparam_ln":
        return {}
    out = {"scale": ParamSpec(lead + (cfg.d_model,), laxes + (None,), init="ones")}
    if cfg.norm == "ln":
        out["bias"] = ParamSpec(lead + (cfg.d_model,), laxes + (None,), init="zeros")
    return out


def _mlp_specs(cfg: ModelConfig, L: int, std: float):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi_gate": _linear((L, d, f), ("layer", "embed", "ffn"), std),
            "wi_up": _linear((L, d, f), ("layer", "embed", "ffn"), std),
            "wo": _linear((L, f, d), ("layer", "ffn", "embed"), std),
        }
    return {
        "wi": _linear((L, d, f), ("layer", "embed", "ffn"), std),
        "wo": _linear((L, f, d), ("layer", "ffn", "embed"), std),
    }


def _moe_specs(cfg: ModelConfig, L: int, std: float):
    # gelu experts use "gate" and "down" only; "up" is kept, unused, so the
    # tree is the reference's leaf for leaf
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.num_experts
    out = {
        "router": _linear((L, d, e), ("layer", "embed", None), std),
        "gate": _linear((L, e, d, f), ("layer", "expert", "embed", "ffn"), std),
        "up": _linear((L, e, d, f), ("layer", "expert", "embed", "ffn"), std),
        "down": _linear((L, e, f, d), ("layer", "expert", "ffn", "embed"), std),
    }
    if m.shared_expert:
        out["shared"] = _mlp_specs(cfg, L, std)
    return out


def decoder_specs(cfg: ModelConfig):
    if cfg.family not in ("decoder", "vlm"):
        raise ValueError(f"decoder_specs: family {cfg.family!r} has no decoder backbone")
    L, d = cfg.n_layers, cfg.d_model
    hd = cfg.head_dim
    std = 0.02
    layer = {
        "ln1": _norm_specs(cfg, L),
        "ln2": _norm_specs(cfg, L),
        "wq": _linear((L, d, cfg.n_heads * hd), ("layer", "embed", "heads"), std),
        "wk": _linear((L, d, cfg.kv_heads * hd), ("layer", "embed", "kv"), std),
        "wv": _linear((L, d, cfg.kv_heads * hd), ("layer", "embed", "kv"), std),
        "wo": _linear((L, cfg.n_heads * hd, d), ("layer", "heads", "embed"), std),
    }
    if cfg.moe is not None:
        layer["moe"] = _moe_specs(cfg, L, std)
    else:
        layer["mlp"] = _mlp_specs(cfg, L, std)
    specs = {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), std=0.02),
        "layers": layer,
        "final_norm": _norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _linear((d, cfg.vocab_padded), ("embed", "vocab"), std)
    if cfg.family == "vlm" and cfg.num_patches:
        specs["patch_proj"] = _linear((cfg.patch_dim, d), (None, "embed"), std)
    return specs


def _layer(tree, i: int):
    """Layer ``i`` of the stacked (or unbound) layer tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind_layers(tree):
    """Stacked (L, ...) leaves split once into per-layer views."""
    return {k: _unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}


def _rows(fn, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """Apply ``fn`` to each leading row (kept as a batch of one) and stack:
    every row runs the same fixed-shape program whatever the batch size."""
    return torch.cat([fn(x[i:i + 1], *(r[i:i + 1] for r in rest))
                      for i in range(x.shape[0])])


# ---------------------------------------------------------------------------
# Model-axis hooks (identity without an active sharded plan)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _TP:
    cfg: ModelConfig  # the whole model's config
    layout: object  # parallel.planner.DecoderLayout
    rank: int
    group: object


def _tp() -> Optional[_TP]:
    plan = actshard.active_plan()
    if (plan is None or plan.model_shards == 1 or plan.cfg is None
            or not getattr(plan.mesh, "is_concrete", False)):
        return None
    return _TP(plan.cfg, plan.layout(), plan.mesh.coord("model"), plan.mesh.group("model"))


def _gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """Every model rank's columns of ``x``, concatenated in rank order (a
    result every rank uses alike: the backward takes this rank's slice)."""
    return collectives.gather_replicated(x.contiguous(), group, -1)


class _ShardLookup(torch.autograd.Function):
    """Rows ``idx`` of a vocab shard (``idx`` = the shard's row count for
    a token another rank owns: its row is never selected, so it reads the
    last row and takes no gradient).  The backward accumulates only the
    owned tokens' gradients, in the order a whole table's embedding
    backward does."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.rows = table.shape[0]
        ctx.save_for_backward(idx)
        return F.embedding(idx.clamp(max=ctx.rows - 1), table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = torch.ops.aten.embedding_dense_backward(g, idx, ctx.rows + 1, ctx.rows, False)
        return grad[:ctx.rows], None


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; over a vocab shard each rank looks up the rows
    it holds, the lookups are all-gathered and each token takes its row
    from the rank that holds it (selected, not summed with zeros)."""
    tp = _tp()
    if tp is None or not tp.layout.vocab:
        return table[tokens]
    vl = table.shape[0]
    lo = tp.rank * vl
    owned = (tokens >= lo) & (tokens < lo + vl)
    local = _ShardLookup.apply(table, torch.where(owned, tokens - lo, vl))
    stacked = collectives.gather_replicated(local[None], tp.group, 0)
    owner = (tokens // vl).clamp(max=tp.layout.model - 1)
    idx = owner[None, ..., None].expand((1,) + tuple(local.shape))
    return torch.gather(stacked, 0, idx)[0]


def _attend_whole(tp: Optional[_TP], x: torch.Tensor) -> bool:
    """Under autograd with K/V heads selected from a whole product: each
    rank attends with the whole q, K and V (:func:`_heads_whole`)."""
    return (tp is not None and tp.layout.kv == "select" and torch.is_grad_enabled()
            and x.requires_grad)


def _kv_select(k: torch.Tensor) -> torch.Tensor:
    """A whole K or V projection (..., KV*hd) cut to the K/V heads this
    rank's q heads read (``kv == 'select'``; kept whole under autograd,
    :func:`_heads_whole`); otherwise as it is."""
    tp = _tp()
    if tp is None or tp.layout.kv != "select" or _attend_whole(tp, k):
        return k
    hd = tp.cfg.head_dim
    lo = tp.layout.kv_lo(tp.rank, tp.cfg)
    return k[..., lo * hd:(lo + tp.layout.kv_local) * hd]


def _heads_whole(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """On a model axis that splits the heads: this rank's q heads (B, S,
    H_r, hd) and K/V heads placed at their global offsets in zero tensors
    of the whole model's head counts, and the slice of an attention
    output's heads that is this rank's; elsewhere (q, k, v, None).  The
    card's batched products pick their kernel, and so their rounding, by
    the batch's size: attending over the whole head count gives each of
    this rank's heads one rank's bits (the padded heads are discarded).

    Under autograd with K/V heads selected from a whole product (``k`` and
    ``v`` whole, :func:`_kv_select`) a rank's q heads would take only
    their share of a shared K/V head's gradient.  So every rank attends
    with the whole q (gathered over the model ranks; its backward keeps
    this rank's column-parallel slice) over the whole K and V, and
    :func:`_mine` cuts the output to its heads: the attention's backward
    is one rank's, replicated, and dK and dV reach the whole wk and wv
    products."""
    tp = _tp()
    if tp is None or not tp.layout.heads:
        return q, k, v, None
    lo, kv_lo = tp.rank * tp.layout.heads_local, tp.layout.kv_lo(tp.rank, tp.cfg)
    mine = slice(lo, lo + q.shape[2])
    if _attend_whole(tp, q):
        return collectives.gather_replicated(q.contiguous(), tp.group, 2), k, v, mine

    def whole(x, n, at):
        out = x.new_zeros(x.shape[:2] + (n,) + x.shape[3:])
        out[:, :, at:at + x.shape[2]] = x
        return out

    return (whole(q, tp.cfg.n_heads, lo), whole(k, tp.cfg.kv_heads, kv_lo),
            whole(v, tp.cfg.kv_heads, kv_lo), mine)


def _mine(out: torch.Tensor, mine: Optional[slice]) -> torch.Tensor:
    """This rank's heads ``mine`` (:func:`_heads_whole`) of an attention
    output (B, S, H, hd); under autograd with K/V heads selected from a
    whole product through ``collectives.slice_replicated``, whose backward
    gathers every rank's heads' gradient into the whole one."""
    if mine is None:
        return out
    tp = _tp()
    if _attend_whole(tp, out):
        return collectives.slice_replicated(out, tp.group, 2)
    return out[:, :, mine]


def head_group():
    """The model group when the active plan splits the attention's heads
    (each rank holds its q and K/V heads of every token: a per-token or
    per-tensor scale of them is a max over the group), else None."""
    tp = _tp()
    return tp.group if tp is not None and tp.layout.heads else None


def _out_proj(p, x, policy, mode: str, whole: bool = False) -> torch.Tensor:
    """An output projection whose input is split over the model axis
    (``wo`` of the attention, ``mode`` 'wo'; the MLP's down projection,
    'mlp_wo'; an ssm's ``out_proj``, 'wo'; a hybrid's ``wout``, 'lru_wo'):
    row-parallel where the layout folds, else over the all-gathered input
    with the weight whole.  ``whole``: ``x`` is the whole input, the same
    on every rank (a mixer run whole under autograd); where the layout
    folds this rank's slice of it is taken by
    ``collectives.slice_replicated``, whose backward gathers every rank's
    slice gradient into the whole, replicated one.  Unquantized, a fold
    adds the ranks' partial products in rank order (``mfmac.mf_linear``'s
    ``row_group``)."""
    tp = _tp()
    how = getattr(tp.layout, mode) if tp is not None else "whole"
    if whole and how == "fold":
        x, whole = collectives.slice_replicated(x, tp.group, -1), False
    if how == "fold":
        return mfmac.mf_linear(x, p["w"], p["gamma"], policy=policy, row_group=tp.group)
    if how != "whole" and not whole:
        x = _gather_cols(x, tp.group)
    return mfmac.mf_linear(x, p["w"], p["gamma"], policy=policy)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _mlp_apply(cfg: ModelConfig, policy: QuantPolicy, p, x):
    tp = _tp()  # the hidden width split: gate and up are column-parallel
    col = tp.group if tp is not None and tp.layout.ffn else None
    if cfg.act == "swiglu":
        g = mfmac.mf_linear(x, p["wi_gate"]["w"], p["wi_gate"]["gamma"], policy=policy,
                            col_group=col)
        u = mfmac.mf_linear(x, p["wi_up"]["w"], p["wi_up"]["gamma"], policy=policy,
                            col_group=col)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = common.gelu(
            mfmac.mf_linear(x, p["wi"]["w"], p["wi"]["gamma"], policy=policy, col_group=col)
        )
    return _out_proj(p["wo"], h, policy, "mlp_wo")


def _softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis whose sum runs in a fixed order
    (:func:`halves_fold`), so a row's bits never depend on the shape of
    the batch around it; exp and the max are elementwise or exact."""
    ex = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return ex / halves_fold(ex)[..., None]


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, largest
    first; among equal values the lower index wins, as in
    ``jax.lax.top_k`` (argmax returns the first maximal index)."""
    vals, idxs, p = [], [], probs
    for i in range(k):
        j = p.argmax(-1, keepdim=True)
        vals.append(probs.gather(-1, j))
        idxs.append(j)
        if i + 1 < k:
            p = p.scatter(-1, j, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Expert capacity of a dispatch group of ``t`` tokens (a multiple of
    4, at least 4); tokens past it are dropped."""
    m = cfg.moe
    cap = int(t * m.top_k / m.num_experts * m.capacity_factor)
    return max(4, ((cap + 3) // 4) * 4)


def moe_route(cfg: ModelConfig, probs: torch.Tensor):
    """Top-k routing of router probabilities (G, T, E) over the (G, T*k)
    token slots, token-major (slot ``t*k + j`` is token t's j-th choice).
    Returns (gate, expert, pos, keep, cap): the normalized gate value, the
    expert, the slot's position in its expert's queue of the group (a
    cumulative count in slot order), whether it fits the capacity, and the
    capacity."""
    g, t, e = probs.shape
    k = cfg.moe.top_k
    gate, expert = _top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True)
    expert = expert.reshape(g, t * k)
    onehot = (expert[..., None] == torch.arange(e, device=probs.device)).to(torch.int64)
    pos = torch.gather(onehot.cumsum(1), 2, expert[..., None])[..., 0] - 1
    cap = moe_capacity(cfg, t)
    return gate.reshape(g, t * k), expert, pos, pos < cap, cap


def _moe_apply(cfg: ModelConfig, policy: QuantPolicy, p, x, group_size: int = 512,
               per_slot: bool = False):
    """GShard-style capacity dispatch; the experts run through
    ``mf_expert_linear``.

    x: (B, S, D).  Tokens are regrouped into groups of ``group_size``
    (training, prefill; under data-parallel training the global token
    count sets the group size, and a rank's rows must hold whole groups),
    or with ``per_slot`` every batch row is a group of its own (serving):
    its own capacity, and its own activation scale per expert, so a
    slot's routing and bits never depend on its neighbours.

    The reference's one-hot dispatch and combine einsums are index ops
    here, with the same values: each kept token slot is written to cell
    (expert, group, pos) of a zeroed (E, G, C, D) buffer (slots that are
    dropped, or whose gate is 0, go to one dead row past it), and its
    output is read back from that cell times its gate; top-k slots are
    summed in k order.  Every shape is static: nothing syncs with the
    host.

    On a model axis every rank routes the whole layer (its input and the
    router are the same on each).  Under EP a rank fills only its own
    experts' cells and runs them; each token slot's ungated output is then
    taken from the rank that owns its expert
    (``collectives.select_from_owner``: all-gathered and selected, never
    summed with zeros) and gated on every rank, so the top-k sum keeps one
    rank's bits.  Under autograd the slots enter the cells through
    ``collectives.grad_from_owner``: each slot's input gradient comes from
    its expert's rank, and the gate's (the router's) is one rank's,
    replicated.  Under TP each rank runs gate and up over its slice of the
    hidden width (column-parallel per expert, K2 chained across the ranks,
    ``core/mfmac.py``), and the down projection over the all-gathered
    hidden state."""
    m = cfg.moe
    b, s, d = x.shape
    if per_slot:
        g, t = b, s
        xg = x
    else:
        shards = actshard.batch_shards()
        t = min(group_size, b * s * shards)
        g = b * s // t
        if g * t != b * s:
            raise ValueError(f"{b} x {s} tokens do not split into groups of {t}" + (
                f" (the global batch's, over {shards} data ranks): a dispatch group would "
                "straddle two ranks" if shards > 1 else ""))
        xg = x.reshape(g, t, d)
    logits = mfmac.mf_linear(xg, p["router"]["w"], p["router"]["gamma"],
                             policy=policy).to(torch.float32)  # (G, T, E)
    gate, expert, pos, keep, cap = moe_route(cfg, _softmax_rows(logits))
    e, k = m.num_experts, m.top_k
    tp = _tp()
    mode = tp.layout.experts if tp is not None else None
    el = tp.layout.experts_local if mode == "EP" else e
    lo = tp.rank * el if mode == "EP" else 0
    xk = xg.repeat_interleave(k, dim=1) if k > 1 else xg  # (G, T*k, D)
    grp = torch.arange(g, device=x.device)[:, None]
    dead = el * g * cap
    live = keep & (gate > 0)
    owner = expert // el if mode == "EP" else None  # the rank of each slot's expert
    if mode == "EP":  # this rank's experts' cells only
        live &= owner == tp.rank
        xk = collectives.grad_from_owner(xk, owner, tp.group)
    cell = torch.where(live, ((expert - lo) * g + grp) * cap + pos, dead)
    buf = x.new_zeros((dead + 1, d)).index_put((cell.reshape(-1),), xk.reshape(-1, d))
    ein = buf[:dead].reshape(el, g, cap, d)
    if not per_slot:
        ein = ein.reshape(el, g * cap, d)

    # the backward's groups: the experts split over the model ranks (EP),
    # or gate's and up's hidden width (TP)
    experts_group = tp.group if mode == "EP" else None
    cols = tp.group if mode == "TP" else None

    def ffn(name, h, col_group=None):
        q = p[name]
        return mfmac.mf_expert_linear(h, q["w"], q["gamma"], policy=policy, per_slot=per_slot,
                                      expert_group=experts_group, col_group=col_group)

    if cfg.act == "swiglu":
        h = F.silu(ffn("gate", ein, cols).to(torch.float32)).to(x.dtype) * ffn("up", ein, cols)
    else:
        h = common.gelu(ffn("gate", ein, cols))
    if mode == "TP":
        h = _gather_cols(h, tp.group)
    eout = ffn("down", h).reshape(dead, d)
    eout = torch.cat([eout, eout.new_zeros((1, d))])
    rows = eout[cell]  # (G, T*k, D)
    if mode == "EP":  # each slot's from its expert's rank
        rows = collectives.select_from_owner(rows, owner, tp.group)
    out = (rows.to(torch.float32) * torch.where(keep, gate, 0.0)[..., None]).to(x.dtype)
    if k > 1:
        out = out.reshape(g, t, k, d).sum(dim=2)
    out = out.reshape(b, s, d)
    if m.shared_expert:
        out = out + _mlp_apply(cfg, policy, p["shared"], x)
    return out


def _ffn(cfg, policy, p, x, per_slot=False):
    """The block's feed-forward: the MoE layer (``per_slot`` in serving
    steps) or the MLP."""
    if cfg.moe is not None:
        return _moe_apply(cfg, policy, p["moe"], x, per_slot=per_slot)
    return _mlp_apply(cfg, policy, p["mlp"], x)


def _qkv(cfg, policy, p, x, qpos):
    """q, k, v projections of x (B, S, D) with rope at positions (B, S)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    tp = _tp()  # split heads: q (and K/V split with them) column-parallel
    qcol = tp.group if tp is not None and tp.layout.heads else None
    kvcol = tp.group if tp is not None and tp.layout.kv == "split" else None
    q = mfmac.mf_linear(x, p["wq"]["w"], p["wq"]["gamma"], policy=policy, col_group=qcol)
    k = _kv_select(mfmac.mf_linear(x, p["wk"]["w"], p["wk"]["gamma"], policy=policy,
                                   col_group=kvcol))
    v = _kv_select(mfmac.mf_linear(x, p["wv"]["w"], p["wv"]["gamma"], policy=policy,
                                   col_group=kvcol))
    # K/V: this rank's heads, or the whole product's (_kv_select)
    q = common.rope(q.reshape(b, s, cfg.n_heads, hd), qpos, cfg.rope_theta)
    k = common.rope(k.reshape(b, s, -1, hd), qpos, cfg.rope_theta)
    return q, k, v.reshape(b, s, -1, hd)


def _attn_apply(cfg: ModelConfig, policy: QuantPolicy, p, x, qpos, *,
                window=None):
    """Self-attention over the sequence itself (training forward/prefill);
    ``qpos`` is 1-D.  Returns (output, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, policy, p, x, qpos[None, :].expand(b, s))
    att = _sdpa(cfg, policy, q, k, v, qpos, qpos, window)
    att = att.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return _out_proj(p["wo"], att, policy, "wo"), (k, v)


def _sdpa(cfg, policy, q, k, v, qpos, kpos, window):
    """Grouped-GQA attention with FP32 scores (K/V at kv-head width); QK^T
    and PV through ``mfmac.mf_act_dot`` (PoT-quantized under
    ``policy.quantize_attention``, one scale group per tensor or per
    leading-dim sample, over every rank's heads on a model axis).

    ``qpos``/``kpos`` are 1-D (shared across the batch) or 2-D
    ``(B, Sq)``/``(B, Skv)``.  Masked scores take -1e30, as in the
    reference; ``kpos < 0`` marks cache entries not yet written.  On a
    model axis it attends over the whole head count (:func:`_heads_whole`)
    and returns this rank's heads."""
    q, k, v, mine = _heads_whole(q, k, v)
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32, device=q.device))
    qg = q.reshape(b, sq, kv, rep, hd).permute(0, 2, 3, 1, 4)  # (B,KV,rep,Sq,hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,Skv)
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,Skv,hd)
    group = head_group() if mine is not None else None
    scores = mfmac.mf_act_dot(qg, kt, policy=policy,
                              group=group).to(torch.float32) * scale  # (B,KV,rep,Sq,Skv)
    if qpos.dim() == 1:
        qpos = qpos[None, :].expand(b, sq)
    if kpos.dim() == 1:
        kpos = kpos[None, :].expand(b, skv)
    mask = kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    mask &= (kpos >= 0)[:, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = mfmac.mf_act_dot(probs.to(q.dtype), vt, policy=policy,
                           group=group)  # (B,KV,rep,Sq,hd)
    return _mine(out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype), mine)


def _block(cfg, policy, p, x, qpos):
    h = common.apply_norm(cfg.norm, x, p.get("ln1"))
    att, new_kv = _attn_apply(cfg, policy, p, h, qpos, window=cfg.window)
    x = x + att
    h2 = common.apply_norm(cfg.norm, x, p.get("ln2"))
    x = x + _ffn(cfg, policy, p, h2)
    return x, new_kv


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------

def embed_inputs(cfg, policy, params, tokens, patch_embeds=None):
    """Token embeddings (B, S, D), prefixed for a vlm by the projected
    patch embeddings (B, P, patch_dim) -> (B, P + S, D).  On a model axis
    the tokens' rows come from the vocab shards (:func:`_embed`) and
    ``patch_proj``, whole on every rank, projects every patch row there."""
    # the values of embed[tokens]; the backward is embedding_dense_backward
    # rather than an accumulating index_put_, and the trainer's
    # deterministic mode keeps it run-to-run identical on the card (a
    # table whole on every model rank, a tied one, takes the same backward)
    tp = _tp()
    x = (F.embedding(tokens, params["embed"]) if tp is None or not tp.layout.vocab
         else _embed(params["embed"], tokens)).to(getattr(torch, cfg.act_dtype))
    if cfg.family == "vlm" and patch_embeds is not None:
        pp = params["patch_proj"]
        pe = mfmac.mf_linear(patch_embeds.to(torch.float32), pp["w"], pp["gamma"],
                             policy=policy).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _block_out(cfg, policy, p, x, qpos):
    return _block(cfg, policy, p, x, qpos)[0]


def forward(cfg: ModelConfig, policy: QuantPolicy, params, tokens: torch.Tensor,
            *, patch_embeds=None, return_kv: bool = False, remat: bool = False):
    """Full-sequence forward.  Returns logits (B, S_total, V_padded), the
    patch positions of a vlm first, and, with ``return_kv``, the
    per-layer (k, v) lists stacked to (L, B, S_total, KV, hd).  ``remat``
    recomputes each layer in the backward (when grad is on)."""
    x = embed_inputs(cfg, policy, params, tokens, patch_embeds)
    qpos = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    layers = _unbind_layers(params["layers"])
    recompute = remat and torch.is_grad_enabled() and not return_kv
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        if recompute:
            x = checkpoint(_block_out, cfg, policy, lp, x, qpos,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, (k, v) = _block(cfg, policy, lp, x, qpos)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = common.apply_norm(cfg.norm, x, params.get("final_norm"))
    logits = _lm_head(cfg, policy, params, x)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def tied_head(policy, embed, x):
    """The LM head tied to the token embedding, x @ embed^T, with the last
    layer's gradient bits and gamma = ``ratio_clip_init``.  The embedding
    table is never prequantized, so it is quantized at use (at every
    call, as in the reference: no quantized copy is kept)."""
    pol = dataclasses.replace(policy, weights_prequantized=False)
    return mfmac.mf_linear(x, embed.T, policy.ratio_clip_init or 1.0, policy=pol,
                           is_last=True)


def _lm_head(cfg, policy, params, x):
    if cfg.tie_embeddings:
        return tied_head(policy, params["embed"], x)
    hp = params["lm_head"]
    tp = _tp()
    vocab = tp is not None and tp.layout.vocab
    logits = mfmac.mf_linear(x, hp["w"], hp["gamma"], policy=policy, is_last=True,
                             col_group=tp.group if vocab else None)
    if vocab:
        logits = _gather_cols(logits, tp.group)  # the vocab shards in rank order
    return logits


def lm_loss(cfg: ModelConfig, policy: QuantPolicy, params, tokens, labels,
            loss_mask, *, patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy over ``loss_mask``; padded-vocab ids
    are masked out (logits -1e30) before the logsumexp.  A vlm's patch
    positions carry no loss: the logits are cut after them."""
    logits = forward(cfg, policy, params, tokens, patch_embeds=patch_embeds, remat=remat)
    if patch_embeds is not None:
        logits = logits[:, patch_embeds.shape[1]:]
    return next_token_loss(cfg, logits, labels, loss_mask)


def token_losses(cfg: ModelConfig, logits, labels) -> torch.Tensor:
    """Per-token cross entropy (B, S) of ``logits`` (B, S, V_padded)
    against ``labels``, padded-vocab ids masked out."""
    logits = logits.to(torch.float32)
    vpad = cfg.vocab_padded
    if vpad != cfg.vocab:
        invalid = torch.arange(vpad, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(invalid, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def next_token_loss(cfg: ModelConfig, logits, labels, loss_mask) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (B, S, V_padded) against ``labels``
    over ``loss_mask``, padded-vocab ids masked out.  Under a data-parallel
    plan the mean's denominator is the global token count, so the ranks'
    losses (and gradients) sum to one rank's."""
    losses = token_losses(cfg, logits, labels)
    mask = loss_mask.to(torch.float32)
    # over data-parallel ranks: this rank's share of the global mean
    denom = torch.clamp(collectives.all_reduce_sum(mask.sum(), actshard.batch_group()),
                        min=1.0)
    return (losses * mask).sum() / denom


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device):
    """Ring KV cache (window caps the live span for sliding-window archs)."""
    span = min(max_len, cfg.window) if cfg.window else max_len
    L, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, span, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, span, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((span,), -1, dtype=torch.int64, device=device),
        "len": torch.zeros((), dtype=torch.int64, device=device),
    }


def prefill(cfg, policy, params, tokens, cache, patch_embeds=None):
    """Run the prompt (a vlm's patches, then its tokens) through the
    model, filling ``cache`` (in place); returns the last position's
    logits and the cache.

    The LM head runs over ALL prompt positions before the last one is
    taken: prefill's (1, S, D) input is one activation-scale group, and
    the head must see the same group the reference's does."""
    logits, (ks, vs) = forward(cfg, policy, params, tokens, patch_embeds=patch_embeds,
                               return_kv=True)
    s = ks.shape[2]
    span = cache["k"].shape[2]
    take = min(s, span)
    ks_t = ks[:, :, s - take:].to(cache["k"].dtype)
    vs_t = vs[:, :, s - take:].to(cache["v"].dtype)
    pos = torch.arange(s - take, s, dtype=cache["pos"].dtype, device=ks.device)
    if take == span:
        # ring layout: global position p lives in slot p % span
        shift = s % span
        cache["k"].copy_(torch.roll(ks_t, shift, dims=2))
        cache["v"].copy_(torch.roll(vs_t, shift, dims=2))
        cache["pos"] = torch.roll(pos, shift)
    else:
        cache["k"][:, :, :take] = ks_t
        cache["v"][:, :, :take] = vs_t
        cache["pos"] = cache["pos"].clone()
        cache["pos"][:take] = pos
    cache["len"] = torch.full((), s, dtype=cache["len"].dtype, device=ks.device)
    return logits[:, -1, :], cache


# ---------------------------------------------------------------------------
# Paged pool cache (serve/slots.py): gathers and guarded writes
# ---------------------------------------------------------------------------

def page_ids(cache) -> torch.Tensor:
    """The page table with drop_id entries clamped onto the null page."""
    return cache["table"].clamp(max=cache["pos"].shape[0] - 1)


def page_view(leaf, ids):
    """Logical (B, span, ...) row view (a copy) of a physical page store
    (P+1, page, ...) through clamped table ids (B, n).  Entries of dead
    and unallocated slots read the null page, whose ``pos`` is -1: masked
    out of attention."""
    b, n = ids.shape
    x = leaf[ids]  # (B, n, page, ...)
    return x.reshape((b, n * x.shape[2]) + x.shape[3:])


def paged_write(leaf, dest, loff, vals, num_pages: int):
    """``leaf[dest, loff] = vals`` where ``dest < num_pages``; where it is
    the null page or drop_id nothing changes.  Those positions are pointed
    at the null page and written with the null page's own contents, so no
    index is out of bounds (torch has no drop mode), no live page is
    touched and the step needs no host round trip."""
    ok = dest < num_pages
    d = torch.where(ok, dest, torch.full_like(dest, num_pages))
    old = leaf[d, loff]
    keep = ok.reshape(ok.shape + (1,) * (old.dim() - ok.dim()))
    leaf[d, loff] = torch.where(keep, vals.to(leaf.dtype), old)
    return leaf


def _kv_check(policy, cache):
    """The cache's KV wire format: ``policy.kv_quant`` when the cache holds
    quantized pages (it carries the ``k_beta``/``v_beta`` leaves), else
    None (bf16 pages; a solo prefill's mini cache stays bf16 under a
    kv_quant policy)."""
    if "k_beta" not in cache:
        return None
    if policy.kv_quant is None:
        raise ValueError("cache holds quantized K/V pages but policy.kv_quant is None")
    return policy.kv_quant


def _kv_scatter(cache, key, layer, dest, loff, vals, npages, spec):
    """Write fresh K or V vectors (..., KV, hd) of ``layer`` at (dest,
    loff) as :func:`paged_write` does; PoT-encoded, with their per-token
    betas (over every model rank's K/V heads), when ``spec`` is set."""
    if spec is None:
        paged_write(cache[key][layer], dest, loff, vals, npages)
        return
    codes, beta = compress.kv_page_encode(vals, spec, head_group())
    paged_write(cache[key][layer], dest, loff, codes, npages)
    paged_write(cache[f"{key}_beta"][layer], dest, loff, beta, npages)


def _kv_page_view(cache, key, layer, ids, spec):
    """Logical (B, span, KV, hd) K or V view of ``layer``, decoded to exact
    PoT float32 values when ``spec`` is set (the attention casts it to
    the activation dtype, exactly)."""
    view = page_view(cache[key][layer], ids)
    if spec is None:
        return view
    return compress.kv_page_decode(view, page_view(cache[f"{key}_beta"][layer], ids), spec)


def _attend(cfg, policy, q, k, v, qpos, kpos, window):
    return _sdpa(cfg, policy, q, k.to(q.dtype), v.to(q.dtype), qpos, kpos, window)


def rows_are_groups(policy) -> bool:
    """Whether each leading row (slot) of an attention is an activation-
    scale group of its own, so that attending row by row gives the
    batch's bits: always unless ``quantize_attention`` puts the products
    under one scale per tensor (no ``per_sample_act_scales``)."""
    return policy.per_sample_act_scales or not (policy.enabled and policy.quantize_attention)


def _needs_row_groups(policy, step):
    if not rows_are_groups(policy):
        raise ValueError(f"{step} attends slot by slot: under quantize_attention it needs "
                         "per_sample_act_scales (the serving policy)")


def _norm_fn(cfg, p):
    return lambda r: common.apply_norm(cfg.norm, r, p)


class DecodeSlots:
    """The cache addresses of one decode step, shared by every layer (and
    by ``models/encdec.py``, and by each attention layer of
    ``models/recurrent.py`` over its own ring): the position each row
    writes, the rows' query positions and the ``pos`` view they attend
    against.  Building it writes the new positions into a paged ``pos``."""

    def __init__(self, cache, token, spec):
        pos = cache["len"]
        b = token.shape[0]
        self.pos, self.spec = pos, spec
        self.paged = "table" in cache
        self.lockstep = pos.dim() == 0
        if self.paged:
            page = cache["pos"].shape[1]
            self.ids = page_ids(cache)
            span = self.ids.shape[1] * page
            self.npages = cache["pos"].shape[0] - 1
            slot = pos % span
            self.dest = torch.gather(cache["table"], 1, (slot // page)[:, None])[:, 0]
            self.loff = slot % page
            paged_write(cache["pos"], self.dest, self.loff, pos, self.npages)
            self.kpos = page_view(cache["pos"], self.ids)
        elif self.lockstep:
            span = cache["k"].shape[2]
            self.slot = (pos % span).reshape(1)
            self.kpos_new = cache["pos"].index_copy(0, self.slot, pos.reshape(1))
            self.kpos = self.kpos_new[None].expand(b, span)
        else:
            span = cache["k"].shape[2]
            self.slot = pos % span
            self.rows = torch.arange(b, device=token.device)
            self.kpos = cache["pos"].clone()
            self.kpos[self.rows, self.slot] = pos
        # (B, 1)
        self.qpos = pos.reshape(1, 1).expand(b, 1) if self.lockstep else pos[:, None]

    def attend(self, cfg, policy, cache, i, q, k, v):
        """Write layer ``i``'s fresh K/V (B, 1, KV, hd) of every row, then
        attend each row over its own view, row by row (B, 1, H, hd); the
        whole batch at once where its attention products share one scale
        group (:func:`rows_are_groups`)."""
        spec = self.spec
        if self.paged:
            _kv_scatter(cache, "k", i, self.dest, self.loff, k[:, 0], self.npages, spec)
            _kv_scatter(cache, "v", i, self.dest, self.loff, v[:, 0], self.npages, spec)
            kview = _kv_page_view(cache, "k", i, self.ids, spec)
            vview = _kv_page_view(cache, "v", i, self.ids, spec)
        elif self.lockstep:
            ck, cv = cache["k"][i], cache["v"][i]  # views: written in place
            ck.index_copy_(1, self.slot, k.to(ck.dtype))
            cv.index_copy_(1, self.slot, v.to(cv.dtype))
            kview, vview = ck, cv
        else:
            ck, cv = cache["k"][i], cache["v"][i]  # views: written in place
            ck[self.rows, self.slot] = k[:, 0].to(ck.dtype)
            cv[self.rows, self.slot] = v[:, 0].to(cv.dtype)
            kview, vview = ck, cv

        if not rows_are_groups(policy):
            return _attend(cfg, policy, q, kview, vview, self.qpos, self.kpos, cfg.window)

        def one(q1, kv1, vv1, qp, kp):
            return _attend(cfg, policy, q1, kv1, vv1, qp, kp, cfg.window)

        return _rows(one, q, kview, vview, self.qpos, self.kpos)

    def done(self, cache):
        """The step's ``pos`` (where it is not paged) and ``len`` + 1."""
        if self.lockstep:
            cache["pos"] = self.kpos_new
        elif not self.paged:
            cache["pos"] = self.kpos
        cache["len"] = self.pos + 1


def decode_step(cfg, policy, params, token, cache):
    """One decode step.  token: (B,) -> (logits (B, V), cache).  K/V (and
    ``pos`` where it is shared or paged) are written into ``cache`` in
    place; ``len`` is replaced.  Three layouts (``registry.init_cache``,
    ``registry.init_pool_cache`` and ``serve.slots.lift_cache``):

    * lockstep: ``len`` a scalar, ``pos`` (span,), ``k``/``v``
      (L, B, span, KV, hd).  Every row decodes at the one position
      ``len`` and writes ring slot ``len % span``; the activation scales
      are per tensor unless ``policy.per_sample_act_scales``.
    * paged: ``table`` (B, n), ``pos`` (P+1, page), ``k``/``v``
      (L, P+1, page, KV, hd).  Each row's view is gathered through its
      page table; it holds the same (position, value) pairs in the same
      order as a contiguous row, so the served bits do not depend on the
      page layout or size.  Rows whose page is drop_id (dead slots) write
      nothing.  Quantized pages (``k_beta`` leaves, ``policy.kv_quant``)
      are encoded per written token and decoded in the gathered view.
    * contiguous slot rows: ``pos`` (B, span), ``k``/``v``
      (L, B, span, KV, hd).

    Norms and attention run row by row in every layout, so a batch-1
    lockstep row runs the very programs of a pooled row.  Attention reads
    the cache cast to the activation dtype."""
    b = token.shape[0]
    st = DecodeSlots(cache, token, _kv_check(policy, cache))
    x = _embed(params["embed"], token[:, None])  # (B, 1, D)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _rows(_norm_fn(cfg, lp.get("ln1")), x)
        q, k, v = _qkv(cfg, policy, lp, h, st.qpos)
        att = st.attend(cfg, policy, cache, i, q, k, v).reshape(b, 1, cfg.n_heads * cfg.head_dim)
        y = x + _out_proj(lp["wo"], att, policy, "wo")
        h2 = _rows(_norm_fn(cfg, lp.get("ln2")), y)
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    x = _rows(_norm_fn(cfg, params.get("final_norm")), x)
    logits = _lm_head(cfg, policy, params, x)[:, 0, :]
    st.done(cache)
    return logits, cache


def _row(t, s):
    """Row ``s``, position 0 of a (B, C, ...) tensor as a fresh contiguous
    (1, 1, ...) tensor: the very strides ``decode_step`` hands its
    per-row programs."""
    return t[s:s + 1, :1].clone(memory_format=torch.contiguous_format)


def slot_norms(norm, x, layout):
    """``norm`` of each slot's rows: a decode row alone at (1, 1, D), as
    ``decode_step`` runs it; a chunk at (1, C, D), as a one-slot pool
    runs it; idle slots stay zero."""
    out = torch.zeros_like(x)
    for s, kind in enumerate(layout):
        if kind == "decode":
            out[s:s + 1, :1] = norm(_row(x, s))
        elif kind == "chunk":
            out[s:s + 1] = norm(x[s:s + 1])
    return out


def slot_attend(fn, q, layout):
    """``fn(q_s, s)`` of each slot's queries, at the shapes of
    :func:`slot_norms` (a decode row at (1, 1, H, hd), a chunk at (1, C,
    H, hd)); idle slots stay zero."""
    out = torch.zeros_like(q)
    for s, kind in enumerate(layout):
        if kind == "decode":
            out[s:s + 1, :1] = fn(_row(q, s), s)
        elif kind == "chunk":
            out[s:s + 1] = fn(q[s:s + 1], s)
    return out


class ChunkSlots:
    """The cache addresses of one chunk step, shared by every layer (and
    by ``models/encdec.py``): each slot's layout ("idle", "decode" or
    "chunk", from ``n_new`` read on the host), the valid positions and
    their query positions, the page each position writes and the ``pos``
    view.  Building it writes the valid positions into ``pos``."""

    def __init__(self, cfg, cache, tokens, n_new, spec):
        if "table" not in cache:
            raise NotImplementedError("repro_torch's chunk_step runs the paged pool cache")
        n_host = [int(n) for n in n_new]
        b, c = tokens.shape
        dev = tokens.device
        page = cache["pos"].shape[1]
        table = cache["table"]
        span = table.shape[1] * page
        self.npages = cache["pos"].shape[0] - 1
        if c > span:
            raise ValueError(f"chunk {c} exceeds the cache span {span}")
        self.windowed = cfg.window is not None
        self.spec = spec
        self.layout = ["idle" if n == 0 else "decode" if n == 1 and not self.windowed
                       else "chunk" for n in n_host]
        self.ids = page_ids(cache)
        self.pos0 = cache["len"]
        self.nn = to_device(n_host, dev, self.pos0.dtype)
        offs = torch.arange(c, dtype=self.pos0.dtype, device=dev)
        self.valid = offs[None, :] < self.nn[:, None]  # (B, C)
        gpos = self.pos0[:, None] + offs[None, :]
        self.qpos = torch.where(self.valid, gpos, torch.full_like(gpos, -1))
        lo = gpos % span
        dest = torch.gather(table, 1, lo // page)
        # pads: drop
        self.dest = torch.where(self.valid, dest, torch.full_like(dest, self.npages + 1))
        self.loff = lo % page
        # pre-scatter
        self.kpos_old = page_view(cache["pos"], self.ids) if self.windowed else None
        paged_write(cache["pos"], self.dest, self.loff, self.qpos, self.npages)
        self.kpos = page_view(cache["pos"], self.ids)
        self.vmask = self.valid[:, :, None]

    def norms(self, norm, x):
        """:func:`slot_norms`, pad rows zeroed (each slot's (C, D) scale
        group then has the amax of its valid rows alone)."""
        return torch.where(self.vmask, slot_norms(norm, x, self.layout), 0.0)

    def attend(self, cfg, policy, cache, i, q, k, v):
        """Write layer ``i``'s fresh K/V of the valid positions, then attend
        each slot over its view (a windowed arch over the pre-scatter cache
        and the fresh chunk); pad rows zeroed.  Returns (B, C, H * hd).

        A decode row attends at (1, 1, ·) and a chunk at (1, C, ·): under
        ``quantize_attention`` each keeps its slot's scale group, since a
        slot's pad queries are zero and their uniform probabilities are no
        larger than a valid row's largest."""
        _needs_row_groups(policy, "chunk_step")
        spec = self.spec
        windowed, npages, ids = self.windowed, self.npages, self.ids
        if windowed:
            ok = _kv_page_view(cache, "k", i, ids, spec)
            ov = _kv_page_view(cache, "v", i, ids, spec)
            kf, vf = k, v
            if spec is not None:
                group = head_group()
                kf = compress.kv_page_decode(*compress.kv_page_encode(k, spec, group), spec)
                vf = compress.kv_page_decode(*compress.kv_page_encode(v, spec, group), spec)
        _kv_scatter(cache, "k", i, self.dest, self.loff, k, npages, spec)
        _kv_scatter(cache, "v", i, self.dest, self.loff, v, npages, spec)
        if not windowed:
            ok = _kv_page_view(cache, "k", i, ids, spec)
            ov = _kv_page_view(cache, "v", i, ids, spec)
        qpos, kpos = self.qpos, self.kpos

        def one(q_s, s):
            kind = self.layout[s]
            if kind == "decode":
                return _attend(cfg, policy, q_s, ok[s:s + 1], ov[s:s + 1], qpos[s:s + 1, :1],
                               kpos[s:s + 1], None)
            if not windowed:
                return _attend(cfg, policy, q_s, ok[s:s + 1], ov[s:s + 1], qpos[s:s + 1],
                               kpos[s:s + 1], None)
            # old entries hold positions < pos0 only, fresh ones >= pos0
            # (-1 where invalid): each key is seen exactly once
            k_all = torch.cat([ok[s:s + 1].to(q.dtype), kf[s:s + 1].to(q.dtype)], dim=1)
            v_all = torch.cat([ov[s:s + 1].to(q.dtype), vf[s:s + 1].to(q.dtype)], dim=1)
            kp_all = torch.cat([self.kpos_old[s:s + 1], qpos[s:s + 1]], dim=1)
            return _attend(cfg, policy, q_s, k_all, v_all, qpos[s:s + 1], kp_all, cfg.window)

        att = slot_attend(one, q, self.layout)
        # a pad query's softmax is uniform over every key, stale ones of a
        # reused slot included: zero it before the (C, D) scale group
        b, c = self.valid.shape
        return torch.where(self.vmask[..., None], att, 0.0).reshape(b, c, -1)

    def emit_rows(self, x):
        """Each slot's last valid position of x (B, C, D) -> (B, 1, D):
        gathered BEFORE the head, so its scale group is the (1, D) row, as
        in decode_step."""
        c = x.shape[1]
        emit = (self.nn - 1).clamp(0, c - 1)
        return x[torch.arange(x.shape[0], device=x.device), emit][:, None, :]

    def done(self, cache):
        cache["len"] = self.pos0 + self.nn


def chunk_step(cfg, policy, params, tokens, n_new, cache):
    """One fused pooled step over ``(B, C)`` token positions, the step
    body of chunked piggybacked prefill (serve/engine.py).

    Every slot advances by its own ``n_new[b]`` (0..C) positions: decode
    slots carry one valid token (``tokens[b, 0]``), prefilling slots up to
    C prompt tokens, idle slots none.  Positions past ``n_new[b]`` are
    padding: qpos -1, never written to the cache, and zeroed before every
    activation-scale group (the norm outputs, the attention output), so a
    slot's (C, D) group has the amax of its valid rows alone.

    ``n_new`` is read on the host, and each slot's norms and attention run
    as a program of their own: a decode row (window-free, ``n_new <= 1``)
    at ``decode_step``'s (1, 1, ·) shapes, any other slot at (1, C, ·).
    cuBLAS and torch's reductions pick their kernels by shape, so this is
    what makes a decode row bit-equal between the two step bodies on the
    card (the engine's decode fast path switches between them mid-request)
    and a slot's rows independent of its pool neighbours.  The linear
    layers take the whole (B*C, D) block through K1 in one call per
    weight: K1 reduces each row on its own.

    Without a window no ring wrap can occur, so the step scatters first
    and attends over the post-scatter view, as ``decode_step`` does.  A
    windowed arch attends over [the pre-scatter cache ∪ the fresh chunk],
    so a wrap inside the chunk cannot overwrite keys that earlier chunk
    positions still need (requires C <= span).

    Quantized pages are written through the wire format; the windowed
    layout re-reads the fresh chunk's K/V through it too (encode, then
    decode), so every attended key is the value later steps gather.

    Returns (logits (B, V) at each slot's last valid position, the cache,
    updated in place).  Paged pool caches only."""
    st = ChunkSlots(cfg, cache, tokens, n_new, _kv_check(policy, cache))
    x = _embed(params["embed"], tokens)  # (B, C, D)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = st.norms(_norm_fn(cfg, lp.get("ln1")), x)
        q, k, v = _qkv(cfg, policy, lp, h, st.qpos)
        att = st.attend(cfg, policy, cache, i, q, k, v)
        y = x + _out_proj(lp["wo"], att, policy, "wo")
        h2 = st.norms(_norm_fn(cfg, lp.get("ln2")), y)
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    xe = _rows(_norm_fn(cfg, params.get("final_norm")), st.emit_rows(x))
    logits = _lm_head(cfg, policy, params, xe)[:, 0, :]
    st.done(cache)
    return logits, cache


def live_norms(norm, x, live):
    """``norm`` of each live row of a (R, 1, D) block at ``decode_step``'s
    (1, 1, D) shape; the other rows stay zero."""
    out = torch.zeros_like(x)
    for r in live:
        out[r:r + 1] = norm(x[r:r + 1])
    return out


class VerifySlots:
    """The cache addresses of one verify step, shared by every layer (and
    by ``models/encdec.py``): per position j the page each slot writes
    and the ``pos`` view with positions 0..j written, the live (slot,
    position) rows and their query positions.  Building it writes the
    valid positions into ``pos``."""

    def __init__(self, cfg, cache, tokens, n_new, spec):
        if "table" not in cache:
            raise NotImplementedError("repro_torch's verify_step runs the paged pool cache")
        n_host = [int(n) for n in n_new]
        b, c = tokens.shape
        dev = tokens.device
        page = cache["pos"].shape[1]
        table = cache["table"]
        span = table.shape[1] * page
        self.npages = npages = cache["pos"].shape[0] - 1
        if c > span:
            raise ValueError(f"verify row {c} exceeds the cache span {span}")
        self.spec = spec
        self.ids = page_ids(cache)
        self.pos0 = cache["len"]
        self.nn = to_device(n_host, dev, self.pos0.dtype)
        offs = torch.arange(c, dtype=self.pos0.dtype, device=dev)
        valid = offs[None, :] < self.nn[:, None]  # (B, C)
        gpos = self.pos0[:, None] + offs[None, :]
        self.qpos = torch.where(valid, gpos, torch.full_like(gpos, -1))
        lo = gpos % span
        dest = torch.gather(table, 1, lo // page)
        # pads: drop
        self.dest = torch.where(valid, dest, torch.full_like(dest, npages + 1))
        self.loff = lo % page
        # position j attends over the pos view with positions 0..j written
        self.kpos = []
        for j in range(c):
            paged_write(cache["pos"], self.dest[:, j], self.loff[:, j], self.qpos[:, j], npages)
            self.kpos.append(page_view(cache["pos"], self.ids))
        self.live = [[s for s in range(b) if j < n_host[s]] for j in range(c)]
        # the row of (s, j) in the (B*C, 1, ·) block
        self.rows = sorted(s * c + j for j in range(c) for s in self.live[j])
        self.rq = self.qpos.reshape(b * c, 1)

    def attend(self, cfg, policy, cache, i, q, k, v):
        """Per position j: write layer ``i``'s K/V of every live slot at j,
        then each live (slot, j) row attends over its slot's view.  q, k,
        v are (B*C, 1, ·, hd); returns (B*C, 1, H * hd), pad rows zero.
        Under ``quantize_attention`` a (slot, j) row is the scale group of
        the reference's per-position step under per-sample scales."""
        _needs_row_groups(policy, "verify_step")
        b, c = self.qpos.shape
        spec, npages, ids = self.spec, self.npages, self.ids
        kb = k.reshape(b, c, cfg.kv_heads, cfg.head_dim)
        vb = v.reshape(b, c, cfg.kv_heads, cfg.head_dim)
        att = torch.zeros_like(q)
        for j in range(c):
            if not self.live[j]:
                break  # later positions are pads in every slot
            _kv_scatter(cache, "k", i, self.dest[:, j], self.loff[:, j], kb[:, j], npages, spec)
            _kv_scatter(cache, "v", i, self.dest[:, j], self.loff[:, j], vb[:, j], npages, spec)
            kview = _kv_page_view(cache, "k", i, ids, spec)
            vview = _kv_page_view(cache, "v", i, ids, spec)
            for s in self.live[j]:
                r = s * c + j
                att[r:r + 1] = _attend(cfg, policy, q[r:r + 1], kview[s:s + 1], vview[s:s + 1],
                                       self.qpos[s:s + 1, j:j + 1], self.kpos[j][s:s + 1],
                                       cfg.window)
        return att.reshape(b * c, 1, -1)

    def done(self, cache):
        cache["len"] = self.pos0 + self.nn


def verify_step(cfg, policy, params, tokens, n_new, cache):
    """Score ``n_new[b]`` candidate tokens per slot in ONE weight pass,
    bit-identically to ``n_new[b]`` sequential ``decode_step`` calls: the
    speculative-decoding verifier (serve/spec.py).

    ``tokens[b, :n_new[b]]`` is slot b's verify row: its last emitted
    token, then the draft.  ``chunk_step`` cannot verify, since a slot's
    (C, D) chunk is one activation-scale group; here every (slot,
    position) row is a scale group of its own, as in decode.

    The reference loops over the C positions inside each layer with
    ``(B, 1, D)`` linears, C weight reads a layer.  The port runs each
    linear layer, and the LM head, ONCE over all B*C rows as a (B*C, 1, D)
    block: ``per_sample_act_scales`` gives every row decode's (1, D)
    amax, beta and clip, and K1 reduces each row on its own in a fixed
    order, so a row's bits do not depend on the block (225 K1 launches a
    pass).  Norms and attention run per (slot, position) at
    ``decode_step``'s own shapes: a (1, 1, ·) row against the slot's whole
    span view.  Position j's K/V (and ``pos``) are written before position
    j attends and after position j-1 did, so each position sees exactly
    the cache sequential decode would, windowed rings included.  Positions
    past ``n_new[b]`` are padding: never written, their rows zero.

    ``n_new`` is read on the host.  Returns (logits (B, C, V), position i
    scoring the token after ``tokens[b, i]``; the cache updated in place,
    ``len += n_new``).  Paged pool caches only; the caller owns acceptance
    and the rollback of rejected positions (``serve.slots.spec_restore``)."""
    st = VerifySlots(cfg, cache, tokens, n_new, _kv_check(policy, cache))
    b, c = tokens.shape
    x = _embed(params["embed"], tokens).reshape(b * c, 1, -1)  # (B*C, 1, D)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = live_norms(_norm_fn(cfg, lp.get("ln1")), x, st.rows)
        q, k, v = _qkv(cfg, policy, lp, h, st.rq)  # (B*C, 1, heads, hd)
        att = st.attend(cfg, policy, cache, i, q, k, v)
        y = x + _out_proj(lp["wo"], att, policy, "wo")
        h2 = live_norms(_norm_fn(cfg, lp.get("ln2")), y, st.rows)
        # every (slot, position) row is a dispatch group of its own (t = 1),
        # as in the reference's per-position decode
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    xe = live_norms(_norm_fn(cfg, params.get("final_norm")), x, st.rows)
    logits = _lm_head(cfg, policy, params, xe)[:, 0, :].reshape(b, c, -1)
    st.done(cache)
    return logits, cache
