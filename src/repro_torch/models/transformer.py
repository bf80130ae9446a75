"""Decoder-only transformer LM, dense or MoE (port of
``repro/models/transformer.py``, the decoder family: specs, forward, loss,
prefill, lockstep decode and per-slot decode over the paged or contiguous
pool cache, the fused chunk step and the speculative verify step).

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
    if cfg.family != "decoder":
        raise NotImplementedError(
            "repro_torch ports the decoder family only; VLM comes with the "
            "other families"
        )
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
# Blocks
# ---------------------------------------------------------------------------

def _mlp_apply(cfg: ModelConfig, policy: QuantPolicy, p, x):
    if cfg.act == "swiglu":
        g = mfmac.mf_linear(x, p["wi_gate"]["w"], p["wi_gate"]["gamma"], policy=policy)
        u = mfmac.mf_linear(x, p["wi_up"]["w"], p["wi_up"]["gamma"], policy=policy)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = common.gelu(
            mfmac.mf_linear(x, p["wi"]["w"], p["wi"]["gamma"], policy=policy)
        )
    return mfmac.mf_linear(h, p["wo"]["w"], p["wo"]["gamma"], policy=policy)


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
    (training, prefill), or with ``per_slot`` every batch row is a group of
    its own (serving): its own capacity, and its own activation scale per
    expert, so a slot's routing and bits never depend on its neighbours.

    The reference's one-hot dispatch and combine einsums are index ops
    here, with the same values: each kept token slot is written to cell
    (expert, group, pos) of a zeroed (E, G, C, D) buffer (slots that are
    dropped, or whose gate is 0, go to one dead row past it), and its
    output is read back from that cell times its gate; top-k slots are
    summed in k order.  Every shape is static: nothing syncs with the
    host."""
    m = cfg.moe
    b, s, d = x.shape
    if per_slot:
        g, t = b, s
        xg = x
    else:
        t = min(group_size, b * s)
        g = b * s // t
        if g * t != b * s:
            raise ValueError(f"{b} x {s} tokens do not split into groups of {t}")
        xg = x.reshape(g, t, d)
    logits = mfmac.mf_linear(xg, p["router"]["w"], p["router"]["gamma"],
                             policy=policy).to(torch.float32)  # (G, T, E)
    gate, expert, pos, keep, cap = moe_route(cfg, _softmax_rows(logits))
    e, k = m.num_experts, m.top_k
    xk = xg.repeat_interleave(k, dim=1) if k > 1 else xg  # (G, T*k, D)
    grp = torch.arange(g, device=x.device)[:, None]
    dead = e * g * cap
    cell = torch.where(keep & (gate > 0), (expert * g + grp) * cap + pos, dead)
    buf = x.new_zeros((dead + 1, d)).index_put((cell.reshape(-1),), xk.reshape(-1, d))
    ein = buf[:dead].reshape(e, g, cap, d)
    if not per_slot:
        ein = ein.reshape(e, g * cap, d)

    def ffn(name, h):
        q = p[name]
        return mfmac.mf_expert_linear(h, q["w"], q["gamma"], policy=policy, per_slot=per_slot)

    if cfg.act == "swiglu":
        h = F.silu(ffn("gate", ein).to(torch.float32)).to(x.dtype) * ffn("up", ein)
    else:
        h = common.gelu(ffn("gate", ein))
    eout = ffn("down", h).reshape(dead, d)
    eout = torch.cat([eout, eout.new_zeros((1, d))])
    out = (eout[cell].to(torch.float32)
           * torch.where(keep, gate, 0.0)[..., None]).to(x.dtype)  # (G, T*k, D)
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
    q = mfmac.mf_linear(x, p["wq"]["w"], p["wq"]["gamma"], policy=policy)
    k = mfmac.mf_linear(x, p["wk"]["w"], p["wk"]["gamma"], policy=policy)
    v = mfmac.mf_linear(x, p["wv"]["w"], p["wv"]["gamma"], policy=policy)
    q = common.rope(q.reshape(b, s, cfg.n_heads, hd), qpos, cfg.rope_theta)
    k = common.rope(k.reshape(b, s, cfg.kv_heads, hd), qpos, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.kv_heads, hd)


def _attn_apply(cfg: ModelConfig, policy: QuantPolicy, p, x, qpos, *,
                window=None):
    """Self-attention over the sequence itself (training forward/prefill);
    ``qpos`` is 1-D.  Returns (output, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, policy, p, x, qpos[None, :].expand(b, s))
    att = _sdpa(cfg, q, k, v, qpos, qpos, window)
    att = att.reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = mfmac.mf_linear(att, p["wo"]["w"], p["wo"]["gamma"], policy=policy)
    return out, (k, v)


def _sdpa(cfg, q, k, v, qpos, kpos, window):
    """Grouped-GQA attention with FP32 scores (K/V at kv-head width).

    ``qpos``/``kpos`` are 1-D (shared across the batch) or 2-D
    ``(B, Sq)``/``(B, Skv)``.  Masked scores take -1e30, as in the
    reference; ``kpos < 0`` marks cache entries not yet written."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32, device=q.device))
    qg = q.reshape(b, sq, kv, rep, hd).permute(0, 2, 3, 1, 4)  # (B,KV,rep,Sq,hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,Skv)
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,Skv,hd)
    scores = torch.matmul(qg, kt).to(torch.float32) * scale  # (B,KV,rep,Sq,Skv)
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
    out = torch.matmul(probs.to(q.dtype), vt)  # (B,KV,rep,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


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

def embed_inputs(cfg, params, tokens):
    # the values of embed[tokens]; the backward is embedding_dense_backward
    # rather than an accumulating index_put_, and the trainer's
    # deterministic mode keeps it run-to-run identical on the card
    return F.embedding(tokens, params["embed"]).to(getattr(torch, cfg.act_dtype))


def _block_out(cfg, policy, p, x, qpos):
    return _block(cfg, policy, p, x, qpos)[0]


def forward(cfg: ModelConfig, policy: QuantPolicy, params, tokens: torch.Tensor,
            *, return_kv: bool = False, remat: bool = False):
    """Full-sequence forward.  Returns logits (B, S, V_padded) and, with
    ``return_kv``, the per-layer (k, v) lists stacked to (L, B, S, KV, hd).
    ``remat`` recomputes each layer in the backward (when grad is on)."""
    x = embed_inputs(cfg, params, tokens)
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


def _lm_head(cfg, policy, params, x):
    if cfg.tie_embeddings:
        # the embedding table is never prequantized: quantize at use
        pol = dataclasses.replace(policy, weights_prequantized=False)
        return mfmac.mf_linear(x, params["embed"].T, policy.ratio_clip_init or 1.0,
                               policy=pol, is_last=True)
    hp = params["lm_head"]
    return mfmac.mf_linear(x, hp["w"], hp["gamma"], policy=policy, is_last=True)


def lm_loss(cfg: ModelConfig, policy: QuantPolicy, params, tokens, labels,
            loss_mask, *, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy over ``loss_mask``; padded-vocab ids
    are masked out (logits -1e30) before the logsumexp."""
    logits = forward(cfg, policy, params, tokens, remat=remat).to(torch.float32)
    vpad = cfg.vocab_padded
    if vpad != cfg.vocab:
        invalid = torch.arange(vpad, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(invalid, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    mask = loss_mask.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    return ((logz - gold) * mask).sum() / denom


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


def prefill(cfg, policy, params, tokens, cache):
    """Run the prompt through the model, filling ``cache`` (in place);
    returns the last position's logits and the cache.

    The LM head runs over ALL prompt positions before the last one is
    taken: prefill's (1, S, D) input is one activation-scale group, and
    the head must see the same group the reference's does."""
    logits, (ks, vs) = forward(cfg, policy, params, tokens, return_kv=True)
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
    betas, when ``spec`` is set."""
    if spec is None:
        paged_write(cache[key][layer], dest, loff, vals, npages)
        return
    codes, beta = compress.kv_page_encode(vals, spec)
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


def _attend(cfg, q, k, v, qpos, kpos, window):
    return _sdpa(cfg, q, k.to(q.dtype), v.to(q.dtype), qpos, kpos, window)


def _norm_fn(cfg, p):
    return lambda r: common.apply_norm(cfg.norm, r, p)


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
    pos = cache["len"]
    b = token.shape[0]
    paged = "table" in cache
    lockstep = pos.dim() == 0
    spec = _kv_check(policy, cache)
    if paged:
        page = cache["pos"].shape[1]
        ids = page_ids(cache)
        span = ids.shape[1] * page
        npages = cache["pos"].shape[0] - 1
        slot = pos % span
        dest = torch.gather(cache["table"], 1, (slot // page)[:, None])[:, 0]
        loff = slot % page
        paged_write(cache["pos"], dest, loff, pos, npages)
        kpos = page_view(cache["pos"], ids)
    elif lockstep:
        span = cache["k"].shape[2]
        slot = (pos % span).reshape(1)
        kpos_new = cache["pos"].index_copy(0, slot, pos.reshape(1))
        kpos = kpos_new[None].expand(b, span)
    else:
        span = cache["k"].shape[2]
        slot = pos % span
        rows = torch.arange(b, device=token.device)
        kpos = cache["pos"].clone()
        kpos[rows, slot] = pos
    qpos = pos.reshape(1, 1).expand(b, 1) if lockstep else pos[:, None]  # (B, 1)
    x = params["embed"][token[:, None]]  # (B, 1, D)

    def attend(q, kview, vview, qp, kp):
        return _attend(cfg, q, kview, vview, qp, kp, cfg.window)

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _rows(_norm_fn(cfg, lp.get("ln1")), x)
        q, k, v = _qkv(cfg, policy, lp, h, qpos)
        if paged:
            _kv_scatter(cache, "k", i, dest, loff, k[:, 0], npages, spec)
            _kv_scatter(cache, "v", i, dest, loff, v[:, 0], npages, spec)
            kview = _kv_page_view(cache, "k", i, ids, spec)
            vview = _kv_page_view(cache, "v", i, ids, spec)
        elif lockstep:
            ck, cv = cache["k"][i], cache["v"][i]  # views: written in place
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
            kview, vview = ck, cv
        else:
            ck, cv = cache["k"][i], cache["v"][i]  # views: written in place
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            kview, vview = ck, cv
        att = _rows(attend, q, kview, vview, qpos, kpos)
        att = att.reshape(b, 1, cfg.n_heads * cfg.head_dim)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        h2 = _rows(_norm_fn(cfg, lp.get("ln2")), y)
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    x = _rows(_norm_fn(cfg, params.get("final_norm")), x)
    logits = _lm_head(cfg, policy, params, x)[:, 0, :]
    if lockstep:
        cache["pos"] = kpos_new
    elif not paged:
        cache["pos"] = kpos
    cache["len"] = pos + 1
    return logits, cache


def _row(t, s):
    """Row ``s``, position 0 of a (B, C, ...) tensor as a fresh contiguous
    (1, 1, ...) tensor: the very strides ``decode_step`` hands its
    per-row programs."""
    return t[s:s + 1, :1].clone(memory_format=torch.contiguous_format)


def _slot_norms(cfg, p, x, layout):
    """Norm of each slot's rows: a decode row alone at (1, 1, D), as
    ``decode_step`` runs it; a chunk at (1, C, D), as a one-slot pool
    runs it; idle slots stay zero."""
    norm = _norm_fn(cfg, p)
    out = torch.zeros_like(x)
    for s, kind in enumerate(layout):
        if kind == "decode":
            out[s:s + 1, :1] = norm(_row(x, s))
        elif kind == "chunk":
            out[s:s + 1] = norm(x[s:s + 1])
    return out


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
    if "table" not in cache:
        raise NotImplementedError("repro_torch's chunk_step runs the paged pool cache")
    n_host = [int(n) for n in n_new]
    b, c = tokens.shape
    dev = tokens.device
    page = cache["pos"].shape[1]
    table = cache["table"]
    span = table.shape[1] * page
    npages = cache["pos"].shape[0] - 1
    if c > span:
        raise ValueError(f"chunk {c} exceeds the cache span {span}")
    windowed = cfg.window is not None
    spec = _kv_check(policy, cache)
    layout = ["idle" if n == 0 else
              "decode" if n == 1 and not windowed else "chunk" for n in n_host]
    ids = page_ids(cache)
    pos0 = cache["len"]
    nn = to_device(n_host, dev, pos0.dtype)
    offs = torch.arange(c, dtype=pos0.dtype, device=dev)
    valid = offs[None, :] < nn[:, None]  # (B, C)
    gpos = pos0[:, None] + offs[None, :]
    qpos = torch.where(valid, gpos, torch.full_like(gpos, -1))
    lo = gpos % span
    dest = torch.gather(table, 1, lo // page)
    dest = torch.where(valid, dest, torch.full_like(dest, npages + 1))  # pads: drop
    loff = lo % page
    kpos_old = page_view(cache["pos"], ids) if windowed else None  # pre-scatter
    paged_write(cache["pos"], dest, loff, qpos, npages)
    kpos = page_view(cache["pos"], ids)
    x = params["embed"][tokens]  # (B, C, D)
    vmask = valid[:, :, None]
    hd = cfg.head_dim

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = torch.where(vmask, _slot_norms(cfg, lp.get("ln1"), x, layout), 0.0)
        q, k, v = _qkv(cfg, policy, lp, h, qpos)
        if windowed:
            ok = _kv_page_view(cache, "k", i, ids, spec)
            ov = _kv_page_view(cache, "v", i, ids, spec)
            kf, vf = k, v
            if spec is not None:
                kf = compress.kv_page_decode(*compress.kv_page_encode(k, spec), spec)
                vf = compress.kv_page_decode(*compress.kv_page_encode(v, spec), spec)
        _kv_scatter(cache, "k", i, dest, loff, k, npages, spec)
        _kv_scatter(cache, "v", i, dest, loff, v, npages, spec)
        if not windowed:
            ok = _kv_page_view(cache, "k", i, ids, spec)
            ov = _kv_page_view(cache, "v", i, ids, spec)
        att = torch.zeros_like(q)
        for s, kind in enumerate(layout):
            if kind == "decode":
                att[s:s + 1, :1] = _attend(cfg, _row(q, s), ok[s:s + 1], ov[s:s + 1],
                                           qpos[s:s + 1, :1], kpos[s:s + 1], None)
            elif kind == "chunk" and not windowed:
                att[s:s + 1] = _attend(cfg, q[s:s + 1], ok[s:s + 1], ov[s:s + 1],
                                       qpos[s:s + 1], kpos[s:s + 1], None)
            elif kind == "chunk":
                # old entries hold positions < pos0 only, fresh ones >= pos0
                # (-1 where invalid): each key is seen exactly once
                k_all = torch.cat([ok[s:s + 1].to(q.dtype), kf[s:s + 1].to(q.dtype)], dim=1)
                v_all = torch.cat([ov[s:s + 1].to(q.dtype), vf[s:s + 1].to(q.dtype)], dim=1)
                kp_all = torch.cat([kpos_old[s:s + 1], qpos[s:s + 1]], dim=1)
                att[s:s + 1] = _attend(cfg, q[s:s + 1], k_all, v_all, qpos[s:s + 1],
                                       kp_all, cfg.window)
        # a pad query's softmax is uniform over every key, stale ones of a
        # reused slot included: zero it before the (C, D) scale group
        att = torch.where(vmask[..., None], att, 0.0).reshape(b, c, cfg.n_heads * hd)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        h2 = torch.where(vmask, _slot_norms(cfg, lp.get("ln2"), y, layout), 0.0)
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    # emit at each slot's last valid position; gather BEFORE the head so its
    # scale group is the (1, D) row, as in decode_step
    emit = (nn - 1).clamp(0, c - 1)
    xe = x[torch.arange(b, device=dev), emit][:, None, :]  # (B, 1, D)
    xe = _rows(_norm_fn(cfg, params.get("final_norm")), xe)
    logits = _lm_head(cfg, policy, params, xe)[:, 0, :]
    cache["len"] = pos0 + nn
    return logits, cache


def _live_norms(cfg, p, x, live):
    """Norm of each live row of a (R, 1, D) block at ``decode_step``'s
    (1, 1, D) shape; the other rows stay zero."""
    norm = _norm_fn(cfg, p)
    out = torch.zeros_like(x)
    for r in live:
        out[r:r + 1] = norm(x[r:r + 1])
    return out


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
    if "table" not in cache:
        raise NotImplementedError("repro_torch's verify_step runs the paged pool cache")
    n_host = [int(n) for n in n_new]
    b, c = tokens.shape
    dev = tokens.device
    page = cache["pos"].shape[1]
    table = cache["table"]
    span = table.shape[1] * page
    npages = cache["pos"].shape[0] - 1
    if c > span:
        raise ValueError(f"verify row {c} exceeds the cache span {span}")
    spec = _kv_check(policy, cache)
    ids = page_ids(cache)
    pos0 = cache["len"]
    nn = to_device(n_host, dev, pos0.dtype)
    offs = torch.arange(c, dtype=pos0.dtype, device=dev)
    valid = offs[None, :] < nn[:, None]  # (B, C)
    gpos = pos0[:, None] + offs[None, :]
    qpos = torch.where(valid, gpos, torch.full_like(gpos, -1))
    lo = gpos % span
    dest = torch.gather(table, 1, lo // page)
    dest = torch.where(valid, dest, torch.full_like(dest, npages + 1))  # pads: drop
    loff = lo % page
    # position j attends over the pos view with positions 0..j written
    kpos = []
    for j in range(c):
        paged_write(cache["pos"], dest[:, j], loff[:, j], qpos[:, j], npages)
        kpos.append(page_view(cache["pos"], ids))
    live = [[s for s in range(b) if j < n_host[s]] for j in range(c)]
    rows = sorted(s * c + j for j in range(c) for s in live[j])  # row of (s, j)
    x = params["embed"][tokens].reshape(b * c, 1, -1)  # (B*C, 1, D)
    rq = qpos.reshape(b * c, 1)
    h_all = cfg.n_heads * cfg.head_dim

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = _live_norms(cfg, lp.get("ln1"), x, rows)
        q, k, v = _qkv(cfg, policy, lp, h, rq)  # (B*C, 1, heads, hd)
        kb = k.reshape(b, c, cfg.kv_heads, cfg.head_dim)
        vb = v.reshape(b, c, cfg.kv_heads, cfg.head_dim)
        att = torch.zeros_like(q)
        for j in range(c):
            if not live[j]:
                break  # later positions are pads in every slot
            _kv_scatter(cache, "k", i, dest[:, j], loff[:, j], kb[:, j], npages, spec)
            _kv_scatter(cache, "v", i, dest[:, j], loff[:, j], vb[:, j], npages, spec)
            kview = _kv_page_view(cache, "k", i, ids, spec)
            vview = _kv_page_view(cache, "v", i, ids, spec)
            for s in live[j]:
                r = s * c + j
                att[r:r + 1] = _attend(cfg, q[r:r + 1], kview[s:s + 1], vview[s:s + 1],
                                       qpos[s:s + 1, j:j + 1], kpos[j][s:s + 1],
                                       cfg.window)
        att = att.reshape(b * c, 1, h_all)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        h2 = _live_norms(cfg, lp.get("ln2"), y, rows)
        # every (slot, position) row is a dispatch group of its own (t = 1),
        # as in the reference's per-position decode
        x = y + _ffn(cfg, policy, lp, h2, per_slot=True)
    xe = _live_norms(cfg, params.get("final_norm"), x, rows)
    logits = _lm_head(cfg, policy, params, xe)[:, 0, :].reshape(b, c, -1)
    cache["len"] = pos0 + nn
    return logits, cache
