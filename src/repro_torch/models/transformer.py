"""Dense decoder-only transformer LM (port of ``repro/models/transformer.py``,
the dense decoder: specs, forward, loss, prefill and per-slot decode).

Layers are stacked along a leading 'layer' axis, as in the reference, and
run as a Python loop over it.  Every weight matmul is ``mf_linear``.

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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
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


def decoder_specs(cfg: ModelConfig):
    if cfg.moe is not None or cfg.family != "decoder":
        raise NotImplementedError(
            "repro_torch ports the dense decoder only; MoE and VLM come "
            "with the other families"
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
        "mlp": _mlp_specs(cfg, L, std),
    }
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
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
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
    x = x + _mlp_apply(cfg, policy, p["mlp"], h2)
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
    cache["len"] = torch.tensor(s, dtype=cache["len"].dtype, device=ks.device)
    return logits[:, -1, :], cache


def decode_step(cfg, policy, params, token, cache):
    """One decode step over a slot-pooled contiguous cache
    (``len`` (B,), ``pos`` (B, span), ``k``/``v`` (L, B, span, KV, hd)):
    each row decodes at its own position.  token: (B,) -> (logits (B, V),
    cache).  K/V are written into ``cache`` in place; ``pos``/``len`` are
    replaced.  Attention reads the bf16 cache cast to f32."""
    pos = cache["len"]
    if pos.dim() != 1 or "table" in cache:
        raise NotImplementedError(
            "repro_torch decodes the slot-pooled contiguous cache only "
            "(lockstep and paged layouts are later slices)"
        )
    b = token.shape[0]
    span = cache["k"].shape[2]
    slot = pos % span
    rows = torch.arange(b, device=token.device)
    qpos = pos[:, None]  # (B, 1)
    kpos = cache["pos"].clone()
    kpos[rows, slot] = pos
    x = params["embed"][token[:, None]]  # (B, 1, D)

    def attend(q, kview, vview, qp, kp):
        return _sdpa(cfg, q, kview.to(q.dtype), vview.to(q.dtype), qp, kp,
                     cfg.window)

    def norm(p):
        return lambda r: common.apply_norm(cfg.norm, r, p)

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        ck, cv = cache["k"][i], cache["v"][i]  # views: written in place
        h = _rows(norm(lp.get("ln1")), x)
        q, k, v = _qkv(cfg, policy, lp, h, qpos)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        att = _rows(attend, q, ck, cv, qpos, kpos)
        att = att.reshape(b, 1, cfg.n_heads * cfg.head_dim)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        h2 = _rows(norm(lp.get("ln2")), y)
        x = y + _mlp_apply(cfg, policy, lp["mlp"], h2)
    x = _rows(norm(params.get("final_norm")), x)
    logits = _lm_head(cfg, policy, params, x)[:, 0, :]
    cache["pos"] = kpos
    cache["len"] = pos + 1
    return logits, cache
