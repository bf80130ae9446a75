"""RecurrentGemma / Griffin hybrid backbone (arXiv:2402.19427; port of
``repro/models/recurrent.py``: specs, forward, loss, prefill, lockstep and
pooled decode).

Block pattern 1:2: two RG-LRU recurrent blocks, then one local (sliding
window) attention block, repeating.  The layers are heterogeneous, so
``params["layers"]`` is a tuple of per-layer dicts (named
``layers/<i>/...``, as the reference's checkpoints name them); an
attention layer carries the reference's scalar ``kind_attn`` marker.

RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(LAMBDA) * r_t).  A sequence runs it as a scan in
log2(S) doubling steps (:func:`_rglru_scan`), decode as one elementwise
step.  The recurrence, the conv and the gates stay FP32 elementwise ops;
every projection, gate and head is an ``mf_linear`` (K1 forward, K2/K3
backward).  The attention block is the decoder's (``transformer._qkv``,
``_sdpa``) with ``cfg.window``.

Batch invariance, as in ``models/transformer.py``: decode runs its norms
one row at a time (``transformer._rows``) and each row's windowed
attention over its own ring (``transformer.DecodeSlots``); the RG-LRU
step is elementwise and K1 row-independent, so a slot in a pool of four
runs the very programs of a request served alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import common, transformer
from repro_torch.models.spec import ParamSpec

LRU_C = 8.0


def _linear(shape, axes, std):
    return {
        "w": ParamSpec(shape, axes, std=std),
        "gamma": ParamSpec((), (), init="value", value=0.95),
    }


def layer_kinds(cfg: ModelConfig):
    pattern = cfg.pattern or ("rglru", "rglru", "attn")
    return tuple(pattern[i % len(pattern)] for i in range(cfg.n_layers))


def _mlp_specs(cfg: ModelConfig, std: float):
    d = cfg.d_model
    return {
        "wi_gate": _linear((d, cfg.d_ff), ("embed", "ffn"), std),
        "wi_up": _linear((d, cfg.d_ff), ("embed", "ffn"), std),
        "wo": _linear((cfg.d_ff, d), ("ffn", "embed"), std),
    }


def hybrid_specs(cfg: ModelConfig):
    d = cfg.d_model
    lw = cfg.lru_width or d
    std = 0.02
    norm = lambda: {"scale": ParamSpec((d,), (None,), init="ones")}  # noqa: E731
    layers = []
    for kind in layer_kinds(cfg):
        if kind == "attn":
            hd = cfg.head_dim
            layers.append({
                "kind_attn": ParamSpec((), (), init="ones"),  # marker
                "ln1": norm(),
                "ln2": norm(),
                "wq": _linear((d, cfg.n_heads * hd), ("embed", "heads"), std),
                "wk": _linear((d, cfg.kv_heads * hd), ("embed", "kv"), std),
                "wv": _linear((d, cfg.kv_heads * hd), ("embed", "kv"), std),
                "wo": _linear((cfg.n_heads * hd, d), ("heads", "embed"), std),
                "mlp": _mlp_specs(cfg, std),
            })
        else:
            layers.append({
                "ln1": norm(),
                "ln2": norm(),
                "wx": _linear((d, lw), ("embed", "ffn"), std),
                "wy": _linear((d, lw), ("embed", "ffn"), std),
                "conv_w": ParamSpec((cfg.conv_width, lw), (None, None), std=0.2),
                "conv_b": ParamSpec((lw,), (None,), init="zeros"),
                "wa": _linear((lw, lw), ("ffn", "ffn"), std),
                "wi": _linear((lw, lw), ("ffn", "ffn"), std),
                "lam": ParamSpec((lw,), (None,), init="value", value=0.5),
                "wout": _linear((lw, d), ("ffn", "embed"), std),
                "mlp": _mlp_specs(cfg, std),
            })
    return {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), std=0.02),
        "layers": tuple(layers),
        "final_norm": {"scale": ParamSpec((d,), (None,), init="ones")},
        "lm_head": _linear((d, cfg.vocab_padded), ("embed", "vocab"), std),
    }


def _mlp(cfg, policy, p, x):
    g = mfmac.mf_linear(x, p["wi_gate"]["w"], p["wi_gate"]["gamma"], policy=policy)
    u = mfmac.mf_linear(x, p["wi_up"]["w"], p["wi_up"]["gamma"], policy=policy)
    return mfmac.mf_linear(common.gelu(g) * u, p["wo"]["w"], p["wo"]["gamma"], policy=policy)


def _norm(x, scale, rows: bool):
    """RMS norm of x, one row at a time with ``rows`` (decode)."""
    if rows:
        return transformer._rows(lambda r: common.rms_norm(r, scale), x)
    return common.rms_norm(x, scale)


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """The linear recurrence h_t = a_t * h_{t-1} + bx_t over axis 1 (S), by
    log2(S) doubling steps of the associative combine (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2).  Its order is not the reference's
    ``jax.lax.associative_scan``'s (backend-defined), so the two agree
    within rounding."""
    aa, hh = a, bx
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = torch.cat([torch.ones_like(aa[:, :d]), aa[:, :s - d]], dim=1)
        h_prev = torch.cat([torch.zeros_like(hh[:, :d]), hh[:, :s - d]], dim=1)
        hh = aa * h_prev + hh
        aa = a_prev * aa
        d *= 2
    if h0 is not None:
        hh = hh + aa * h0[:, None, :]
    return hh


def _rglru_block(cfg, policy, p, x, *, conv_state=None, lru_state=None):
    """Griffin recurrent block. x: (B, S, D).

    With ``conv_state``/``lru_state`` (decode: S = 1) the new states follow
    from them by one step, the norms run row by row; otherwise the whole
    sequence is scanned from zero state.  Returns (x, (the conv window of
    the last W - 1 inputs, the last state))."""
    decode = conv_state is not None
    h = _norm(x, p["ln1"]["scale"], decode)
    xb = mfmac.mf_linear(h, p["wx"]["w"], p["wx"]["gamma"], policy=policy)
    yb = common.gelu(mfmac.mf_linear(h, p["wy"]["w"], p["wy"]["gamma"], policy=policy))

    # temporal conv (depthwise, causal, width 4), its taps added in order
    w, b = p["conv_w"], p["conv_b"]
    width = w.shape[0]
    if decode:
        # the f32 window promotes the new row, as jnp.concatenate does
        wdt = torch.promote_types(conv_state.dtype, xb.dtype)
        xp = torch.cat([conv_state.to(wdt), xb.to(wdt)], dim=1)
        new_conv_state = xp[:, 1:, :]
    else:
        xp = F.pad(xb, (0, 0, width - 1, 0))
        new_conv_state = xp[:, xp.shape[1] - (width - 1):, :]
    conv = torch.zeros_like(xb)
    for i in range(width):
        conv = conv + xp[:, i:i + xb.shape[1], :] * w[i]
    conv = conv + b

    # RG-LRU gates
    r = torch.sigmoid(mfmac.mf_linear(conv, p["wa"]["w"], p["wa"]["gamma"],
                                      policy=policy).to(torch.float32))
    i_g = torch.sigmoid(mfmac.mf_linear(conv, p["wi"]["w"], p["wi"]["gamma"],
                                        policy=policy).to(torch.float32))
    log_a = -LRU_C * common.softplus(p["lam"]) * r  # (B, S, lw)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i_g * conv.to(torch.float32))
    if decode:
        hseq = a * lru_state[:, None, :] + gated
    else:
        hseq = _rglru_scan(a, gated)
    new_lru_state = hseq[:, -1, :]
    out = hseq.to(x.dtype) * yb
    out = mfmac.mf_linear(out, p["wout"]["w"], p["wout"]["gamma"], policy=policy)
    x = x + out
    h2 = _norm(x, p["ln2"]["scale"], decode)
    x = x + _mlp(cfg, policy, p["mlp"], h2)
    return x, (new_conv_state, new_lru_state)


def _attn_block(cfg, policy, p, x, qpos):
    """Local-attention block over the sequence itself (training forward,
    prefill); ``qpos`` 1-D.  Returns (x, (k, v)), k after rope."""
    h = common.rms_norm(x, p["ln1"]["scale"])
    att, new_kv = transformer._attn_apply(cfg, policy, p, h, qpos, window=cfg.window)
    x = x + att
    h2 = common.rms_norm(x, p["ln2"]["scale"])
    return x + _mlp(cfg, policy, p["mlp"], h2), new_kv


def _attn_decode(cfg, policy, p, x, c, token, pos):
    """One decode step of an attention block over its layer cache ``c``
    (``k``/``v`` (B, span, KV, hd); ``pos`` (span,) with a scalar ``pos``
    (lockstep) or (B, span) with ``pos`` (B,) (pooled)): the fresh K/V are
    written at ring slot ``pos % span`` of each row, then each row attends
    over its own ring.  Updates ``c`` in place; returns x."""
    b = x.shape[0]
    view = {"k": c["k"][None], "v": c["v"][None], "pos": c["pos"], "len": pos}
    st = transformer.DecodeSlots(view, token, None)
    h = _norm(x, p["ln1"]["scale"], True)
    q, k, v = transformer._qkv(cfg, policy, p, h, st.qpos)
    att = st.attend(cfg, policy, view, 0, q, k, v).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    x = x + mfmac.mf_linear(att, p["wo"]["w"], p["wo"]["gamma"], policy=policy)
    h2 = _norm(x, p["ln2"]["scale"], True)
    x = x + _mlp(cfg, policy, p["mlp"], h2)
    st.done(view)
    c["pos"] = view["pos"]
    return x


def _layer_out(cfg, policy, kind, p, x, qpos):
    if kind == "attn":
        return _attn_block(cfg, policy, p, x, qpos)[0]
    return _rglru_block(cfg, policy, p, x)[0]


def _head(policy, params, x):
    x = common.rms_norm(x, params["final_norm"]["scale"])
    hp = params["lm_head"]
    return mfmac.mf_linear(x, hp["w"], hp["gamma"], policy=policy, is_last=True)


def forward(cfg: ModelConfig, policy: QuantPolicy, params, tokens, *, remat: bool = False):
    """Full-sequence forward: logits (B, S, V_padded).  ``remat``
    recomputes each layer in the backward (when grad is on)."""
    x = F.embedding(tokens, params["embed"]).to(getattr(torch, cfg.act_dtype))
    qpos = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    recompute = remat and torch.is_grad_enabled()
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        if recompute:
            x = checkpoint(_layer_out, cfg, policy, kind, p, x, qpos, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer_out(cfg, policy, kind, p, x, qpos)
    return _head(policy, params, x)


def lm_loss(cfg: ModelConfig, policy: QuantPolicy, params, tokens, labels, loss_mask,
            *, remat: bool = True) -> torch.Tensor:
    logits = forward(cfg, policy, params, tokens, remat=remat)
    return transformer.next_token_loss(cfg, logits, labels, loss_mask)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device):
    """Per layer: an attention layer's ring (``k``/``v`` of ``dtype``, span
    ``min(max_len, window)``, ``pos`` -1 where not yet written), an RG-LRU
    layer's conv window and state (f32); ``len`` the position."""
    lw = cfg.lru_width or cfg.d_model
    span = min(max_len, cfg.window or max_len)
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "attn":
            shape = (batch, span, cfg.kv_heads, cfg.head_dim)
            caches.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full((span,), -1, dtype=torch.int64, device=device),
            })
        else:
            caches.append({
                "conv": torch.zeros((batch, cfg.conv_width - 1, lw), dtype=torch.float32,
                                    device=device),
                "lru": torch.zeros((batch, lw), dtype=torch.float32, device=device),
            })
    return {"layers": tuple(caches), "len": torch.zeros((), dtype=torch.int64,
                                                        device=device)}


def prefill(cfg, policy, params, tokens, cache):
    """Run the prompt through the model, filling ``cache`` in place: each
    attention layer's ring with the prompt's last ``span`` K/V (global
    position p in slot p % span once the prompt fills the span), each
    RG-LRU layer's conv window and last state.  Returns the last
    position's logits (the head over that position alone, as in the
    reference) and the cache."""
    x = F.embedding(tokens, params["embed"])
    s = tokens.shape[1]
    qpos = torch.arange(s, dtype=torch.int64, device=x.device)
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        if kind == "attn":
            x, (k, v) = _attn_block(cfg, policy, p, x, qpos)
            span = c["k"].shape[1]
            take = min(s, span)
            kt, vt = k[:, s - take:], v[:, s - take:]
            pos = torch.arange(s - take, s, dtype=c["pos"].dtype, device=x.device)
            if take == span:
                shift = s % span
                c["k"].copy_(torch.roll(kt, shift, dims=1))
                c["v"].copy_(torch.roll(vt, shift, dims=1))
                c["pos"] = torch.roll(pos, shift)
            else:
                c["k"][:, :take] = kt
                c["v"][:, :take] = vt
                c["pos"] = c["pos"].clone()
                c["pos"][:take] = pos
        else:
            x, (cs, ls) = _rglru_block(cfg, policy, p, x)
            c["conv"].copy_(cs)
            c["lru"].copy_(ls)
    logits = _head(policy, params, x[:, -1:, :])[:, 0, :]
    cache["len"] = torch.full((), s, dtype=cache["len"].dtype, device=x.device)
    return logits, cache


def decode_step(cfg, policy, params, token, cache):
    """One decode step.  token: (B,) -> (logits (B, V), cache).  Two
    layouts: lockstep (``len`` a scalar, each attention layer's ``pos``
    (span,)) and slot-pooled (``len`` (B,), ``pos`` (B, span);
    ``serve.slots.lift_cache``).  The RG-LRU states are per row in both.
    Every state is written into ``cache`` in place; ``len`` and the
    attention layers' ``pos`` are replaced."""
    x = params["embed"][token[:, None]]  # (B, 1, D)
    pos = cache["len"]
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        if kind == "attn":
            x = _attn_decode(cfg, policy, p, x, c, token, pos)
        else:
            x, (cs, ls) = _rglru_block(cfg, policy, p, x, conv_state=c["conv"],
                                       lru_state=c["lru"])
            c["conv"].copy_(cs)
            c["lru"].copy_(ls)
    x = _norm(x, params["final_norm"]["scale"], True)
    hp = params["lm_head"]
    logits = mfmac.mf_linear(x, hp["w"], hp["gamma"], policy=policy, is_last=True)[:, 0, :]
    cache["len"] = pos + 1
    return logits, cache
