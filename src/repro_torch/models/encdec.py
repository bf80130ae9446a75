"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``,
arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: precomputed frame
embeddings (B, enc_seq, frame_dim) go through one ``mf_linear``
(``frame_proj``) into the encoder width.  Everything else is real and
MF-MAC quantized: ``enc_layers`` bidirectional encoder layers, then
``n_layers`` decoder layers of causal self-attention (rope), cross
attention over the encoder output, and a gelu MLP; pre-norm LayerNorms
throughout and an LM head tied to the token embedding (quantized at
every use, gamma = ``ratio_clip_init``; :func:`transformer.tied_head`).

Training (:func:`lm_loss`) recomputes each encoder and decoder layer in
the backward, as the reference's ``jax.checkpoint`` does.

Serving keeps the decoder's self-attention K/V in the pool cache of
``models/transformer.py`` (paged, contiguous or lockstep; PoT-quantized
pages under ``policy.kv_quant``) and each slot's cross-attention K/V
(``ck``/``cv``, (L, B, enc_seq, KV, hd)) raw beside it, written once
per admission (:func:`prefill`, or :func:`encode_cross_kv` for chunked
admission) and never shared.  The step bodies share the decoder's
addressing (``transformer.DecodeSlots``, ``ChunkSlots``,
``VerifySlots``) and its batch invariance: norms, self- and cross
attention run per slot (per (slot, position) row in the verify step) at
decode's shapes, over each slot's own ``ck``/``cv``, so a slot's logits
never depend on its pool neighbours.  The encoder runs at admission with
batch 1.  Encdec is never windowed.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.models.spec import ParamSpec


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _ln(L, d):
    return {
        "scale": ParamSpec((L, d), ("layer", None), init="ones"),
        "bias": ParamSpec((L, d), ("layer", None), init="zeros"),
    }


def encdec_specs(cfg: ModelConfig):
    d, hd, std = cfg.d_model, cfg.head_dim, 0.02
    Le, Ld = cfg.enc_layers, cfg.n_layers
    h, kv, f = cfg.n_heads, cfg.kv_heads, cfg.d_ff

    def attn(L, prefix=""):
        return {
            f"{prefix}q": T._linear((L, d, h * hd), ("layer", "embed", "heads"), std),
            f"{prefix}k": T._linear((L, d, kv * hd), ("layer", "embed", "kv"), std),
            f"{prefix}v": T._linear((L, d, kv * hd), ("layer", "embed", "kv"), std),
            f"{prefix}o": T._linear((L, h * hd, d), ("layer", "heads", "embed"), std),
        }

    def mlp(L):
        return {
            "wi": T._linear((L, d, f), ("layer", "embed", "ffn"), std),
            "wo2": T._linear((L, f, d), ("layer", "ffn", "embed"), std),
        }

    final_norm = {"scale": ParamSpec((d,), (None,), init="ones"),
                  "bias": ParamSpec((d,), (None,), init="zeros")}
    return {
        "frame_proj": T._linear((cfg.frame_dim, d), (None, "embed"), std),
        "enc_pos": ParamSpec((cfg.enc_seq, d), (None, "embed"), std=0.01),
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), std=0.02),
        "enc_layers": {"ln1": _ln(Le, d), "ln2": _ln(Le, d), **attn(Le, "w"), **mlp(Le)},
        "dec_layers": {"ln1": _ln(Ld, d), "ln_cross": _ln(Ld, d), "ln2": _ln(Ld, d),
                       **attn(Ld, "w"), **attn(Ld, "c"), **mlp(Ld)},
        "enc_norm": final_norm,
        "dec_norm": dict(final_norm),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(p):
    return lambda r: common.layer_norm(r, p["scale"], p["bias"])


def _proj_heads(p, name, x, policy, nh, hd):
    b, s = x.shape[:2]
    return mfmac.mf_linear(x, p[name]["w"], p[name]["gamma"], policy=policy).reshape(b, s, nh, hd)


def _mha(policy, q, k, v):
    """Bidirectional grouped attention (no mask), FP32 scores: q (B, Sq,
    H, hd) over k, v (B, Skv, KV, hd), cast to q's dtype; QK^T and PV
    through ``mfmac.mf_act_dot``."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / torch.sqrt(torch.full((), hd, dtype=torch.float32, device=q.device))
    qg = q.reshape(b, sq, kv, rep, hd).permute(0, 2, 3, 1, 4)  # (B,KV,rep,Sq,hd)
    kt = k.to(q.dtype).permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,Skv)
    vt = v.to(q.dtype).permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,Skv,hd)
    scores = mfmac.mf_act_dot(qg, kt, policy=policy).to(torch.float32) * scale
    probs = torch.softmax(scores, dim=-1)
    out = mfmac.mf_act_dot(probs.to(q.dtype), vt, policy=policy)  # (B,KV,rep,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def _mlp(policy, lp, h):
    m = common.gelu(mfmac.mf_linear(h, lp["wi"]["w"], lp["wi"]["gamma"], policy=policy))
    return mfmac.mf_linear(m, lp["wo2"]["w"], lp["wo2"]["gamma"], policy=policy)


def _enc_layer(cfg, policy, lp, x):
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = _norm(lp["ln1"])(x)
    q = _proj_heads(lp, "wq", h, policy, cfg.n_heads, hd)
    k = _proj_heads(lp, "wk", h, policy, cfg.kv_heads, hd)
    v = _proj_heads(lp, "wv", h, policy, cfg.kv_heads, hd)
    att = _mha(policy, q, k, v).reshape(b, s, cfg.n_heads * hd)
    y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
    return y + _mlp(policy, lp, _norm(lp["ln2"])(y))


def encode(cfg: ModelConfig, policy: QuantPolicy, params, frames, *, remat: bool = False):
    """frames (B, enc_seq, frame_dim), the stub frontend's embeddings ->
    the encoder output (B, enc_seq, D).  ``remat`` recomputes each layer
    in the backward (when grad is on)."""
    fp = params["frame_proj"]
    x = mfmac.mf_linear(frames.to(torch.float32), fp["w"], fp["gamma"], policy=policy)
    x = (x + params["enc_pos"][None]).to(getattr(torch, cfg.act_dtype))
    layers = T._unbind_layers(params["enc_layers"])
    recompute = remat and torch.is_grad_enabled()
    for i in range(cfg.enc_layers):
        lp = T._layer(layers, i)
        if recompute:
            x = checkpoint(_enc_layer, cfg, policy, lp, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_layer(cfg, policy, lp, x)
    return _norm(params["enc_norm"])(x)


def _dec_block(cfg, policy, lp, x, enc_out, qpos):
    """One decoder layer over a whole sequence (training forward,
    prefill).  Returns (x, (k, v), (ck, cv)): its self-attention K/V and
    its cross K/V of ``enc_out``."""
    b, s, _ = x.shape
    hd, hh = cfg.head_dim, cfg.n_heads * cfg.head_dim
    h = _norm(lp["ln1"])(x)
    q, k, v = T._qkv(cfg, policy, lp, h, qpos[None, :].expand(b, s))
    att = T._sdpa(cfg, policy, q, k, v, qpos, qpos, None).reshape(b, s, hh)
    x = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
    hc = _norm(lp["ln_cross"])(x)
    cq = _proj_heads(lp, "cq", hc, policy, cfg.n_heads, hd)
    ck = _proj_heads(lp, "ck", enc_out, policy, cfg.kv_heads, hd)
    cv = _proj_heads(lp, "cv", enc_out, policy, cfg.kv_heads, hd)
    catt = _mha(policy, cq, ck, cv).reshape(b, s, hh)
    x = x + mfmac.mf_linear(catt, lp["co"]["w"], lp["co"]["gamma"], policy=policy)
    x = x + _mlp(policy, lp, _norm(lp["ln2"])(x))
    return x, (k, v), (ck, cv)


def _dec_block_out(cfg, policy, lp, x, enc_out, qpos):
    return _dec_block(cfg, policy, lp, x, enc_out, qpos)[0]


def _decoder(cfg, policy, params, tokens, enc_out, *, remat=False, keep_kv=False):
    """The decoder stack over whole sequences, up to its final norm:
    (B, S, D) and, with ``keep_kv``, the stacked (L, B, ·, KV, hd) self
    (k, v) and cross (ck, cv) K/V."""
    x = T.embed_inputs(cfg, policy, params, tokens)
    qpos = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    layers = T._unbind_layers(params["dec_layers"])
    recompute = remat and torch.is_grad_enabled() and not keep_kv
    kvs = []
    for i in range(cfg.n_layers):
        lp = T._layer(layers, i)
        if recompute:
            x = checkpoint(_dec_block_out, cfg, policy, lp, x, enc_out, qpos,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, kv, ckv = _dec_block(cfg, policy, lp, x, enc_out, qpos)
        if keep_kv:
            kvs.append(kv + ckv)
    x = _norm(params["dec_norm"])(x)
    return x, ([torch.stack(t) for t in zip(*kvs)] if keep_kv else None)


def forward(cfg: ModelConfig, policy: QuantPolicy, params, tokens, frames, *,
            remat: bool = False):
    """Decoder logits (B, S, V_padded) of ``tokens`` given ``frames``.
    ``remat`` recomputes each layer in the backward (when grad is on)."""
    enc_out = encode(cfg, policy, params, frames, remat=remat)
    x, _ = _decoder(cfg, policy, params, tokens, enc_out, remat=remat)
    return T.tied_head(policy, params["embed"], x)


def lm_loss(cfg: ModelConfig, policy: QuantPolicy, params, tokens, frames, labels,
            loss_mask, *, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of the decoder over ``loss_mask``."""
    logits = forward(cfg, policy, params, tokens, frames, remat=remat)
    return T.next_token_loss(cfg, logits, labels, loss_mask)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device):
    """The decoder's self-attention cache (``transformer.init_cache``;
    encdec has no window) plus the cross K/V rows ``ck``/``cv``."""
    cache = T.init_cache(cfg, batch, max_len, dtype, device=device)
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.kv_heads, cfg.head_dim)
    cache["ck"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["cv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill(cfg, policy, params, tokens, frames, cache):
    """Encode ``frames``, run the decoder prompt, fill ``cache`` in place
    (self K/V at positions 0..S-1, the cross K/V); returns the last
    position's logits (the head sees that row alone, as in the reference)
    and the cache."""
    s = tokens.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache span {cache['k'].shape[2]}")
    enc_out = encode(cfg, policy, params, frames)
    x, (ks, vs, cks, cvs) = _decoder(cfg, policy, params, tokens, enc_out, keep_kv=True)
    logits = T.tied_head(policy, params["embed"], x[:, -1:])[:, 0]
    cache["k"][:, :, :s] = ks.to(cache["k"].dtype)
    cache["v"][:, :, :s] = vs.to(cache["v"].dtype)
    cache["pos"] = cache["pos"].clone()
    cache["pos"][:s] = torch.arange(s, dtype=cache["pos"].dtype, device=ks.device)
    cache["ck"].copy_(cks)
    cache["cv"].copy_(cvs)
    cache["len"] = torch.full((), s, dtype=cache["len"].dtype, device=ks.device)
    return logits, cache


def encode_cross_kv(cfg, policy, params, frames):
    """The encoder side of admission without the decoder prompt (chunked
    admission, serve/engine.py): the encoder pass and every decoder
    layer's cross K/V.  Returns (ck, cv), each (L, B, enc_seq, KV, hd)."""
    enc_out = encode(cfg, policy, params, frames)
    layers = T._unbind_layers(params["dec_layers"])
    cks, cvs = [], []
    for i in range(cfg.n_layers):
        lp = T._layer(layers, i)
        cks.append(_proj_heads(lp, "ck", enc_out, policy, cfg.kv_heads, cfg.head_dim))
        cvs.append(_proj_heads(lp, "cv", enc_out, policy, cfg.kv_heads, cfg.head_dim))
    return torch.stack(cks), torch.stack(cvs)


def _cross_attend(policy, cache, i):
    """Row ``s``'s cross attention over its slot's own ``ck``/``cv`` of
    layer ``i``: ``fn(q_s, s)``."""
    ckx, cvx = cache["ck"][i], cache["cv"][i]
    return lambda q_s, s: _mha(policy, q_s, ckx[s:s + 1], cvx[s:s + 1])


def decode_step(cfg, policy, params, token, cache):
    """One decode step, token (B,) -> (logits (B, V), cache updated in
    place), over the lockstep, contiguous slot-row or paged cache
    (``transformer.decode_step``'s layouts).  Quantized pages hold the
    self-attention K/V only; the cross ``ck``/``cv`` stay raw.  Norms,
    self- and cross attention run row by row."""
    b = token.shape[0]
    hd, hh = cfg.head_dim, cfg.n_heads * cfg.head_dim
    st = T.DecodeSlots(cache, token, T._kv_check(policy, cache))
    x = params["embed"][token[:, None]]  # (B, 1, D)
    for i in range(cfg.n_layers):
        lp = T._layer(params["dec_layers"], i)
        h = T._rows(_norm(lp["ln1"]), x)
        q, k, v = T._qkv(cfg, policy, lp, h, st.qpos)
        att = st.attend(cfg, policy, cache, i, q, k, v).reshape(b, 1, hh)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        hc = T._rows(_norm(lp["ln_cross"]), y)
        cq = _proj_heads(lp, "cq", hc, policy, cfg.n_heads, hd)
        if T.rows_are_groups(policy):
            cross = _cross_attend(policy, cache, i)
            catt = torch.cat([cross(cq[s:s + 1], s) for s in range(b)])
        else:  # one scale group over the batch's attention products
            catt = _mha(policy, cq, cache["ck"][i], cache["cv"][i])
        catt = catt.reshape(b, 1, hh)
        y = y + mfmac.mf_linear(catt, lp["co"]["w"], lp["co"]["gamma"], policy=policy)
        x = y + _mlp(policy, lp, T._rows(_norm(lp["ln2"]), y))
    x = T._rows(_norm(params["dec_norm"]), x)
    logits = T.tied_head(policy, params["embed"], x)[:, 0, :]
    st.done(cache)
    return logits, cache


def chunk_step(cfg, policy, params, tokens, n_new, cache):
    """The fused pooled step over ``(B, C)`` positions of chunked
    piggybacked prefill (``transformer.chunk_step``'s contract and pad
    discipline).  Cross attention reads each slot's own ``ck``/``cv``,
    written at admission by :func:`encode_cross_kv`, per slot at the
    shapes of its self-attention.  Paged pool caches only."""
    b, c = tokens.shape
    hd, hh = cfg.head_dim, cfg.n_heads * cfg.head_dim
    st = T.ChunkSlots(cfg, cache, tokens, n_new, T._kv_check(policy, cache))
    x = params["embed"][tokens]  # (B, C, D)
    for i in range(cfg.n_layers):
        lp = T._layer(params["dec_layers"], i)
        h = st.norms(_norm(lp["ln1"]), x)
        q, k, v = T._qkv(cfg, policy, lp, h, st.qpos)
        att = st.attend(cfg, policy, cache, i, q, k, v)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        cq = _proj_heads(lp, "cq", st.norms(_norm(lp["ln_cross"]), y), policy,
                         cfg.n_heads, hd)
        catt = T.slot_attend(_cross_attend(policy, cache, i), cq, st.layout)
        # zero the pad rows, so nothing downstream depends on them
        catt = torch.where(st.vmask[..., None], catt, 0.0).reshape(b, c, hh)
        y = y + mfmac.mf_linear(catt, lp["co"]["w"], lp["co"]["gamma"], policy=policy)
        x = y + _mlp(policy, lp, st.norms(_norm(lp["ln2"]), y))
    xe = T._rows(_norm(params["dec_norm"]), st.emit_rows(x))
    logits = T.tied_head(policy, params["embed"], xe)[:, 0, :]
    st.done(cache)
    return logits, cache


def verify_step(cfg, policy, params, tokens, n_new, cache):
    """The speculative verifier (``transformer.verify_step``'s contract):
    ``n_new[b]`` candidates a slot in one weight pass, bit for bit the
    logits and cache of as many sequential :func:`decode_step` calls.
    Each live (slot, position) row also reads its slot's cross K/V at
    decode's shapes.  Paged pool caches only."""
    b, c = tokens.shape
    hd, hh = cfg.head_dim, cfg.n_heads * cfg.head_dim
    st = T.VerifySlots(cfg, cache, tokens, n_new, T._kv_check(policy, cache))
    x = params["embed"][tokens].reshape(b * c, 1, -1)  # (B*C, 1, D)
    for i in range(cfg.n_layers):
        lp = T._layer(params["dec_layers"], i)
        h = T.live_norms(_norm(lp["ln1"]), x, st.rows)
        q, k, v = T._qkv(cfg, policy, lp, h, st.rq)
        att = st.attend(cfg, policy, cache, i, q, k, v)
        y = x + mfmac.mf_linear(att, lp["wo"]["w"], lp["wo"]["gamma"], policy=policy)
        cq = _proj_heads(lp, "cq", T.live_norms(_norm(lp["ln_cross"]), y, st.rows), policy,
                         cfg.n_heads, hd)
        cross = _cross_attend(policy, cache, i)
        catt = torch.zeros_like(cq)
        for r in st.rows:
            catt[r:r + 1] = cross(cq[r:r + 1], r // c)
        y = y + mfmac.mf_linear(catt.reshape(b * c, 1, hh), lp["co"]["w"], lp["co"]["gamma"],
                                policy=policy)
        x = y + _mlp(policy, lp, T.live_norms(_norm(lp["ln2"]), y, st.rows))
    xe = T.live_norms(_norm(params["dec_norm"]), x, st.rows)
    logits = T.tied_head(policy, params["embed"], xe)[:, 0, :].reshape(b, c, -1)
    st.done(cache)
    return logits, cache
