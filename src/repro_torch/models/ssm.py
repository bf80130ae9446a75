"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) backbone (port of
``repro/models/ssm.py``: specs, forward, loss, prefill and decode).

Chunked SSD: inside a chunk of Q positions the output is an
attention-like pair of products (C B^T masked by the cumulative decay,
times X); across chunks a small state (H, N, P) is carried by a
sequential loop over the chunks.  The in/out projections and the head
are MF-MAC quantized linear layers (``mf_linear``: K1 forward, K2/K3
backward); the causal conv, the state recurrence and the SSD products
stay FP32 elementwise ops and f32 matmuls, as in the reference.

Decode keeps (conv_state, ssm_state) per layer: O(1) memory in sequence
length.  Like ``models/transformer.py``, decode runs its row reductions
one row at a time (the norms and the ``C · h`` contraction, through
``transformer._rows``), so a slot in a pool of four runs the very
programs of a request served alone; everything else of a decode step is
elementwise or K1, both row-independent.

On a model axis (a sharded plan active, ``parallel/planner.runtime_layout``)
a rank runs the plan's local config, whose ``n_heads`` is its count of
SSD heads, over its shards: ``in_proj`` gives its heads' z, x and dt
columns and B and C whole, the conv runs over its x channels and B and
C, the SSD over its heads placed among zeros of the whole head count
(:func:`_ssd_heads_whole`: the intra-chunk products batch over the heads,
and a smaller batch would round otherwise), and y is all-gathered in rank
order for ``out_norm``, whose mean runs over every channel; ``out_proj``
then folds over this rank's channels (K1's fold chained across the
ranks) or, under a 128-chunk a rank, runs whole over the gathered y
(:func:`_out_norm_proj`).  The embedding rows and the head's columns
split over the vocabulary (``transformer.embed_inputs`` and
``_lm_head``).  Without a plan every hook is the identity.

Under autograd (tensor-parallel training) in_proj is column-parallel
over its index-set pieces, its dA over G and Wq placed whole
(``mfmac.mf_linear(col_cuts=)``), and every rank runs the rest of the
mixer whole: its heads' z, x and dt columns, conv channels and per-head
leaves all-gathered (:func:`_gathered`), the conv, the SSD over every
head, ``y · silu(z)`` and ``out_norm`` at one rank's shapes, and
out_proj's input cut to this rank's channels by
``collectives.slice_replicated`` where it folds.  So the backward of the
conv, the SSD and the norm is one rank's program at one rank's shapes,
replicated: B's and C's gradients, which every head shares, whole on
every rank, and each per-head or per-channel gradient one rank's slice,
whatever order a reduction over a rank's share of the channels would
take.  It costs M times the conv's and the SSD's work a rank, as
``select`` does for attention.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import common
from repro_torch.models.spec import ParamSpec
from repro_torch.models import transformer
from repro_torch.models.transformer import _gather_cols, _layer, _rows, _tp, _unbind_layers
from repro_torch.parallel import actshard, collectives

HEADDIM = 64  # Mamba2's default head dim P


def _dims(cfg: ModelConfig):
    # a model rank's config (planner.ShardingPlan.local_config) names its
    # SSD heads in n_heads; a whole ssm config's is 0
    nheads = cfg.n_heads or cfg.d_inner // HEADDIM
    d_inner = nheads * HEADDIM
    n = cfg.ssm_state
    # in_proj emits [z, x, B, C, dt]: d_inner + d_inner + N + N + nheads
    d_in = 2 * d_inner + 2 * n + nheads
    return d_inner, nheads, n, d_in


def _linear(shape, axes, std):
    if axes and axes[0] == "layer":
        gshape, gaxes = (shape[0],), ("layer",)
    else:
        gshape, gaxes = (), ()
    return {
        "w": ParamSpec(shape, axes, std=std),
        "gamma": ParamSpec(gshape, gaxes, init="value", value=0.95),
    }


def ssm_specs(cfg: ModelConfig):
    L, d = cfg.n_layers, cfg.d_model
    d_inner, nheads, n, d_in = _dims(cfg)
    std = 0.02
    conv_ch = d_inner + 2 * n  # the conv runs over x, B, C
    layer = {
        "norm": {"scale": ParamSpec((L, d), ("layer", None), init="ones")},
        "in_proj": _linear((L, d, d_in), ("layer", "embed", "ffn"), std),
        "conv_w": ParamSpec((L, cfg.conv_width, conv_ch), ("layer", None, None), std=0.2),
        "conv_b": ParamSpec((L, conv_ch), ("layer", None), init="zeros"),
        "A_log": ParamSpec((L, nheads), ("layer", None), init="value", value=0.0),
        "D": ParamSpec((L, nheads), ("layer", None), init="ones"),
        "dt_bias": ParamSpec((L, nheads), ("layer", None), init="zeros"),
        "out_norm": {"scale": ParamSpec((L, d_inner), ("layer", None), init="ones")},
        "out_proj": _linear((L, d_inner, d), ("layer", "ffn", "embed"), std),
    }
    return {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), std=0.02),
        "layers": layer,
        "final_norm": {"scale": ParamSpec((d,), (None,), init="ones")},
        "lm_head": _linear((d, cfg.vocab_padded), ("embed", "vocab"), std),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, _, n, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    bb = zxbcdt[..., 2 * d_inner:2 * d_inner + n]
    cc = zxbcdt[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, x, bb, cc, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (W, C).  The taps are summed
    one by one, in order (W is 4)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return F.silu((out + b).to(torch.float32)).to(x.dtype)


def _cumsum(x, dim: int):
    """Inclusive prefix sum along ``dim`` by log2(n) doubling steps of
    shifted adds: elementwise ops only, so its bits never depend on a
    library scan kernel's choices, under the trainer's deterministic
    mode or not.  Its order is not the reference's ``jnp.cumsum``'s; the
    two agree within rounding."""
    n = x.shape[dim]
    d = 1
    while d < n:
        head = x.narrow(dim, 0, d)
        x = torch.cat([head, x.narrow(dim, d, n - d) + x.narrow(dim, 0, n - d)], dim=dim)
        d *= 2
    return x


def _ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int, with_final: bool = False):
    """SSD forward. x: (B, S, H, P); dt: (B, S, H); b, c: (B, S, N).

    Returns y (B, S, H, P) in f32, and with ``with_final`` the state after
    the last position (B, H, N, P).  One B/C group shared by every head
    (G = 1).  S must be a multiple of ``chunk``: padding the sequence
    would change the final state.

    The reference runs the intra-chunk product ``HEAD_GROUP`` heads at a
    time to bound its memory; every head here goes at once (a serving
    prompt's (NC, Q, Q, H) mask is a few tens of MB at full width), in the
    reference's 2-operand steps, so no (B, NC, Q, N, H) temporary is made.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"SSD: sequence length {s} is not a multiple of the chunk "
                         f"{chunk} {(s, chunk)}")
    a = -torch.exp(a_log)  # (H,) negative decay rates
    dt = common.softplus(dt.to(torch.float32))  # (B, S, H)
    da = dt * a  # (B, S, H) log-decay a step
    xdt = x.to(torch.float32) * dt[..., None]

    xc = xdt.reshape(bsz, nc, chunk, h, p)
    dac = da.reshape(bsz, nc, chunk, h)
    bc = b.to(torch.float32).reshape(bsz, nc, chunk, n)
    cc = c.to(torch.float32).reshape(bsz, nc, chunk, n)

    cum = _cumsum(dac, 2)  # (B, NC, Q, H) inclusive cumsum of log decay
    qi = torch.arange(chunk, device=x.device)
    causal = qi[:, None] >= qi[None, :]
    # (Q, Q) scores shared by every head (G = 1): C_q · B_k, causal-masked
    scores = torch.einsum("bzqn,bzkn->bzqk", cc, bc)
    scores = torch.where(causal, scores, torch.zeros_like(scores))

    # intra-chunk: the per-head decay mask exp(cum_q - cum_k), (B, NC, Q, Q, H),
    # zero above the diagonal (exp(-inf): the masked entries, which can
    # overflow, never reach exp or its gradient)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    lm = torch.exp(li.masked_fill(~causal[:, :, None], float("-inf")))
    m = scores[..., None] * lm
    y_intra = torch.einsum("bzqkh,bzkhp->bzqhp", m, xc)

    # chunk-final states: S_z = sum_k exp(cum_end - cum_k) * B_k ⊗ x_k
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, NC, Q, H)
    wx = xc * decay_to_end[..., None]  # (B, NC, Q, H, P)
    states = torch.einsum("bzkn,bzkhp->bzhnp", bc, wx)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, NC, H) a chunk's total decay

    # sequential loop over the chunks, carrying the state (B, H, N, P)
    hcur = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    hprevs = []
    for z in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, z, :, None, None] + states[:, z]
    hprevs = torch.stack(hprevs, dim=1)  # (B, NC, H, N, P): the state entering a chunk

    # inter-chunk: y_q += (C_q · h_in) * exp(cum_q)
    t = torch.einsum("bzqn,bzhnp->bzqhp", cc, hprevs)
    y_inter = t * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + d_skip[None, None, :, None] * x.to(torch.float32)
    if with_final:
        return y, hcur
    return y


def _ssd_heads_whole(xh, dt, a_log, bb, cc, d_skip, chunk):
    """:func:`_ssd_chunked` with the final state.  On a model axis that
    splits the SSD heads, this rank's heads (B, S, H_r, P) are placed at
    their global offsets in zeros of the whole head count and the outputs
    cut back to them: the SSD's products batch over the heads, and the
    port's CPU matmuls round a smaller batch otherwise (the card gave equal
    bits both ways, ``tools/ssm_heads_probe.py``), so a rank's heads get
    one rank's bits either way."""
    tp = _tp()
    if tp is None or not tp.layout.heads:
        return _ssd_chunked(xh, dt, a_log, bb, cc, d_skip, chunk, with_final=True)
    hl = xh.shape[2]
    lo = tp.rank * hl

    def whole(t, dim):
        shape = list(t.shape)
        shape[dim] = hl * tp.layout.model
        out = t.new_zeros(shape)
        out.narrow(dim, lo, hl).copy_(t)
        return out

    y, final = _ssd_chunked(whole(xh, 2), whole(dt, 2), whole(a_log, 0), bb, cc,
                            whole(d_skip, 0), chunk, with_final=True)
    return y[:, :, lo:lo + hl], final[:, lo:lo + hl]


def _out_norm_proj(policy, lp, y, rows: bool, whole: bool = False):
    """``out_norm`` (row by row with ``rows``: decode), then ``out_proj``.
    On a model axis that splits the heads, y (this rank's heads'
    channels; ``whole``: every channel already, :func:`_gathered`) is
    all-gathered in rank order and normed whole; ``out_proj`` then folds
    over this rank's channels, or runs whole over the gathered y where a
    rank's channels are not whole 128-chunks (``transformer._out_proj``)."""
    tp = _tp()
    if tp is not None and tp.layout.heads and not whole:
        y = _gather_cols(y, tp.group)

    def norm(r):
        return common.rms_norm(r, lp["out_norm"]["scale"])

    y = _rows(norm, y) if rows else norm(y)
    return transformer._out_proj(lp["out_proj"], y, policy, "wo", whole=True)


def _gathered(tp, cfg, lp, zxbcdt):
    """The mixer whole on every model rank, from in_proj's output on:
    (the whole config, the layer's leaves with the conv's, ``A_log``'s,
    ``D``'s and ``dt_bias``'s whole, in_proj's whole output) from this
    rank's.  Its heads' z, x and dt columns and its conv channels and
    per-head leaves are all-gathered in rank order
    (``collectives.gather_replicated``: the backward takes this rank's
    slice); B and C are whole on every rank already."""
    d_inner = _dims(cfg)[0]

    def g(t, dim=-1):
        return collectives.gather_replicated(t.contiguous(), tp.group, dim)

    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    lp = dict(lp, conv_w=torch.cat([g(lp["conv_w"][:, :d_inner]), lp["conv_w"][:, d_inner:]],
                                   dim=-1),
              conv_b=torch.cat([g(lp["conv_b"][:d_inner]), lp["conv_b"][d_inner:]], dim=-1),
              **{k: g(lp[k], 0) for k in ("A_log", "D", "dt_bias")})
    return tp.cfg, lp, torch.cat([g(z), g(xs), bb, cc, g(dt)], dim=-1)


def _mixer(cfg, policy, lp, x, chunk):
    """The block's SSD mixer over a whole sequence.  Returns (the block's
    output, the conv window of its last W - 1 inputs, the final state).

    On a model axis that splits the SSD heads, in_proj is column-parallel
    over this rank's pieces (its backward over G and Wq placed whole:
    ``mfmac.mf_linear(col_cuts=)``).  Under autograd every rank then runs
    the rest whole (:func:`_gathered`: M times the conv's and the SSD's
    work a rank), so the backward of the conv, the SSD and ``out_norm`` is
    one rank's, replicated: B's and C's gradients (shared by every head)
    whole, and each per-head and per-channel gradient one rank's slice.
    Without grad (serving, prefill, the per-token losses) a rank runs its
    own heads, padded to the whole head count (:func:`_ssd_heads_whole`);
    the forward's bits are the same either way."""
    tp = _tp()
    split = tp is not None and tp.layout.heads
    h = common.rms_norm(x, lp["norm"]["scale"])
    p = lp["in_proj"]
    cuts = actshard.active_plan().model_cuts("layers/in_proj/w")[1] if split else None
    zxbcdt = mfmac.mf_linear(h, p["w"], p["gamma"], policy=policy,
                             col_group=tp.group if split else None, col_cuts=cuts)
    whole = split and torch.is_grad_enabled() and zxbcdt.requires_grad
    if whole:
        cfg, lp, zxbcdt = _gathered(tp, cfg, lp, zxbcdt)
    d_inner, nheads, n, _ = _dims(cfg)
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_state = conv_in[:, conv_in.shape[1] - (cfg.conv_width - 1):, :]
    conv_out = _causal_conv(conv_in, lp["conv_w"], lp["conv_b"])
    xs = conv_out[..., :d_inner]
    bb = conv_out[..., d_inner:d_inner + n]
    cc = conv_out[..., d_inner + n:]
    bsz, s, _ = xs.shape
    xh = xs.reshape(bsz, s, nheads, HEADDIM)
    ssd = functools.partial(_ssd_chunked, with_final=True) if whole else _ssd_heads_whole
    y, final = ssd(xh, dt + lp["dt_bias"], lp["A_log"], bb, cc, lp["D"], chunk)
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return x + _out_norm_proj(policy, lp, y, rows=False, whole=whole), conv_state, final


def _block(cfg, policy, lp, x, chunk):
    return _mixer(cfg, policy, lp, x, chunk)[0]


def _head(cfg, policy, params, x):
    x = common.rms_norm(x, params["final_norm"]["scale"])
    return transformer._lm_head(cfg, policy, params, x)


def forward(cfg: ModelConfig, policy: QuantPolicy, params, tokens, *, remat: bool = False):
    """Full-sequence forward: logits (B, S, V_padded).  ``remat``
    recomputes each layer in the backward (when grad is on), as the
    reference's ``jax.checkpoint`` around its layer scan."""
    x = transformer.embed_inputs(cfg, policy, params, tokens)
    chunk = min(cfg.ssm_chunk, x.shape[1])
    layers = _unbind_layers(params["layers"])
    recompute = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        if recompute:
            x = checkpoint(_block, cfg, policy, lp, x, chunk, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(cfg, policy, lp, x, chunk)
    return _head(cfg, policy, params, x)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, *, device):
    """Per-layer conv windows (W - 1 inputs) and SSM states, both f32 by
    default (the registry passes no dtype, as the reference's does)."""
    d_inner, nheads, n, _ = _dims(cfg)
    conv_ch = d_inner + 2 * n
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((L, batch, nheads, n, HEADDIM), dtype=torch.float32,
                           device=device),
        "len": torch.zeros((), dtype=torch.int64, device=device),
    }


def _contract_c(cc, state):
    """y = C · h over the state axis: (B, N) x (B, H, N, P) -> (B, H, P)."""
    return torch.einsum("bn,bhnp->bhp", cc, state)


def _block_decode(cfg, policy, lp, x, conv_state, ssm_state):
    """x: (B, 1, D).  Returns (y, the new conv window, the new SSM state)."""
    d_inner, nheads, n, _ = _dims(cfg)
    norm = lambda r: common.rms_norm(r, lp["norm"]["scale"])  # noqa: E731
    h = _rows(norm, x)
    zxbcdt = mfmac.mf_linear(h, lp["in_proj"]["w"], lp["in_proj"]["gamma"], policy=policy)
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, bb, cc], dim=-1)  # (B, 1, C)
    # an f32 window promotes the new row, as jnp.concatenate does
    wdt = torch.promote_types(conv_state.dtype, conv_in.dtype)
    window = torch.cat([conv_state.to(wdt), conv_in.to(wdt)], dim=1)  # (B, W, C)
    w = lp["conv_w"]  # (W, C)
    # the reference's jnp.sum over the window, its taps added in order:
    # elementwise, so a row never depends on its neighbours
    acc = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i] * w[i]
    conv_out = (acc[:, None, :] + lp["conv_b"])
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    new_conv_state = window[:, 1:, :]

    xs = conv_out[..., :d_inner]
    bb = conv_out[..., d_inner:d_inner + n].to(torch.float32)
    cc = conv_out[..., d_inner + n:].to(torch.float32)
    bsz = xs.shape[0]
    xh = xs.reshape(bsz, nheads, HEADDIM).to(torch.float32)
    dtv = common.softplus((dt[:, 0, :] + lp["dt_bias"]).to(torch.float32))  # (B, H)
    a = -torch.exp(lp["A_log"])  # (H,)
    decay = torch.exp(dtv * a)  # (B, H)
    # h' = decay * h + dt * B ⊗ x ;  y = C · h' + D * x
    # the outer product B ⊗ (dt x) of each row: (B, H, N, P)
    outer = bb[:, 0, None, :, None] * (xh * dtv[..., None])[:, :, None, :]
    new_ssm = ssm_state * decay[:, :, None, None] + outer
    y = _rows(_contract_c, cc[:, 0, :], new_ssm)
    y = y + lp["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner)
    y = y * F.silu(z.to(torch.float32))
    return x + _out_norm_proj(policy, lp, y.to(x.dtype), rows=True), new_conv_state, new_ssm


def prefill(cfg, policy, params, tokens, cache):
    """Run the prompt through the model and fill ``cache`` in place with
    each layer's last W - 1 conv inputs and its SSD state after the
    prompt; returns the last position's logits and the cache.  The prompt
    needs at least W - 1 tokens (the conv window), and past one SSD chunk
    a multiple of it.  The LM head runs over every prompt position, one
    activation-scale group, as the reference's does."""
    s = tokens.shape[1]
    if s < cfg.conv_width - 1:
        raise ValueError(f"ssm prefill: a prompt of {s} tokens is shorter than the conv "
                         f"window ({cfg.conv_width - 1})")
    x = transformer._embed(params["embed"], tokens)
    chunk = min(cfg.ssm_chunk, s)
    layers = _unbind_layers(params["layers"])
    for i in range(cfg.n_layers):
        x, conv_state, final = _mixer(cfg, policy, _layer(layers, i), x, chunk)
        cache["conv"][i].copy_(conv_state)
        cache["ssm"][i].copy_(final)
    logits = _head(cfg, policy, params, x[:, -1:, :])[:, 0, :]
    cache["len"] = torch.full((), s, dtype=cache["len"].dtype, device=tokens.device)
    return logits, cache


def decode_step(cfg, policy, params, token, cache):
    """One decode step.  token: (B,) -> (logits (B, V), cache).  The conv
    windows and SSM states are written into ``cache`` in place and
    ``len`` is replaced: a scalar (lockstep, ``registry.init_cache``) or
    (B,) per slot (``serve.slots.lift_cache``); the states are per row in
    either layout."""
    x = transformer._embed(params["embed"], token[:, None])  # (B, 1, D)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x, conv, ssm_state = _block_decode(cfg, policy, lp, x, cache["conv"][i],
                                           cache["ssm"][i])
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(ssm_state)
    fn = lambda r: common.rms_norm(r, params["final_norm"]["scale"])  # noqa: E731
    x = _rows(fn, x)
    logits = transformer._lm_head(cfg, policy, params, x)[:, 0, :]
    cache["len"] = cache["len"] + 1
    return logits, cache
