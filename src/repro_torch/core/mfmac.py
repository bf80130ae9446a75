"""MF-MAC linear layers with their backward (port of ``repro/core/mfmac.py``:
``mf_linear``, ``mf_expert_linear``, ``mf_act_dot`` and ``mf_conv2d``;
Algorithm 1).

Forward (lines 4-8):
    Wq = ALS-PoTQ(W - mean(W))            # WBC then quantize
    Aq = ALS-PoTQ(clip(A, gamma*max|A|))  # PRC then quantize
    out = MF_MAC(Aq, Wq)                  # kernels/ops.pot_value_matmul (K1)

Backward (lines 13-15): the incoming gradient G is ALS-PoTQ quantized
once (``bits_g_last`` into the LM head), in the kernels' scaled domain,
and reused:
    dA = MF_MAC(Gq, Wq^T), then PRC's clip mask and dgamma   (K2)
    dW = MF_MAC(Aq^T, Gq), the raw MAC output (STE)          (K3)
through ``kernels/ops.potq_grad_matmuls``.

The MACs run over the *dequantized* PoT values (exact in bf16), with the
numeric spec of ``kernels/ref.py``.  ``mf_linear`` is a
``torch.autograd.Function``: the clamp, the scales and the rounding all
happen inside its forward, so autograd never sees through them — a's
gradient is the masked dA, gamma's the kernel's dgamma and w's the raw dW,
as in the reference's ``custom_vjp``.  dW keeps float32 whatever w's dtype
is, so the training step differentiates float32 weights (the shadow of
``train/step.py`` holds exact PoT values in float32).

``mf_expert_linear`` is the MoE experts' a[E, T, K] @ w[E, K, N]: each
expert is its own "layer" (its own W scale and WBC mean, its own A scale
and PRC threshold), the forward is ONE launch of K1's expert-batched form
(``ops.pot_value_bmm``) and the backward runs K2/K3 once per expert
(``ops.potq_expert_grad_matmuls``), as the reference's vmap does.

``mf_act_dot`` is the attention's activation-by-activation product
x[..., M, K] @ y[..., K, N] (QK^T and PV).  Under
``policy.quantize_attention`` both operands are PoT-quantized without a
PRC clip and the product runs over their exact values in float32 (no
kernel: the reference's is a plain dot outside any Pallas kernel);
otherwise it is today's plain product, bit for bit.

``mf_conv2d`` is a convolution as im2col (pure data movement, the
reference's ``conv_general_dilated_patches`` element for element) followed
by ``mf_linear``: K1 forward, K2 and K3 backward at conv shapes.

On a sharded plan (``parallel/actshard.py``) the quantizers take global
maxima wherever their input is split: the per-tensor activation amax and
PRC threshold, and the backward's max|G| (the G scale of
``kernels/ops.py``), over the data axis when the batch rows are split
(data-parallel training); the activation amax (per tensor or per sample)
over the model axis when the contraction is split (``row_group``: a
row-parallel linear, whose K1 fold continues across the ranks,
``parallel/collectives.ordered_fold``).  Max is exact, so each quantized
value is one rank's, bit for bit.  Without a plan nothing changes.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import potq
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.parallel import actshard, collectives

_BF16 = torch.bfloat16


def _pot_matmul(x: torch.Tensor, y: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """(M,K)@(K,N) over already-quantized (PoT-valued) operands."""
    return ops.pot_value_matmul(x, y, bits_a=policy.bits_a, bits_w=policy.bits_w)


def _pot_bmm(x: torch.Tensor, y: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """(E,M,K)@(E,K,N) over already-quantized operands, one K1 launch."""
    return ops.pot_value_bmm(x, y, bits_a=policy.bits_a, bits_w=policy.bits_w)


#: elements of one block of rows in :func:`_quantize_w`'s rounding: its
#: full-size float32 temporaries (several per element) stay this small
W_BLOCK_ELEMS = 1 << 25


def _quantize_w(w: torch.Tensor, policy: QuantPolicy, axes=None) -> torch.Tensor:
    if policy.weights_prequantized:
        return w.to(_BF16)  # already exact PoT values (serving path)
    w = w.to(torch.float32)
    if axes is not None:
        if policy.weight_bias_correction:
            w = w - w.mean(dim=tuple(axes), keepdim=True)
        beta = potq.compute_beta(w, policy.bits_w, axes)
        return potq.pot_quantize(w, policy.bits_w, beta).to(_BF16)
    # one scale for the whole matrix: the WBC mean over all of it, and the
    # largest |w - mean| from each block's extremes (rounding w - mean is
    # monotone in w, so this is exact); the rounding then runs a block of
    # rows at a time, so a large matrix (an LM head) never holds several
    # float32 copies of itself
    mean = w.mean() if policy.weight_bias_correction else None
    rows = w.reshape(-1, w.shape[-1])
    step = max(1, W_BLOCK_ELEMS // rows.shape[1])
    starts = range(0, rows.shape[0], step)
    ext = torch.stack([torch.stack(torch.aminmax(rows[r:r + step])) for r in starts])
    beta = potq.compute_beta(ext if mean is None else ext - mean, policy.bits_w)

    def rounded(r):
        blk = rows[r:r + step]
        return potq.pot_quantize(blk if mean is None else blk - mean,
                                 policy.bits_w, beta).to(_BF16)

    if len(starts) == 1:
        return rounded(0).reshape(w.shape)
    out = torch.empty(rows.shape, dtype=_BF16, device=w.device)
    for r in starts:
        out[r:r + step] = rounded(r)
    return out.reshape(w.shape)


def _sample_axes(policy: QuantPolicy, x: torch.Tensor, axes):
    """Scale-group axes for a forward activation: per-sample (all dims but
    the leading batch dim) under ``policy.per_sample_act_scales``."""
    if axes is None and policy.per_sample_act_scales and x.dim() >= 2:
        return tuple(range(1, x.dim()))
    return axes


def _global_amax(amax: torch.Tensor, per_tensor: bool, row_group) -> torch.Tensor:
    """``amax`` over every rank that holds part of its group: the data
    axis for a per-tensor amax of split batch rows, the model axis for a
    split contraction."""
    if per_tensor:
        amax = collectives.all_reduce_max(amax, actshard.batch_group())
    return collectives.all_reduce_max(amax, row_group)


def _quantize_a(a: torch.Tensor, gamma: torch.Tensor, policy: QuantPolicy,
                axes=None, row_group=None) -> torch.Tensor:
    axes = _sample_axes(policy, a, axes)
    a32 = a.to(torch.float32)
    # global maxima where the input is split (identities on one rank):
    # amax, the PRC threshold t and the exact amax of the clipped values,
    # min(amax, t) (a clamp to a t < 0 sets every value to t: then -t)
    amax = a32.abs().amax() if axes is None else a32.abs().amax(dim=axes, keepdim=True)
    amax = _global_amax(amax, axes is None, row_group)
    if policy.prc_enabled:
        t = amax * gamma
        a32 = torch.clamp(a32, -t, t)
        amax = torch.where(t < 0, -t, torch.minimum(amax, t))
    beta = potq.beta_of_amax(amax, policy.bits_a)
    return potq.pot_quantize(a32, policy.bits_a, beta).to(_BF16)


class _MFLinear(torch.autograd.Function):
    """a[..., K] @ w[K, N] through K1, backward through K2 and K3."""

    @staticmethod
    def forward(ctx, a, w, gamma, policy: QuantPolicy, is_last: bool):
        aq = _quantize_a(a, gamma, policy)
        wq = _quantize_w(w, policy)
        k = a.shape[-1]
        out = _pot_matmul(aq.reshape(-1, k), wq, policy)
        ctx.policy, ctx.is_last = policy, is_last
        ctx.save_for_backward(a, aq, wq, gamma)
        return out.reshape(*a.shape[:-1], w.shape[-1]).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, aq, wq, gamma = ctx.saved_tensors
        policy = ctx.policy
        k, n = wq.shape
        g2 = g.to(torch.float32).reshape(-1, n)
        bits_g = policy.bits_for("g", ctx.is_last)
        kw = dict(bits_g=bits_g, bits_a=policy.bits_a, bits_w=policy.bits_w,
                  per_sample_act_scales=policy.per_sample_act_scales)
        dgroup = actshard.batch_group()
        # the G scale of the whole batch
        gmax = collectives.all_reduce_max(g2.abs().amax(), dgroup)
        kw["beta_g"] = potq.beta_of_amax(gmax, bits_g)
        if policy.prc_enabled:
            a32 = a.to(torch.float32)
            amax = collectives.all_reduce_max(a32.abs().amax(), dgroup)
            da, dw, dgamma = ops.potq_grad_matmuls(
                g2, aq.reshape(-1, k), wq, a=a32.reshape(-1, k),
                clip_t=amax * gamma, amax=amax, **kw)
            dgamma = dgamma.reshape(gamma.shape).to(gamma.dtype)
        else:
            da, dw, _ = ops.potq_grad_matmuls(g2, aq.reshape(-1, k), wq, **kw)
            dgamma = torch.zeros_like(gamma)
        return da.reshape(a.shape).to(a.dtype), dw, dgamma, None, None


def _row_parallel(a, w, gamma, policy: QuantPolicy, group) -> torch.Tensor:
    """a[..., K_r] @ w[K_r, N] with K split over ``group`` at whole
    128-chunks, in rank order: global activation scales, then K1's fold
    chained across the ranks.  Serving only (prequantized weights, whose
    scale was taken whole; no backward)."""
    if not policy.weights_prequantized:
        raise ValueError("a row-parallel mf_linear needs weights prequantized whole "
                         "(a shard's own WBC mean and scale would not be the matrix's)")
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        raise ValueError("row-parallel mf_linear has no backward: tensor-parallel "
                         "training is not ported (ROADMAP)")
    k, n = w.shape
    aq = _quantize_a(a, gamma, policy, row_group=group).reshape(-1, k)
    wq = _quantize_w(w, policy)
    out = collectives.ordered_fold(
        lambda start: ops.pot_value_matmul(aq, wq, bits_a=policy.bits_a,
                                           bits_w=policy.bits_w, start=start),
        (aq.shape[0], n), a.device, group)
    return out.reshape(*a.shape[:-1], n).to(a.dtype)


def mf_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    is_last: bool = False,
    row_group=None,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[..., K] @ w[K, N].

    ``is_last`` selects the last layer's gradient bit-width
    (``policy.bits_g_last``) in the backward.  dW comes back in float32.
    ``row_group`` (a process group): K is split over its ranks, this
    rank's slice in ``a`` and ``w``; the result is the whole product on
    every rank (:func:`_row_parallel`)."""
    if not policy.enabled:
        w_ = w.to(a.dtype)
        if a.dim() == 3 and a.shape[1] == 1:
            # decode rows: one (1, D) @ (D, N) product per row, so a row's
            # reduction never depends on the batch size
            return torch.stack([torch.matmul(r, w_) for r in a])
        return torch.matmul(a, w_)
    if gamma is None:
        gamma = policy.ratio_clip_init or 1.0
    if not torch.is_tensor(gamma):
        # a fill on the device, not a host-to-device copy (no host sync)
        gamma = torch.full((), gamma, dtype=torch.float32, device=a.device)
    if row_group is not None:
        return _row_parallel(a, w, gamma, policy, row_group)
    return _MFLinear.apply(a, w, gamma, policy, is_last)


class _MFExpertLinear(torch.autograd.Function):
    """a[E, T, K] @ w[E, K, N], scales per expert (axes (1, 2)): forward
    through one K1 launch, backward through K2 and K3 once per expert."""

    @staticmethod
    def forward(ctx, a, w, gamma, policy: QuantPolicy):
        aq = _quantize_a(a, gamma, policy, axes=(1, 2))
        wq = _quantize_w(w, policy, axes=(1, 2))
        out = _pot_bmm(aq, wq, policy)
        ctx.policy = policy
        ctx.save_for_backward(a, aq, wq, gamma)
        return out.to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, aq, wq, gamma = ctx.saved_tensors
        policy = ctx.policy
        # experts get bits_g, never bits_g_last (the reference's choice)
        da, dw, dgamma = ops.potq_expert_grad_matmuls(
            g.to(torch.float32), aq, wq, a=a if policy.prc_enabled else None, gamma=gamma,
            bits_g=policy.bits_g, bits_a=policy.bits_a, bits_w=policy.bits_w)
        if dgamma is None:
            dgamma = torch.zeros_like(gamma)
        return da.to(a.dtype), dw, dgamma.reshape(gamma.shape).to(gamma.dtype), None


def _expert_per_slot(a, w, gamma, policy: QuantPolicy) -> torch.Tensor:
    """a[E, G, C, K] @ w[E, K, N] with activation scales per (expert, slot)
    over (C, K) and weight scales per expert: the reference's vmap of
    ``mf_expert_linear`` over the slot axis G, as ONE K1 launch over the
    (E, G*C, K) rows (each row still carries one beta)."""
    e, g, c, k = a.shape
    aq = _quantize_a(a, gamma, policy, axes=(2, 3))
    wq = _quantize_w(w, policy, axes=(1, 2))
    out = _pot_bmm(aq.reshape(e, g * c, k), wq, policy)
    return out.reshape(e, g, c, -1).to(a.dtype)


def mf_expert_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    per_slot: bool = False,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[E, T, K] @
    w[E, K, N], each expert its own layer.  ``per_slot`` takes a[E, G, C,
    K] and gives every (expert, slot) its own activation scale (serving's
    per-slot dispatch); it has no backward, as the reference only runs it
    in serving steps.  dW comes back in float32."""
    if not policy.enabled:
        # one (rows, K) @ (K, N) product per expert (and slot), so a
        # matrix's reduction never depends on the batch around it
        w_ = w.to(a.dtype)
        if per_slot:
            return torch.stack([torch.stack([torch.matmul(r, w_[i]) for r in a[i]])
                                for i in range(a.shape[0])])
        return torch.stack([torch.matmul(a[i], w_[i]) for i in range(a.shape[0])])
    if gamma is None:
        gamma = policy.ratio_clip_init or 1.0
    if not torch.is_tensor(gamma):
        gamma = torch.tensor(gamma, dtype=torch.float32, device=a.device)
    if per_slot:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            raise ValueError("mf_expert_linear(per_slot=True) has no backward")
        return _expert_per_slot(a, w, gamma, policy)
    return _MFExpertLinear.apply(a, w, gamma, policy)


# ---------------------------------------------------------------------------
# mf_act_dot: activation x activation products (attention), opt-in
# ---------------------------------------------------------------------------

def _qact(x: torch.Tensor, bits: int, axes=None) -> torch.Tensor:
    """x PoT-quantized at ``bits`` under one scale per ``axes`` group (the
    whole tensor for None), as exact values in bf16; no PRC clip."""
    x32 = x.to(torch.float32)
    return potq.pot_quantize(x32, bits, potq.compute_beta(x32, bits, axes)).to(_BF16)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the dims that broadcasting added or widened, back
    to ``shape``."""
    lead = t.dim() - len(shape)
    if lead:
        t = t.sum(dim=tuple(range(lead)))
    wide = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=wide, keepdim=True) if wide else t


class _MFActDot(torch.autograd.Function):
    """x[..., M, K] @ y[..., K, N] over PoT-quantized operands (batch dims
    broadcast); the backward is the reference's ``_mf_act_dot_bwd``."""

    @staticmethod
    def forward(ctx, x, y, policy: QuantPolicy):
        xq = _qact(x, policy.bits_a, _sample_axes(policy, x, None))
        yq = _qact(y, policy.bits_a, _sample_axes(policy, y, None))
        ctx.policy, ctx.dtypes = policy, (x.dtype, y.dtype)
        ctx.save_for_backward(xq, yq)
        # PoT products are exact in float32 (TF32 is off on the card)
        return torch.matmul(xq.to(torch.float32), yq.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, yq = ctx.saved_tensors
        # G quantized once, one scale for the whole tensor
        gq = _qact(g, ctx.policy.bits_g).to(torch.float32)
        dx = _sum_to(torch.matmul(gq, yq.to(torch.float32).transpose(-1, -2)), xq.shape)
        dy = _sum_to(torch.matmul(xq.to(torch.float32).transpose(-1, -2), gq), yq.shape)
        # rounded to bf16 as the reference's rule does, in the primal's dtype
        return dx.to(_BF16).to(ctx.dtypes[0]), dy.to(_BF16).to(ctx.dtypes[1]), None


def mf_act_dot(x: torch.Tensor, y: torch.Tensor, *, policy: QuantPolicy) -> torch.Tensor:
    """x[..., M, K] @ y[..., K, N], batch dims broadcast: through PoT
    quantization under ``policy.quantize_attention`` (one activation scale
    per tensor, per leading-dim sample under ``per_sample_act_scales``),
    otherwise the plain product."""
    if policy.enabled and policy.quantize_attention:
        return _MFActDot.apply(x, y, policy)
    return torch.matmul(x, y)


# ---------------------------------------------------------------------------
# mf_conv2d: convolution as im2col + MF-MAC (the paper's CNN linear layers)
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's "SAME" split: the output is ceil(size / stride) wide, the
    total pad goes one more to the end than to the start when odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """im2col of x (B, H, W, Cin): (B, Ho, Wo, Cin*KH*KW), features
    Cin-major, element for element the reference's
    ``conv_general_dilated_patches`` (pads of zeros, explicit and, at
    stride 2, possibly asymmetric)."""
    b, h, w, c = x.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    ho = (h + ph[0] + ph[1] - kh) // stride + 1
    wo = (w + pw[0] + pw[1] - kw) // stride + 1
    cols = F.unfold(xc, (kh, kw), stride=stride)  # (B, Cin*KH*KW, Ho*Wo)
    return cols.transpose(1, 2).reshape(b, ho, wo, c * kh * kw)


def mf_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    stride: int = 1,
    padding: str = "SAME",
    is_last: bool = False,
) -> torch.Tensor:
    """2-D convolution of x (B, H, W, Cin) by w (KH, KW, Cin, Cout) through
    the quantized MAC path: im2col, then ``mf_linear`` of the patches by
    the (Cin*KH*KW, Cout) filter matrix, one layer-wise scale for W and one
    for A.  Returns (B, Ho, Wo, Cout)."""
    kh, kw, cin, cout = w.shape
    patches = conv_patches(x, kh, kw, stride, padding)
    wm = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return mf_linear(patches, wm, gamma, policy=policy, is_last=is_last)
