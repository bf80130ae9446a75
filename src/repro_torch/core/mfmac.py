"""MF-MAC linear layers with their backward (port of ``repro/core/mfmac.py``,
``mf_linear`` and ``mf_expert_linear``; Algorithm 1).

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
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import potq
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops

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


def _quantize_a(a: torch.Tensor, gamma: torch.Tensor, policy: QuantPolicy,
                axes=None) -> torch.Tensor:
    axes = _sample_axes(policy, a, axes)
    a32 = a.to(torch.float32)
    if policy.prc_enabled:
        if axes is None:
            t = a32.abs().amax() * gamma
        else:
            t = a32.abs().amax(dim=axes, keepdim=True) * gamma
        a32 = torch.clamp(a32, -t, t)
    beta = potq.compute_beta(a32, policy.bits_a, axes)
    return potq.pot_quantize(a32, policy.bits_a, beta).to(_BF16)


def _bits_g(policy: QuantPolicy, is_last: bool) -> int:
    return policy.bits_g_last if is_last else policy.bits_g


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
        kw = dict(bits_g=_bits_g(policy, ctx.is_last), bits_a=policy.bits_a,
                  bits_w=policy.bits_w,
                  per_sample_act_scales=policy.per_sample_act_scales)
        if policy.prc_enabled:
            a32 = a.to(torch.float32)
            amax = a32.abs().amax()
            da, dw, dgamma = ops.potq_grad_matmuls(
                g2, aq.reshape(-1, k), wq, a=a32.reshape(-1, k),
                clip_t=amax * gamma, amax=amax, **kw)
            dgamma = dgamma.reshape(gamma.shape).to(gamma.dtype)
        else:
            da, dw, _ = ops.potq_grad_matmuls(g2, aq.reshape(-1, k), wq, **kw)
            dgamma = torch.zeros_like(gamma)
        return da.reshape(a.shape).to(a.dtype), dw, dgamma, None, None


def mf_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    is_last: bool = False,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[..., K] @ w[K, N].

    ``is_last`` selects the last layer's gradient bit-width
    (``policy.bits_g_last``) in the backward.  dW comes back in float32."""
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
