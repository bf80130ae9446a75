"""MF-MAC linear layers, forward (port of ``repro/core/mfmac.py``).

    Wq = ALS-PoTQ(W - mean(W))            # WBC then quantize
    Aq = ALS-PoTQ(clip(A, gamma*max|A|))  # PRC then quantize
    out = MF_MAC(Aq, Wq)                  # kernels/ops.pot_value_matmul

The MAC runs over the *dequantized* PoT values in bf16 (exact for them)
through K1, whose numeric spec is in ``kernels/ref.py``.  Serving needs no
gradient; the ``torch.autograd.Function`` with the backward kernels comes
with the training slice.
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


def _quantize_w(w: torch.Tensor, policy: QuantPolicy, axes=None) -> torch.Tensor:
    if policy.weights_prequantized:
        return w.to(_BF16)  # already exact PoT values (serving path)
    w = w.to(torch.float32)
    if policy.weight_bias_correction:
        if axes is None:
            w = w - w.mean()
        else:
            w = w - w.mean(dim=tuple(axes), keepdim=True)
    beta = potq.compute_beta(w, policy.bits_w, axes)
    return potq.pot_quantize(w, policy.bits_w, beta).to(_BF16)


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


def mf_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    is_last: bool = False,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[..., K] @ w[K, N].

    ``is_last`` selects the last layer's gradient bit-width in the
    backward, which the training slice adds; the forward ignores it."""
    if not policy.enabled:
        w_ = w.to(a.dtype)
        if a.dim() == 3 and a.shape[1] == 1:
            # decode rows: one (1, D) @ (D, N) product per row, so a row's
            # reduction never depends on the batch size
            return torch.stack([torch.matmul(r, w_) for r in a])
        return torch.matmul(a, w_)
    if gamma is None:
        gamma = policy.ratio_clip_init or 1.0
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=a.device)
    aq = _quantize_a(a, gamma, policy)
    wq = _quantize_w(w, policy)
    k = a.shape[-1]
    out = _pot_matmul(aq.reshape(-1, k), wq, policy)
    return out.reshape(*a.shape[:-1], w.shape[-1]).to(a.dtype)
