"""Shared model components: norms, RoPE, activations
(port of ``repro/models/common.py:21-77``).

Everything outside the linear-layer MACs stays FP32 — the paper's scope
boundary (it quantizes the MACs of linear layers only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def nonparametric_layer_norm(x, eps: float = 1e-5):
    """OLMo-style LN without learned scale/bias (arXiv:2402.00838)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x, params):
    if kind == "rms":
        return rms_norm(x, params["scale"])
    if kind == "ln":
        return layer_norm(x, params["scale"], params["bias"])
    if kind == "nonparam_ln":
        return nonparametric_layer_norm(x)
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    freqs = torch.exp(
        -torch.log(torch.full((), theta, **f32))
        * torch.arange(half, **f32) / half
    )  # (half,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x):
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)
