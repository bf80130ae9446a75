"""Serving-side weight compression (port of
``repro/serve/quantized_weights.py:36-47``).

``quantize_for_serving`` applies WBC + ALS-PoTQ to every linear-layer
weight once (what ``mf_linear``'s forward would do per step) and stores
the exact PoT values in bf16, halving the weight bytes a decode step
streams.  Each trailing 2-D matrix gets its own WBC mean and beta, so a
stacked (L, D, F) weight gets one per layer.  The embedding, norms and
PRC gammas stay f32.
"""
from __future__ import annotations

import torch

from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.spec import named_leaves


def is_linear_weight(name: str, x: torch.Tensor) -> bool:
    # linear weights live under {'w': ...} dicts built by the _linear
    # helpers; embedding / norm / gamma leaves are not
    return name.split("/")[-1] == "w" and x.dim() >= 2


def quantize_leaf(name: str, x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Serving form of one parameter leaf (identity for non-linear leaves)."""
    if not is_linear_weight(name, x):
        return x
    # one matrix at a time: the same per-matrix groups as quantizing the
    # stack with trailing-axes reductions, at a fraction of the temporaries
    flat = x.reshape(-1, *x.shape[-2:])
    out = torch.empty(flat.shape, dtype=torch.bfloat16, device=x.device)
    for i in range(flat.shape[0]):
        out[i] = mfmac._quantize_w(flat[i], policy)
    return out.reshape(x.shape)


def quantize_for_serving(cfg, policy: QuantPolicy, params):
    """PoT-quantize every linear weight and store it at bf16 (exact).
    Returns a new tree; ``params`` is left as it is."""
    out: dict = {}
    for name, x in named_leaves(params):
        node = out
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = quantize_leaf(name, x, policy)
    return out
