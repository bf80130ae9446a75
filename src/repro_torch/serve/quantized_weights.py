"""Serving-side weight compression (port of
``repro/serve/quantized_weights.py:36-81``).

``quantize_for_serving`` applies WBC + ALS-PoTQ to every linear-layer
weight once (what ``mf_linear``'s forward would do per step) and stores
the exact PoT values in bf16, halving the weight bytes a decode step
streams.  Each trailing 2-D matrix gets its own WBC mean and beta, so a
stacked (L, D, F) weight gets one per layer.  The embedding, norms and
PRC gammas stay f32.

``pack_int8`` goes further for offline storage: one int8 code per element
(``core/compress.py`` layout) through K4 (``ops.potq_encode``) and ONE
beta per tensor, as the reference packs — so a stacked leaf shares one
beta across its layers, and a layer whose largest value lies well below
the stack's may lose its smallest codes to zero.  ``unpack_int8`` gives
the bf16 PoT values back.
"""
from __future__ import annotations

import torch

from repro_torch.core import compress, mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.models.spec import named_leaves, unflatten


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
    return unflatten((name, quantize_leaf(name, x, policy))
                     for name, x in named_leaves(params))


def pack_int8(params, bits: int = 5):
    """Offline int8 packing: every linear weight becomes
    ``{"code": int8 of its shape, "beta": int32 scalar}`` (K4 on the card);
    other leaves are kept as they are.  Returns a new tree."""
    def one(name, x):
        if is_linear_weight(name, x):
            code, beta = ops.potq_encode(x, bits)
            return {"code": code, "beta": beta}
        return x

    return unflatten((name, one(name, x)) for name, x in named_leaves(params))


def unpack_int8(packed, bits: int = 5):
    """Inverse of :func:`pack_int8`: the packed leaves as bf16 PoT values
    (exact), the others as they are."""
    if isinstance(packed, (tuple, list)):
        return type(packed)(unpack_int8(v, bits) for v in packed)
    if "code" in packed and not isinstance(packed["code"], dict):
        return compress.decompress(packed["code"], packed["beta"], bits).to(torch.bfloat16)
    return {k: unpack_int8(v, bits) if isinstance(v, (dict, tuple, list)) else v
            for k, v in packed.items()}
