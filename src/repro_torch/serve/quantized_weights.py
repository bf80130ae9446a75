"""Serving-side weight compression (port of
``repro/serve/quantized_weights.py:36-81``).

``quantize_for_serving`` applies WBC + ALS-PoTQ to every linear-layer
weight once (what ``mf_linear``'s forward would do per step) and stores
the exact PoT values in bf16, halving the weight bytes a decode step
streams.  Each trailing 2-D matrix gets its own WBC mean and beta, so a
stacked (L, D, F) weight gets one per layer.  The embedding, norms and
PRC gammas stay f32.

``draft_stats`` gives the low-bit self-draft on a model axis each
matrix's whole statistics at the draft's bit-width, so a rank rounds its
shard as the whole matrix is rounded on one rank.

``pack_int8`` goes further for offline storage: one int8 code per element
(``core/compress.py`` layout) through K4 (``ops.potq_encode``) and ONE
beta per tensor, as the reference packs — so a stacked leaf shares one
beta across its layers, and a layer whose largest value lies well below
the stack's may lose its smallest codes to zero.  ``unpack_int8`` gives
the bf16 PoT values back.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.core import compress, mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.models.spec import named_leaves, unflatten
from repro_torch.parallel import collectives


def is_linear_weight(name: str, x: torch.Tensor) -> bool:
    # linear weights live under {'w': ...} dicts built by the _linear
    # helpers; embedding / norm / gamma leaves are not
    return name.split("/")[-1] == "w" and x.dim() >= 2


def quantize_leaf(name: str, x: torch.Tensor, policy: QuantPolicy, plan=None) -> torch.Tensor:
    """Serving form of one parameter leaf (identity for non-linear leaves).
    With ``plan`` (a sharded plan of ``parallel/planner.py``), this model
    rank's shard of it (``plan.shard_slice``: one range, or an ssm's
    index set of packed columns), quantized a matrix at a time from the
    whole leaf: along a stacked dim only this rank's matrices, inside the
    matrices each whole matrix and this rank's pieces of it kept, so the
    leaf's whole quantized copy is never held."""
    cut = None if plan is None else plan.shard_slice(name)
    if not is_linear_weight(name, x):
        return x if cut is None else plan.shard_leaf(name, x)
    shape, lead, inner = list(x.shape), [0] * (x.dim() - 2), None
    if cut is not None:
        dim, pieces = cut
        n = sum(length for _, length in pieces)
        if x.shape[dim] == plan.param_shape(name)[dim]:
            shape[dim] = n
            if dim < x.dim() - 2:
                if len(pieces) != 1:
                    raise ValueError(f"{name}: a stacked dim splits into one range")
                lead[dim] = pieces[0][0]
            else:
                inner = (dim - x.dim() + 2, pieces)
        elif dim >= x.dim() - 2 or x.shape[dim] != n:
            raise ValueError(f"{name}: a leaf split inside its matrices is quantized whole "
                             f"(its WBC mean and scale), got dim {dim} of {x.shape[dim]}")
    # one matrix at a time: the same per-matrix groups as quantizing the
    # stack with trailing-axes reductions, at a fraction of the temporaries
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    for idx in itertools.product(*(range(s) for s in shape[:-2])):
        w = mfmac._quantize_w(x[tuple(i + o for i, o in zip(idx, lead))], policy)
        out[idx] = w if inner is None else plan.take(w, inner)
        del w
    return out


def draft_stats(params, policy: QuantPolicy, plan):
    """The self-draft's statistics on a model axis: for every matrix that
    ``params`` (this rank's shards of served weights) holds a piece of,
    its WBC mean and scale under ``policy`` (the draft's bit-width) over
    the whole matrix, per expert for a MoE leaf's experts, as
    ``mfmac._quantize_w`` takes them of the whole at use.  Each matrix is
    all-gathered over the model ranks and placed whole a matrix at a
    time (the served values never change, so these are the statistics of
    every draft step).  Returns ``{mfmac.weight_key(shard view): (mean,
    beta)}`` for ``mfmac.whole_stats`` (a ``mfmac.WholeStats``, which
    also marks each split leaf, so a view of it that is not listed
    raises); a leaf whose scale groups are whole on the rank (whole, or
    split along its stack or its experts) needs none."""
    group = plan.mesh.group("model")
    table = mfmac.WholeStats()
    for name, x in named_leaves(params):
        cuts = plan.model_cuts(name) if is_linear_weight(name, x) else None
        if cuts is None or cuts[0] < x.dim() - 2:
            continue
        expert = name.split("/")[-2] in ("gate", "up", "down") and "/moe/" in f"/{name}"
        unit = 3 if expert else 2  # the trailing dims one _quantize_w call takes
        cut = (cuts[0] - (x.dim() - unit), cuts[1])
        table.add_leaf(x)
        for idx in itertools.product(*(range(s) for s in x.shape[:x.dim() - unit])):
            view = x[idx]
            whole = plan.untake(collectives.all_gather(view, group), cut)
            table[mfmac.weight_key(view)] = mfmac.weight_stats(
                whole, policy, (1, 2) if expert else None)
            del whole
    return table


def quantize_for_serving(cfg, policy: QuantPolicy, params, plan=None):
    """PoT-quantize every linear weight and store it at bf16 (exact); with
    ``plan``, each leaf's model-rank shard (:func:`quantize_leaf`).
    Returns a new tree; ``params`` is left as it is."""
    return unflatten((name, quantize_leaf(name, x, policy, plan))
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
