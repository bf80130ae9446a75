"""Public wrappers around K1-K4 (port of ``repro/kernels/ops.py:49-332``).

* :func:`potq_matmul`       — fused PRC-clip + WBC + ALS-PoTQ + matmul (K1).
* :func:`pot_value_matmul`  — matmul over already-PoT-valued operands (K1;
  what ``core/mfmac.py`` calls on every quantized ``mf_linear`` forward).
* :func:`pot_value_bmm`     — the same over a batch of experts, one launch
  (K1's expert-batched form; every quantized ``mf_expert_linear`` forward).
* :func:`grad_da_matmul`    — dA = Gq·Wq^T with the PRC epilogue (K2).
* :func:`grad_dw_matmul`    — dW = Aq^T·Gq (K3).
* :func:`potq_grad_matmuls` — both, G quantized once under one beta_g
  (every quantized ``mf_linear`` backward; on the card one pre-pass
  writes Gq and both kernels read it, :func:`grad_prepass`).  A
  tensor-parallel backward (``core/mfmac.py``) calls the three itself, K2
  with ``start`` / ``last`` / ``rows_start`` (its chain across ranks).
* :func:`potq_expert_grad_matmuls` — :func:`potq_grad_matmuls` once per
  expert (every quantized ``mf_expert_linear`` backward).
* :func:`potq_encode`       — f32 -> int8 PoT wire codes + beta (K4;
  ``serve/quantized_weights.pack_int8``).

Dispatch depends only on the operands' device: CUDA tensors launch the
hand-written kernels (``kernels/potq_matmul.py``, ``kernels/potq_grad.py``,
``kernels/potq_encode.py``)
— a build or launch failure raises, nothing falls back — and CPU tensors
take the kernels' plain PyTorch versions.  The kernels mask their own
ragged edges, so there is no padding to block multiples, and there is no
block-shape autotuning.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import potq
from repro_torch.kernels import ref
from repro_torch.kernels import potq_encode as _ke
from repro_torch.kernels import potq_grad as _kg
from repro_torch.kernels import potq_matmul as _k


def _dispatch(device: torch.device, cuda_fn, plain_fn):
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {device}")


def _launch(a, w, scalars, **kw) -> torch.Tensor:
    return _dispatch(a.device, _k.potq_matmul_cuda, _k.potq_matmul_plain)(a, w, scalars, **kw)


def potq_matmul(
    a: torch.Tensor,
    w: torch.Tensor,
    *,
    bits_a: int = 5,
    bits_w: int = 5,
    w_mean: Optional[torch.Tensor] = None,
    clip_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ALS-PoTQ quantize + matmul: a(M,K) @ w(K,N) -> (M,N) f32.

    Layer-wise betas come from global amax reductions; the clip, the WBC
    shift, the quantization and the dequant run in the kernel."""
    ref.check_exact_spread(bits_a, bits_w)
    a = a.to(torch.float32)
    w = w.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=a.device)
    # fills on the device, not host-to-device copies (no host sync)
    clip_t = (torch.full((), float("inf"), **f32) if clip_t is None
              else torch.as_tensor(clip_t).to(**f32))
    w_mean = (torch.full((), 0.0, **f32) if w_mean is None
              else torch.as_tensor(w_mean).to(**f32))
    # betas of the clipped / shifted operands, from their amax alone
    beta_a = potq.compute_beta(torch.minimum(a.abs().amax(), clip_t), bits_a)
    beta_w = potq.compute_beta((w - w_mean).abs().amax(), bits_w)
    scalars = torch.stack([
        potq.exp2i(-beta_a), potq.exp2i(-beta_w), potq.exp2i(beta_a + beta_w),
        w_mean, clip_t,
    ])
    return _launch(a, w, scalars, emax_a=potq.pot_emax(bits_a),
                   emax_w=potq.pot_emax(bits_w), quantize=True)


def pot_value_matmul(x: torch.Tensor, y: torch.Tensor, *,
                     bits_a: int = 5, bits_w: int = 5,
                     start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,K)@(K,N) over already-quantized (PoT-valued) operands.

    ``bits_a``/``bits_w`` are the widths the operands were quantized at;
    they only gate the exactness precondition (``ref.check_exact_spread``).
    ``start`` continues the fold from an (M, N) running sum (a
    row-parallel product's previous ranks, ``parallel/collectives.py``).
    """
    ref.check_exact_spread(bits_a, bits_w)
    return _launch(x, y, None, quantize=False, start=start)


def pot_value_bmm(x: torch.Tensor, y: torch.Tensor, *,
                  bits_a: int = 5, bits_w: int = 5) -> torch.Tensor:
    """(E,M,K)@(E,K,N) over already-quantized (PoT-valued) operands, one
    scale per expert's W and per row of its A; K1's expert-batched form, a
    single launch on the card.  ``bits_a``/``bits_w`` as for
    :func:`pot_value_matmul`."""
    ref.check_exact_spread(bits_a, bits_w)
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError(f"pot_value_bmm takes (E,M,K)@(E,K,N), got {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    return _launch(x, y, None, quantize=False)


def _g_scalars(g: torch.Tensor, bits_g: int, beta_g: Optional[torch.Tensor],
               clip_t: Optional[torch.Tensor]) -> torch.Tensor:
    """(3,) f32 ``[2^-beta_g, 2^beta_g, clip_t]`` on g's device."""
    if beta_g is None:
        beta_g = potq.compute_beta(g, bits_g)
    f32 = dict(dtype=torch.float32, device=g.device)
    # a fill on the device, not a host-to-device copy (no host sync)
    clip = (torch.full((), float("inf"), **f32) if clip_t is None
            else torch.as_tensor(clip_t).to(**f32).reshape(()))
    return torch.stack([potq.exp2i(-beta_g), potq.exp2i(beta_g), clip])


def grad_prepass(g: torch.Tensor, bits_g: int, beta_g: torch.Tensor) -> Optional[torch.Tensor]:
    """G quantized once for K2 and K3 under ``beta_g``: on the card the
    pre-pass's bf16 Gq, which both kernels read; None on the CPU, where
    the plain versions quantize G themselves (the same values)."""
    if g.device.type != "cuda":
        return None
    return _kg.quantize_g_cuda(g, _g_scalars(g, bits_g, beta_g, None),
                               emax_g=potq.pot_emax(bits_g))


def grad_da_matmul(
    g: torch.Tensor,
    wq: torch.Tensor,
    *,
    a: Optional[torch.Tensor] = None,
    clip_t: Optional[torch.Tensor] = None,
    bits_g: int = 5,
    bits_w: int = 5,
    beta_g: Optional[torch.Tensor] = None,
    gq: Optional[torch.Tensor] = None,
    start: Optional[torch.Tensor] = None,
    last: bool = True,
    rows_start: Optional[torch.Tensor] = None,
):
    """dA = Gq·Wq^T (K2): g (M, N) raw gradient, wq (K, N) the forward's
    quantized weights, read in that layout.

    With ``a``/``clip_t`` the PRC epilogue runs in the kernel: dA is
    clip-masked and the dgamma contributions are reduced to the (M,) row
    vector; ``halves_fold(rows) * max|a|`` is dgamma.  Returns
    ``(da, rows)``, ``rows`` None with PRC off.  ``gq`` (CUDA only) is G
    already quantized by the pre-pass under ``beta_g``.  ``start``,
    ``last`` and ``rows_start``: K2's chain across ranks
    (``kernels/potq_grad.py``); with ``last=False`` ``da`` is the raw
    running sum."""
    ref.check_exact_spread(bits_g, bits_w)
    prc = a is not None
    if prc and clip_t is None:
        raise ValueError("PRC epilogue needs both a and clip_t")
    g = g.to(torch.float32)
    scalars = _g_scalars(g, bits_g, beta_g, clip_t)
    fn = _dispatch(g.device, functools.partial(_kg.grad_da_cuda, gq=gq), _kg.grad_da_plain)
    return fn(g, wq, a, scalars, emax_g=potq.pot_emax(bits_g), prc=prc, start=start,
              last=last, rows_start=rows_start)


def grad_dw_matmul(
    g: torch.Tensor,
    aq: torch.Tensor,
    *,
    bits_g: int = 5,
    bits_a: int = 5,
    beta_g: Optional[torch.Tensor] = None,
    per_sample_act_scales: bool = False,
    gq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dW = Aq^T·Gq (K3): g (M, N) raw gradient, aq (M, K) the forward's
    quantized activations, read in that layout; ``gq`` as for
    :func:`grad_da_matmul`.

    The contraction runs over M, so all of Aq must lie on one lattice (one
    activation scale).  Under per-sample activation scales it does not,
    and this raises instead of computing outside the exact regime."""
    if per_sample_act_scales:
        raise ValueError(
            "grad_dw_matmul needs one activation scale along M: per-sample "
            "activation scales (the serving policy) put the rows of Aq on "
            "different lattices, outside the exact-chunk regime"
        )
    ref.check_exact_spread(bits_a, bits_g)
    g = g.to(torch.float32)
    scalars = _g_scalars(g, bits_g, beta_g, None)
    fn = _dispatch(g.device, functools.partial(_kg.grad_dw_cuda, gq=gq), _kg.grad_dw_plain)
    return fn(aq, g, scalars, emax_g=potq.pot_emax(bits_g))


def potq_grad_matmuls(
    g: torch.Tensor,
    aq: torch.Tensor,
    wq: torch.Tensor,
    *,
    a: Optional[torch.Tensor] = None,
    clip_t: Optional[torch.Tensor] = None,
    amax: Optional[torch.Tensor] = None,
    bits_g: int = 5,
    bits_a: int = 5,
    bits_w: int = 5,
    per_sample_act_scales: bool = False,
    beta_g: Optional[torch.Tensor] = None,
):
    """The backward MACs (Algorithm 1, lines 13-15): G (M, N) is quantized
    once — one beta_g (given: the scale of G's whole batch across
    data-parallel ranks; else from this G), shared by both kernels — then

        dA = Gq·Wq^T   (PRC mask + dgamma rows in the epilogue, K2)
        dW = Aq^T·Gq   (K3)

    Returns ``(da, dw, dgamma)``; ``dgamma`` is None without ``a``/``clip_t``
    (PRC off).  dgamma = halves_fold(rows) * amax, amax defaulting to
    max|a|: a fixed order, the same bits on every device."""
    g = g.to(torch.float32)
    if beta_g is None:
        beta_g = potq.compute_beta(g, bits_g)  # quantized once: one shared beta
    gq = grad_prepass(g, bits_g, beta_g)  # one pre-pass, read by both kernels
    da, rows = grad_da_matmul(g, wq, a=a, clip_t=clip_t, bits_g=bits_g,
                              bits_w=bits_w, beta_g=beta_g, gq=gq)
    dw = grad_dw_matmul(g, aq, bits_g=bits_g, bits_a=bits_a, beta_g=beta_g,
                        per_sample_act_scales=per_sample_act_scales, gq=gq)
    if rows is None:
        return da, dw, None
    if amax is None:
        amax = a.to(torch.float32).abs().amax()
    return da, dw, ref.halves_fold(rows) * amax


def potq_expert_grad_matmuls(
    g: torch.Tensor,
    aq: torch.Tensor,
    wq: torch.Tensor,
    *,
    gmax: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    gamma: Optional[torch.Tensor] = None,
    amax: Optional[torch.Tensor] = None,
    bits_g: int = 5,
    bits_a: int = 5,
    bits_w: int = 5,
):
    """The backward MACs of an expert linear: :func:`potq_grad_matmuls` on
    each expert's g (E, M, N), aq (E, M, K) and wq (E, K, N), each expert
    its own "layer": its own beta_g, from ``gmax[e]``; with PRC (``a``
    given) its own ``amax[e]`` and clip ``amax[e] * gamma``.  ``gmax`` and
    ``amax`` (E,) are each expert's max|g| and max|a| over every rank that
    holds some of its rows (one rank: its own).

    Returns ``(da (E, M, K), dw (E, K, N), dgammas (E,))``: each expert's
    dgamma, unfolded (the layer's gamma takes their :func:`ref.halves_fold`,
    over every rank's experts where they are split), None with PRC off."""
    kw = dict(bits_g=bits_g, bits_a=bits_a, bits_w=bits_w)
    das, dws, dgs = [], [], []
    for e in range(g.shape[0]):
        kw["beta_g"] = potq.beta_of_amax(gmax[e], bits_g)
        if a is not None:
            da, dw, dg = potq_grad_matmuls(g[e], aq[e], wq[e], a=a[e].to(torch.float32),
                                           clip_t=amax[e] * gamma, amax=amax[e], **kw)
            dgs.append(dg)
        else:
            da, dw, _ = potq_grad_matmuls(g[e], aq[e], wq[e], **kw)
        das.append(da)
        dws.append(dw)
    return torch.stack(das), torch.stack(dws), torch.stack(dgs) if dgs else None


def potq_encode(x: torch.Tensor, bits: int = 5):
    """Encode a tensor to int8 PoT codes + one int32 beta (the wire format
    of ``core/compress.py``): code 0 for zero, otherwise
    ``|code| = exp + emax + 1`` with the value's sign.

    beta comes from :func:`potq.compute_beta` over the whole tensor and
    stays on x's device; the codes have x's shape.  The kernel reads the
    tensor flat, so there is no padding."""
    x = x.to(torch.float32)
    beta = potq.compute_beta(x, bits)
    fn = _dispatch(x.device, _ke.potq_encode_cuda, _ke.potq_encode_plain)
    return fn(x, beta, emax=potq.pot_emax(bits)), beta
