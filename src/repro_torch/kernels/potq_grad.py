"""K2 and K3: the MF-MAC backward kernels, hand-written in CUDA for sm_90a
on Hopper's FP64 tensor cores (``mma.sync ... .f64``).

* K2 replaces the Pallas TPU kernel ``repro/kernels/potq_grad.py``
  ``_grad_da_kernel`` (launcher ``grad_da_padded``): dA = Gq·Wq^T with the
  PRC epilogue (dA masked where |a| > clip_t, per-row dgamma sums of
  ``where(clipped, dA_raw·sign(a), 0)``).
* K3 replaces ``_grad_dw_kernel`` (launcher ``grad_dw_padded``):
  dW = Aq^T·Gq.
* The pre-pass :func:`quantize_g_cuda` takes the place of the TPU kernels'
  in-VMEM quantization of G: it writes Gq (scaled domain, bf16) once per
  backward, and K2 and K3 both read it.

Every ``mf_linear`` backward of the training step launches each once (113
per olmo-1b step).  Source: ``repro_torch/csrc/potq_grad.cu`` — its header
says what bounds the kernels on an H100, why the tensor-core datapath
keeps every bit, and the tiles, stages and shared memory.  Built by
``kernels/_build.py`` at first use.

Beside each kernel is its plain PyTorch version, the port's numeric spec
(``kernels/ref.py``); within the exactness preconditions (bit widths that
pass ``ref.check_exact_spread``, one scale for all of Wq, and for K3 one
scale for all of Aq) the kernel equals it bit for bit.  ``scalars`` is a
(3,) float32 tensor ``[2^-beta_g, 2^beta_g, clip_t]``, on the operands'
device, so no launch waits for the host.

K2's chain (tensor-parallel training, ``core/mfmac.py``).  ``start`` (an
(M, K) f32 running sum) continues dA's fold over N from the previous
model rank's, whose N range ends at a whole 128-chunk; ``last=False``
returns that raw running sum (no dequant, no PRC epilogue), which the next
rank continues; the last rank's launch dequantizes and runs the epilogue
on the finished dA.  ``rows_start`` (an (M,) f32 running sum) continues the
dgamma rows' left fold over K chunks from the previous rank's, for a
row-parallel linear whose K the ranks split at whole 128-chunks.  Chained
over ranks in rank order, each equals the unsplit launch bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (CANONICAL_BK, grad_rowsum_ref,
                                     pot_value_matmul_ref, quantize_tile_ref)

SOURCE = "potq_grad.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "grad_g_quantize_launch": [_P, _P, _P, _L, _I, _P],
    "grad_da_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "grad_dw_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    if _lib is None:
        _lib, build_seconds = _build.load(SOURCE, _SIGNATURES)
    return _lib


def _quantize_g(g: torch.Tensor, scalars: torch.Tensor, emax_g: int) -> torch.Tensor:
    """G in the scaled PoT domain (f32): the plain version of the pre-pass
    :func:`quantize_g_cuda`, which writes the same values as bf16."""
    return quantize_tile_ref(g.to(torch.float32) * scalars[0], emax_g)


def grad_da_plain(g: torch.Tensor, wq: torch.Tensor, a: Optional[torch.Tensor],
                  scalars: torch.Tensor, *, emax_g: int, prc: bool,
                  start: Optional[torch.Tensor] = None, last: bool = True,
                  rows_start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K2: ``(dA (M,K), dgamma rows (M,) or None)``;
    with ``last=False`` ``(the raw running sum, None)`` (module docstring)."""
    _check_chain(g, wq, prc, start, last, rows_start)
    gq = _quantize_g(g, scalars, emax_g)
    acc = pot_value_matmul_ref(gq, wq.to(torch.float32).T, start)
    if not last:
        return acc, None
    da = acc * scalars[1]
    if not prc:
        return da, None
    a = a.to(torch.float32)
    clipped = a.abs() > scalars[2]
    zero = torch.zeros_like(da)
    rows = grad_rowsum_ref(torch.where(clipped, da * torch.sign(a), zero), rows_start)
    return torch.where(clipped, zero, da), rows


def grad_dw_plain(aq: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor, *,
                  emax_g: int) -> torch.Tensor:
    """Plain PyTorch version of K3: dW (K, N)."""
    gq = _quantize_g(g, scalars, emax_g)
    return pot_value_matmul_ref(aq.to(torch.float32).T, gq) * scalars[1]


def _check_chain(g, wq, prc, start, last, rows_start) -> None:
    m, k = g.shape[0], wq.shape[0]
    if start is not None and tuple(start.shape) != (m, k):
        raise ValueError(f"start must be ({m}, {k}), got {tuple(start.shape)}")
    if not last and prc:
        raise ValueError("a rank before the last of K2's chain returns the raw running sum: "
                         "the PRC epilogue runs on the last rank only")
    if rows_start is not None and (not prc or tuple(rows_start.shape) != (m,)):
        raise ValueError(f"rows_start continues the PRC dgamma rows: ({m},) with prc")


def _check_cuda(*ts: torch.Tensor) -> None:
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError("the backward kernels need CUDA tensors")


def _scalars(scalars: torch.Tensor, device) -> torch.Tensor:
    s = scalars.to(device=device, dtype=torch.float32).contiguous()
    if s.numel() != 3:
        raise ValueError("scalars must hold 3 values")
    return s


def quantize_g_cuda(g: torch.Tensor, scalars: torch.Tensor, *, emax_g: int) -> torch.Tensor:
    """Launch the pre-pass on g's CUDA device (PyTorch's current stream):
    Gq = PoT(g·2^-beta_g) with ``emax_g``, as bf16 of g's shape (exact:
    every value is 0 or ±2^e with |e| <= 15).  Raises on a bad device or
    launch."""
    _check_cuda(g, scalars)
    g = g.to(torch.float32).contiguous()
    s = _scalars(scalars, g.device)
    gq = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    err = build().grad_g_quantize_launch(
        g.data_ptr(), s.data_ptr(), gq.data_ptr(), g.numel(), emax_g,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grad_g_quantize kernel launch failed: CUDA error {err}")
    quantize_g_cuda.launches += 1
    return gq


def _gq(g: torch.Tensor, scalars: torch.Tensor, emax_g: int,
        gq: Optional[torch.Tensor]) -> torch.Tensor:
    """The pre-pass's Gq: ``gq`` when the caller shares one, else launched."""
    if gq is None:
        return quantize_g_cuda(g, scalars, emax_g=emax_g)
    _check_cuda(gq)
    if gq.dtype != torch.bfloat16 or gq.shape != g.shape or not gq.is_contiguous():
        raise ValueError(f"gq must be a contiguous bf16 tensor of G's shape {tuple(g.shape)}")
    return gq


def grad_da_cuda(g: torch.Tensor, wq: torch.Tensor, a: Optional[torch.Tensor],
                 scalars: torch.Tensor, *, emax_g: int, prc: bool,
                 gq: Optional[torch.Tensor] = None, start: Optional[torch.Tensor] = None,
                 last: bool = True, rows_start: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K2 on the tensors' CUDA device (PyTorch's current stream).
    g: (M, N) f32, wq: (K, N) PoT values (read as bf16), a: (M, K) f32
    raw activations (PRC only); gq: G from :func:`quantize_g_cuda` under
    the same scalars (the pre-pass is launched here when it is None);
    ``start``, ``last`` and ``rows_start``: the chain (module docstring).
    Raises on a bad device, shape or launch."""
    _check_cuda(g, wq, scalars, *([a] if prc else []),
                *(t for t in (start, rows_start) if t is not None))
    if g.dim() != 2 or wq.dim() != 2 or g.shape[1] != wq.shape[1]:
        raise ValueError(f"bad shapes G {tuple(g.shape)}, Wq {tuple(wq.shape)}")
    _check_chain(g, wq, prc, start, last, rows_start)
    m, n = g.shape
    k = wq.shape[0]
    if start is not None:
        start = start.to(torch.float32).contiguous()
    if rows_start is not None:
        rows_start = rows_start.to(torch.float32).contiguous()
    wq = wq.to(torch.bfloat16).contiguous()
    s = _scalars(scalars, g.device)
    da = torch.empty((m, k), dtype=torch.float32, device=g.device)
    part = rows = None
    if prc:
        if a is None or tuple(a.shape) != (m, k):
            raise ValueError(f"PRC needs a of shape {(m, k)}")
        a = a.to(torch.float32).contiguous()
        nchunk = (k + CANONICAL_BK - 1) // CANONICAL_BK
        part = torch.empty((nchunk, m), dtype=torch.float32, device=g.device)
        rows = torch.empty((m,), dtype=torch.float32, device=g.device)
    lib = build()
    gq = _gq(g, s, emax_g, gq)
    err = lib.grad_da_launch(
        gq.data_ptr(), wq.data_ptr(), a.data_ptr() if prc else None, s.data_ptr(),
        start.data_ptr() if start is not None else None, da.data_ptr(),
        part.data_ptr() if prc else None,
        rows_start.data_ptr() if rows_start is not None else None,
        rows.data_ptr() if prc else None, m, n, k, int(prc), int(not last),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grad_da kernel launch failed: CUDA error {err}")
    grad_da_cuda.launches += 1
    return da, rows


def grad_dw_cuda(aq: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor, *,
                 emax_g: int, gq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on the tensors' CUDA device (PyTorch's current stream).
    aq: (M, K) PoT values (read as bf16), g: (M, N) f32; gq as for
    :func:`grad_da_cuda`.  Raises on a bad device, shape or launch."""
    _check_cuda(aq, g, scalars)
    if aq.dim() != 2 or g.dim() != 2 or aq.shape[0] != g.shape[0]:
        raise ValueError(f"bad shapes Aq {tuple(aq.shape)}, G {tuple(g.shape)}")
    m, k = aq.shape
    n = g.shape[1]
    aq = aq.to(torch.bfloat16).contiguous()
    s = _scalars(scalars, g.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=g.device)
    lib = build()
    gq = _gq(g, s, emax_g, gq)
    err = lib.grad_dw_launch(
        aq.data_ptr(), gq.data_ptr(), s.data_ptr(), dw.data_ptr(), m, n, k,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grad_dw kernel launch failed: CUDA error {err}")
    grad_dw_cuda.launches += 1
    return dw


#: kernel launches since the last reset (the caller sets them to 0)
quantize_g_cuda.launches = 0
grad_da_cuda.launches = 0
grad_dw_cuda.launches = 0
