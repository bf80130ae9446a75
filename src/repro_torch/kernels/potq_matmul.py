"""K1: the MF-MAC forward kernel, hand-written in CUDA for sm_90a.

Replaces the Pallas TPU kernel ``repro/kernels/potq_matmul.py``
``_potq_matmul_kernel`` (launcher ``potq_matmul_padded``) in both modes:
``quantize=False`` (PoT-valued bf16 operands — every ``mf_linear``
forward, 225 launches per llama3-8b weight pass) and ``quantize=True``
(in-tile PRC clip, WBC shift, exact 2^-beta scaling and nearest PoT
rounding of raw f32 operands).

Source: ``repro_torch/csrc/potq_matmul.cu`` — see its header for what
bounds the kernel on an H100 (weight bytes at decode, fp64 operations at
prefill) and how the design keeps the reduction exact and in order.

Build: ``kernels/_build.py`` (nvcc for sm_90a into a shared library with a
plain C interface, at first use, into ``<checkout>/build/kernels/<hash>/``,
loaded with ``ctypes``).

Exactness precondition: operands come from the port's quantizer (one beta
per row of A, one for all of W) and the bit widths pass
``ref.check_exact_spread``.  Within it the kernel equals
:func:`potq_matmul_plain` bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pot_value_matmul_ref, quantize_tile_ref

#: Accumulation-scheme tag of the port: exact chunk partials, left fold.
ACC_SCHEME = "canonical-k128-exactchunk-leftfold-v1"

SOURCE = "potq_matmul.cu"
_SIGNATURES = {
    "potq_matmul_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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


def potq_matmul_plain(a: torch.Tensor, w: torch.Tensor,
                      scalars: Optional[torch.Tensor] = None, *,
                      emax_a: int = 7, emax_w: int = 7,
                      quantize: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments.

    ``scalars`` is a (5,) float32 tensor ``[2^-beta_a, 2^-beta_w,
    2^(beta_a+beta_w), w_mean, clip_t]``; ``None`` means
    ``[1, 1, 1, 0, inf]``."""
    a = a.to(torch.float32)
    w = w.to(torch.float32)
    if quantize:
        if scalars is None:
            raise ValueError("quantize=True needs the (5,) scalars")
        sa, sw, _, w_mean, clip_t = scalars.unbind()
        a = quantize_tile_ref(torch.clamp(a, -clip_t, clip_t) * sa, emax_a)
        w = quantize_tile_ref((w - w_mean) * sw, emax_w)
    out = pot_value_matmul_ref(a, w)
    if scalars is not None:
        out = out * scalars[2]
    return out


def potq_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                     scalars: Optional[torch.Tensor] = None, *,
                     emax_a: int = 7, emax_w: int = 7,
                     quantize: bool = False) -> torch.Tensor:
    """Launch K1 on the tensors' CUDA device (PyTorch's current stream).

    ``quantize=False`` reads bf16 operands (f32 PoT values are cast, which
    is exact); ``quantize=True`` reads raw f32 operands.  Raises on a bad
    device, shape or launch."""
    if a.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError("potq_matmul_cuda needs CUDA tensors")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(w.shape)}")
    dt = torch.float32 if quantize else torch.bfloat16
    a = a.to(dt).contiguous()
    w = w.to(dt).contiguous()
    if scalars is not None:
        scalars = scalars.to(device=a.device, dtype=torch.float32).contiguous()
        if scalars.numel() != 5:
            raise ValueError("scalars must hold 5 values")
    elif quantize:
        raise ValueError("quantize=True needs the (5,) scalars")
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = build()
    err = lib.potq_matmul_launch(
        a.data_ptr(), w.data_ptr(),
        scalars.data_ptr() if scalars is not None else None,
        out.data_ptr(), m, n, k, emax_a, emax_w, int(quantize),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"potq_matmul kernel launch failed: CUDA error {err}")
    potq_matmul_cuda.launches += 1
    return out


#: kernel launches since the last reset (the caller sets it to 0)
potq_matmul_cuda.launches = 0
