"""K4: the PoT encode kernel (f32 -> int8 wire codes), hand-written in CUDA
for sm_90a.

Replaces the Pallas TPU kernel ``repro/kernels/potq_encode.py``
``_encode_kernel`` (launcher ``potq_encode_padded``): one int8 code per
element under one layer-wise scale 2^-beta, in the layout of
``core/compress.py`` — 0 for zero, otherwise ``|code| = exp + emax + 1``
with the sign of the value.  The port runs it to pack trained weights
(``serve/quantized_weights.pack_int8`` through ``ops.potq_encode``).

Source: ``repro_torch/csrc/potq_encode.cu`` — a grid-stride pass of
float4 loads and 32-bit code stores, bound by bytes (5 per element).

Build: ``kernels/_build.py`` (nvcc for sm_90a into a shared library with a
plain C interface, at first use, into ``<checkout>/build/kernels/<hash>/``,
loaded with ``ctypes``).

The kernel takes beta (int32, on the device) rather than the scale
2^-beta: it forms the exponent of ``x * 2^-beta`` as ``frexp``'s exponent
minus beta, which is exact for every beta, also where 2^-beta is not a
normal float, and is the exponent of the product wherever that product is
exact.  The kernel equals :func:`potq_encode_plain` bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import potq
from repro_torch.kernels import _build

SOURCE = "potq_encode.cu"
_SIGNATURES = {
    "potq_encode_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
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


def potq_encode_plain(x: torch.Tensor, beta: torch.Tensor, *, emax: int = 7) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int8 codes of ``x`` (any shape)
    under the scale 2^-``beta`` (an int32 scalar).

    ``r = round_log2(|x|) - beta`` is the rounded exponent of
    ``x * 2^-beta`` (frexp rule, ``core/potq.py``); ``r < -emax`` — and
    ±0 and NaN, whose ``round_log2`` is far below any exponent — give 0;
    otherwise ``code = ±(min(r, emax) + emax + 1)`` with the sign of x;
    ±inf saturate to ``±(2*emax + 1)``."""
    x = x.to(torch.float32)
    beta = torch.as_tensor(beta, device=x.device).to(torch.int32)
    r = potq.round_log2(x.abs()) - beta
    code = torch.where(r < -emax, torch.zeros_like(r), r.clamp(max=emax) + (emax + 1))
    code = torch.where(torch.isinf(x), torch.full_like(code, 2 * emax + 1), code)
    return torch.where(x < 0, -code, code).to(torch.int8)


def potq_encode_cuda(x: torch.Tensor, beta: torch.Tensor, *, emax: int = 7) -> torch.Tensor:
    """Launch K4 on the tensor's CUDA device (PyTorch's current stream).
    ``x`` is read as float32 (cast and made contiguous when it is not);
    ``beta`` stays on the device.  Raises on a bad device or launch."""
    if x.device.type != "cuda":
        raise ValueError("potq_encode_cuda needs a CUDA tensor")
    x = x.to(torch.float32).contiguous()
    beta = torch.as_tensor(beta, device=x.device).to(torch.int32).contiguous()
    if beta.numel() != 1 or beta.device != x.device:
        raise ValueError("beta must be one int32 on the tensor's device")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = build()
    err = lib.potq_encode_launch(x.data_ptr(), out.data_ptr(), x.numel(), beta.data_ptr(),
                                 emax, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"potq_encode kernel launch failed: CUDA error {err}")
    potq_encode_cuda.launches += 1
    return out


#: kernel launches since the last reset (the caller sets it to 0)
potq_encode_cuda.launches = 0
