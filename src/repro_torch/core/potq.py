"""ALS-PoTQ: Adaptive Layer-wise Scaling Power-of-Two Quantization
(port of ``repro/core/potq.py``, nearest rounding).

* b-bit PoT numbers take values {0, ±2^emin, ..., ±2^emax} with
  emax = 2^(b-2) - 1 and emin = -emax.
* The layer-wise scale 2^beta, beta = round(log2(max|F|)) - emax.
* Rounding happens in the log2 domain (round-to-nearest), with underflow
  to zero below emin and saturation at emax.

Port numeric spec — ``round(log2 x)`` is taken from the float's own bits:
``m, e = frexp(x)`` (x = m·2^e, m in [0.5, 1)) and
``round(log2 x) = e - 1 + (m >= 0.70710683)``, the threshold being the
first float32 above √2/2 (bits 0x3F3504F4).  √2 is irrational, so there
are no ties.  frexp is exact (subnormals included) on the CPU and in the
CUDA kernel (``frexpf``), so both devices agree bit for bit.  The
reference's ``jnp.round(jnp.log2(x))`` disagrees with this rule on a few
mantissas just below √2·2^k (the "√2 band"); tests hold the port against
it bit for bit outside that band.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: First float32 above √2/2: mantissas at or above it round log2 up.
SQRT_HALF_UP_BITS = 0x3F3504F4
SQRT_HALF_UP = torch.tensor(SQRT_HALF_UP_BITS, dtype=torch.int32).view(
    torch.float32
).item()

#: exponent used for exact zeros (far below any -emax)
_ZERO_EXP = -(1 << 20)

EXP_ZERO = -128  # int8 sentinel for exact zero in the wire format


def pot_emax(bits: int) -> int:
    """Largest exponent representable by a ``bits``-bit PoT number."""
    if bits < 3:
        raise ValueError(f"PoT bit-width must be >= 3, got {bits}")
    return 2 ** (bits - 2) - 1


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """EXACT 2^e (float32) for integer-valued e in [-126, 127], built from
    the exponent bits (never exp(x·ln2))."""
    ei = torch.as_tensor(e).to(torch.int32)
    return ((ei + 127) << 23).view(torch.float32)


def round_log2(mag: torch.Tensor) -> torch.Tensor:
    """round(log2(mag)) as int32 for mag > 0 by the frexp rule above;
    mag == 0 maps to a very negative exponent."""
    m, e = torch.frexp(mag.to(torch.float32))
    r = e.to(torch.int32) - 1 + (m >= SQRT_HALF_UP).to(torch.int32)
    return torch.where(mag > 0, r, torch.full_like(r, _ZERO_EXP))


def compute_beta(f: torch.Tensor, bits: int, axes=None) -> torch.Tensor:
    """Layer-wise PoT scale exponent beta = round(log2(max|F|)) - emax
    (int32).  ``axes=None`` reduces over the whole tensor; otherwise the
    reduced axes are kept so the result broadcasts against ``f``.
    All-zero groups get beta = 0."""
    emax = pot_emax(bits)
    mag = f.abs().to(torch.float32)
    if axes is None:
        amax = mag.amax()
    else:
        amax = mag.amax(dim=tuple(axes), keepdim=True)
    beta = round_log2(amax) - emax
    return torch.where(amax > 0, beta, torch.zeros_like(beta))


def pot_quantize(f: torch.Tensor, bits: int,
                 beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize ``f`` to b-bit PoT with layer-wise PoT scaling
    (round to nearest).  Returns float32 values, each exact in bf16."""
    emax = pot_emax(bits)
    f = f.to(torch.float32)
    if beta is None:
        beta = compute_beta(f, bits)
    scale = exp2i(beta)
    scaled = f / scale
    e = round_log2(scaled.abs())
    underflow = e < -emax
    q = torch.where(underflow, torch.zeros_like(scaled),
                    exp2i(e.clamp(-emax, emax)))
    return torch.sign(scaled) * q * scale


class PotEncoded(NamedTuple):
    """Integer wire format: value = (-1)^sign * 2^(exp + beta), with
    ``exp == EXP_ZERO`` meaning 0."""

    sign: torch.Tensor  # int8, 0/1
    exp: torch.Tensor  # int8
    beta: torch.Tensor  # int32


def pot_encode(f: torch.Tensor, bits: int,
               beta: Optional[torch.Tensor] = None) -> PotEncoded:
    """Quantize ``f`` to the integer PoT wire format (sign, exp, beta)."""
    emax = pot_emax(bits)
    f = f.to(torch.float32)
    if beta is None:
        beta = compute_beta(f, bits)
    scaled = f / exp2i(beta)
    e = round_log2(scaled.abs())
    exp = e.clamp(-emax, emax).to(torch.int8)
    exp = torch.where(e < -emax, torch.full_like(exp, EXP_ZERO), exp)
    sign = (scaled < 0).to(torch.int8)
    return PotEncoded(sign=sign, exp=exp, beta=beta.to(torch.int32))


def pot_decode(enc: PotEncoded) -> torch.Tensor:
    """Inverse of :func:`pot_encode` — exact."""
    zero = enc.exp == EXP_ZERO
    e = torch.where(zero, torch.zeros_like(enc.beta),
                    enc.exp.to(torch.int32) + enc.beta)
    mag = torch.where(zero, torch.zeros(e.shape, dtype=torch.float32,
                                        device=e.device), exp2i(e))
    return torch.where(enc.sign == 1, -mag, mag)
