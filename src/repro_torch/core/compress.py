"""Decoder of the int8 PoT wire format (port of ``repro/core/compress.py:47-58``).

Code layout (int8): 0 means an exact zero; otherwise
    code = (exp + emax + 1) * (-1 if negative else +1),  |code| in [1, 2*emax+1],
and the value is ``sign * 2^(exp + beta)`` under one int32 beta per
tensor.  ``ops.potq_encode`` (K4) produces it with nearest rounding; the
reference's stochastic ``compress`` (gradient compression) and its KV
page format come with their slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.core import potq


def decompress(code: torch.Tensor, beta: torch.Tensor, bits: int = 5) -> torch.Tensor:
    """Exact float32 values of int8 ``code`` under ``beta``."""
    emax = potq.pot_emax(bits)
    mag = code.to(torch.int32).abs()
    exp = mag - (emax + 1) + torch.as_tensor(beta, device=code.device).to(torch.int32)
    val = potq.exp2i(torch.where(mag == 0, torch.zeros_like(exp), exp))
    val = torch.where(mag == 0, torch.zeros_like(val), val)
    return torch.where(code < 0, -val, val)


def wire_bytes(g: torch.Tensor) -> int:
    """Bytes on the wire for one tensor: 1 per element + the scalar beta."""
    return int(g.numel()) + 4
