"""Plain PyTorch versions of the kernels: the port's numeric spec
(port of ``repro/kernels/ref.py``).

The CUDA kernel (csrc/potq_matmul.cu) matches these bit for bit on the
same inputs, on the CPU and on the card.

Chunk partials.  K is cut into ``CANONICAL_BK``-wide chunks.  The spec's
partial of one chunk is the EXACT sum of its PoT products rounded once to
float32, and the partials are left-folded in float32 in ascending chunk
order — ``acc = ((p_0 + p_1) + p_2) + ...``.  fp64 computes the exact sum
in any order as long as the products of a chunk fit one 53-bit lattice:
one beta per row of A and one for all of W (the quantizer's groups) and
``2*emax_a + 2*emax_w + 8 <= 53`` (see :func:`check_exact_spread`).  The
reference's chunk partial follows the XLA backend's summation order
instead, so port and reference agree only within
``ceil(K/128) * eps_f32 * (|Aq| @ |Wq|)`` (docs/DESIGN_kernels.md §3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import potq
from repro_torch.core.potq import exp2i

# Width of one canonical K chunk of the fixed-order float32 reduction.
CANONICAL_BK = 128


def check_exact_spread(bits_a: int, bits_w: int) -> None:
    """Raise unless a 128-term chunk of PoT products is exact in fp64.

    Within one quantizer group the products 2^(ea+ew) span
    2*emax_a + 2*emax_w + 1 exponents; 128 of them add 7 bits of carry, so
    a chunk sum needs 2*emax_a + 2*emax_w + 8 significant bits.  This fits
    fp64's 53 for every pair up to 6 x 5 bits, not for 6 x 6.
    """
    need = 2 * potq.pot_emax(bits_a) + 2 * potq.pot_emax(bits_w) + 8
    if need > 53:
        raise ValueError(
            f"bits_a={bits_a}, bits_w={bits_w}: a chunk partial needs "
            f"{need} bits, more than fp64's 53; the exact-chunk MF-MAC "
            "supports bit-width pairs up to 6 x 5"
        )


def quantize_tile_ref(x: torch.Tensor, emax: int) -> torch.Tensor:
    """Round-to-nearest PoT quantization of an already-scaled tile: values
    in {0, ±2^e : e in [-emax, emax]}."""
    x = x.to(torch.float32)
    e = potq.round_log2(x.abs())
    under = (e < -emax) | (x == 0)
    q = torch.where(under, torch.zeros_like(x), exp2i(e.clamp(-emax, emax)))
    return torch.sign(x) * q


def pot_value_matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M,K)@(K,N) over PoT-valued operands (cast to bf16, as the kernel
    reads them): exact fp64 partial per canonical chunk, rounded once to
    f32, left-folded in f32 in ascending chunk order."""
    m, k = x.shape
    n = y.shape[1]
    xb = x.to(torch.bfloat16)
    yb = y.to(torch.bfloat16)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for c in range(0, k, CANONICAL_BK):
        part = xb[:, c:c + CANONICAL_BK].double() @ yb[c:c + CANONICAL_BK].double()
        out = out + part.float()
    return out


def potq_matmul_ref(
    a: torch.Tensor,
    w: torch.Tensor,
    *,
    bits_a: int = 5,
    bits_w: int = 5,
    w_mean: Optional[torch.Tensor] = None,
    clip_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Oracle for the fused quantize + matmul (K1, ``quantize=True``).

    a: (M, K) raw activations; w: (K, N) raw weights; w_mean: scalar WBC
    mean (None = no WBC); clip_t: scalar PRC threshold (None = no clip).
    """
    a = a.to(torch.float32)
    w = w.to(torch.float32)
    if clip_t is not None:
        a = torch.clamp(a, -clip_t, clip_t)
    if w_mean is not None:
        w = w - w_mean
    beta_a = potq.compute_beta(a, bits_a)
    beta_w = potq.compute_beta(w, bits_w)
    aq = quantize_tile_ref(a * exp2i(-beta_a), potq.pot_emax(bits_a))
    wq = quantize_tile_ref(w * exp2i(-beta_w), potq.pot_emax(bits_w))
    return pot_value_matmul_ref(aq, wq) * exp2i(beta_a + beta_w)
