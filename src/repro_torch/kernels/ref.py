"""Plain PyTorch versions of the kernels: the port's numeric spec
(port of ``repro/kernels/ref.py``).

The CUDA kernels (csrc/potq_matmul.cu, csrc/potq_grad.cu) match these bit
for bit on the same inputs, on the CPU and on the card.

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

Backward (K2, K3).  G is quantized in the scaled domain — ``g * 2^-beta_g``
rounded to the nearest PoT with ``emax`` of ``bits_g`` (``bits_g_last``
into the LM head) — and dequantized once, by ``2^beta_g``, after the fold;
beta_g is one global exponent shared by dA and dW.  dA = Gq·Wq^T folds
over N and dW = Aq^T·Gq over M, each in the chunk scheme above, so both
pairs must pass :func:`check_exact_spread`; dW also needs all of Aq along
M on one lattice (one activation scale).  ``kernels/potq_grad.py``'s
``grad_da_plain`` and ``grad_dw_plain`` put these pieces together.

The PRC dgamma rows are sums of arbitrary f32 values, so their order is
part of the spec: inside each 128-wide K chunk a halves fold
(:func:`halves_fold`: ``x[..., :n/2] + x[..., n/2:]``, seven times, in
fp64, rounded once), then an f32 left fold over chunks in ascending
order.  The final (M,) -> scalar sum is the same halves fold over M
zero-padded to a power of two.  Elementwise fp64 adds give the same bits
on every device, and the kernel's 4-per-lane sum followed by a
``__shfl_xor`` butterfly performs exactly these adds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import potq
from repro_torch.core.potq import exp2i

# Width of one canonical K chunk of the fixed-order float32 reduction.
CANONICAL_BK = 128


def check_exact_spread(bits_x: int, bits_y: int) -> None:
    """Raise unless a 128-term chunk of products of two PoT operands, of
    ``bits_x`` and ``bits_y`` bits, is exact in fp64 (forward: A x W;
    backward: G x W for dA, A x G for dW).

    Within one quantizer group the products 2^(ex+ey) span
    2*emax_x + 2*emax_y + 1 exponents; 128 of them add 7 bits of carry, so
    a chunk sum needs 2*emax_x + 2*emax_y + 8 significant bits.  This fits
    fp64's 53 for every pair up to 6 x 5 bits, not for 6 x 6.
    """
    need = 2 * potq.pot_emax(bits_x) + 2 * potq.pot_emax(bits_y) + 8
    if need > 53:
        raise ValueError(
            f"bits {bits_x} x {bits_y}: a chunk partial needs "
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


def pot_value_matmul_ref(x: torch.Tensor, y: torch.Tensor,
                         start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,K)@(K,N) over PoT-valued operands (cast to bf16, as the kernel
    reads them): exact fp64 partial per canonical chunk, rounded once to
    f32, left-folded in f32 in ascending chunk order from ``start`` (an
    (M, N) running sum: a row-parallel product's previous ranks) or 0."""
    m, k = x.shape
    n = y.shape[1]
    xb = x.to(torch.bfloat16)
    yb = y.to(torch.bfloat16)
    out = (torch.zeros((m, n), dtype=torch.float32, device=x.device) if start is None
           else start.to(torch.float32).clone())
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


def halves_fold(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the spec's fixed order: zero-pad to a
    power of two, then ``x[..., :n/2] + x[..., n/2:]`` until one column is
    left, in fp64; the result is rounded once to float32."""
    x = x.to(torch.float64)
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0].to(torch.float32)


def grad_rowsum_ref(x: torch.Tensor, start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row sums of (M, K) in the spec's order: :func:`halves_fold` inside
    each 128-wide K chunk (zero-padded), then an f32 left fold over the
    chunks in ascending order, from ``start`` (an (M,) running sum: a
    row-parallel linear's previous ranks) or 0.  The numeric spec of K2's
    dgamma rows."""
    m, k = x.shape
    out = (torch.zeros((m,), dtype=torch.float32, device=x.device) if start is None
           else start.to(torch.float32).clone())
    for c in range(0, k, CANONICAL_BK):
        chunk = x[:, c:c + CANONICAL_BK]
        if chunk.shape[1] < CANONICAL_BK:
            chunk = torch.nn.functional.pad(chunk, (0, CANONICAL_BK - chunk.shape[1]))
        out = out + halves_fold(chunk)
    return out

