"""The int8 PoT wire format: the gradient compressor, its decoder and the
KV-page wire format (port of ``repro/core/compress.py``).

Code layout (int8): 0 means an exact zero; otherwise
    code = (exp + emax + 1) * (-1 if negative else +1),  |code| in [1, 2*emax+1],
and the value is ``sign * 2^(exp + beta)`` under one int32 beta per
tensor.  ``ops.potq_encode`` (K4) produces it with nearest rounding.

Gradient compression (beyond the paper, as in the reference):
:func:`compress` encodes a gradient with **stochastic** log2 rounding
under a **conservative** beta (ceil: max|G| never saturates), so
E[decompress(compress(g))] = g elementwise, at one byte an element plus
the beta (:func:`wire_bytes`).  :func:`compressed_psum` is its collective
over a ``torch.distributed`` process group: all-reduce max of the amax
(so every rank has one beta), stochastic quantize, all-reduce sum of the
decoded values.  The reference declares ``QuantPolicy.stochastic_rounding``
and ``TrainConfig.grad_compression`` and reads neither; the port keeps
both refused and runs the compressor only where it is called.

KV pages (``serve/slots.py``, ``core.policy.KVQuantSpec``) use the same
code layout with three serving choices, each the reference's:

* the scale group is ONE written token's (kv_heads, head_dim) K or V
  vector, so a code never depends on the page, slot or batch it lands
  in (decode is bit-identical across page sizes, pool vs solo, and the
  decode / chunk / verify write paths);
* rounding is nearest, and the input is canonicalized through bf16 (solo
  admission encodes a bf16 mini cache, the step bodies fresh
  activations: both must give the same codes); a value that is
  subnormal after that is flushed to a zero of its own sign, as XLA
  flushes it in the reference, so it codes 0 and takes no part in the
  token's amax;
* beta is clamped to [emax-126, 127-emax] at encode and at decode, and
  |code| at decode, so stale or junk codes decode to *finite* values:
  attention multiplies masked rows by an exact 0, and 0 * inf is NaN.

Betas are stored page-shaped (one int32 per page position), so a page's
scales travel with it through copies on write and prefix sharing.  On a
model axis a rank holds only its K/V heads of a token, so the token's
amax is a max over the model ranks (:func:`kv_page_encode`'s ``group``)
and every rank stores the one beta a whole-head encode would.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import potq
from repro_torch.core.policy import KVQuantSpec
from repro_torch.parallel import collectives


def compress(g: torch.Tensor, generator: torch.Generator,
             bits: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a gradient to (int8 codes, int32 beta), unbiased: stochastic
    rounding drawn from ``generator`` under the conservative beta."""
    emax = potq.pot_emax(bits)
    beta = potq.compute_beta(g, bits, conservative=True)
    enc = potq.pot_encode(g, bits, beta, stochastic=True, generator=generator)
    mag = torch.where(enc.exp == potq.EXP_ZERO, torch.zeros_like(enc.exp, dtype=torch.int32),
                      enc.exp.to(torch.int32) + emax + 1)
    code = torch.where(enc.sign == 1, -mag, mag).to(torch.int8)
    return code, enc.beta


def compressed_psum(g: torch.Tensor, generator: torch.Generator, group,
                    bits: int = 5) -> torch.Tensor:
    """Quantize-then-sum over ``group`` (a process group; None: this rank
    alone): every rank quantizes its ``g`` under the beta of the global
    max|g| (conservative), stochastically from its own ``generator``, and
    the decoded values are summed (f32)."""
    from repro_torch.parallel import collectives

    emax = potq.pot_emax(bits)
    amax = collectives.all_reduce_max(g.abs().amax().to(torch.float32), group)
    beta = torch.where(amax > 0, potq.ceil_log2(amax) - emax,
                       torch.zeros((), dtype=torch.int32, device=g.device))
    q = potq.pot_quantize(g, bits, beta, stochastic=True, generator=generator)
    return collectives.all_reduce_sum(q, group)


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


# ---------------------------------------------------------------------------
# KV-cache page wire format
# ---------------------------------------------------------------------------

def _kv_beta_window(bits: int) -> Tuple[int, int]:
    emax = potq.pot_emax(bits)
    return emax - 126, 127 - emax


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack signed-nibble codes (|code| <= 7) pairwise along the last axis
    into uint8: ``codes[..., 2i]`` low nibble, ``codes[..., 2i+1]`` high."""
    if codes.shape[-1] % 2:
        raise ValueError(f"cannot nibble-pack odd last dim {codes.shape[-1]}")
    c = codes.to(torch.int32) & 0xF
    return ((c[..., 1::2] << 4) | c[..., 0::2]).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: int32 codes, sign-extended."""
    p = packed.to(torch.int32)
    pair = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    flat = pair.reshape(packed.shape[:-1] + (2 * packed.shape[-1],))
    return (flat ^ 8) - 8


def kv_code_width(spec: KVQuantSpec, head_dim: int) -> int:
    """Trailing extent of the code leaf for one token's head vector."""
    if spec.pack:
        if head_dim % 2:
            raise ValueError(
                f"nibble-packed KV cache requires an even head_dim, got {head_dim}")
        return head_dim // 2
    return head_dim


def kv_code_dtype(spec: KVQuantSpec) -> torch.dtype:
    return torch.uint8 if spec.pack else torch.int8


def kv_page_encode(f: torch.Tensor, spec: KVQuantSpec, group=None):
    """Encode K/V vectors ``f`` (..., kv_heads, head_dim).  Returns
    ``(codes, beta)``: codes (..., kv_heads, head_dim[/2]) and int32 beta
    (...,), one amax scale per written token.  ``group``: the model ranks
    that hold the token's other K/V heads; its amax is their max."""
    f = f.to(torch.bfloat16)
    f = torch.where(f.abs() < torch.finfo(torch.float32).tiny, f * 0, f)
    emax = potq.pot_emax(spec.bits)
    lo, hi = _kv_beta_window(spec.bits)
    amax = f.abs().to(torch.float32).amax(dim=(-2, -1), keepdim=True)
    beta = potq.beta_of_amax(collectives.all_reduce_max(amax, group),
                             spec.bits).clamp(lo, hi)
    enc = potq.pot_encode(f, spec.bits, beta)
    mag = torch.where(enc.exp == potq.EXP_ZERO, 0, enc.exp.to(torch.int32) + emax + 1)
    code = torch.where(enc.sign == 1, -mag, mag)
    if spec.pack:
        kv_code_width(spec, f.shape[-1])  # validates an even head_dim
        codes = pack_nibbles(code)
    else:
        codes = code.to(torch.int8)
    return codes, beta.reshape(beta.shape[:-2])


def kv_page_decode(codes: torch.Tensor, beta: torch.Tensor,
                   spec: KVQuantSpec) -> torch.Tensor:
    """Exact float32 PoT values of code leaves; ``beta`` has the shape of
    ``codes`` without its trailing (kv, hd) dims.  Junk codes and betas
    decode finite (the clamps above)."""
    emax = potq.pot_emax(spec.bits)
    lo, hi = _kv_beta_window(spec.bits)
    code = unpack_nibbles(codes) if spec.pack else codes.to(torch.int32)
    b = beta.to(torch.int32).clamp(lo, hi)[..., None, None]
    mag = code.abs().clamp(max=2 * emax + 1)
    exp = mag - (emax + 1) + b
    val = potq.exp2i(torch.where(mag == 0, 0, exp))
    val = torch.where(mag == 0, 0.0, val)
    return torch.where(code < 0, -val, val)


def kv_page_wire_bytes(spec: KVQuantSpec, page_size: int, kv_heads: int,
                       head_dim: int) -> int:
    """Bytes of ONE (layer, K-or-V) page: codes + one int32 beta a token."""
    return page_size * (kv_heads * kv_code_width(spec, head_dim) + 4)
