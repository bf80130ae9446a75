"""K1: the MF-MAC forward kernel, hand-written in CUDA for sm_90a.

Replaces the Pallas TPU kernel ``repro/kernels/potq_matmul.py``
``_potq_matmul_kernel`` (launcher ``potq_matmul_padded``) in both modes:
``quantize=False`` (PoT-valued bf16 operands — every ``mf_linear``
forward, 225 launches per llama3-8b weight pass and per olmo-1b training
step) and ``quantize=True`` (PRC clip, WBC shift, exact 2^-beta scaling
and nearest PoT rounding of raw f32 operands, by an elementwise pre-pass
that writes the scaled values as bf16, then the same product).  With
``quantize=False`` it also takes an expert batch, (E, M, K) @ (E, K, N)
in one launch, E of the products above side by side (the MoE experts).

Source: ``repro_torch/csrc/potq_matmul.cu`` — its header says what bounds
each path on an H100 and how each keeps the reduction exact and in order.
:func:`plan` picks the path from the shapes alone: the FP64 tensor cores
(``block_product`` of ``csrc/fp64_mma.cuh``, shared with K2/K3) above
``DECODE_MAX_M`` rows, a bandwidth-bound fp64 kernel on the CUDA cores at
or below it; where the grid is under two waves the chunks are split across
blocks into a scratch that a fold kernel adds in the spec's order.

Build: ``kernels/_build.py`` (nvcc for sm_90a into a shared library with a
plain C interface, at first use, into ``<checkout>/build/kernels/<hash>/``,
loaded with ``ctypes``).

Exactness precondition: operands come from the port's quantizer (one beta
per row of A, one for all of W) and the bit widths pass
``ref.check_exact_spread``.  Within it the kernel equals
:func:`potq_matmul_plain` bit for bit on every path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import CANONICAL_BK, pot_value_matmul_ref, quantize_tile_ref

#: Accumulation-scheme tag of the port: exact chunk partials, left fold.
ACC_SCHEME = "canonical-k128-exactchunk-leftfold-v1"

SOURCE = "potq_matmul.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "potq_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "potq_matmul_quantize_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _P],
}
#: rows of A up to which the decode kernel runs (above: the tensor cores)
DECODE_MAX_M = 32
#: output columns of one decode block, and the tensor cores' block tile
DECODE_COLS, TC_TILE = 256, 128
_KINDS = {"decode": 0, "tc": 1}

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
    ``[1, 1, 1, 0, inf]``.  An expert batch (E, M, K) @ (E, K, N) is one
    expert at a time."""
    if a.dim() == 3:
        if quantize:
            raise ValueError("quantize=True takes one (M, K) @ (K, N) product")
        return torch.stack([potq_matmul_plain(a[e], w[e], scalars) for e in range(a.shape[0])])
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


#: a tensor-core tile's fixed cost (ring fill, epilogue) in chunks of work
_TILE_OVERHEAD = 0.5


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, sms: int = 132, batch: int = 1) -> Tuple[str, int]:
    """``(path, groups)`` of ``batch`` (m, k) @ (k, n) products in one
    launch on a card of ``sms`` SMs: ``path`` is "decode" (m <=
    DECODE_MAX_M) or "tc"; ``groups`` > 1 splits the 128-wide chunks into
    that many ranges (scratch + fold).  Every expert of a batch takes the
    path one product of its shape would."""
    path = "decode" if m <= DECODE_MAX_M else "tc"
    return path, split_groups(path, m, n, k, sms, batch)


def split_groups(path: str, m: int, n: int, k: int, sms: int = 132, batch: int = 1) -> int:
    """Chunk ranges for ``path``; the grid holds ``batch`` times the warps
    or tiles of one product.

    Decode: a warp streams one strip of 256 columns for 8 rows of A; where
    the strips give fewer than three warps an SM, too few bytes are in
    flight, and every chunk becomes a task of its own (the LM head's 502
    strips run unsplit; ``tools/k1_path_sweep.py`` times each path and
    split on the card).  Under 4 chunks the fold's launch costs about what
    the split saves, so nothing is split.

    Tensor cores: a 128 x 128 tile fills an SM.  A grid of two waves or
    more runs unsplit; under that, the split whose waves finish soonest
    wins, a wave taking its ranges' chunks plus a tile's fixed cost, and a
    split must beat the best so far by 10% (the scratch's bytes and the
    fold are not in the model)."""
    nchunk = -(-k // CANONICAL_BK)
    if nchunk <= 1:
        return 1
    if path == "decode":
        warps = batch * -(-n // DECODE_COLS) * -(-m // 8)
        return nchunk if nchunk >= 4 and warps < 3 * sms else 1
    tiles = batch * -(-m // TC_TILE) * -(-n // TC_TILE)
    if tiles >= 2 * sms:
        return 1
    best, best_t = 1, None
    for g in range(1, nchunk + 1):
        per = -(-nchunk // g)
        if -(-nchunk // per) != g:
            continue  # the same ranges as a smaller g
        t = -(-tiles * g // sms) * (per + _TILE_OVERHEAD)
        if best_t is None or t < 0.9 * best_t:
            best, best_t = g, t
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def potq_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                     scalars: Optional[torch.Tensor] = None, *,
                     emax_a: int = 7, emax_w: int = 7,
                     quantize: bool = False) -> torch.Tensor:
    """Launch K1 on the tensors' CUDA device (PyTorch's current stream).

    ``quantize=False`` reads bf16 operands (f32 PoT values are cast, which
    is exact), (M, K) @ (K, N) or an expert batch (E, M, K) @ (E, K, N) ->
    (E, M, N) in one launch; each expert's W must then carry one beta and
    each row of its A one, so that the result equals E single launches
    bit for bit.  ``quantize=True`` reads raw f32 (M, K) @ (K, N)
    operands.  Raises on a bad device, shape or launch."""
    if a.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError("potq_matmul_cuda needs CUDA tensors")
    batched = a.dim() == 3
    if (a.dim() not in (2, 3) or w.dim() != a.dim() or a.shape[-1] != w.shape[-2]
            or a.shape[:-2] != w.shape[:-2] or (batched and quantize)):
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(w.shape)}"
                         f"{' with quantize=True' if quantize else ''}")
    dt = torch.float32 if quantize else torch.bfloat16
    a = a.to(dt).contiguous()
    w = w.to(dt).contiguous()
    if scalars is not None:
        scalars = scalars.to(device=a.device, dtype=torch.float32).contiguous()
        if scalars.numel() != 5:
            raise ValueError("scalars must hold 5 values")
    elif quantize:
        raise ValueError("quantize=True needs the (5,) scalars")
    e = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    n = w.shape[-1]
    dev = a.device
    path, groups = plan(m, n, k, _sm_count(dev.index), e)
    out = torch.empty((*a.shape[:-2], m, n), dtype=torch.float32, device=dev)
    part = None
    if groups > 1:
        part = torch.empty((-(-k // CANONICAL_BK), e, m, n), dtype=torch.float32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sp = scalars.data_ptr() if scalars is not None else None
    pp = part.data_ptr() if part is not None else None
    if quantize:
        aq = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
        wq = torch.empty((k, n), dtype=torch.bfloat16, device=dev)
        err = lib.potq_matmul_quantize_launch(
            a.data_ptr(), w.data_ptr(), sp, aq.data_ptr(), wq.data_ptr(), out.data_ptr(), pp,
            m, n, k, emax_a, emax_w, _KINDS[path], groups, stream)
    else:
        err = lib.potq_matmul_launch(a.data_ptr(), w.data_ptr(), sp, out.data_ptr(), pp,
                                     e, m, n, k, _KINDS[path], groups, stream)
    if err != 0:
        raise RuntimeError(f"potq_matmul kernel launch failed: CUDA error {err}")
    potq_matmul_cuda.launches += 1
    return out


#: kernel launches since the last reset (the caller sets it to 0); an
#: expert batch counts one
potq_matmul_cuda.launches = 0
