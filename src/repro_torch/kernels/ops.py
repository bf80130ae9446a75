"""Public wrappers around K1 (port of ``repro/kernels/ops.py:49-155``).

* :func:`potq_matmul`      — fused PRC-clip + WBC + ALS-PoTQ + matmul.
* :func:`pot_value_matmul` — matmul over already-PoT-valued operands (what
  ``core/mfmac.py`` calls on every quantized ``mf_linear`` forward).

Dispatch depends only on the operands' device: CUDA tensors launch the
hand-written kernel (``kernels/potq_matmul.py``) — a build or launch
failure raises, nothing falls back — and CPU tensors take the kernel's
plain PyTorch version.  The kernel masks its own ragged edges, so there is
no padding to block multiples, and there is no block-shape autotuning.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import potq
from repro_torch.kernels import ref
from repro_torch.kernels import potq_matmul as _k


def _launch(a, w, scalars, **kw) -> torch.Tensor:
    if a.device.type == "cuda":
        return _k.potq_matmul_cuda(a, w, scalars, **kw)
    if a.device.type == "cpu":
        return _k.potq_matmul_plain(a, w, scalars, **kw)
    raise ValueError(f"unsupported device {a.device}")


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
    clip_t = (torch.tensor(float("inf"), **f32) if clip_t is None
              else torch.as_tensor(clip_t).to(**f32))
    w_mean = (torch.tensor(0.0, **f32) if w_mean is None
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
                     bits_a: int = 5, bits_w: int = 5) -> torch.Tensor:
    """(M,K)@(K,N) over already-quantized (PoT-valued) operands.

    ``bits_a``/``bits_w`` are the widths the operands were quantized at;
    they only gate the exactness precondition (``ref.check_exact_spread``).
    """
    ref.check_exact_spread(bits_a, bits_w)
    return _launch(x, y, None, quantize=False)
