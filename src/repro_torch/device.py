"""Device resolution shared by the port's entry points.

The port runs on the card.  ``device=None`` means ``cuda``; with no CUDA
device that is an error, never a silent move to the CPU.  Callers that
want the CPU (the tests, the CPU half of ``chip_smoke.py``) ask for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda":
        # FP32 matmuls at full precision, as the reference's HIGHEST dots
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array or list as a tensor on ``device``.  To a card the
    copy is staged in pinned memory and issued ``non_blocking``, so the
    host does not wait for the work already queued on the stream (a
    pageable copy synchronizes the stream)."""
    t = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
