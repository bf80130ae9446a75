"""Declarative parameter specs (port of ``repro/models/spec.py``).

Models declare their parameters as a nested dict of :class:`ParamSpec`
(shape + init std + logical axis names).  Parameters are nested dicts of
tensors with the reference's key names; a leaf's flat name joins its keys
with ``/`` (``layers/wq/w``), as ``repro/ckpt/manager.py`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    std: float = 0.02
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'value'
    value: float = 0.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(``/``-joined name, leaf) pairs of a nested dict, in sorted key
    order (the order JAX flattens dicts in)."""
    for key in sorted(tree):
        name = f"{prefix}/{key}" if prefix else key
        val = tree[key]
        if isinstance(val, dict):
            yield from named_leaves(val, name)
        else:
            yield name, val


def set_leaf(tree: dict, name: str, value) -> None:
    """Put ``value`` at the ``/``-joined ``name`` of a nested dict."""
    *head, last = name.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def materialize(specs, generator: torch.Generator, *,
                transform: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
    """Initialize real parameters from a spec tree on ``generator``'s
    device (untruncated normal init, paper §7.1.1).

    ``transform(name, tensor)``, when given, is applied to each leaf right
    after it is drawn, so a caller can quantize leaf by leaf without ever
    holding the whole f32 tree."""
    device = generator.device
    out: Dict = {}
    for name, s in named_leaves(specs):
        if s.init == "zeros":
            x = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            x = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.init == "value":
            x = torch.full(s.shape, s.value, dtype=s.dtype, device=device)
        else:
            x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(s.std).to(s.dtype)
        set_leaf(out, name, transform(name, x) if transform is not None else x)
    return out


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in named_leaves(specs))


def params_from_numpy(tree: Mapping[str, np.ndarray], device) -> Dict:
    """Turn a reference parameter tree given as ``{name: numpy array}``
    (names ``/``-joined, e.g. ``layers/wq/w`` of shape (L, D, H*hd)) into
    the port's nested parameter dict on ``device``.  bf16 arrays (the
    reference's prequantized serving weights) stay bf16."""
    out: Dict = {}
    for name, arr in tree.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":  # numpy has no native bf16
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # copy: arrays may be read-only
        set_leaf(out, name, t.to(device))
    return out
