"""Declarative parameter specs (port of ``repro/models/spec.py``).

Models declare their parameters as a nested tree of :class:`ParamSpec`
(shape + init std + logical axis names).  Parameters are nested dicts of
tensors with the reference's key names, and tuples where the reference
has them (the hybrid family's heterogeneous ``layers``); a leaf's flat
name joins its keys, and a tuple entry's index, with ``/``
(``layers/wq/w``, ``layers/2/wq/w``), as ``repro/ckpt/manager.py`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

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


def is_node(x) -> bool:
    """An inner node of a parameter tree: a dict, or a tuple or list."""
    return isinstance(x, (dict, tuple, list))


def children(tree) -> List[Tuple[str, object]]:
    """(key, child) pairs of a node in the order JAX flattens it: a dict's
    keys sorted, a tuple's or list's entries by index (key ``"0"``, ...)."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` of matching leaves of trees of one structure, as a tree of
    that structure (tuples stay tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(``/``-joined name, leaf) pairs of a nested tree, in the order JAX
    flattens it (dict keys sorted, tuple entries by index)."""
    for key, val in children(tree):
        name = f"{prefix}/{key}" if prefix else key
        if is_node(val):
            yield from named_leaves(val, name)
        else:
            yield name, val


def set_leaf(tree: dict, name: str, value) -> None:
    """Put ``value`` at the ``/``-joined ``name`` of a nested dict (a
    tuple's entries land under their index as a key: :func:`unflatten`
    turns such dicts back into tuples)."""
    *head, last = name.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _seq_nodes(tree):
    """Dicts whose keys are all indices (``"0"``, ``"1"``, ...) as tuples,
    the indices sorted as numbers (as strings ``"10"`` would sort before
    ``"2"``)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _seq_nodes(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"tuple node with indices {idx} is not 0..{len(idx) - 1}")
        return tuple(out[k] for k in idx)
    return out


def unflatten(pairs: Iterable[Tuple[str, object]]):
    """The nested tree of (``/``-joined name, leaf) pairs, the inverse of
    :func:`named_leaves`: index-keyed levels become tuples."""
    out: Dict = {}
    for name, value in pairs:
        set_leaf(out, name, value)
    return _seq_nodes(out)


def materialize(specs, generator: torch.Generator, *,
                transform: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
    """Initialize real parameters from a spec tree on ``generator``'s
    device (untruncated normal init, paper §7.1.1).

    ``transform(name, tensor)``, when given, is applied to each leaf right
    after it is drawn, so a caller can quantize leaf by leaf without ever
    holding the whole f32 tree."""
    device = generator.device

    def draw(name, s):
        if s.init == "zeros":
            x = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            x = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.init == "value":
            x = torch.full(s.shape, s.value, dtype=s.dtype, device=device)
        else:
            x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(s.std).to(s.dtype)
        return transform(name, x) if transform is not None else x

    return unflatten((name, draw(name, s)) for name, s in named_leaves(specs))


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in named_leaves(specs))


def params_from_numpy(tree: Mapping[str, np.ndarray], device) -> Dict:
    """Turn a reference parameter tree given as ``{name: numpy array}``
    (names ``/``-joined, e.g. ``layers/wq/w`` of shape (L, D, H*hd)) into
    the port's nested parameter tree on ``device`` (``layers/<i>/...``
    names make a tuple).  bf16 arrays (the reference's prequantized
    serving weights) stay bf16."""
    def one(arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":  # numpy has no native bf16
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # copy: arrays may be read-only
        return t.to(device)

    return unflatten((name, one(arr)) for name, arr in tree.items())
