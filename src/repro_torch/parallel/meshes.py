"""Meshes (port of ``repro/parallel/meshes.py``).

A :class:`Mesh` is ``(sizes, names)``: an axis name per dimension and its
size, and nothing else.  It comes in two kinds:

* **abstract** (:func:`make_abstract_mesh`): no processes behind it.  The
  planner and its tests use it, and the TPU pod shapes (16, 16) and
  (2, 16, 16) exist only as such, for planning.
* **concrete** (:func:`make_mesh` and the helpers below): laid over the
  launched ``torch.distributed`` world, one process a mesh point, rank to
  coordinates row-major (rank = sum of coordinate x stride, the last axis
  fastest).  It carries this process's coordinates and, per axis, the
  process group of the ranks that differ from it only along that axis
  (``parallel/collectives.py``).

The serving and training meshes are ``("data", "model")``; the
multi-pod planning mesh prepends ``"pod"``, which composes with
``"data"`` for data parallelism (``parallel/sharding.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes and names; ``coords`` (this process's point) and
    ``groups`` (one process group per axis, None where the axis has size
    1) only on a concrete mesh."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def is_concrete(self) -> bool:
        return self.coords is not None

    def coord(self, axis: str) -> int:
        """This process's index along ``axis`` (0 on an abstract mesh)."""
        if self.coords is None or axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` (None: size 1, absent or abstract)."""
        if self.groups is None or axis not in self.axis_names:
            return None
        return self.groups[self.axis_names.index(axis)]


def axis_names(mesh) -> Tuple[str, ...]:
    """Axis names of a concrete or abstract mesh."""
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Tuple[int, ...]:
    """Axis sizes of a concrete or abstract mesh, in axis order."""
    return tuple(int(s) for s in mesh.axis_sizes)


def shape_dict(mesh) -> dict:
    """``{axis_name: size}`` for a concrete or abstract mesh."""
    return dict(zip(axis_names(mesh), axis_sizes(mesh)))


def _check(sizes, names) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    sizes = tuple(int(s) for s in sizes)
    names = tuple(str(n) for n in names)
    if len(sizes) != len(names):
        raise ValueError(f"axis count mismatch: sizes={sizes} names={names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"axis sizes must be >= 1: {sizes}")
    return sizes, names


def make_abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> Mesh:
    """A mesh with no processes behind it (planning only)."""
    return Mesh(*_check(sizes, names))


def coords_of(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` on a mesh of ``sizes``."""
    out = []
    for s in reversed(tuple(sizes)):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    """Inverse of :func:`coords_of`."""
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_mesh(sizes: Sequence[int], names: Sequence[str]) -> Mesh:
    """A concrete mesh over the launched ``torch.distributed`` world (or
    over this one process when no world is launched and the mesh has one
    point).  The world must have exactly ``prod(sizes)`` ranks."""
    sizes, names = _check(sizes, names)
    from repro_torch.parallel import collectives

    world, rank = collectives.world_size(), collectives.rank()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
                         f"processes, the launched world has {world}")
    coords = coords_of(rank, sizes)
    groups = tuple(collectives.axis_group(sizes, i) for i in range(len(sizes)))
    return Mesh(sizes, names, coords, groups)


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False) -> Mesh:
    """The planning topology: (16, 16) single-pod or (2, 16, 16) multi-pod.
    ``abstract=True`` returns a mesh without processes (what the planner
    and its tests use); otherwise the launched world must have 256 or 512
    ranks."""
    sizes, names = MULTI_POD if multi_pod else SINGLE_POD
    if abstract:
        return make_abstract_mesh(sizes, names)
    return make_mesh(sizes, names)


def make_host_mesh() -> Mesh:
    """The degenerate one-process mesh (1, world) the CPU tests use: every
    rule replicates at world size 1."""
    from repro_torch.parallel import collectives

    return make_mesh((1, collectives.world_size()), ("data", "model"))


def make_serving_mesh(*, data: Optional[int] = None, model: int = 1) -> Mesh:
    """``(data, model)`` mesh over the launched world for the sharded
    serving pool: slots over ``data``, weights over ``model``.  ``data``
    defaults to every rank not claimed by ``model``; without a launched
    world it is (1, 1)."""
    from repro_torch.parallel import collectives

    n = collectives.world_size()
    if model < 1 or n % model:
        raise ValueError(f"model={model} must divide the {n} launched ranks")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} ranks, have {n}")
    return make_mesh((data, model), ("data", "model"))


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r} is not of the form DxM (e.g. 2x1)") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {text!r}: both sizes must be >= 1")
    return d, m
