"""Logical-axis -> mesh-axis sharding rules (port of
``repro/parallel/sharding.py``).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
an axis name, or a tuple of axis names (the dim split over their
product).  The rules are the reference's:

* weights: ``embed`` over the data axes (``("pod", "data")`` multi-pod,
  ``("data",)`` otherwise), ``ffn``/``heads``/``kv``/``vocab`` over
  ``model``;
* MoE experts: the expert axis over ``model`` (EP) when the expert count
  divides it, otherwise the normal rules inside each expert (TP);
* activations and batches: batch over the data axes, sequence over
  ``model``;
* a dim that does not divide its axes falls back to replication, dim by
  dim.

These are the rules only; the runtime reads them through the validated
:class:`repro_torch.parallel.planner.ShardingPlan`, which also lists where
the port's runtime lays a tensor out otherwise (``plan.overrides``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.models import spec as pspec
from repro_torch.parallel import meshes


class Spec(tuple):
    """One entry per tensor dim: None | axis name | tuple of axis names.
    A tuple, so it compares equal to a plain tuple of the same entries;
    its own type, so tree walkers take it as a leaf."""

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in meshes.axis_names(mesh))


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in meshes.axis_names(mesh) else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = meshes.shape_dict(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def logical_rules(mesh) -> Dict:
    fa = fsdp_axes(mesh)
    ma = model_axis(mesh)
    return {
        "embed": fa if fa else None,
        "ffn": ma,
        "heads": ma,
        "kv": ma,
        "vocab": ma,
        "expert": None,  # resolved per tensor (EP vs TP) below
        "layer": None,
        "state": None,
        None: None,
    }


def spec_to_pspec(s: "pspec.ParamSpec", mesh) -> Spec:
    """One ParamSpec's spec under the baseline rules."""
    rules = logical_rules(mesh)
    ma = rules["ffn"]
    axes = list(s.axes)
    out = [None] * len(axes)
    used = set()

    if "expert" in axes and ma is not None:
        e_dim = s.shape[axes.index("expert")]
        if e_dim % _axis_size(mesh, ma) == 0:
            # EP: experts over 'model'; 'ffn' inside each expert replicated
            out[axes.index("expert")] = ma
            used.add(ma)
        # else: TP inside each expert through the normal 'ffn' rule below

    for i, name in enumerate(axes):
        if out[i] is not None or name == "expert":
            continue
        tgt = rules.get(name)
        if tgt is None:
            continue
        tgt_t = (tgt,) if isinstance(tgt, str) else tuple(tgt)
        if any(a in used for a in tgt_t):
            continue
        if s.shape[i] % _axis_size(mesh, tgt_t) != 0:
            continue  # ragged: replicate this dim
        out[i] = tgt_t[0] if len(tgt_t) == 1 else tgt_t
        used.update(tgt_t)
    return Spec(out)


def param_pspecs(specs_tree, mesh):
    """The spec tree mirroring a ParamSpec tree."""
    return pspec.tree_map(lambda s: spec_to_pspec(s, mesh), specs_tree)


# ---------------------------------------------------------------------------
# Activation / batch specs
# ---------------------------------------------------------------------------

def _maybe(dim: int, mesh, axes) -> Optional[Tuple[str, ...]]:
    if not axes:
        return None
    if dim % _axis_size(mesh, axes) != 0:
        return None
    return tuple(axes) if not isinstance(axes, str) else (axes,)


def batch_pspec(mesh, batch_dim: int, seq_dim: Optional[int], ndim: int, *,
                batch_size: int, seq_len: Optional[int]) -> Spec:
    """Spec of a (B, S, ...) activation or batch tensor."""
    fa = fsdp_axes(mesh)
    ma = model_axis(mesh)
    out = [None] * ndim
    b_axes = _maybe(batch_size, mesh, fa)
    if b_axes:
        out[batch_dim] = b_axes if len(b_axes) > 1 else b_axes[0]
    if seq_dim is not None and seq_len is not None and ma:
        s_axes = _maybe(seq_len, mesh, ma)
        if s_axes:
            out[seq_dim] = s_axes[0]
    return Spec(out)


def data_pspecs(mesh, batch_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Spec]:
    """Specs of a batch dict given as ``{name: shape}``:

    tokens/labels/mask (B, S): (data, model); frames (B, enc_seq, F) and
    patch_embeds (B, P, F): (data, None, None); anything else replicated.
    """
    out = {}
    for name, shape in batch_shapes.items():
        shape = tuple(shape)
        if name in ("tokens", "labels", "mask"):
            out[name] = batch_pspec(mesh, 0, 1, len(shape), batch_size=shape[0],
                                    seq_len=shape[1])
        elif name in ("frames", "patch_embeds"):
            out[name] = batch_pspec(mesh, 0, None, len(shape), batch_size=shape[0],
                                    seq_len=None)
        else:
            out[name] = Spec()
    return out


def cache_pspec(mesh, name: str, shape: Tuple[int, ...], *, pool: bool = False) -> Spec:
    """Spec of one decode-cache leaf, keyed on its name (the reference's
    ``cache_pspecs`` rules, ``repro/parallel/sharding.py:169``):

      k/v/ck/cv  (L,B,S,KV,hd) or (B,S,KV,hd): B -> data, S -> model
      conv       (L,B,W,C) or (B,W,C):         B -> data, C -> model
      ssm        (L,B,H,N,P):                  B -> data, H -> model
      lru        (B,C):                        B -> data, C -> model
      anything else (pos, len):                replicated

    ``pool=True`` (pool plans) adds: ``len`` (slots,) and ``table`` (slots,
    pages) slot axis -> data; ``k_beta``/``v_beta`` (L, pages, page) pages
    -> data; the paged k/v (L, pages, page, KV, hd) land on the 5-D rule
    (pages -> data, in-page position -> model).  Each dim falls back to
    replication where it does not divide; trailing replicated dims are
    trimmed (the canonical form)."""
    fa = fsdp_axes(mesh)
    ma = model_axis(mesh)
    mt = (ma,) if ma else ()
    nd = len(shape)

    def assign(dim_axes):
        out = [None] * nd
        for dim, axes in dim_axes:
            a = _maybe(shape[dim], mesh, axes)
            if a:
                out[dim] = a if len(a) > 1 else a[0]
        while out and out[-1] is None:
            out.pop()
        return Spec(out)

    if pool:
        if name == "len" and nd == 1:
            return assign([(0, fa)])
        if name == "table" and nd == 2:
            return assign([(0, fa)])
        if name in ("k_beta", "v_beta") and nd == 3:
            return assign([(1, fa)])
    if name in ("k", "v", "ck", "cv"):
        if nd == 5:
            return assign([(1, fa), (2, mt)])
        if nd == 4:
            return assign([(0, fa), (1, mt)])
    if name == "conv":
        if nd == 4:
            return assign([(1, fa), (3, mt)])
        if nd == 3:
            return assign([(0, fa), (2, mt)])
    if name == "ssm" and nd == 5:
        return assign([(1, fa), (2, mt)])
    if name == "lru" and nd == 2:
        return assign([(0, fa), (1, mt)])
    return Spec()


def cache_pspecs(mesh, cache_tree, *, pool: bool = False):
    """Specs of a decode cache tree (of tensors, meta tensors included),
    keyed on each leaf's last name; the tree's structure is kept."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)) and not isinstance(node, Spec):
            return type(node)(walk(v, key) for v in node)
        return cache_pspec(mesh, key, tuple(node.shape), pool=pool)

    return walk(cache_tree, None)
