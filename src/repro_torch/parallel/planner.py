"""Sharding plans: one validated object per (config, mesh) (port of
``repro/parallel/planner.py``).

``parallel/sharding.py`` holds the logical-axis -> mesh-axis rules; this
module packages their output into a :class:`ShardingPlan`, the one
artifact that ``launch/train.py``, ``serve/engine.py``,
``parallel/actshard.py`` and ``parallel/smoke.py`` consume.  A plan is
validated on build:

* every dim of every param / batch / cache leaf divides its mesh axes or
  is replicated,
* no mesh axis is used twice within one spec,
* every MoE tensor carries an explicit EP / TP / replicated decision.

A misconfiguration fails at plan construction with a
:class:`ShardingPlanError` naming the leaf and the dim.

Leaf paths are the ``/``-joined names of ``repro/ckpt/manager.py``
(``layers/wq/w``, ``layers/2/attn/wq/w``); batch leaves are the batch
keys.  Abstract cache shapes come from ``registry.init_pool_cache`` /
``init_cache`` built on PyTorch's ``meta`` device (shapes, no memory).

``params``, ``data`` and ``cache`` are the reference's rules, spec for
spec.  Where the port's runtime lays a tensor out otherwise, the plan
says so in ``overrides`` ({(kind, path): :class:`Override`}), for every
family of the registry (:func:`runtime_layout`: the decoder, dense or
MoE, the vlm on the decoder's backbone and the encoder-decoder through
:func:`decoder_layout`; the ssm and the hybrid through their own fields
of the same layout):

* a ``heads``/``kv`` output is split only at whole heads, and a
  contraction (``wo``, the MLP's and the shared expert's down
  projections; an encdec's ``wo``, ``co`` and ``wo2`` in both stacks;
  an ssm's ``out_proj``, a hybrid's ``wout``) only at whole 128-wide
  chunks, so that the split product keeps K1's fold
  (``kernels/ref.py``); elsewhere that product is computed whole on
  each rank;
* the encdec's tied embedding stays whole on every model rank: the head
  (``transformer.tied_head``) quantizes the whole table per tensor at
  every call, so a vocab shard's own scale would not be the table's;
  ``frame_proj``, ``enc_pos``, a vlm's ``patch_proj`` and the norms are
  whole too (the rules split them over the data axes only);
* the experts follow the reference's decision (``moe``): EP keeps E/model
  whole experts a rank; under TP (the expert count does not divide
  ``model``) gate and up split over ``ffn`` and the down projection,
  whose contraction the rules split, runs whole over the all-gathered
  hidden state (K1's expert batch has no ``start`` to continue a fold);
* an ssm splits at whole SSD heads: ``in_proj`` packs z | x | B | C | dt
  along the dim the rules split in two halves, so a rank takes its
  heads' z, x and dt columns and the B and C columns whole, the conv its
  heads' x channels and B and C whole, ``A_log``/``D``/``dt_bias`` its
  heads (index sets, :meth:`ShardingPlan.shard_slice`); ``out_norm``
  stays whole (its mean runs over every channel, so y is all-gathered);
* a hybrid's RG-LRU gates ``wa``/``wi`` split their columns, not their
  contraction as the rules do: the conv output is all-gathered and each
  rank computes its own channels' gates whole, so no fold chains the
  ranks; the conv, ``lam`` and the state split by channel with ``wx``
  and ``wy``; its one K/V head stays whole on every rank (the rules put
  ring positions on ``model``);
* the paged K/V stores put their **heads** on ``model`` (the reference:
  in-page positions), and so do an encdec's cross K/V rows ``ck``/``cv``
  (the reference: the encoder's positions), so attention stays on the
  rank: a softmax split over positions would change its reduction order;
* in serving, weights are held whole across the data axis, and the
  table, ``len`` and page stores whole on every data rank; each data
  rank steps only its slots (``serve/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import CANONICAL_BK
from repro_torch.parallel import meshes, sharding as shd


class ShardingPlanError(ValueError):
    """A sharding plan failed validation (non-divisible dim, axis reuse,
    a geometry the pool cannot take)."""


@dataclasses.dataclass(frozen=True)
class DimDecision:
    """What the plan decided for one dim of one leaf."""

    dim: int
    size: int
    axes: Tuple[str, ...]  # () == replicated
    reason: str  # 'sharded' | 'replicated'


@dataclasses.dataclass(frozen=True)
class LeafReport:
    """Per-leaf record: where each dim went and why."""

    kind: str  # 'param' | 'data' | 'cache'
    path: str
    shape: Tuple[int, ...]
    spec: Tuple
    dims: Tuple[DimDecision, ...]


@dataclasses.dataclass(frozen=True)
class Override:
    """Where the port's runtime departs from the reference's spec for a
    leaf: the layout it uses instead (a spec of the same form) and why."""

    spec: Tuple
    reason: str


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _analyze_leaf(kind: str, path: str, shape, spec) -> LeafReport:
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    dims = tuple(DimDecision(i, int(size), _entry_axes(e),
                             "sharded" if _entry_axes(e) else "replicated")
                 for i, (size, e) in enumerate(zip(shape, entries)))
    return LeafReport(kind, path, tuple(int(s) for s in shape), tuple(spec), dims)


def _validate_leaf(rep: LeafReport, mesh_shape: dict):
    if len(rep.spec) > len(rep.shape):
        raise ShardingPlanError(
            f"{rep.kind} {rep.path}: spec {rep.spec} longer than shape {rep.shape}")
    used = set()
    for d in rep.dims:
        n = 1
        for a in d.axes:
            if a not in mesh_shape:
                raise ShardingPlanError(
                    f"{rep.kind} {rep.path} dim {d.dim}: unknown mesh axis {a!r} "
                    f"(mesh has {sorted(mesh_shape)})")
            if a in used:
                raise ShardingPlanError(
                    f"{rep.kind} {rep.path}: mesh axis {a!r} used twice in {rep.spec}")
            used.add(a)
            n *= mesh_shape[a]
        if d.size % n != 0:
            raise ShardingPlanError(
                f"{rep.kind} {rep.path} dim {d.dim}: size {d.size} not divisible "
                f"by {d.axes} (= {n}) on mesh {mesh_shape}")


def _named(tree, prefix=""):
    """(``/``-joined name, leaf) pairs of a nested dict/tuple tree, dict
    keys sorted (the order ``models/spec.named_leaves`` walks); a
    :class:`~repro_torch.parallel.sharding.Spec` is a leaf."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, shd.Spec):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _named(v, f"{prefix}/{k}" if prefix else k)
    return out


# ---------------------------------------------------------------------------
# The runtime layout on the model axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderLayout:
    """How a model's tensors sit on a model axis of ``model`` ranks: the
    decoder's (a vlm's backbone; an encdec's encoder and decoder stacks
    alike, its cross attention's ``cq``/``ck``/``cv``/``co`` as
    ``wq``/``wk``/``wv``/``wo``; a hybrid's attention and MLP layers).
    ``heads``: q heads split (``heads_local`` a rank); ``kv``: 'split'
    (K/V heads split with them), 'select' (wk/wv computed whole, each
    rank keeps the ``kv_local`` heads its q heads read) or 'whole'; ``wo``
    / ``mlp_wo``: 'fold' (row-parallel, K1's fold continued across ranks),
    'gather' (the input all-gathered, the product whole) or 'whole';
    ``ffn``: the MLP's (a MoE layer's shared expert's) hidden width split;
    ``vocab``: the embedding rows and the head's columns split (never
    for a tied embedding);
    ``experts`` (a MoE decoder): 'EP' (``experts_local`` whole experts a
    rank), 'TP' (gate and up split over ``ffn``, the down projection over
    the gathered hidden state), 'whole', or None for a dense decoder.

    An ssm's ``heads`` are its SSD heads (their z, x and dt columns of
    ``in_proj``, their conv channels and state; B and C whole on every
    rank) and ``wo`` its ``out_proj`` over the all-gathered, normed y.  A
    hybrid's ``lru``: its RG-LRU channels split (``lru_local`` a rank:
    ``wx``, ``wy``, the conv, the gates' columns, ``lam`` and the state),
    ``lru_wo``: ``wout``'s mode, as ``wo``'s."""

    model: int
    heads: bool
    heads_local: int
    kv: str
    kv_local: int
    wo: str
    ffn: bool
    ffn_local: int
    mlp_wo: str
    vocab: bool
    experts: Optional[str] = None
    experts_local: int = 0
    lru: bool = False
    lru_local: int = 0
    lru_wo: str = "whole"

    def kv_lo(self, r: int, cfg) -> int:
        """First global K/V head that model rank ``r`` keeps."""
        if self.kv == "split":
            return r * self.kv_local
        if self.kv == "select":
            rep = cfg.n_heads // cfg.kv_heads
            return (r * self.heads_local) // rep
        return 0


def _contraction(split: bool, width: int) -> str:
    """How a product whose contraction is a split of ``width`` columns a
    rank runs: a fold at whole 128-chunks, else over the gathered input."""
    if not split:
        return "whole"
    return "fold" if width % CANONICAL_BK == 0 else "gather"


def decoder_layout(cfg, model: int) -> DecoderLayout:
    """The port's layout of ``cfg`` (a decoder, vlm, encdec or a hybrid's
    attention and MLP) on ``model`` ranks (see the module docstring):
    whole heads, whole 128-chunks, a tied embedding whole, and the
    experts as the reference's rules place them (EP when the expert count
    divides ``model``, else TP when ``d_ff`` does)."""
    nh, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    heads = model > 1 and nh % model == 0
    hl = nh // model if heads else nh
    kv_mode, kvl = "whole", kv
    if heads:
        rep = nh // kv
        if kv % model == 0:
            kv_mode, kvl = "split", kv // model
        elif rep % hl == 0:
            kv_mode, kvl = "select", 1
        elif hl % rep == 0:
            kv_mode, kvl = "select", hl // rep
        else:
            heads, hl = False, nh
    wo = _contraction(heads, hl * hd)
    ffn = model > 1 and cfg.d_ff % model == 0
    ffl = cfg.d_ff // model if ffn else cfg.d_ff
    mlp_wo = _contraction(ffn, ffl)
    vocab = model > 1 and cfg.vocab_padded % model == 0 and not tied_embedding(cfg)
    experts, el = None, 0
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        experts, el = ("EP", e // model) if model > 1 and e % model == 0 else (
            "TP" if ffn else "whole", e)
    return DecoderLayout(model, heads, hl, kv_mode, kvl, wo, ffn, ffl, mlp_wo, vocab,
                         experts, el)


def runtime_layout(cfg, model: int) -> DecoderLayout:
    """The port's layout of ``cfg`` on ``model`` ranks, for every family:
    :func:`decoder_layout`; an ssm its SSD heads whole (80 of 64 at
    mamba2-2.7b: 40 a rank at ``model`` 2, ``out_proj`` folding over
    their 2560 channels) and its vocabulary; a hybrid its attention and
    MLP as a decoder's and its RG-LRU channels (2560 at recurrentgemma-2b:
    1280 a rank, ``wout`` folding)."""
    if cfg.family == "ssm":
        from repro_torch.models.ssm import HEADDIM

        nh = cfg.d_inner // HEADDIM
        heads = model > 1 and nh % model == 0
        hl = nh // model if heads else nh
        return DecoderLayout(model, heads, hl, "whole", 0, _contraction(heads, hl * HEADDIM),
                             False, 0, "whole",
                             model > 1 and cfg.vocab_padded % model == 0)
    lay = decoder_layout(cfg, model)
    if cfg.family != "hybrid":
        return lay
    lw = cfg.lru_width or cfg.d_model
    lru = model > 1 and lw % model == 0
    lwl = lw // model if lru else lw
    return dataclasses.replace(lay, lru=lru, lru_local=lwl, lru_wo=_contraction(lru, lwl))


def tied_embedding(cfg) -> bool:
    """The LM head is the token embedding (an encdec's always is)."""
    return cfg.tie_embeddings or cfg.family == "encdec"


#: the layer stacks of a parameter tree: the decoder's and the vlm's; an
#: encdec's encoder and decoder
_STACKS = ("layers", "enc_layers", "dec_layers")


def _module(path: str) -> str:
    """A param leaf's module within its layer stack (``layers/wq/w`` and a
    hybrid's ``layers/2/wq/w`` -> ``wq``; ``layers/conv_w`` -> ``conv_w``);
    a leaf outside the stacks as it is (``lm_head/w`` -> ``lm_head``)."""
    mod = path[:-2] if path.endswith("/w") else path
    stack, _, leaf = mod.partition("/")
    if stack not in _STACKS:
        return mod
    head, _, rest = leaf.partition("/")
    return rest if head.isdigit() else leaf


def _decoder_param_layout(lay: DecoderLayout, path: str) -> Optional[int]:
    """The runtime's model-axis split of one param leaf of the decoder,
    the vlm or the encdec (whose ``enc_layers``/``dec_layers`` stacks
    follow the decoder's rules leaf for leaf): the dim it splits over
    ``model`` (None: whole on each rank)."""
    ffn_in = (2, lay.ffn)
    heads, kv = (2, lay.heads), (2, lay.kv == "split")
    wo, mlp_wo = (1, lay.wo == "fold"), (1, lay.mlp_wo == "fold")
    expert_in = (1, True) if lay.experts == "EP" else (3, lay.experts == "TP")
    rules = {
        "embed": (0, lay.vocab),
        "lm_head/w": (1, lay.vocab),
        "layers/wq/w": heads,
        "layers/wk/w": kv,
        "layers/wv/w": kv,
        "layers/wo/w": wo,
        "layers/mlp/wi_gate/w": ffn_in,
        "layers/mlp/wi_up/w": ffn_in,
        "layers/mlp/wi/w": ffn_in,
        "layers/mlp/wo/w": mlp_wo,
        "layers/moe/gate/w": expert_in,
        "layers/moe/up/w": expert_in,
        "layers/moe/down/w": (1, lay.experts == "EP"),
        "layers/moe/shared/wi_gate/w": ffn_in,
        "layers/moe/shared/wi_up/w": ffn_in,
        "layers/moe/shared/wi/w": ffn_in,
        "layers/moe/shared/wo/w": mlp_wo,
    }
    stack, _, leaf = path.partition("/")
    if stack in _STACKS[1:]:
        rules = {"wq/w": heads, "wk/w": kv, "wv/w": kv, "wo/w": wo, "cq/w": heads,
                 "ck/w": kv, "cv/w": kv, "co/w": wo, "wi/w": ffn_in, "wo2/w": mlp_wo}
        path = leaf
    dim, split = rules.get(path, (None, False))
    return dim if split else None


def _recurrent_param_layout(cfg, lay: DecoderLayout, path: str):
    """The runtime's model-axis split of one param leaf of an ssm (stacked
    (L, ...) leaves) or a hybrid (per-layer ``layers/<i>/...`` leaves):
    ``(dim, segments)``, or None where the leaf is whole on each rank.
    ``segments`` lists the split dim as (offset, width, split) pieces in
    order (an ssm's packed in_proj and conv: a split piece gives each
    rank its 1/model of it, a whole one all of it); None is one split
    piece over the whole dim.  A gamma's or a norm's module (``in_proj/gamma``,
    ``norm/scale``) matches no rule."""
    mod = _module(path)
    if mod in ("embed", "lm_head"):
        return (0 if mod == "embed" else 1, None) if lay.vocab else None
    if cfg.family == "ssm":
        if mod == "out_proj":
            return (1, None) if lay.wo == "fold" else None
        di, n, nh = cfg.d_inner, cfg.ssm_state, lay.heads_local * lay.model
        conv = ((0, di, True), (di, 2 * n, False))
        rules = {"in_proj": (2, ((0, di, True), (di, di, True), (2 * di, 2 * n, False),
                                 (2 * di + 2 * n, nh, True))),
                 "conv_w": (2, conv), "conv_b": (1, conv), "A_log": (1, None),
                 "D": (1, None), "dt_bias": (1, None)}
        return rules.get(mod) if lay.heads else None
    rules = {"wq": (1, lay.heads), "wk": (1, lay.kv == "split"), "wv": (1, lay.kv == "split"),
             "wo": (0, lay.wo == "fold"), "mlp/wi_gate": (1, lay.ffn),
             "mlp/wi_up": (1, lay.ffn), "mlp/wo": (0, lay.mlp_wo == "fold"),
             "wx": (1, lay.lru), "wy": (1, lay.lru), "wa": (1, lay.lru), "wi": (1, lay.lru),
             "conv_w": (1, lay.lru), "conv_b": (0, lay.lru), "lam": (0, lay.lru),
             "wout": (0, lay.lru_wo == "fold")}
    dim, split = rules.get(mod, (None, False))
    return (dim, None) if split else None


def _param_split(cfg, lay: DecoderLayout, path: str):
    """``(dim, segments)`` of param leaf ``path`` on the model axis, or
    None where it is whole on each rank."""
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_param_layout(cfg, lay, path)
    dim = _decoder_param_layout(lay, path)
    return None if dim is None else (dim, None)


_DOWN = ("contraction split only at whole 128-chunks: the MLP hidden state is "
         "all-gathered and the down projection computed whole")
_Q = "q heads split only at whole heads: n_heads % model != 0"
_KV = ("K/V heads split only at whole heads with the q heads: computed whole, each rank "
       "keeps the K/V heads its q heads read")
_WO = ("contraction split only at whole 128-chunks: the attention output is all-gathered "
       "and the output projection computed whole")
_SSM_HEADS = "the SSD heads split only at whole heads: computed whole on each rank"
_LRU = "the RG-LRU's channels split only evenly: computed whole on each rank"
_GATES = ("the RG-LRU gates split their columns (the reference: their contraction): the conv "
          "output is all-gathered and each rank computes its own channels' gates whole, so "
          "no fold chains the ranks")
# keyed by a leaf's module within its layer stack (an encdec's cross
# attention's cq/ck/cv/co as wq/wk/wv/wo): why a dim the rules split over
# model runs whole
_WHY = {
    "embed": "the tied embedding stays whole: the head quantizes the whole table per "
             "tensor at every call (transformer.tied_head)",
    "wq": _Q, "cq": _Q, "wk": _KV, "wv": _KV, "ck": _KV, "cv": _KV, "wo": _WO, "co": _WO,
    "mlp/wo": _DOWN, "moe/shared/wo": _DOWN, "wo2": _DOWN,
    "moe/down": "TP inside each expert: K1's expert batch has no start to continue a fold, "
                "so the experts' hidden state is all-gathered and the down projection "
                "computed whole",
    "in_proj": _SSM_HEADS,
    "out_proj": ("contraction split only at whole 128-chunks: y, all-gathered for out_norm, "
                 "goes through out_proj whole"),
    "wx": _LRU, "wy": _LRU,
    "wa": _GATES, "wi": _GATES,
    "wout": ("contraction split only at whole 128-chunks: the RG-LRU output is all-gathered "
             "and wout computed whole"),
}
# why the runtime splits a dim that the rules keep whole
_SPLIT_WHY = {
    "conv_w": "per channel: this rank's conv channels (the reference keeps them whole)",
    "A_log": "per SSD head: this rank's heads (the reference keeps them whole)",
    "lam": "per RG-LRU channel: this rank's channels (the reference keeps them whole)",
    "wa": _GATES, "wi": _GATES,
}
_SPLIT_WHY["conv_b"] = _SPLIT_WHY["conv_w"]
_SPLIT_WHY["D"] = _SPLIT_WHY["dt_bias"] = _SPLIT_WHY["A_log"]
# why a split dim is an index set, not the rules' contiguous range
_PACKED_WHY = {
    "in_proj": "this rank's heads' z, x and dt columns and the B and C columns whole, not "
               "a contiguous half of the packed z|x|B|C|dt columns",
    "conv_w": "this rank's heads' x channels and the B and C channels whole",
    "conv": "this rank's heads' x channels and the B and C channels whole, not a contiguous "
            "half of the x|B|C channels",
}
_PACKED_WHY["conv_b"] = _PACKED_WHY["conv_w"]
_SPLIT_WHY["in_proj"] = _PACKED_WHY["in_proj"]
_CACHE_HEADS = {
    "k": "K/V heads on model (the reference: in-page positions), so attention stays on "
         "the rank",
    "ck": "cross K/V heads on model (the reference: the encoder's positions), so cross "
          "attention stays on the rank",
}
_CACHE_HEADS["v"], _CACHE_HEADS["cv"] = _CACHE_HEADS["k"], _CACHE_HEADS["ck"]
_RING_WHOLE = ("the K/V heads whole on every rank (the reference: ring positions on model), "
               "so attention stays on the rank")


def _why(path: str) -> str:
    """The reason a param leaf the rules split over ``model`` runs whole."""
    return _WHY.get(_module(path), "computed whole on each rank")


def _cache_model(cfg, lay: DecoderLayout, key: str, entries, ma):
    """The runtime's model-axis entries of one cache leaf (named ``key``)
    and the reasons, where they depart from the rules' ``entries``."""
    want, reasons = list(entries), []
    off = [None if e == ma else e for e in want]  # nothing on model
    if cfg.family == "ssm" and key in ("conv", "ssm"):
        if not lay.heads and off != want:
            want = off
            reasons.append(_SSM_HEADS)
        elif lay.heads and key == "conv":
            reasons.append(_PACKED_WHY["conv"])
    elif cfg.family == "hybrid" and key in ("k", "v", "conv", "lru"):
        if key in ("k", "v") and lay.kv == "split":
            want = off + [None] * (3 - len(off))
            want[2] = ma
            reasons.append(_CACHE_HEADS["k"])
        elif off != want and (key in ("k", "v") or not lay.lru):
            want = off
            reasons.append(_RING_WHOLE if key in ("k", "v") else _LRU)
    elif key in _CACHE_HEADS:
        want = off + [None] * (4 - len(off))
        want[3] = ma
        reasons.append(_CACHE_HEADS[key])
    return want, reasons


def _overrides(cfg, mesh, params, cache, pool: bool) -> Dict[Tuple[str, str], Override]:
    """The runtime's departures from the reference's specs."""
    shape = meshes.shape_dict(mesh)
    ma = shd.model_axis(mesh)
    m = shape.get("model", 1)
    fa = shd.fsdp_axes(mesh)
    dsz = shd._axis_size(mesh, fa)
    lay = runtime_layout(cfg, m)
    out: Dict[Tuple[str, str], Override] = {}
    for path, spec in _named(params):
        entries = list(spec)
        want = list(entries)
        reasons = []
        if m > 1:
            cut = _param_split(cfg, lay, path)
            split = None if cut is None else cut[0]
            for i, e in enumerate(entries):
                if ma in _entry_axes(e) and i != split:
                    want[i] = None
                    reasons.append(_why(path))
            if split is not None and ma not in _entry_axes(entries[split]):
                why = _SPLIT_WHY.get(_module(path))
                if why is None:
                    raise ShardingPlanError(f"param {path}: the runtime splits dim {split} "
                                            f"over model, the rules do not")
                want += [None] * (split + 1 - len(want))
                want[split] = ma
                reasons.append(why)
            if cut is not None and cut[1] is not None:
                reasons.append(_PACKED_WHY[_module(path)])
        if pool and dsz > 1:
            for i, e in enumerate(want):
                if any(a in fa for a in _entry_axes(e)):
                    want[i] = None
                    reasons.append("serving holds weights whole across the data axis")
        if want != entries or reasons:
            out[("param", path)] = Override(shd.Spec(want), "; ".join(dict.fromkeys(reasons)))
    if cache is not None:
        for path, spec in _named(cache):
            key = path.split("/")[-1]
            entries = list(spec)
            want = list(entries)
            reasons = []
            if pool and dsz > 1 and any(any(a in fa for a in _entry_axes(e)) for e in entries):
                want = [None if any(a in fa for a in _entry_axes(e)) else e for e in want]
                reasons.append("whole on every data rank; each data rank steps its own slots")
            if m > 1:
                want, why = _cache_model(cfg, lay, key, want, ma)
                reasons += why
            while want and want[-1] is None:
                want.pop()
            if want != entries or reasons:
                out[("cache", path)] = Override(shd.Spec(want), "; ".join(reasons))
    return out


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A validated plan for one (model config, mesh) pair."""

    mesh: Any  # meshes.Mesh, abstract or concrete
    params: Any  # spec tree mirroring registry.param_specs(cfg)
    data: Optional[Dict[str, Tuple]]  # batch-dict specs (built with a shape)
    cache: Optional[Any]  # decode-cache specs (prefill/decode shapes)
    moe: Dict[str, str]  # MoE leaf path -> 'EP' | 'TP' | 'replicated'
    report: Tuple[LeafReport, ...]
    shape: Optional[Any] = None
    cache_abstract: Optional[Any] = None  # meta-tensor tree behind `cache`
    specs: Optional[Any] = None  # the ParamSpec tree
    pool_slots: Optional[int] = None
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    kv_bits: Optional[int] = None
    data_shards: int = 1
    model_shards: int = 1
    cfg: Optional[Any] = None
    overrides: Dict = dataclasses.field(default_factory=dict)

    # -- activation helpers ------------------------------------------------
    def activation_pspec(self, ndim: int, *, batch_size: int,
                         seq_len: Optional[int] = None, batch_dim: int = 0,
                         seq_dim: Optional[int] = None) -> Tuple:
        """Spec of a (B, [S,] ...) activation under the plan's rules."""
        return shd.batch_pspec(self.mesh, batch_dim, seq_dim, ndim,
                               batch_size=batch_size, seq_len=seq_len)

    def token_pspec(self, batch_size: int) -> Tuple:
        return self.activation_pspec(1, batch_size=batch_size)

    def fsdp_size(self) -> int:
        return shd._axis_size(self.mesh, shd.fsdp_axes(self.mesh))

    def model_size(self) -> int:
        ma = shd.model_axis(self.mesh)
        return shd._axis_size(self.mesh, (ma,) if ma else None)

    def mesh_shape(self) -> dict:
        return meshes.shape_dict(self.mesh)

    def param_spec(self, path: str) -> Tuple:
        """The reference's spec of the param leaf at ``path``."""
        for rep in self.report:
            if rep.kind == "param" and rep.path == path:
                return rep.spec
        raise KeyError(path)

    def layout(self) -> DecoderLayout:
        """The runtime's model-axis layout (:func:`runtime_layout`)."""
        if self.cfg is None:
            raise ShardingPlanError("a plan without a config has no runtime layout")
        return runtime_layout(self.cfg, self.model_shards)

    def local_config(self):
        """The config as one model rank runs it: its q heads and the K/V
        heads it keeps, in an encdec's encoder and cross attention too; an
        ssm's SSD heads in ``n_heads`` (the whole ssm config's is 0); a
        hybrid's RG-LRU channels in ``lru_width`` (the whole config at
        model 1; a MoE decoder keeps its global expert count, which
        routing reads)."""
        if self.model_shards == 1:
            return self.cfg
        lay = self.layout()
        if self.cfg.family == "ssm":
            return dataclasses.replace(self.cfg, n_heads=lay.heads_local)
        cfg = dataclasses.replace(self.cfg, n_heads=lay.heads_local, kv_heads=lay.kv_local)
        if self.cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, lru_width=lay.lru_local)
        return cfg

    def model_split_dim(self, path: str) -> Optional[int]:
        """The dim of param leaf ``path`` the runtime splits over ``model``
        (None: whole on every model rank)."""
        cut = self.shard_slice(path)
        return None if cut is None else cut[0]

    def data_split_dim(self, path: str) -> Optional[int]:
        """The dim of param leaf ``path`` that the rules put over the data
        axes (training stores masters and optimizer state split there)."""
        if self.fsdp_size() == 1:
            return None
        fa = shd.fsdp_axes(self.mesh)
        for i, e in enumerate(self.param_spec(path)):
            if any(a in fa for a in _entry_axes(e)):
                return i
        return None

    def shard_segments(self, path: str, rank: Optional[int] = None):
        """``(dim, ((start, length, split), ...))``: model rank ``rank``'s
        (default this rank's) pieces of param leaf ``path`` along the dim
        the runtime splits, in order and unmerged, each marked split (its
        1/model of a segment) or whole on every rank (an ssm's B and C
        columns); None: the leaf is whole."""
        if self.model_shards == 1:
            return None
        cut = _param_split(self.cfg, self.layout(), path)
        if cut is None:
            return None
        dim, segments = cut
        m = self.model_shards
        r = self.mesh.coord("model") if rank is None else rank
        return dim, tuple((off + r * (width // m), width // m, True) if split
                          else (off, width, False)
                          for off, width, split in
                          segments or ((0, self.param_shape(path)[dim], True),))

    def shard_slice(self, path: str, rank: Optional[int] = None
                    ) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
        """``(dim, ((start, length), ...))``: model rank ``rank``'s (default
        this rank's) pieces of param leaf ``path`` along the dim the runtime
        splits, in order, adjacent ones merged (one piece, but for an ssm's
        packed ``in_proj`` and conv: its heads' z, x and dt columns and B
        and C whole; None: whole)."""
        seg = self.shard_segments(path, rank)
        if seg is None:
            return None
        dim, segments = seg
        pieces = []
        for start, n, _ in segments:
            if pieces and sum(pieces[-1]) == start:
                pieces[-1] = (pieces[-1][0], pieces[-1][1] + n)
            else:
                pieces.append((start, n))
        return dim, tuple(pieces)

    def model_cuts(self, path: str):
        """``(dim, (rank 0's pieces, rank 1's, ...))`` of param leaf
        ``path`` (:meth:`shard_slice` of every model rank), or None."""
        cut = self.shard_slice(path, 0)
        if cut is None:
            return None
        return cut[0], tuple(self.shard_slice(path, r)[1] for r in range(self.model_shards))

    @staticmethod
    def take(x: torch.Tensor, cut) -> torch.Tensor:
        """``x``'s pieces of a :meth:`shard_slice` cut (a contiguous copy)."""
        dim, pieces = cut
        if len(pieces) == 1:
            return x.narrow(dim, *pieces[0]).contiguous()
        return torch.cat([x.narrow(dim, start, n) for start, n in pieces], dim=dim)

    @staticmethod
    def untake(parts, cuts) -> torch.Tensor:
        """The inverse of :meth:`take` over every model rank: the whole
        tensor from each rank's shard ``parts[r]`` and ``cuts`` (a
        :meth:`model_cuts` pair).  A piece that several ranks hold (an
        ssm's B and C, the same on each) is taken from the first of them."""
        dim, per_rank = cuts
        if all(len(p) == 1 for p in per_rank) and all(
                per_rank[r][0][0] == sum(per_rank[r - 1][0]) for r in range(1, len(per_rank))):
            return torch.cat(parts, dim=dim)  # contiguous ranges in rank order
        shape = list(parts[0].shape)
        shape[dim] = max(start + n for pieces in per_rank for start, n in pieces)
        out = parts[0].new_empty(shape)
        # the last rank first, so that rank 0 writes a shared piece last
        for part, pieces in reversed(list(zip(parts, per_rank))):
            off = 0
            for start, n in pieces:
                out.narrow(dim, start, n).copy_(part.narrow(dim, off, n))
                off += n
        return out

    def shard_leaf(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """This model rank's shard of param leaf ``path`` (a contiguous
        copy), given whole; a leaf the runtime keeps whole, or one that
        already has the shard's shape, is returned as it is."""
        cut = self.shard_slice(path)
        if cut is None:
            return x
        dim, pieces = cut
        n = sum(length for _, length in pieces)
        if x.shape[dim] == n:
            return x
        whole = self.param_shape(path)[dim]
        if x.shape[dim] != whole:
            raise ShardingPlanError(f"param {path}: dim {dim} is {x.shape[dim]}, neither "
                                    f"whole ({whole}) nor a shard ({n})")
        return self.take(x, cut)

    def shard_params(self, params):
        """:meth:`shard_leaf` over a whole parameter tree."""
        from repro_torch.models.spec import named_leaves, unflatten

        return unflatten((n, self.shard_leaf(n, x)) for n, x in named_leaves(params))

    def param_shape(self, path: str) -> Tuple[int, ...]:
        for rep in self.report:
            if rep.kind == "param" and rep.path == path:
                return rep.shape
        raise KeyError(path)

    # -- introspection -------------------------------------------------------
    def validate(self) -> "ShardingPlan":
        mesh_shape = meshes.shape_dict(self.mesh)
        for rep in self.report:
            _validate_leaf(rep, mesh_shape)
        return self

    def summary(self) -> str:
        mesh_shape = meshes.shape_dict(self.mesh)
        lines = [f"ShardingPlan on mesh {mesh_shape}:"]
        for rep in self.report:
            lines.append(f"  [{rep.kind}] {rep.path} {rep.shape} -> {rep.spec}")
        for path, decision in sorted(self.moe.items()):
            lines.append(f"  [moe] {path}: {decision}")
        for (kind, path), ov in sorted(self.overrides.items()):
            lines.append(f"  [runtime] {kind} {path} -> {ov.spec}: {ov.reason}")
        return "\n".join(lines)


def _moe_decision(spec_axes, spec, mesh) -> Optional[str]:
    if "expert" not in spec_axes:
        return None
    ma = shd.model_axis(mesh)
    if ma is None:
        return "replicated"
    entries = tuple(spec)
    e_dim = spec_axes.index("expert")
    if e_dim < len(entries) and ma in _entry_axes(entries[e_dim]):
        return "EP"
    if any(ma in _entry_axes(e) for e in entries):
        return "TP"
    return "replicated"


def abstract_pool_cache(cfg, pool_slots: int, seq_len: int, *, page_size=None,
                        num_pages=None, kv_quant=None):
    """``registry.init_pool_cache`` on the meta device: the shapes alone."""
    from repro_torch.models import registry

    return registry.init_pool_cache(cfg, pool_slots, seq_len, device="meta",
                                    page_size=page_size, num_pages=num_pages,
                                    kv_quant=kv_quant)


def plan_for(cfg, mesh, shape=None, *, validate: bool = True,
             pool_slots: Optional[int] = None, page_size: Optional[int] = None,
             num_pages: Optional[int] = None, kv_quant=None) -> ShardingPlan:
    """Build (and by default validate) the plan for ``cfg`` on ``mesh``.

    ``shape`` (a ``ShapeConfig``) adds the batch dict's specs and, for a
    prefill or decode shape, the cache's.  ``pool_slots`` plans the slot
    pool of :class:`~repro_torch.serve.engine.PoolEngine` instead of the
    lockstep cache; it must equal ``shape.global_batch``.  For a paged
    family ``page_size`` defaults to the span and ``num_pages`` to
    ``pool_slots * span / page_size``, rounded up so that ``num_pages + 1``
    (the null page included) divides the data axes; an explicit
    ``num_pages`` is kept.  ``kv_quant`` keys the plan by the quantized-KV
    wire format.  ``plan.data_shards`` / ``model_shards`` are the data
    (pod x data) and model sizes of the mesh."""
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.models.spec import named_leaves

    specs = registry.param_specs(cfg)
    params = shd.param_pspecs(specs, mesh)

    report = []
    moe: Dict[str, str] = {}
    flat_p = dict(_named(params))
    for path, s in named_leaves(specs):
        p = flat_p[path]
        report.append(_analyze_leaf("param", path, s.shape, p))
        d = _moe_decision(s.axes, p, mesh)
        if d is not None:
            moe[path] = d

    data = cache = abstract_cache = None
    if shape is not None:
        batch_shapes = pipeline.batch_specs(cfg, shape)
        data = shd.data_pspecs(mesh, batch_shapes)
        for name, p in data.items():
            report.append(_analyze_leaf("data", name, batch_shapes[name], p))
        if getattr(shape, "kind", None) in ("prefill", "decode"):
            if pool_slots is not None:
                if pool_slots != shape.global_batch:
                    raise ShardingPlanError(
                        f"pool_slots={pool_slots} must equal the decode shape's "
                        f"global_batch={shape.global_batch}: the pool IS the decode batch")
                if cfg.family in registry.PAGED_FAMILIES:
                    span = registry.pool_span(cfg, shape.seq_len)
                    page_size = page_size or span
                    if num_pages is None:
                        num_pages = pool_slots * (span // page_size)
                        dsz = shd._axis_size(mesh, shd.fsdp_axes(mesh))
                        if dsz > 1 and (num_pages + 1) % dsz:
                            num_pages += dsz - (num_pages + 1) % dsz
                with torch.device("meta"):
                    abstract_cache = abstract_pool_cache(
                        cfg, pool_slots, shape.seq_len, page_size=page_size,
                        num_pages=num_pages, kv_quant=kv_quant)
            else:
                abstract_cache = registry.init_cache(cfg, shape.global_batch,
                                                     shape.seq_len, device="meta")
            cache = shd.cache_pspecs(mesh, abstract_cache, pool=pool_slots is not None)
            flat_cp = dict(_named(cache))
            for path, leaf in _named(abstract_cache):
                report.append(_analyze_leaf("cache", path, tuple(leaf.shape), flat_cp[path]))

    ma = shd.model_axis(mesh)
    plan = ShardingPlan(
        mesh=mesh, params=params, data=data, cache=cache, moe=moe, report=tuple(report),
        shape=shape, cache_abstract=abstract_cache, specs=specs, pool_slots=pool_slots,
        page_size=page_size, num_pages=num_pages,
        kv_bits=kv_quant.bits if kv_quant is not None else None,
        data_shards=shd._axis_size(mesh, shd.fsdp_axes(mesh)),
        model_shards=shd._axis_size(mesh, (ma,) if ma else None),
        cfg=cfg,
        overrides=_overrides(cfg, mesh, params, cache, pool_slots is not None),
    )
    if validate:
        plan.validate()
    return plan
