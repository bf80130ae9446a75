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
says so in ``overrides`` ({(kind, path): :class:`Override`}), for the
families the port runs on a plan (``PLAN_FAMILIES``: the decoder, dense
or MoE, the vlm on the decoder's backbone and the encoder-decoder; one
:func:`decoder_layout` for all three):

* a ``heads``/``kv`` output is split only at whole heads, and a
  contraction (``wo``, the MLP's and the shared expert's down
  projections; an encdec's ``wo``, ``co`` and ``wo2`` in both stacks)
  only at whole 128-wide chunks, so that the split product keeps K1's
  fold (``kernels/ref.py``); elsewhere that product is computed whole on
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
# The runtime layout on the model axis (the decoder, the vlm, the encdec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderLayout:
    """How the decoder's tensors sit on a model axis of ``model`` ranks
    (a vlm's backbone; an encdec's encoder and decoder stacks alike, its
    cross attention's ``cq``/``ck``/``cv``/``co`` as ``wq``/``wk``/``wv``/``wo``).
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
    the gathered hidden state), 'whole', or None for a dense decoder."""

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

    def kv_lo(self, r: int, cfg) -> int:
        """First global K/V head that model rank ``r`` keeps."""
        if self.kv == "split":
            return r * self.kv_local
        if self.kv == "select":
            rep = cfg.n_heads // cfg.kv_heads
            return (r * self.heads_local) // rep
        return 0


def decoder_layout(cfg, model: int) -> DecoderLayout:
    """The port's layout of ``cfg`` (a ``PLAN_FAMILIES`` config) on
    ``model`` ranks (see the module docstring): whole heads, whole
    128-chunks, a tied embedding whole, and the experts
    as the reference's rules place them (EP when the expert count divides
    ``model``, else TP when ``d_ff`` does)."""
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
    if heads:
        wo = "fold" if (hl * hd) % CANONICAL_BK == 0 else "gather"
    else:
        wo = "whole"
    ffn = model > 1 and cfg.d_ff % model == 0
    ffl = cfg.d_ff // model if ffn else cfg.d_ff
    if ffn:
        mlp_wo = "fold" if ffl % CANONICAL_BK == 0 else "gather"
    else:
        mlp_wo = "whole"
    vocab = model > 1 and cfg.vocab_padded % model == 0 and not tied_embedding(cfg)
    experts, el = None, 0
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        experts, el = ("EP", e // model) if model > 1 and e % model == 0 else (
            "TP" if ffn else "whole", e)
    return DecoderLayout(model, heads, hl, kv_mode, kvl, wo, ffn, ffl, mlp_wo, vocab,
                         experts, el)


#: the families the port runs on a sharded plan; ssm and hybrid need
#: layouts of their own (ROADMAP Queue 1)
PLAN_FAMILIES = ("decoder", "vlm", "encdec")


def runs_on_plan(cfg) -> bool:
    """Whether the port runs ``cfg``'s family on a sharded plan."""
    return cfg.family in PLAN_FAMILIES


def tied_embedding(cfg) -> bool:
    """The LM head is the token embedding (an encdec's always is)."""
    return cfg.tie_embeddings or cfg.family == "encdec"


def family_refusal(cfg, what: str) -> str:
    """Why ``what`` refuses ``cfg``'s family on a sharded plan."""
    return (f"{what} runs the decoder (dense or MoE), the vlm and the encdec on a sharded "
            f"plan; family {cfg.family!r} on a plan is not ported yet (ROADMAP Queue 1)")


#: the layer stacks of a parameter tree: the decoder's and the vlm's; an
#: encdec's encoder and decoder
_STACKS = ("layers", "enc_layers", "dec_layers")


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


_DOWN = ("contraction split only at whole 128-chunks: the MLP hidden state is "
         "all-gathered and the down projection computed whole")
_Q = "q heads split only at whole heads: n_heads % model != 0"
_KV = ("K/V heads split only at whole heads with the q heads: computed whole, each rank "
       "keeps the K/V heads its q heads read")
_WO = ("contraction split only at whole 128-chunks: the attention output is all-gathered "
       "and the output projection computed whole")
# keyed by a leaf's module within its layer stack (an encdec's cross
# attention's cq/ck/cv/co as wq/wk/wv/wo)
_WHY = {
    "embed": "the tied embedding stays whole: the head quantizes the whole table per "
             "tensor at every call (transformer.tied_head)",
    "wq": _Q, "cq": _Q, "wk": _KV, "wv": _KV, "ck": _KV, "cv": _KV, "wo": _WO, "co": _WO,
    "mlp/wo": _DOWN, "moe/shared/wo": _DOWN, "wo2": _DOWN,
    "moe/down": "TP inside each expert: K1's expert batch has no start to continue a fold, "
                "so the experts' hidden state is all-gathered and the down projection "
                "computed whole",
}
_CACHE_HEADS = {
    "k": "K/V heads on model (the reference: in-page positions), so attention stays on "
         "the rank",
    "ck": "cross K/V heads on model (the reference: the encoder's positions), so cross "
          "attention stays on the rank",
}
_CACHE_HEADS["v"], _CACHE_HEADS["cv"] = _CACHE_HEADS["k"], _CACHE_HEADS["ck"]


def _why(path: str) -> str:
    """The reason a param leaf the rules split over ``model`` runs whole."""
    mod = path[:-2] if path.endswith("/w") else path
    stack, _, leaf = mod.partition("/")
    return _WHY.get(leaf if stack in _STACKS else mod, "computed whole on each rank")


def _overrides(cfg, mesh, params, cache, pool: bool) -> Dict[Tuple[str, str], Override]:
    """The runtime's departures from the reference's specs."""
    if not runs_on_plan(cfg):
        return {}
    shape = meshes.shape_dict(mesh)
    ma = shd.model_axis(mesh)
    m = shape.get("model", 1)
    fa = shd.fsdp_axes(mesh)
    dsz = shd._axis_size(mesh, fa)
    lay = decoder_layout(cfg, m)
    out: Dict[Tuple[str, str], Override] = {}
    for path, spec in _named(params):
        entries = list(spec)
        want = list(entries)
        reasons = []
        if m > 1:
            split = _decoder_param_layout(lay, path)
            for i, e in enumerate(entries):
                if ma in _entry_axes(e) and i != split:
                    want[i] = None
                    reasons.append(_why(path))
            if split is not None and ma not in _entry_axes(entries[split]):
                raise ShardingPlanError(f"param {path}: the runtime splits dim {split} "
                                        f"over model, the rules do not")
        if pool and dsz > 1:
            for i, e in enumerate(want):
                if any(a in fa for a in _entry_axes(e)):
                    want[i] = None
                    reasons.append("serving holds weights whole across the data axis")
        if want != entries:
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
            if m > 1 and key in _CACHE_HEADS:
                want = [None if e == ma else e for e in want]
                want += [None] * (4 - len(want))
                want[3] = ma
                reasons.append(_CACHE_HEADS[key])
            while want and want[-1] is None:
                want.pop()
            if want != entries:
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
        """The runtime's model-axis layout (``PLAN_FAMILIES`` only)."""
        if self.cfg is None:
            raise ShardingPlanError("a plan without a config has no runtime layout")
        if not runs_on_plan(self.cfg):
            raise ShardingPlanError(family_refusal(self.cfg, "ShardingPlan.layout"))
        return decoder_layout(self.cfg, self.model_shards)

    def local_config(self):
        """The config as one model rank runs it: its q heads and the K/V
        heads it keeps, in an encdec's encoder and cross attention too
        (the whole config at model 1; a MoE decoder keeps its global
        expert count, which routing reads)."""
        if self.model_shards == 1:
            return self.cfg
        lay = self.layout()
        return dataclasses.replace(self.cfg, n_heads=lay.heads_local, kv_heads=lay.kv_local)

    def model_split_dim(self, path: str) -> Optional[int]:
        """The dim of param leaf ``path`` the runtime splits over ``model``
        (None: whole on every model rank)."""
        if self.model_shards == 1:
            return None
        return _decoder_param_layout(self.layout(), path)

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

    def shard_slice(self, path: str) -> Optional[Tuple[int, int, int]]:
        """``(dim, start, length)`` of this model rank's shard of param leaf
        ``path`` along the dim the runtime splits (None: whole)."""
        dim = self.model_split_dim(path)
        if dim is None:
            return None
        n = self.param_shape(path)[dim] // self.model_shards
        return dim, self.mesh.coord("model") * n, n

    def shard_leaf(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """This model rank's shard of param leaf ``path`` (a contiguous
        copy), given whole; a leaf the runtime keeps whole, or one that
        already has the shard's shape, is returned as it is."""
        cut = self.shard_slice(path)
        if cut is None:
            return x
        dim, start, n = cut
        if x.shape[dim] == n:
            return x
        whole = self.param_shape(path)[dim]
        if x.shape[dim] != whole:
            raise ShardingPlanError(f"param {path}: dim {dim} is {x.shape[dim]}, neither "
                                    f"whole ({whole}) nor a shard ({n})")
        return x.narrow(dim, start, n).contiguous()

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
