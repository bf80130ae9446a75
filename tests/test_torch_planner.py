"""The port's sharding planner (``repro_torch.parallel``) against the
reference's (``repro.parallel``), leaf by leaf, for every registered
config on the meshes (1,1), (2,1), (1,2), (2,2), (4,2) (data, model) and
the planning meshes (16,16) and (2,16,16): each param spec, each batch
spec, each cache spec (the lockstep cache of a decode shape; the slot
pool with its page geometry, plain and under ``KV_PINNED``), the MoE
EP/TP decisions, ``num_pages``' rounding, ``data_shards`` and
``model_shards``.  The same misconfigurations raise
``ShardingPlanError`` in both packages.

The port's runtime departs from the reference's specs in listed ways
only (``plan.overrides``; every family): whole heads / whole 128-chunks
(a product that would split elsewhere is computed whole on each rank;
under TP inside the experts, the experts' down projection), an encdec's
tied embedding whole, and the K/V stores' heads on ``model`` (the
reference puts in-page positions there; for an encdec's cross K/V
``ck``/``cv``, the encoder's positions); an ssm's packed ``in_proj`` and
conv cut at whole SSD heads (index sets) with its per-head leaves split;
a hybrid's RG-LRU gates split by column, its conv and ``lam`` by channel
and its one K/V head whole on every rank; and, in serving, weights,
tables and page stores whole on every data rank.  The tests pin these as
the only differences, with an independent statement of each rule."""
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as C  # noqa: E402
from repro.core.policy import KV_PINNED as J_KV_PINNED  # noqa: E402
from repro.parallel import meshes as jmeshes, planner as jplanner  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import KV_PINNED  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.parallel import meshes, planner  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": meshes.SINGLE_POD,
    "2x16x16": meshes.MULTI_POD,
}
SLOTS = 4
SEQ = 64


def _ref_path(path) -> str:
    """A reference keystr (``['layers'][0]['wq']``) as a ``/`` name."""
    parts = re.findall(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)", path)
    return "/".join(a or b or c for a, b, c in parts)


def _reports(plan, ref: bool):
    out = {}
    for rep in plan.report:
        path = _ref_path(rep.path) if ref and rep.kind != "data" else rep.path
        out[(rep.kind, path)] = (tuple(rep.shape), tuple(rep.spec))
    return out


def _plans(arch, mesh_id, shape, **kw):
    sizes, names = MESHES[mesh_id]
    tcfg, jcfg = TC.get_config(arch), C.get_config(arch)
    tp = planner.plan_for(tcfg, meshes.make_abstract_mesh(sizes, names),
                          shape and TC.ShapeConfig(*shape), **kw)
    if "kv_quant" in kw:
        kw["kv_quant"] = J_KV_PINNED
    jp = jplanner.plan_for(jcfg, jmeshes.make_abstract_mesh(sizes, names),
                           shape and C.ShapeConfig(*shape), **kw)
    return tcfg, tp, jp


CELLS = {
    "train": (("t", SEQ, 8, "train"), {}),
    "lockstep": (("d", SEQ, SLOTS, "decode"), {}),
    "pool": (("d", SEQ, SLOTS, "decode"), dict(pool_slots=SLOTS)),
    "pool_paged_kvq": (("d", SEQ, SLOTS, "decode"), dict(pool_slots=SLOTS, page_size=16,
                                                        kv_quant=KV_PINNED)),
}


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_plan_matches_reference(arch, mesh_id):
    for cell, (shape, kw) in CELLS.items():
        cfg = TC.get_config(arch)
        if "pool_slots" in kw and cfg.family not in ("decoder", "vlm", "encdec", "ssm",
                                                     "hybrid"):
            continue
        if "page_size" in kw and cfg.family not in ("decoder", "vlm", "encdec"):
            continue
        if "page_size" in kw and cfg.window is not None:
            kw = dict(kw, page_size=8 if cfg.window % 8 == 0 else None)
        _, tp, jp = _plans(arch, mesh_id, shape, **kw)
        ours, theirs = _reports(tp, False), _reports(jp, True)
        assert ours == theirs, (cell, sorted(set(ours.items()) ^ set(theirs.items()))[:6])
        assert {k: v for k, v in tp.moe.items()} == {_ref_path(k): v for k, v in jp.moe.items()}
        assert (tp.num_pages, tp.page_size, tp.kv_bits) == (jp.num_pages, jp.page_size,
                                                           jp.kv_bits), cell
        assert (tp.data_shards, tp.model_shards) == (jp.data_shards, jp.model_shards)
        assert tp.mesh_shape() == jp.mesh_shape()
        assert (tp.fsdp_size(), tp.model_size()) == (jp.fsdp_size(), jp.model_size())
        assert tuple(tp.token_pspec(SLOTS)) == tuple(jp.token_pspec(SLOTS))
        assert tuple(tp.activation_pspec(3, batch_size=8, seq_len=SEQ, seq_dim=1)) == tuple(
            jp.activation_pspec(3, batch_size=8, seq_len=SEQ, seq_dim=1))
        tp.validate()


def _data_overrides(plan):
    """Serving's leaves that the rules put on a data axis: whole on every
    data rank."""
    return ({("param", r.path) for r in plan.report
             if r.kind == "param" and any(a in ("pod", "data") for d in r.dims
                                          for a in d.axes)}
            | {("cache", r.path) for r in plan.report
               if r.kind == "cache" and any(a in ("pod", "data") for d in r.dims
                                            for a in d.axes)})


def _recurrent_overrides(cfg, plan, m):
    """An ssm's and a hybrid's model-axis departures, leaf by leaf."""
    from repro_torch.models import recurrent

    out = set()
    if m == 1:
        return out
    if cfg.family == "ssm":
        nh, n, di = cfg.d_inner // 64, cfg.ssm_state, cfg.d_inner
        if nh % m == 0:
            # packed columns and conv channels by index set, per-head leaves split
            out |= {("param", f"layers/{k}") for k in ("in_proj/w", "conv_w", "conv_b",
                                                       "A_log", "D", "dt_bias")}
            if (nh // m * 64) % 128:
                out.add(("param", "layers/out_proj/w"))  # gathered y, out_proj whole
            if plan.cache is not None:
                out.add(("cache", "conv"))
        else:
            if (2 * di + 2 * n + nh) % m == 0:
                out.add(("param", "layers/in_proj/w"))
            if di % m == 0:
                out.add(("param", "layers/out_proj/w"))
            if plan.cache is not None and (di + 2 * n) % m == 0:
                out.add(("cache", "conv"))
        return out
    nh, kv, hd, ff, lw = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff, cfg.lru_width
    whole_heads = nh % m == 0 and (kv % m == 0 or (nh // kv) % (nh // m) == 0
                                   or (nh // m) % (nh // kv) == 0)
    for i, kind in enumerate(recurrent.layer_kinds(cfg)):
        at = f"layers/{i}"
        if ff % m == 0 and (ff // m) % 128:
            out.add(("param", f"{at}/mlp/wo/w"))
        if kind == "attn":
            if not whole_heads and (nh * hd) % m == 0:
                out.add(("param", f"{at}/wq/w"))
            if not (whole_heads and kv % m == 0) and (kv * hd) % m == 0:
                out |= {("param", f"{at}/wk/w"), ("param", f"{at}/wv/w")}
            if (nh * hd) % m == 0 and not (whole_heads and (nh // m * hd) % 128 == 0):
                out.add(("param", f"{at}/wo/w"))
            if plan.cache is not None:  # the one K/V head whole, not ring positions
                out |= {("cache", f"{at}/k"), ("cache", f"{at}/v")}
        elif lw % m == 0:
            # gates by column, conv and lam by channel; wout gathered under a chunk
            out |= {("param", f"{at}/{k}") for k in ("wa/w", "wi/w", "conv_w", "conv_b",
                                                     "lam")}
            if (lw // m) % 128:
                out.add(("param", f"{at}/wout/w"))
    return out


def _expected_overrides(cfg, plan, pool: bool):
    """The runtime's departures, stated leaf by leaf from the rule."""
    shape = plan.mesh_shape()
    m = shape.get("model", 1)
    dsz = plan.data_shards
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_overrides(cfg, plan, m) | (
            _data_overrides(plan) if pool and dsz > 1 else set())
    nh, kv, hd, ff = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    encdec = cfg.family == "encdec"
    # an encdec's two stacks follow the decoder's rules, its cross
    # attention's cq/ck/cv/co as wq/wk/wv/wo; a MoE layer's shared expert
    # follows the MLP's rule
    stacks = ["enc_layers", "dec_layers"] if encdec else ["layers"]
    mlp_wo = "wo2" if encdec else "mlp/wo" if cfg.moe is None else "moe/shared/wo"
    whole_heads = nh % m == 0 and (kv % m == 0 or (nh // kv) % (nh // m) == 0
                                   or (nh // m) % (nh // kv) == 0)
    out = set()
    if m > 1:
        for st in stacks:
            cross = st == "dec_layers"
            if not whole_heads and (nh * hd) % m == 0:
                out |= {("param", f"{st}/{q}/w") for q in ("wq", "cq")[:1 + cross]}
            if not (whole_heads and kv % m == 0) and (kv * hd) % m == 0:
                out |= {("param", f"{st}/{w}/w")
                        for w in ("wk", "wv", "ck", "cv")[:2 + 2 * cross]}
            if (nh * hd) % m == 0 and not (whole_heads and (nh // m * hd) % 128 == 0):
                out |= {("param", f"{st}/{o}/w") for o in ("wo", "co")[:1 + cross]}
            if ff % m == 0 and (ff // m) % 128 and (cfg.moe is None or cfg.moe.shared_expert):
                out.add(("param", f"{st}/{mlp_wo}/w"))
        if cfg.moe is not None and cfg.moe.num_experts % m and ff % m == 0:
            # TP inside the experts: the down projection runs whole
            out.add(("param", "layers/moe/down/w"))
        if encdec and cfg.vocab_padded % m == 0:
            out.add(("param", "embed"))  # the tied embedding stays whole
        if plan.cache is not None:
            out |= {("cache", "k"), ("cache", "v")}
            if encdec:
                out |= {("cache", "ck"), ("cache", "cv")}
    if pool and dsz > 1:
        out |= _data_overrides(plan)
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b", "mistral-nemo-12b",
                                  "starcoder2-7b", "llama4-scout-17b-a16e", "grok-1-314b",
                                  "mamba2-2.7b", "recurrentgemma-2b", "internvl2-76b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("cell", ["train", "pool"])
def test_runtime_overrides_are_the_listed_ones(arch, mesh_id, cell):
    shape, kw = CELLS[cell]
    cfg, tp, _ = _plans(arch, mesh_id, shape, **kw)
    assert set(tp.overrides) == _expected_overrides(cfg, tp, "pool_slots" in kw)
    for (kind, path), ov in tp.overrides.items():
        assert ov.reason, (kind, path)
        if kind == "cache" and path in ("k", "v", "ck", "cv") and tp.model_shards > 1:
            assert len(ov.spec) == 4 and ov.spec[3] == "model"  # heads on model
        if (kind, path) == ("param", "embed") and cfg.family == "encdec" and (
                tp.model_shards > 1):
            assert "tied" in ov.reason
        if tp.model_shards > 1 and cfg.family in ("ssm", "hybrid"):
            leaf = path.split("/")[-1] if kind == "cache" else path.split("/")[-2 if (
                path.endswith("/w")) else -1]
            assert any(word in ov.reason for word in REASON_WORDS[leaf]), (kind, path,
                                                                            ov.reason)
    assert "[runtime]" in tp.summary() or not tp.overrides


# words the reason of each recurrent family's departure names (by leaf;
# a serving plan's data-axis reason as well)
_DATA_WORDS = ("data",)
REASON_WORDS = {
    "in_proj": ("B and C", "whole heads") + _DATA_WORDS,
    "conv_w": ("channels",) + _DATA_WORDS, "conv_b": ("channels",) + _DATA_WORDS,
    "A_log": ("SSD head",), "D": ("SSD head",), "dt_bias": ("SSD head",),
    "out_proj": ("128-chunks",) + _DATA_WORDS,
    "conv": ("B and C", "channels", "whole heads") + _DATA_WORDS,
    "ssm": ("whole heads",) + _DATA_WORDS, "len": _DATA_WORDS,
    "lru": ("channels",) + _DATA_WORDS, "pos": _DATA_WORDS,
    "wa": ("columns",), "wi": ("columns",), "lam": ("channel",),
    "wout": ("128-chunks",) + _DATA_WORDS, "wo": ("128-chunks",) + _DATA_WORDS,
    "wq": ("whole heads",) + _DATA_WORDS, "wk": ("K/V heads",) + _DATA_WORDS,
    "wv": ("K/V heads",) + _DATA_WORDS, "k": ("K/V heads whole",), "v": ("K/V heads whole",),
    "embed": _DATA_WORDS, "lm_head": _DATA_WORDS, "wx": _DATA_WORDS, "wy": _DATA_WORDS,
    "wi_gate": _DATA_WORDS, "wi_up": _DATA_WORDS, "scale": _DATA_WORDS,
}


def test_recurrent_layouts_at_published_widths():
    """mamba2-2.7b at model = 2: 80 SSD heads of 64, 40 a rank; in_proj's
    10576 packed columns (z 5120 | x 5120 | B 128 | C 128 | dt 80) give a
    rank its heads' z, x and dt columns and B and C whole, 5416 columns;
    the conv's 5376 channels 2816 a rank; out_proj folds over 2560 rows
    (20 chunks); the vocabulary 50688 splits 25344 a rank; the cache's
    conv is 2816 channels and its ssm states 40 heads a rank.
    recurrentgemma-2b: the RG-LRU's 2560 channels 1280 a rank (wout folds
    over 10 chunks), its MLP 3840 a rank (30 chunks, folds), 5 of the 10 q
    heads a rank and the one K/V head selected whole, wo folding over
    1280 rows (10 chunks), the vocabulary 256000 splitting 128000 a
    rank."""
    from repro_torch.models import registry

    cfg = TC.get_config("mamba2-2.7b")
    for r in range(2):
        mesh = meshes.Mesh((1, 2), ("data", "model"), coords=(0, r))
        plan = planner.plan_for(cfg, mesh, TC.ShapeConfig("s", 528, 4, "decode"),
                                pool_slots=4)
        lay = plan.layout()
        assert (lay.heads, lay.heads_local, lay.wo, lay.vocab) == (True, 40, "fold", True)
        assert plan.param_shape("layers/in_proj/w") == (64, 2560, 10576)
        # z | x | B and C (| dt, adjacent on rank 0)
        want = (((0, 2560), (5120, 2560), (10240, 256 + 40)) if r == 0 else
                ((2560, 2560), (7680, 2560 + 256), (10496 + 40, 40)))
        assert plan.shard_slice("layers/in_proj/w") == (2, want)
        assert sum(n for _, n in plan.shard_slice("layers/in_proj/w")[1]) == 5416
        assert plan.shard_slice("layers/conv_w") == (2, ((0, 2560), (5120, 256))
                                                     if r == 0 else ((2560, 2560 + 256),))
        assert plan.shard_slice("layers/out_proj/w") == (1, ((2560 * r, 2560),))
        assert plan.shard_slice("layers/A_log") == (1, ((40 * r, 40),))
        assert plan.shard_slice("embed") == (0, ((25344 * r, 25344),))
        assert plan.shard_slice("layers/out_norm/scale") is None
        lcfg = plan.local_config()
        pool = registry.init_pool_cache(lcfg, 4, 528, device="meta")
        assert tuple(pool["conv"].shape) == (64, 4, 3, 2816)
        assert tuple(pool["ssm"].shape) == (64, 4, 40, 128, 64)
    cfg = TC.get_config("recurrentgemma-2b")
    lay = planner.runtime_layout(cfg, 2)
    assert (lay.lru, lay.lru_local, lay.lru_wo, lay.ffn_local, lay.mlp_wo) == (
        True, 1280, "fold", 3840, "fold")
    assert (lay.heads_local, lay.kv, lay.kv_local, lay.wo, lay.vocab) == (
        5, "select", 1, "fold", True)
    plan = planner.plan_for(cfg, meshes.Mesh((1, 2), ("data", "model"), coords=(0, 1)),
                            TC.ShapeConfig("s", 256, 4, "decode"), pool_slots=4)
    assert plan.shard_slice("layers/0/wa/w") == (1, ((1280, 1280),))
    assert plan.shard_slice("layers/0/wout/w") == (0, ((1280, 1280),))
    assert plan.shard_slice("layers/2/wo/w") == (0, ((1280, 1280),))
    assert plan.shard_slice("layers/2/wk/w") is None
    assert plan.shard_slice("lm_head/w") == (1, ((128000, 128000),))
    lcfg = plan.local_config()
    assert (lcfg.n_heads, lcfg.kv_heads, lcfg.lru_width) == (5, 1, 1280)
    pool = registry.init_pool_cache(lcfg, 4, 256, device="meta")
    assert tuple(pool["layers"][0]["conv"].shape) == (4, 3, 1280)
    assert tuple(pool["layers"][0]["lru"].shape) == (4, 1280)
    assert tuple(pool["layers"][2]["k"].shape) == (4, 256, 1, 256)


def test_llama3_smoke_layout_names_the_fallbacks():
    """llama3-8b's smoke config (4 heads of 16, 1 KV head, d_ff 128) at
    model = 2: q heads split, wk/wv computed whole (the one KV head kept by
    both ranks), wo and the MLP's down projection all-gathered (32 and 64
    columns a rank, under a 128-chunk); the widened config (4 heads of 64,
    2 KV heads, d_ff 512) folds both."""
    import dataclasses

    cfg = TC.smoke_config("llama3-8b")
    lay = planner.decoder_layout(cfg, 2)
    assert (lay.heads, lay.heads_local, lay.kv, lay.kv_local, lay.wo, lay.ffn,
            lay.mlp_wo, lay.vocab) == (True, 2, "select", 1, "gather", True, "gather", True)
    wide = dataclasses.replace(cfg, d_ff=512, head_dim=64, kv_heads=2)
    lay = planner.decoder_layout(wide, 2)
    assert (lay.kv, lay.kv_local, lay.wo, lay.mlp_wo) == ("split", 1, "fold", "fold")
    full = planner.decoder_layout(TC.get_config("llama3-8b"), 2)
    assert (full.heads_local, full.kv, full.kv_local, full.wo, full.ffn_local,
            full.mlp_wo) == (16, "split", 4, "fold", 7168, "fold")
    plan = planner.plan_for(cfg, meshes.make_abstract_mesh((1, 2), ("data", "model")),
                            TC.ShapeConfig("s", 24, 2, "decode"), pool_slots=2)
    assert set(plan.overrides) == {("param", "layers/wk/w"), ("param", "layers/wv/w"),
                                   ("param", "layers/wo/w"), ("param", "layers/mlp/wo/w"),
                                   ("cache", "k"), ("cache", "v")}


def _raises_both(tcall, jcall):
    with pytest.raises(planner.ShardingPlanError) as te:
        tcall()
    with pytest.raises(jplanner.ShardingPlanError) as je:
        jcall()
    return str(te.value), str(je.value)


def test_pool_slots_must_equal_global_batch():
    tm = meshes.make_abstract_mesh((2, 1), ("data", "model"))
    jm = jmeshes.make_abstract_mesh((2, 1), ("data", "model"))
    t, j = _raises_both(
        lambda: planner.plan_for(TC.get_config("llama3-8b"), tm,
                                 TC.ShapeConfig("d", 32, 4, "decode"), pool_slots=2),
        lambda: jplanner.plan_for(C.get_config("llama3-8b"), jm,
                                  C.ShapeConfig("d", 32, 4, "decode"), pool_slots=2))
    assert t == j


@pytest.mark.parametrize("bad", ["ragged", "reuse", "unknown"])
def test_validate_refuses_the_same_leaves(bad):
    from jax.sharding import PartitionSpec as P

    spec, shape = {"ragged": (("model",), (3,)), "reuse": (("model", "model"), (4, 4)),
                   "unknown": (("pod",), (4,))}[bad]
    sizes, names = (2, 2), ("data", "model")
    trep = planner._analyze_leaf("param", "w", shape, spec)
    jrep = jplanner._analyze_leaf("param", "w", shape, P(*spec))
    kw = dict(params=None, data=None, cache=None, moe={})
    _raises_both(
        lambda: planner.ShardingPlan(mesh=meshes.make_abstract_mesh(sizes, names),
                                     report=(trep,), **kw).validate(),
        lambda: jplanner.ShardingPlan(mesh=jmeshes.make_abstract_mesh(sizes, names),
                                      report=(jrep,), **kw).validate())


def test_meshes_and_launch_reexport():
    m = launch_mesh.make_production_mesh(abstract=True)
    assert (meshes.axis_names(m), meshes.axis_sizes(m)) == (("data", "model"), (16, 16))
    m = meshes.make_production_mesh(multi_pod=True, abstract=True)
    assert meshes.shape_dict(m) == {"pod": 2, "data": 16, "model": 16}
    assert not m.is_concrete
    # no launched world: the host and serving meshes are one point
    assert meshes.shape_dict(launch_mesh.make_host_mesh()) == {"data": 1, "model": 1}
    assert meshes.shape_dict(meshes.make_serving_mesh()) == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        meshes.make_serving_mesh(model=2)
    assert [meshes.coords_of(r, (2, 3)) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert all(meshes.rank_of(meshes.coords_of(r, (2, 2, 3)), (2, 2, 3)) == r
               for r in range(12))
    assert launch_mesh.parse_mesh("2x1") == (2, 1)
    with pytest.raises(ValueError):
        launch_mesh.parse_mesh("2")


# smoke configs at model = 2, each with leaves split inside their matrices
# (heads, ffn, folded contractions; mamba2's packed in_proj by its index
# set), grok-1's experts along their stacked dim (EP)
QUANT_CONFIGS = {"llama3-8b": {}, "grok-1-314b": {},
                 "internvl2-76b": dict(head_dim=64, d_ff=512, kv_heads=2),
                 "whisper-large-v3": dict(head_dim=64, d_ff=512),
                 "mamba2-2.7b": dict(d_model=256),
                 "recurrentgemma-2b": dict(lru_width=256, d_ff=512, head_dim=64)}


def _rank_plan(arch, model_rank):
    import dataclasses

    cfg = dataclasses.replace(TC.smoke_config(arch), **QUANT_CONFIGS[arch])
    mesh = meshes.Mesh((1, 2), ("data", "model"), coords=(0, model_rank))
    return cfg, planner.plan_for(cfg, mesh, TC.ShapeConfig("s", 24, 2, "decode"), pool_slots=2)


@pytest.mark.parametrize("model_rank", [0, 1])
@pytest.mark.parametrize("arch", list(QUANT_CONFIGS))
def test_quantized_shard_is_the_shard_of_the_whole_quantized_leaf(arch, model_rank):
    """``quantize_leaf(..., plan)`` (a sharded engine's load) gives, leaf
    by leaf, this model rank's shard of the whole leaf's serving form
    bit for bit, without holding that whole form."""
    import torch

    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import quantized_weights as qw

    cfg, plan = _rank_plan(arch, model_rank)
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    cuts = {"inside": 0, "stacked": 0}
    for name, x in spec.named_leaves(params):
        got = qw.quantize_leaf(name, x, PAPER_FAITHFUL, plan)
        want = plan.shard_leaf(name, qw.quantize_leaf(name, x, PAPER_FAITHFUL))
        assert got.dtype == want.dtype and torch.equal(got, want), name
        cut = plan.shard_slice(name)
        if cut is not None and qw.is_linear_weight(name, x):
            cuts["inside" if cut[0] >= x.dim() - 2 else "stacked"] += 1
    assert cuts["inside"] > 0
    assert (cuts["stacked"] > 0) == (plan.layout().experts == "EP")


def test_quantized_shard_needs_the_whole_leaf():
    """A leaf split inside its matrices takes its WBC mean and scale from
    the whole matrix: given a shard, ``quantize_leaf(..., plan)`` raises."""
    import torch

    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.serve import quantized_weights as qw

    cfg, plan = _rank_plan("llama3-8b", 1)
    x = dict(spec.named_leaves(spec.materialize(registry.param_specs(cfg),
                                                torch.Generator().manual_seed(0))))
    name = "layers/wq/w"
    with pytest.raises(ValueError, match="quantized whole"):
        qw.quantize_leaf(name, plan.shard_leaf(name, x[name]), PAPER_FAITHFUL, plan)
