"""The port's sharding planner (``repro_torch.parallel``) against the
reference's (``repro.parallel``), leaf by leaf, for every registered
config on the meshes (1,1), (2,1), (1,2), (2,2), (4,2) (data, model) and
the planning meshes (16,16) and (2,16,16): each param spec, each batch
spec, each cache spec (the lockstep cache of a decode shape; the slot
pool with its page geometry, plain and under ``KV_PINNED``), the MoE
EP/TP decisions, ``num_pages``' rounding, ``data_shards`` and
``model_shards``.  The same misconfigurations raise
``ShardingPlanError`` in both packages.

The port's runtime departs from the reference's specs in two listed ways
only (``plan.overrides``, dense decoder): whole heads / whole 128-chunks
(a product that would split elsewhere is computed whole on each rank)
and the K/V stores' heads on ``model`` (the reference puts in-page
positions there); and, in serving, weights, tables and page stores whole
on every data rank.  The tests pin these as the only differences, with
an independent statement of each rule."""
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


def _expected_overrides(cfg, plan, pool: bool):
    """The runtime's departures, stated leaf by leaf from the rule."""
    shape = plan.mesh_shape()
    m = shape.get("model", 1)
    dsz = plan.data_shards
    if not (cfg.family == "decoder" and cfg.moe is None):
        return set()
    nh, kv, hd, ff = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    whole_heads = nh % m == 0 and (kv % m == 0 or (nh // kv) % (nh // m) == 0
                                   or (nh // m) % (nh // kv) == 0)
    out = set()
    if m > 1:
        if not whole_heads and (nh * hd) % m == 0:
            out.add(("param", "layers/wq/w"))
        if not (whole_heads and kv % m == 0) and (kv * hd) % m == 0:
            out |= {("param", "layers/wk/w"), ("param", "layers/wv/w")}
        if (nh * hd) % m == 0 and not (whole_heads and (nh // m * hd) % 128 == 0):
            out.add(("param", "layers/wo/w"))
        if ff % m == 0 and (ff // m) % 128:
            out.add(("param", "layers/mlp/wo/w"))
        if plan.cache is not None:
            out |= {("cache", "k"), ("cache", "v")}
    if pool and dsz > 1:
        out |= {("param", r.path) for r in plan.report
                if r.kind == "param" and any(a in ("pod", "data") for d in r.dims
                                             for a in d.axes)}
        out |= {("cache", r.path) for r in plan.report
                if r.kind == "cache" and any(a in ("pod", "data") for d in r.dims
                                             for a in d.axes)}
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b", "mistral-nemo-12b",
                                  "starcoder2-7b", "llama4-scout-17b-a16e", "mamba2-2.7b"])
@pytest.mark.parametrize("cell", ["train", "pool"])
def test_runtime_overrides_are_the_listed_ones(arch, mesh_id, cell):
    shape, kw = CELLS[cell]
    cfg, tp, _ = _plans(arch, mesh_id, shape, **kw)
    assert set(tp.overrides) == _expected_overrides(cfg, tp, "pool_slots" in kw)
    for (kind, path), ov in tp.overrides.items():
        assert ov.reason, (kind, path)
        if kind == "cache" and path in ("k", "v") and tp.model_shards > 1:
            assert len(ov.spec) == 4 and ov.spec[3] == "model"  # heads on model
    assert "[runtime]" in tp.summary() or not tp.overrides


def test_llama3_smoke_layout_names_the_fallbacks():
    """llama3-8b's smoke config (4 heads of 16, 1 KV head, d_ff 128) at
    model = 2: q heads split, wk/wv computed whole (the one KV head kept by
    both ranks), wo and the MLP's down projection all-gathered (32 and 64
    columns a rank, under a 128-chunk); the widened config (4 heads of 64,
    2 KV heads, d_ff 512) folds both."""
    import dataclasses

    cfg = TC.smoke_config("llama3-8b")
    lay = planner.dense_layout(cfg, 2)
    assert (lay.heads, lay.heads_local, lay.kv, lay.kv_local, lay.wo, lay.ffn,
            lay.mlp_wo, lay.vocab) == (True, 2, "select", 1, "gather", True, "gather", True)
    wide = dataclasses.replace(cfg, d_ff=512, head_dim=64, kv_heads=2)
    lay = planner.dense_layout(wide, 2)
    assert (lay.kv, lay.kv_local, lay.wo, lay.mlp_wo) == ("split", 1, "fold", "fold")
    full = planner.dense_layout(TC.get_config("llama3-8b"), 2)
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
