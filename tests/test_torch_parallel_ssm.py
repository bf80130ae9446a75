"""mamba2-2.7b (the ssm family) of repro_torch on a sharded plan over two
gloo ranks on the CPU, at smoke width (2 SSD heads of 64, 1 a rank:
out_proj runs over the gathered y) and widened (d_model 256: 8 heads, 4 a
rank, so out_proj folds over a rank's 256 channels), against the port's
single rank and the reference's single-device ``PoolEngine``
(``tests/_parallel_recurrent.py`` runs the ranks).

No tolerance on tokens, counters, shards, first-step per-token losses or
quantizer scales: they are equal.  Gradients are sums of partial MAC
folds over ranks: within 1e-4 of a leaf's largest magnitude, and 3-step
losses within 1e-5 relative (ROADMAP's stated bounds).
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

import _parallel_recurrent as R  # noqa: E402

ARCH = "mamba2-2.7b"
NAMES = list(R.CONFIGS[ARCH])
CASES = [(name, mid) for name in NAMES for mid in R.MESHES]


@pytest.fixture(scope="module")
def world():
    return R.spawn_world(ARCH)


def _rank_plan(name, rank):
    from repro_torch import configs as TC
    from repro_torch.parallel import meshes, planner

    cfg = R.cfg_of(TC, ARCH, name)
    mesh = meshes.Mesh((1, 2), ("data", "model"), coords=(0, rank))
    return planner.plan_for(cfg, mesh, TC.ShapeConfig("s", R.MAX_LEN, R.SLOTS, "decode"),
                            pool_slots=R.SLOTS)


def test_layouts_fold_only_in_the_wide_variant():
    """At model = 2 the smoke config splits its 2 SSD heads and gathers y
    for out_proj (64 channels a rank); the widened one folds out_proj
    over a rank's 4 heads (256 channels); both split the vocabulary."""
    from repro_torch import configs as TC
    from repro_torch.parallel import planner

    for name, want in (("smoke", (True, 1, "gather")), ("wide", (True, 4, "fold"))):
        lay = planner.runtime_layout(R.cfg_of(TC, ARCH, name), 2)
        assert (lay.heads, lay.heads_local, lay.wo, lay.vocab) == want + (True,), name


@pytest.mark.parametrize("name,mesh", CASES)
def test_sharded_pool_equals_one_rank(world, name, mesh):
    """Tokens and every counter of the sharded slot-row pool equal the
    single-rank pool's on both ranks."""
    single_toks, single_stats, _ = world[0][(name, "single")]
    d, m = R.MESHES[mesh]
    for res in world:
        toks, stats, _ = res[(name, mesh)]
        assert toks == single_toks
        assert {f: stats[f] for f in R.STAT_FIELDS} == {
            f: single_stats[f] for f in R.STAT_FIELDS}
        assert (stats["data_shards"], stats["model_shards"]) == (d, m)
    assert single_stats["prefills"] == R.TRACE["n_requests"]


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_pool_equals_reference(world, name):
    """The port's single-rank pool against the reference's single-device
    pool on the same weights and requests: the same tokens and counters."""
    from repro_torch import configs as TC

    toks, stats, _ = world[0][(name, "single")]
    jtoks, jstats = R.reference(ARCH, name, R.requests(R.cfg_of(TC, ARCH, name), ARCH))
    assert toks == jtoks
    assert {f: stats[f] for f in R.STAT_FIELDS if f != "ttft_passes"} == {
        f: jstats[f] for f in R.STAT_FIELDS if f != "ttft_passes"}


@pytest.mark.parametrize("name,mesh", CASES)
def test_each_rank_holds_its_shards(world, name, mesh):
    """On (1, 2) each rank holds, leaf by leaf, its cut of the whole
    serving weights: in_proj its heads' z, x and dt columns and B and C
    whole (not a contiguous half), the conv its heads' x channels and B
    and C, A_log / D / dt_bias its heads, out_proj its rows where it
    folds, the embedding's and the head's vocabulary halves; out_norm
    whole; it steps its SSD heads.  On (2, 1) every leaf is whole."""
    single = world[0][(name, "single")][2]
    d, m = R.MESHES[mesh]
    split = 0
    for rank, res in enumerate(world):
        _, stats, held = res[(name, mesh)]
        nh = single["layers/A_log"].shape[1]
        assert stats["n_heads"] == (nh // m if m > 1 else 0)
        for path, whole in single.items():
            want = R.expected_shard(_rank_plan(name, rank), path, whole) if m > 1 else whole
            assert held[path].shape == want.shape and np.array_equal(held[path], want), path
            split += held[path].shape != whole.shape
        assert held["layers/out_norm/scale"].shape == single["layers/out_norm/scale"].shape
    if m > 1:
        # in_proj, conv_w, conv_b, A_log, D, dt_bias, embed, lm_head (+ out_proj folded)
        assert split == 2 * (8 + (name == "wide"))


@pytest.mark.parametrize("name", NAMES)
def test_folds_where_the_layout_says(world, name):
    """On (1, 2) out_proj folds once a layer a weight pass in the widened
    config (its K1 fold chained across the ranks) and never at smoke
    width (gathered)."""
    from repro_torch import configs as TC

    cfg = R.cfg_of(TC, ARCH, name)
    for res in world:
        stats = res[(name, "1x2")][1]
        assert stats["folds"] == R.folds_a_pass(cfg, name) * stats["weight_passes"]
        assert res[(name, "2x1")][1]["folds"] == 0


def test_ssd_runs_over_the_whole_head_count(world):
    """Under the (1, 2) plan a rank's SSD runs its heads among zeros of
    the whole head count and gives the whole SSD's output and final state
    for them, bit for bit."""
    for res in world:
        assert res["unit"]["equal"]
        (y, fin) = res["unit"]["shapes"]
        assert y[2] == fin[1] == 4


def test_dp_first_step_losses_and_scales(world):
    """The first step's per-token losses are one rank's bit for bit, and
    every quantizer scale equals one rank's, call by call; the masters
    split over the data ranks."""
    for res in world:
        tr = res["train"]
        ours, one = tr["token_losses"]
        assert ours.shape == one.shape == (R.BATCH // 2, R.SEQ)
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()
        s_dp, s_one = tr["scales"]
        assert len(s_dp) == len(s_one) > 0
        assert s_dp == s_one
        assert "layers/in_proj/w" in tr["split"]


def test_dp_gradients_and_losses_within_bound(world):
    for res in world:
        tr = res["train"]
        for name, (diff, top) in tr["grads"].items():
            assert diff <= R.GRAD_TOL * max(top, 1e-30), (name, diff, top)
        np.testing.assert_allclose(tr["dp_losses"], tr["one_losses"], rtol=R.LOSS_RTOL)
    assert world[0]["train"]["dp_losses"] == world[1]["train"]["dp_losses"]


def test_launch_train_mesh_2x1(world):
    """``launch.train --arch mamba2-2.7b --smoke --mesh 2x1`` trains
    data-parallel: both ranks report one loss a step, within 1e-5 of the
    one-rank CLI run's."""
    a, b = (res["train"] for res in world)
    assert a["cli_dp"] == b["cli_dp"] and len(a["cli_dp"]) == 2
    np.testing.assert_allclose(a["cli_dp"], a["cli_one"], rtol=R.LOSS_RTOL)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_smoke_entry_point_equals_reference(world, mesh):
    """``parallel.smoke.run_smoke`` (what ``python -m
    repro_torch.parallel.smoke --arch mamba2-2.7b --mesh DxM`` runs on
    each rank) on the reference's seed-0 weights gives the tokens and
    weight passes of the reference's single-device engine (2 slots, solo
    prefill, no pages) on the smoke requests, on both meshes."""
    from repro_torch import configs as TC
    from repro_torch.parallel import smoke

    ours = world[0][("smoke_cli", mesh)]
    assert world[1][("smoke_cli", mesh)] == ours
    assert ours["num_pages"] is None
    tokens, stats = R.reference(ARCH, "smoke_cli",
                                smoke.smoke_requests(TC.smoke_config(ARCH), 4))
    assert ours["tokens"] == tokens
    assert (ours["data_shards"], ours["model_shards"]) == R.MESHES[mesh]
    assert ours["weight_passes"] == stats["weight_passes"]
