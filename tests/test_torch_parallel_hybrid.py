"""recurrentgemma-2b (the hybrid family: RG-LRU blocks and windowed
attention, a tuple of per-layer parameter dicts) of repro_torch on a
sharded plan over two gloo ranks on the CPU, at smoke width (RG-LRU 96,
48 a rank; 2 q heads of 16 a rank; d_ff 64 a rank: wout, wo and the MLP's
down projection run over their gathered inputs) and widened (lru_width
256, d_ff 512, head_dim 64: wout, the down projection and wo fold over
128 and 256 channels a rank), against the port's single rank and the
reference's single-device ``PoolEngine`` (``tests/_parallel_recurrent.py``
runs the ranks).

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

ARCH = "recurrentgemma-2b"
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
    """At model = 2 the smoke config splits its RG-LRU channels (48 a
    rank), its 4 q heads (2 a rank, the one K/V head selected whole) and
    its MLP (64 a rank) and gathers the inputs of wout, wo and the down
    projection; the widened one folds all three; both split the
    vocabulary."""
    from repro_torch import configs as TC
    from repro_torch.parallel import planner

    for name, want in (("smoke", (48, "gather", 2, "select", "gather", 64, "gather")),
                       ("wide", (128, "fold", 2, "select", "fold", 256, "fold"))):
        lay = planner.runtime_layout(R.cfg_of(TC, ARCH, name), 2)
        assert lay.lru and lay.heads and lay.ffn and lay.vocab, name
        assert (lay.lru_local, lay.lru_wo, lay.heads_local, lay.kv, lay.wo, lay.ffn_local,
                lay.mlp_wo) == want, name


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


# the per-layer leaves a model rank holds a cut of, and their split dim,
# by layer kind (the widened config folds wout, wo and the MLP's down
# projection too); the vocabulary outside the layers
RGLRU_SPLIT = {"wx/w": 1, "wy/w": 1, "wa/w": 1, "wi/w": 1, "conv_w": 1, "conv_b": 0,
               "lam": 0, "mlp/wi_gate/w": 1, "mlp/wi_up/w": 1}
ATTN_SPLIT = {"wq/w": 1, "mlp/wi_gate/w": 1, "mlp/wi_up/w": 1}
FOLDED = {"wout/w": 0, "wo/w": 0, "mlp/wo/w": 0}


@pytest.mark.parametrize("name,mesh", CASES)
def test_each_rank_holds_its_shards(world, name, mesh):
    """On (1, 2) each rank holds, leaf by leaf, its cut of the whole
    serving weights: an RG-LRU layer's wx, wy, its gates' columns, its
    conv and ``lam`` by channel, a layer's q heads and MLP hidden slice,
    the contractions it folds, the vocabulary halves; wk/wv (one K/V head)
    and the norms whole; it steps its heads and RG-LRU channels.  On
    (2, 1) every leaf is whole."""
    from repro_torch import configs as TC
    from repro_torch.models import recurrent

    cfg = R.cfg_of(TC, ARCH, name)
    kinds = recurrent.layer_kinds(cfg)
    single = world[0][(name, "single")][2]
    d, m = R.MESHES[mesh]
    for rank, res in enumerate(world):
        _, stats, held = res[(name, mesh)]
        assert (stats["n_heads"], stats["lru_width"]) == (
            (cfg.n_heads // 2, cfg.lru_width // 2) if m > 1 else (cfg.n_heads, cfg.lru_width))
        plan = _rank_plan(name, rank)
        for path, whole in single.items():
            parts = path.split("/")
            leaf = "/".join(parts[2:])
            dim = None
            if parts[0] == "layers":
                rule = RGLRU_SPLIT if kinds[int(parts[1])] == "rglru" else ATTN_SPLIT
                dim = rule.get(leaf, FOLDED.get(leaf) if name == "wide" else None)
            elif path in ("embed", "lm_head/w"):
                dim = 0 if path == "embed" else 1
            if m == 1 or dim is None:
                assert held[path].shape == whole.shape and np.array_equal(held[path], whole), path
                continue
            assert plan.model_split_dim(path) == dim, path
            want = R.expected_shard(plan, path, whole)
            assert want.shape[dim] * 2 == whole.shape[dim], path
            assert held[path].shape == want.shape and np.array_equal(held[path], want), path


@pytest.mark.parametrize("name", NAMES)
def test_folds_where_the_layout_says(world, name):
    """On (1, 2) the widened config folds an RG-LRU layer's wout and an
    attention layer's wo, and every layer's MLP down projection, once a
    weight pass (K1's fold chained across the ranks); the smoke widths
    never fold (gathered)."""
    from repro_torch import configs as TC

    cfg = R.cfg_of(TC, ARCH, name)
    for res in world:
        stats = res[(name, "1x2")][1]
        assert stats["folds"] == R.folds_a_pass(cfg, name) * stats["weight_passes"]
        assert res[(name, "2x1")][1]["folds"] == 0


def test_gates_take_their_columns_over_the_gathered_conv(world):
    """Under the (1, 2) plan a rank's RG-LRU gates are the whole gates'
    columns of its channels, bit for bit, from its channels of the conv
    output (all-gathered) and its columns of wa and wi."""
    for res in world:
        assert res["unit"]["equal"]
        assert res["unit"]["shapes"] == ((2, 3, 128), (2, 3, 128))


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
        assert "layers/0/wx/w" in tr["split"] and "layers/2/wq/w" in tr["split"]


def test_dp_gradients_and_losses_within_bound(world):
    for res in world:
        tr = res["train"]
        for name, (diff, top) in tr["grads"].items():
            assert diff <= R.GRAD_TOL * max(top, 1e-30), (name, diff, top)
        np.testing.assert_allclose(tr["dp_losses"], tr["one_losses"], rtol=R.LOSS_RTOL)
    assert world[0]["train"]["dp_losses"] == world[1]["train"]["dp_losses"]


def test_launch_train_mesh_2x1(world):
    """``launch.train --arch recurrentgemma-2b --smoke --mesh 2x1`` trains
    data-parallel: both ranks report one loss a step, within 1e-5 of the
    one-rank CLI run's."""
    a, b = (res["train"] for res in world)
    assert a["cli_dp"] == b["cli_dp"] and len(a["cli_dp"]) == 2
    np.testing.assert_allclose(a["cli_dp"], a["cli_one"], rtol=R.LOSS_RTOL)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_smoke_entry_point_equals_reference(world, mesh):
    """``parallel.smoke.run_smoke`` (what ``python -m
    repro_torch.parallel.smoke --arch recurrentgemma-2b --mesh DxM`` runs on
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
