"""The MoE decoder of repro_torch on a sharded plan over two gloo ranks on
the CPU: llama4-scout-17b-a16e (4 experts top-1 + a shared expert) and
grok-1-314b (4 experts top-2, gelu) at smoke width, served through
``PoolEngine(plan=...)`` on the (1, 2) and (2, 1) (data, model) meshes and
trained data-parallel on (2, 1), against the port's single rank and the
reference's single-device ``PoolEngine`` under ``PAPER_FAITHFUL``, on the
same numpy weights (the reference's seed-0 draw, quantized for serving by
each engine).

* On (1, 2) both archs run EP (2 whole experts a rank): every rank routes
  the whole layer, runs its experts, and each token slot takes its output
  from the rank that owns its expert.  A 3-expert grok-1 (``grok3``) runs
  TP: gate and up split over the hidden width, the down projection over
  the all-gathered hidden state.
* On (2, 1) each data rank steps its own slots; a MoE layer dispatches
  per slot, so nothing crosses ranks.
* Data-parallel training: the dispatch groups are the global batch's
  (512 tokens of the 4 x 256 batch: one group a rank), and every expert's
  activation amax, PRC threshold and max|G| are global maxima.  The batch
  weights the second rank's rows 1/16 (``_skewed``), so a rank-local
  expert scale would show in the scales.

No tolerance on tokens, counters, first-step per-token losses or
quantizer scales: they are equal.  Gradients are sums of partial MAC
folds over ranks: within 1e-4 of a leaf's largest magnitude, and 3-step
losses within 1e-5 relative (ROADMAP's stated bounds).

One spawned world runs everything the ranks compute; the tests read its
results.
"""
import dataclasses
import importlib.util
import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

MAX_LEN = 24
SLOTS = 2
NUM_PAGES = SLOTS * (MAX_LEN // 8)
RECIPES = {"solo": dict(page_size=8), "chunked": dict(prefill_chunk=4, page_size=8)}
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
CONFIGS = {"llama4": ("llama4-scout-17b-a16e", None, MESHES),
           "grok": ("grok-1-314b", None, MESHES),
           "grok3": ("grok-1-314b", 3, {"1x2": (1, 2)})}
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum",
               "weight_passes", "ttft_passes", "prompt_tokens", "prefix_hit_tokens",
               "cow_copies", "evictions", "admission_deferrals", "pages_in_use_sum",
               "page_size", "kv_page_bytes")
TRAIN_ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
CLI_ARCH = "llama4-scout-17b-a16e"
SMOKE_PAGES = 3  # the smoke driver's 2 slots of one page, and a null page, split over 2
BATCH, SEQ, STEPS = 4, 256, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
EXPERT_LEAVES = ("layers/moe/gate/w", "layers/moe/up/w", "layers/moe/down/w")


def _cfg(pkg_configs, name):
    arch, experts, _ = CONFIGS[name]
    cfg = pkg_configs.smoke_config(arch)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

def _serve(cfg, params, recipe, mesh):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.parallel import meshes, planner
    from repro_torch.parallel.smoke import smoke_requests
    from repro_torch.serve import PoolEngine

    kw = RECIPES[recipe]
    plan = None
    if mesh is not None:
        plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                                TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"),
                                pool_slots=SLOTS, page_size=kw["page_size"],
                                num_pages=NUM_PAGES)
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                     num_pages=NUM_PAGES, plan=plan, device="cpu", **kw)
    out = eng.run(smoke_requests(cfg, 4))
    st = eng.last_stats
    stats = {f: getattr(st, f) for f in STAT_FIELDS}
    stats.update(data_shards=st.data_shards, model_shards=st.model_shards)
    from repro_torch.models import spec

    shapes = {n: tuple(x.shape) for n, x in spec.named_leaves(eng.params) if n in EXPERT_LEAVES}
    return {str(k): v.tolist() for k, v in out.items()}, stats, shapes


def _skewed(batch, vocab):
    """The pipeline's batch with the second half's token ids mirrored and
    its loss weights cut to 1/16 (as ``test_torch_parallel_train.py``)."""
    half = batch["tokens"].shape[0] // 2
    out = dict(batch)
    for key in ("tokens", "labels"):
        x = batch[key].clone()
        x[half:] = vocab - 1 - x[half:]
        out[key] = x
    out["mask"] = batch["mask"].clone()
    out["mask"][half:] *= 1.0 / 16
    return out


def _record_scales(fn):
    """(``fn()``, every quantizer scale it takes, in call order: each
    ``potq.pot_quantize``'s beta (weights, activations, the experts'
    per-expert ones) and each G's (``ops._g_scalars``, once per linear and
    once per expert))."""
    from repro_torch.core import potq
    from repro_torch.kernels import ops

    seen = []
    pq, gs = potq.pot_quantize, ops._g_scalars

    def pot_quantize(f, bits, beta=None, **kw):
        seen.append(("w/a", None if beta is None else beta.flatten().tolist()))
        return pq(f, bits, beta, **kw)

    def g_scalars(g, bits_g, beta_g, clip_t):
        seen.append(("g", beta_g.flatten().tolist()))
        return gs(g, bits_g, beta_g, clip_t)

    potq.pot_quantize, ops._g_scalars = pot_quantize, g_scalars
    try:
        out = fn()
    finally:
        potq.pot_quantize, ops._g_scalars = pq, gs
    return out, seen


def _train(rank, arch):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    cfg = TC.smoke_config(arch)
    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh((2, 1), ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    dp_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    dp = dp_step.data_parallel
    whole = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    shards = dp.shard(whole)
    batches = [_skewed(pipeline.make_batch(cfg, shape, s, device="cpu"), cfg.vocab)
               for s in range(STEPS)]
    rows = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
    (_, g), dp_scales = _record_scales(lambda: dp_step.grads(shards, batches[0]))
    (_, g1), one_scales = _record_scales(lambda: one_step.grads(whole, batches[0]))
    res = {"token_losses": (dp_step.token_losses(shards, batches[0]).numpy(),
                            one_step.token_losses(whole, batches[0])[rows].numpy()),
           "scales": (dp_scales, one_scales)}
    g = dp.gather(dp.reduce(g))
    res["grads"] = {n: (float((x - y).abs().max()), float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g), spec.named_leaves(g1))}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for s in range(STEPS):
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
        return losses

    # the updates run in place: each run starts from its own copy
    res["dp_losses"] = run(dp_step, dp.shard(spec.tree_map(torch.clone, whole)))
    res["one_losses"] = run(one_step, spec.tree_map(torch.clone, whole))
    try:  # 4 x 16 tokens: one group of 64 would straddle the two ranks
        small = pipeline.make_batch(cfg, TC.ShapeConfig("t", 16, BATCH, "train"), 0,
                                    device="cpu")
        dp_step.token_losses(shards, small)
        res["straddle"] = None
    except ValueError as e:
        res["straddle"] = str(e)
    if arch == CLI_ARCH:
        cli = ["--arch", arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
               "--steps", "2", "--log-every", "1", "--device", "cpu"]
        res["cli_dp"] = [r["loss"] for r in train_cli.main(cli + ["--mesh", "2x1"]).records]
        res["cli_one"] = [r["loss"] for r in train_cli.main(cli).records]
    return res


def _rank_cases(rank, weights):
    from repro_torch import configs as TC
    from repro_torch.models import spec

    torch.set_num_threads(1)
    res = {}
    for name, (_, _, meshes_) in CONFIGS.items():
        cfg = _cfg(TC, name)
        params = spec.params_from_numpy(weights[name], "cpu")
        for recipe in RECIPES:
            res[(name, "single", recipe)] = _serve(cfg, params, recipe, None)
            for mid, mesh in meshes_.items():
                res[(name, mid, recipe)] = _serve(cfg, params, recipe, mesh)
    from repro_torch.parallel.smoke import run_smoke

    params = spec.params_from_numpy(weights["llama4"], "cpu")
    for mid, mesh in MESHES.items():
        res[("smoke", mid)] = run_smoke(CONFIGS["llama4"][0], mesh=mesh, params=params,
                                        num_pages=SMOKE_PAGES, device="cpu")
    for arch in TRAIN_ARCHS:
        res[("train", arch)] = _train(rank, arch)
    return res


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _ref_weights(name):
    """(reference cfg, its seed-0 params, the params as /-named numpy)."""
    if name not in _WEIGHTS:
        import jax

        from repro import configs as C
        from repro.ckpt.manager import _flatten_with_names
        from repro.models import registry as jreg, spec as jspec

        cfg = _cfg(C, name)
        params = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
        _WEIGHTS[name] = (cfg, params, {k: np.asarray(v) for k, v in
                                        _flatten_with_names(params)[0].items()})
    return _WEIGHTS[name]


@pytest.fixture(scope="module")
def world():
    from repro_torch.parallel import collectives

    weights = {name: _ref_weights(name)[2] for name in CONFIGS}
    return collectives.spawn(_rank_cases, 2, weights, device="cpu", threads=1)


_REF = {}


def _reference(name, recipe):
    """The reference's single-device PoolEngine tokens and counters."""
    if (name, recipe) not in _REF:
        from repro.core.policy import PAPER_FAITHFUL as J_PF
        from repro.parallel.smoke import smoke_requests as j_requests
        from repro.serve import PoolEngine as JPoolEngine

        jcfg, params, _ = _ref_weights(name)
        eng = JPoolEngine(jcfg, J_PF, params, max_slots=SLOTS, max_len=MAX_LEN,
                          num_pages=NUM_PAGES, **RECIPES[recipe])
        out = eng.run(j_requests(jcfg, 4))
        st = eng.last_stats
        _REF[(name, recipe)] = ({str(k): np.asarray(v).tolist() for k, v in out.items()},
                                {f: getattr(st, f) for f in STAT_FIELDS})
    return _REF[(name, recipe)]


SERVE_CASES = [(name, mid, recipe) for name, (_, _, ms) in CONFIGS.items() for mid in ms
               for recipe in RECIPES]


@pytest.mark.parametrize("name,mesh,recipe", SERVE_CASES)
def test_sharded_moe_pool_equals_one_rank(world, name, mesh, recipe):
    """Tokens and every counter of the sharded pool equal the single-rank
    pool's on both ranks."""
    single_toks, single_stats, _ = world[0][(name, "single", recipe)]
    d, m = CONFIGS[name][2][mesh]
    for res in world:
        toks, stats, _ = res[(name, mesh, recipe)]
        assert toks == single_toks
        assert {f: stats[f] for f in STAT_FIELDS} == {f: single_stats[f] for f in STAT_FIELDS}
        assert (stats["data_shards"], stats["model_shards"]) == (d, m)


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("name", ["llama4", "grok"])
def test_one_rank_moe_pool_equals_reference(world, name, recipe):
    """The port's single-rank pool against the reference's single-device
    pool, on the same weights: the same tokens and counters (the 3-expert
    variant is held to one rank only)."""
    toks, stats, _ = world[0][(name, "single", recipe)]
    jtoks, jstats = _reference(name, recipe)
    assert toks == jtoks
    assert {f: stats[f] for f in STAT_FIELDS if f != "ttft_passes"} == {
        f: jstats[f] for f in STAT_FIELDS if f != "ttft_passes"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_moe_is_the_reference_and_the_split_follows_it(world, name, mesh):
    """``plan.moe`` is the reference's decision for every expert leaf, and
    each rank holds the expert leaves as it says: EP the expert dim split
    (E/2 whole experts a rank), TP gate and up split over ``ffn`` and the
    down projection whole, replicated whole."""
    from repro import configs as C
    from repro.parallel import meshes as jmeshes, planner as jplanner
    from repro_torch import configs as TC
    from repro_torch.parallel import meshes, planner

    sizes, names = MESHES[mesh], ("data", "model")
    shape = TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode")
    tp = planner.plan_for(_cfg(TC, name), meshes.make_abstract_mesh(sizes, names), shape,
                          pool_slots=SLOTS)
    jp = jplanner.plan_for(_cfg(C, name), jmeshes.make_abstract_mesh(sizes, names),
                           C.ShapeConfig("s", MAX_LEN, SLOTS, "decode"), pool_slots=SLOTS)
    ref = {"/".join(p.strip("[]'").replace("']['", "/").split("/")): v
           for p, v in jp.moe.items()}
    assert tp.moe == ref
    assert set(tp.moe) >= set(EXPERT_LEAVES)
    if mesh not in CONFIGS[name][2]:
        return
    whole = {r.path: r.shape for r in tp.report if r.kind == "param"}
    for res in world:
        held = res[(name, mesh, "solo")][2]
        for path in EXPERT_LEAVES:
            want = list(whole[path])
            decision = tp.moe[path]
            if sizes[1] > 1 and decision == "EP":
                want[1] //= 2
            elif sizes[1] > 1 and decision == "TP" and not path.endswith("down/w"):
                want[3] //= 2
            assert held[path] == tuple(want), (path, decision)
    if sizes[1] > 1:
        assert set(tp.moe.values()) == {"EP" if name != "grok3" else "TP"}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_dp_moe_first_step_losses_and_scales(world, arch):
    """The first step's per-token losses are one rank's bit for bit, and
    every quantizer scale (the experts' per-expert activation and G
    scales included) equals one rank's, call by call."""
    for rank, res in enumerate(world):
        ours, one = res[("train", arch)]["token_losses"]
        assert ours.shape == (BATCH // 2, SEQ)
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()
        s_dp, s_one = res[("train", arch)]["scales"]
        assert len(s_dp) == len(s_one) > 0
        assert any(k == "w/a" and v is not None and len(v) == 4 for k, v in s_dp)
        assert s_dp == s_one


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_dp_moe_gradients_and_losses_within_bound(world, arch):
    for res in world:
        tr = res[("train", arch)]
        for name, (diff, top) in tr["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)
        np.testing.assert_allclose(tr["dp_losses"], tr["one_losses"], rtol=LOSS_RTOL)
    assert world[0][("train", arch)]["dp_losses"] == world[1][("train", arch)]["dp_losses"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_dp_moe_refuses_straddling_groups(world, arch):
    for res in world:
        msg = res[("train", arch)]["straddle"]
        assert msg is not None and "straddle" in msg and "2 data ranks" in msg


def test_launch_train_mesh_2x1_moe(world):
    """``launch.train --mesh 2x1`` trains a MoE smoke arch: both ranks
    report one loss a step, within 1e-5 of the one-rank CLI run's."""
    a, b = (res[("train", CLI_ARCH)] for res in world)
    assert a["cli_dp"] == b["cli_dp"] and len(a["cli_dp"]) == 2
    np.testing.assert_allclose(a["cli_dp"], a["cli_one"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_smoke_driver_moe_equals_reference(world, mesh):
    """``parallel.smoke.run_smoke`` (what ``python -m repro_torch.parallel.smoke
    --arch llama4-scout-17b-a16e --mesh 1x2`` runs on each rank) on the
    reference's seed-0 weights gives the reference's
    ``run_smoke(sharded=False)`` tokens on both meshes."""
    from repro.parallel import smoke as jsmoke

    arch = CONFIGS["llama4"][0]
    ours = world[0][("smoke", mesh)]
    assert world[1][("smoke", mesh)] == ours
    assert ours["num_pages"] == SMOKE_PAGES
    if "smoke" not in _REF:
        _REF["smoke"] = jsmoke.run_smoke(arch, sharded=False, num_pages=SMOKE_PAGES)
    ref = _REF["smoke"]
    assert ours["tokens"] == ref["tokens"]
    assert (ours["data_shards"], ours["model_shards"]) == MESHES[mesh]
    assert ours["weight_passes"] == ref["weight_passes"]
