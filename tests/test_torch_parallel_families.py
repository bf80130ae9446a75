"""The vlm and the encoder-decoder of repro_torch on a sharded plan over two
gloo ranks on the CPU: internvl2-76b and whisper-large-v3 at smoke width,
and a widened variant of each (head_dim 64, d_ff 512; the vlm with 2 K/V
heads) in which a rank's heads and hidden slice span whole 128-chunks, so
``wo``, ``co`` and the down projections fold (K1's fold continued across
the ranks) where the smoke widths all-gather.  Served through
``PoolEngine(plan=...)`` on the (1, 2) and (2, 1) (data, model) meshes,
solo and chunked, and trained data-parallel on (2, 1), against the port's
single rank and the reference's single-device ``PoolEngine`` under
``PAPER_FAITHFUL``, on the same numpy weights (the reference's seed-0
draw, quantized for serving by each engine).

* The vlm trace's even requests carry patch embeddings (a solo prefill
  through ``patch_proj``, whole on every model rank); its odd ones do not
  (chunked admission in a chunked engine).
* An encdec admission runs the encoder on the slot's data rank; on a
  model axis each rank makes and keeps its own cross K/V heads.
* The prefix cache on (2, 1): pages published by one data rank are mapped
  by the other, and prefix-on tokens equal prefix-off ones, with shared
  and with distinct frames (no hit then: the pages key on the frames).
* Data-parallel training: the batch's ``patch_embeds`` / ``frames`` rows
  split with its tokens; the second rank's rows are weighted 1/16
  (``_skewed``), so a rank-local activation scale or max|G| would show.

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
PAGE = 4
NUM_PAGES = SLOTS * (MAX_LEN // PAGE)
TRACE = dict(n_requests=4, prompt_len=7, lam=1.0, new_lo=2, new_hi=7, seed=3)
RECIPES = {"solo": dict(page_size=PAGE), "chunked": dict(prefill_chunk=4, page_size=PAGE)}
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
WIDE = dict(head_dim=64, d_ff=512)
CONFIGS = {"vlm": ("internvl2-76b", {}),
           "vlm_wide": ("internvl2-76b", dict(WIDE, kv_heads=2)),
           "encdec": ("whisper-large-v3", {}),
           "encdec_wide": ("whisper-large-v3", WIDE)}
# (q heads a rank, kv mode, wo, the down projection) at model = 2
LAYOUTS = {"vlm": (2, "select", "gather", "gather"),
           "vlm_wide": (2, "split", "fold", "fold"),
           "encdec": (2, "split", "gather", "gather"),
           "encdec_wide": (2, "split", "fold", "fold")}
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum",
               "weight_passes", "ttft_passes", "prompt_tokens", "prefix_hit_tokens",
               "cow_copies", "evictions", "admission_deferrals", "pages_in_use_sum",
               "page_size", "kv_page_bytes")
TRAIN_ARCHS = ("internvl2-76b", "whisper-large-v3")
CLI_ARCH = "whisper-large-v3"
SMOKE_PAGES = 3  # the smoke driver's 2 slots of one page, and a null page, split over 2
PREFIX_LEN, SUFFIX_LEN = 8, 3
BATCH, SEQ, STEPS = 4, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# the leaves a model rank holds half of, and the dim it splits: q heads,
# K/V heads and ffn on dim 2 of a stacked leaf, a folded contraction on
# dim 1, the vlm's vocabulary (its embedding is not tied)
_VOCAB = (("embed", 0), ("lm_head/w", 1))
SPLIT_LEAVES = {"vlm": (("layers/wq/w", 2), ("layers/mlp/wi_up/w", 2)) + _VOCAB,
                "vlm_wide": (("layers/wq/w", 2), ("layers/wk/w", 2), ("layers/wo/w", 1),
                             ("layers/mlp/wo/w", 1)) + _VOCAB,
                "encdec": (("enc_layers/wq/w", 2), ("enc_layers/wi/w", 2),
                           ("dec_layers/cq/w", 2), ("dec_layers/ck/w", 2),
                           ("dec_layers/cv/w", 2)),
                "encdec_wide": (("enc_layers/wq/w", 2), ("enc_layers/wo/w", 1),
                                ("enc_layers/wo2/w", 1), ("dec_layers/ck/w", 2),
                                ("dec_layers/cv/w", 2), ("dec_layers/co/w", 1),
                                ("dec_layers/wo2/w", 1))}
WHOLE_LEAVES = ("patch_proj/w", "frame_proj/w", "enc_pos")


def _cfg(pkg_configs, name):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(pkg_configs.smoke_config(arch), **kw)


def _requests(cfg):
    """The port's ``poisson_trace`` of TRACE; a vlm's odd requests without
    their patch embeddings."""
    from repro_torch.serve import poisson_trace

    reqs = poisson_trace(cfg, **TRACE)
    if cfg.family == "vlm":
        reqs = [r if r.uid % 2 == 0 else dataclasses.replace(r, extras={}) for r in reqs]
    return reqs


def _prefix_requests(cfg, same_frames):
    """TRACE's requests with prompts of one shared 8-token head and a
    3-token tail; with ``same_frames`` every request carries the first
    one's frames."""
    from repro_torch.serve import poisson_trace

    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab, (PREFIX_LEN,))
    reqs = poisson_trace(cfg, **TRACE)
    out = []
    for r in reqs:
        tail = rng.integers(0, cfg.vocab, (SUFFIX_LEN,))
        extras = dict(reqs[0].extras) if same_frames else r.extras
        out.append(dataclasses.replace(
            r, tokens=np.concatenate([head, tail])[None].astype(np.int32), extras=extras))
    return out


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

def _plan(cfg, mesh, page_size=PAGE, num_pages=NUM_PAGES):
    from repro_torch import configs as TC
    from repro_torch.parallel import meshes, planner

    return planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                            TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"),
                            pool_slots=SLOTS, page_size=page_size, num_pages=num_pages)


def _serve(cfg, params, recipe, mesh, reqs, prefix=False):
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.serve import PoolEngine

    kw = dict(RECIPES[recipe], prefix_cache=prefix)
    plan = None if mesh is None else _plan(cfg, mesh)
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                     num_pages=NUM_PAGES, plan=plan, device="cpu", **kw)
    out = eng.run(reqs)
    st = eng.last_stats
    stats = {f: getattr(st, f) for f in STAT_FIELDS}
    stats.update(data_shards=st.data_shards, model_shards=st.model_shards,
                 kv_heads=eng.step_cfg.kv_heads, n_heads=eng.step_cfg.n_heads)
    shapes = {n: tuple(x.shape) for n, x in spec.named_leaves(eng.params)}
    return {str(k): v.tolist() for k, v in out.items()}, stats, shapes


def _skewed(batch, vocab):
    """The pipeline's batch with the second half's token ids mirrored, its
    extras' rows scaled by 4 and its loss weights cut to 1/16 (as
    ``test_torch_parallel_train.py``)."""
    half = batch["tokens"].shape[0] // 2
    out = dict(batch)
    for key in ("tokens", "labels"):
        x = batch[key].clone()
        x[half:] = vocab - 1 - x[half:]
        out[key] = x
    for key in ("frames", "patch_embeds"):
        if key in batch:
            x = batch[key].clone()
            x[half:] *= 4.0
            out[key] = x
    out["mask"] = batch["mask"].clone()
    out["mask"][half:] *= 1.0 / 16
    return out


def _record_scales(fn):
    """(``fn()``, every quantizer scale it takes, in call order: each
    ``potq.pot_quantize``'s beta and each G's (``ops._g_scalars``))."""
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
           "scales": (dp_scales, one_scales),
           "extras": sorted(k for k in batches[0] if k in ("frames", "patch_embeds"))}
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
    if arch == CLI_ARCH:
        cli = ["--arch", arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
               "--steps", "2", "--log-every", "1", "--device", "cpu"]
        res["cli_dp"] = [r["loss"] for r in train_cli.main(cli + ["--mesh", "2x1"]).records]
        res["cli_one"] = [r["loss"] for r in train_cli.main(cli).records]
    return res


def _heads_whole(rank):
    """``transformer._heads_whole`` on (1, 2) for each config: where this
    rank's q and K/V heads land in the whole-head tensors (their global
    offsets), whether everything else is zero, and the output slice."""
    from repro_torch import configs as TC
    from repro_torch.models import transformer as T
    from repro_torch.parallel import actshard

    out = {}
    gen = torch.Generator().manual_seed(rank)
    for name in CONFIGS:
        cfg = _cfg(TC, name)
        plan = _plan(cfg, (1, 2))
        lcfg = plan.local_config()
        q = torch.randn((1, 3, lcfg.n_heads, cfg.head_dim), generator=gen)
        k = torch.randn((1, 5, lcfg.kv_heads, cfg.head_dim), generator=gen)
        with actshard.use_plan(plan):
            wq, wk, wv, mine = T._heads_whole(q, k, k.clone())
        lay = plan.layout()
        lo, kv_lo = rank * lay.heads_local, lay.kv_lo(rank, cfg)
        out[name] = dict(
            shapes=(wq.shape[2], wk.shape[2]), mine=(mine.start, mine.stop),
            placed=bool(torch.equal(wq[:, :, mine], q)
                        and torch.equal(wk[:, :, kv_lo:kv_lo + k.shape[2]], k)),
            zeros=int((wq != 0).sum() - (q != 0).sum() + (wk != 0).sum() - (k != 0).sum()),
            lo=(lo, kv_lo))
    return out


def _rank_cases(rank, weights):
    from repro_torch import configs as TC
    from repro_torch.models import spec
    from repro_torch.parallel.smoke import run_smoke

    torch.set_num_threads(1)
    res = {}
    for name in CONFIGS:
        cfg = _cfg(TC, name)
        params = spec.params_from_numpy(weights[name], "cpu")
        reqs = _requests(cfg)
        for recipe in RECIPES:
            if rank == 0:
                res[(name, "single", recipe)] = _serve(cfg, params, recipe, None, reqs)
            for mid, mesh in MESHES.items():
                res[(name, mid, recipe)] = _serve(cfg, params, recipe, mesh, reqs)
    cfg = _cfg(TC, "encdec")
    params = spec.params_from_numpy(weights["encdec"], "cpu")
    for same in (True, False):
        reqs = _prefix_requests(cfg, same)
        res[("prefix", same, "2x1")] = _serve(cfg, params, "chunked", (2, 1), reqs,
                                              prefix=True)
        if rank == 0:
            res[("prefix", same, "off")] = _serve(cfg, params, "chunked", None, reqs)
    for name in ("vlm", "encdec"):
        params = spec.params_from_numpy(weights[name], "cpu")
        for mid, mesh in MESHES.items():
            res[("smoke", name, mid)] = run_smoke(
                CONFIGS[name][0], mesh=mesh, params=params, num_pages=SMOKE_PAGES, device="cpu")
    for arch in TRAIN_ARCHS:
        res[("train", arch)] = _train(rank, arch)
    res["heads_whole"] = _heads_whole(rank)
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
    """The reference's single-device PoolEngine tokens and counters on the
    port's requests (the same numpy arrays)."""
    if (name, recipe) not in _REF:
        from repro.core.policy import PAPER_FAITHFUL as J_PF
        from repro.serve import PoolEngine as JPoolEngine
        from repro.serve.scheduler import Request as JRequest
        from repro_torch import configs as TC

        jcfg, params, _ = _ref_weights(name)
        jreqs = [JRequest(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                          arrival=r.arrival, extras=dict(r.extras))
                 for r in _requests(_cfg(TC, name))]
        eng = JPoolEngine(jcfg, J_PF, params, max_slots=SLOTS, max_len=MAX_LEN,
                          num_pages=NUM_PAGES, **RECIPES[recipe])
        out = eng.run(jreqs)
        st = eng.last_stats
        _REF[(name, recipe)] = ({str(k): np.asarray(v).tolist() for k, v in out.items()},
                                {f: getattr(st, f) for f in STAT_FIELDS})
    return _REF[(name, recipe)]


def test_layouts_fold_only_in_the_wide_variants():
    """The smoke widths all-gather ``wo`` and the down projections (a rank's
    slice is under a 128-chunk); the widened variants fold them.  The
    vlm's smoke config keeps one K/V head (each rank selects it), the
    widened vlm and both encdecs split their K/V heads."""
    from repro_torch import configs as TC
    from repro_torch.parallel import planner

    for name, want in LAYOUTS.items():
        lay = planner.decoder_layout(_cfg(TC, name), 2)
        assert (lay.heads_local, lay.kv, lay.wo, lay.mlp_wo) == want, name
        assert lay.vocab == (CONFIGS[name][0] == "internvl2-76b")  # the tied one stays whole
    full = planner.decoder_layout(TC.get_config("whisper-large-v3"), 2)
    assert (full.heads_local, full.kv, full.kv_local, full.wo, full.ffn_local,
            full.mlp_wo, full.vocab) == (10, "split", 10, "fold", 2560, "fold", False)
    full = planner.decoder_layout(TC.get_config("internvl2-76b"), 2)
    assert (full.heads_local, full.kv, full.kv_local, full.wo, full.ffn_local,
            full.mlp_wo, full.vocab) == (32, "split", 4, "fold", 14336, "fold", True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_attention_runs_over_the_whole_head_count(world, name):
    """On a model axis a rank attends over the whole model's head count,
    its own q and K/V heads at their global offsets and the others zero
    (the card rounds a batched product by the batch's size, so a rank
    that attended over its heads alone would not get one rank's bits),
    and keeps the output's slice of its heads."""
    from repro_torch import configs as TC

    cfg = _cfg(TC, name)
    for rank, res in enumerate(world):
        got = res["heads_whole"][name]
        lo, kv_lo = got["lo"]
        assert got["shapes"] == (cfg.n_heads, cfg.kv_heads)
        assert got["mine"] == (lo, lo + cfg.n_heads // 2)
        assert lo == rank * cfg.n_heads // 2
        assert got["placed"] and got["zeros"] == 0


SERVE_CASES = [(name, mid, recipe) for name in CONFIGS for mid in MESHES for recipe in RECIPES]


@pytest.mark.parametrize("name,mesh,recipe", SERVE_CASES)
def test_sharded_pool_equals_one_rank(world, name, mesh, recipe):
    """Tokens and every counter of the sharded pool equal the single-rank
    pool's on both ranks."""
    single_toks, single_stats, _ = world[0][(name, "single", recipe)]
    d, m = MESHES[mesh]
    for res in world:
        toks, stats, _ = res[(name, mesh, recipe)]
        assert toks == single_toks
        assert {f: stats[f] for f in STAT_FIELDS} == {f: single_stats[f] for f in STAT_FIELDS}
        assert (stats["data_shards"], stats["model_shards"]) == (d, m)
    if recipe == "solo" or name.startswith("vlm"):
        # every vlm patch request and every solo admission is a prefill pass
        assert single_stats["prefills"] == TRACE["n_requests"]


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_rank_pool_equals_reference(world, name, recipe):
    """The port's single-rank pool against the reference's single-device
    pool on the same weights and requests: the same tokens and counters."""
    toks, stats, _ = world[0][(name, "single", recipe)]
    jtoks, jstats = _reference(name, recipe)
    assert toks == jtoks
    assert {f: stats[f] for f in STAT_FIELDS if f != "ttft_passes"} == {
        f: jstats[f] for f in STAT_FIELDS if f != "ttft_passes"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_its_shards(world, name, mesh):
    """On (1, 2) each rank holds half of the split leaves (heads, K/V heads,
    ffn, folded contractions, the vlm's vocabulary; an encdec's cross K/V
    weights among them) and steps half the heads; the tied embedding, ``patch_proj``,
    ``frame_proj`` and ``enc_pos`` stay whole; on (2, 1) every leaf is
    whole."""
    single = world[0][(name, "single", "solo")][2]
    cfg_heads = world[0][(name, "single", "solo")][1]
    d, m = MESHES[mesh]
    for res in world:
        _, stats, held = res[(name, mesh, "solo")]
        assert (stats["n_heads"], stats["kv_heads"]) == (
            cfg_heads["n_heads"] // m,
            max(1, cfg_heads["kv_heads"] // m) if m > 1 else cfg_heads["kv_heads"])
        for path, dim in SPLIT_LEAVES[name]:
            want = list(single[path])
            want[dim] //= m
            assert held[path] == tuple(want), path
        for path in WHOLE_LEAVES + (("embed",) if name.startswith("encdec") else ()):
            if path in single:
                assert held[path] == single[path], path


@pytest.mark.parametrize("same_frames", [True, False])
def test_prefix_cache_on_the_data_axis(world, same_frames):
    """The encdec prefix cache on (2, 1): prefix-on tokens equal one rank's
    prefix-off tokens on both ranks; requests sharing their frames hit
    (pages another data rank published), distinct frames never do."""
    off_toks, off_stats, _ = world[0][("prefix", same_frames, "off")]
    for res in world:
        toks, stats, _ = res[("prefix", same_frames, "2x1")]
        assert toks == off_toks
        assert stats["prefix_hit_tokens"] > 0 if same_frames else (
            stats["prefix_hit_tokens"] == 0)
    assert off_stats["prefix_hit_tokens"] == 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_dp_first_step_losses_and_scales(world, arch):
    """The first step's per-token losses are one rank's bit for bit, and
    every quantizer scale (``patch_proj``'s / ``frame_proj``'s included)
    equals one rank's, call by call."""
    for res in world:
        tr = res[("train", arch)]
        assert tr["extras"] == (["patch_embeds"] if arch == "internvl2-76b" else ["frames"])
        ours, one = tr["token_losses"]
        # a vlm's SEQ positions start with its 4 patches, which carry no loss
        patches = 4 if arch == "internvl2-76b" else 0
        assert ours.shape == one.shape == (BATCH // 2, SEQ - patches)
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()
        s_dp, s_one = tr["scales"]
        assert len(s_dp) == len(s_one) > 0
        assert s_dp == s_one


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_dp_gradients_and_losses_within_bound(world, arch):
    for res in world:
        tr = res[("train", arch)]
        for name, (diff, top) in tr["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)
        np.testing.assert_allclose(tr["dp_losses"], tr["one_losses"], rtol=LOSS_RTOL)
    assert world[0][("train", arch)]["dp_losses"] == world[1][("train", arch)]["dp_losses"]


def test_launch_train_mesh_2x1_encdec(world):
    """``launch.train --arch whisper-large-v3 --mesh 2x1`` trains
    data-parallel: both ranks report one loss a step, within 1e-5 of the
    one-rank CLI run's."""
    a, b = (res[("train", CLI_ARCH)] for res in world)
    assert a["cli_dp"] == b["cli_dp"] and len(a["cli_dp"]) == 2
    np.testing.assert_allclose(a["cli_dp"], a["cli_one"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_smoke_driver_equals_reference(world, name, mesh):
    """``parallel.smoke.run_smoke`` (what ``python -m repro_torch.parallel.smoke
    --arch ... --mesh DxM`` runs on each rank) on the reference's seed-0
    weights gives the tokens and weight passes of the reference's
    single-device engine of ``run_smoke(sharded=False)`` (2 slots, chunk 4,
    one page a slot) on the port's smoke requests, on both meshes (an
    encdec's frames are the port's draws, not the reference smoke
    trace's)."""
    from repro.core.policy import PAPER_FAITHFUL as J_PF
    from repro.serve import PoolEngine as JPoolEngine
    from repro.serve.scheduler import Request as JRequest
    from repro_torch import configs as TC
    from repro_torch.parallel import smoke

    ours = world[0][("smoke", name, mesh)]
    assert world[1][("smoke", name, mesh)] == ours
    assert ours["num_pages"] == SMOKE_PAGES
    if ("smoke", name) not in _REF:
        jcfg, params, _ = _ref_weights(name)
        eng = JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=smoke.MAX_LEN,
                          prefill_chunk=4, page_size=smoke.MAX_LEN, num_pages=SMOKE_PAGES)
        reqs = smoke.smoke_requests(_cfg(TC, name), 4)
        out = eng.run([JRequest(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                                arrival=r.arrival, extras=dict(r.extras)) for r in reqs])
        _REF[("smoke", name)] = ({str(u): np.asarray(t).tolist() for u, t in out.items()},
                                 eng.last_stats.weight_passes)
    tokens, passes = _REF[("smoke", name)]
    assert ours["tokens"] == tokens
    assert (ours["data_shards"], ours["model_shards"]) == MESHES[mesh]
    assert ours["weight_passes"] == passes
