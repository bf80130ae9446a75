"""Tensor-parallel training of repro_torch's dense decoder over gloo ranks on
the CPU: olmo-1b's smoke config on the (1, 2) and (2, 2) (data, model)
meshes against one rank at the same global batch (4 x 16), under
``PAPER_FAITHFUL``, from the reference's seed-0 parameters.

Two widths of the smoke config run in each world:

* ``smoke``: olmo-1b's smoke config as it is.  Its model shards are
  narrower than one 128-chunk (q: 32 columns a rank), so the row-parallel
  products run over their gathered input and a column-parallel linear's
  dA over G and Wq gathered whole (``core/mfmac.py``);
* ``chunked``: the same config with 4 heads of 64, d_ff 256 and the
  vocabulary padded to 512, so every shard is whole 128-chunks a rank:
  ``wo`` and the down projection fold across the ranks (K1's ``start``)
  and every column-parallel dA chains K2 across them (K2's ``start``),
  their dgamma rows too.

What must hold, and why:

* the first step's per-token losses are one rank's bit for bit (every
  quantizer scale is a global maximum, and each chain adds one rank's
  chunk sums in one rank's order);
* every quantizer scale of the step equals one rank's, call by call;
* on (1, 2) each gradient leaf's shard is one rank's slice bit for bit: a
  split leaf's dW is local, a replicated leaf's gradient comes out of the
  same chains on every rank and autograd adds the same terms in the same
  order as on one rank;
* on (2, 2) a gradient is also a sum over the data ranks of partial MAC
  folds, so it agrees with one rank's within the data-parallel bound of
  ``tests/test_torch_parallel_train.py``: ``1e-4`` of the leaf's largest
  magnitude;
* the losses of 3 AdamW steps agree with one rank's within ``1e-5``
  relative (the clip's global norm sums the leaves' squares in another
  order);
* the gathered gradients agree with the reference's ``jax.grad`` of
  ``registry.loss_fn`` within ``tests/test_torch_train.py``'s bound
  (``1e-4`` of each leaf's largest magnitude);
* ``launch.train --mesh 1x2`` trains and checkpoints whole; the
  checkpoint restores in one rank of the port's CLI and in the reference's
  manager, bit for bit; ``--mesh 2x2`` trains;
* K/V heads selected from a whole product (one K/V head for 4 q heads)
  train on (1, 2) bit for bit with one rank.

K2's chain itself is held here on its plain version: chained over 2 and
3 ranks it equals the unsplit call bit for bit (dA, the dgamma rows, a
ragged last N and K).

The worlds run once per module; the tests read what they returned.
"""
import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

BATCH, SEQ, STEPS = 4, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
CHUNKED = dict(n_heads=4, kv_heads=4, head_dim=64, d_ff=256, vocab_pad_multiple=256)
WIDTHS = ("smoke", "chunked")
CLI = ["--arch", "olmo-1b", "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
       "--log-every", "1", "--device", "cpu"]


def _config(pkg, width):
    cfg = pkg.smoke_config("olmo-1b")
    return dataclasses.replace(cfg, **CHUNKED) if width == "chunked" else cfg


def _record_scales(fn):
    """Every quantizer scale ``fn`` takes, in call order (the beta of each
    ``potq.pot_quantize`` and of each G, ``ops._g_scalars``)."""
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
        fn()
    finally:
        potq.pot_quantize, ops._g_scalars = pq, gs
    return seen


def _width_case(mesh, cfg, params_np, batches_np):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    tp_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    sharded = tp_step.data_parallel
    whole = spec.params_from_numpy(params_np, "cpu")
    shards = sharded.shard(whole)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches_np]
    d = plan.mesh.coord("data")
    rows = slice(d * BATCH // mesh[0], (d + 1) * BATCH // mesh[0])
    res = {"coords": (d, plan.mesh.coord("model"))}
    res["token_losses"] = (tp_step.token_losses(shards, batches[0]).numpy(),
                           one_step.token_losses(whole, batches[0])[rows].numpy())
    collectives.reset_stats()
    res["scales"] = (_record_scales(lambda: tp_step.grads(shards, batches[0])),
                     _record_scales(lambda: one_step.grads(whole, batches[0])))
    res["stats"] = dict(collectives.stats)
    _, g = tp_step.grads(shards, batches[0])
    g = sharded.reduce(g)
    _, g1 = one_step.grads(whole, batches[0])
    res["grads"] = {n: (bool(torch.equal(x, y)), float((x - y).abs().max()),
                        float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g),
                                              spec.named_leaves(sharded.shard(g1)))}
    res["whole_grads"] = {n: x.numpy() for n, x in spec.named_leaves(sharded.gather(g))}
    res["shapes"] = {n: (tuple(x.shape), plan.model_split_dim(n), plan.data_split_dim(n))
                     for n, x in spec.named_leaves(shards)}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for s in range(STEPS):
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
        return losses

    # fresh parameters for each run: the updates are in place, and a leaf
    # that no rank splits is the same tensor in the shards and the tree
    res["tp_losses"] = run(tp_step, sharded.shard(spec.params_from_numpy(params_np, "cpu")))
    res["one_losses"] = run(one_step, spec.params_from_numpy(params_np, "cpu"))
    return res


def _rank_cases(rank, mesh, cases, ckdir):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    torch.set_num_threads(1)
    out = {w: _width_case(mesh, _config(TC, w), *cases[w]) for w in WIDTHS}
    if mesh == (1, 2):
        # K/V heads selected from a whole product: olmo-1b's smoke config
        # with 1 K/V head for its 4 q heads, against one rank
        cfg = dataclasses.replace(TC.smoke_config("olmo-1b"), kv_heads=1)
        shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
        plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
        opt = adamw(warmup_cosine_schedule(3e-3, 20, 3))
        step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
        one = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
        whole = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
        params = step.data_parallel.shard(whole)
        batch = pipeline.make_batch(cfg, shape, 0, device="cpu")
        loss, g = step.grads(params, batch)
        loss1, g1 = one.grads(whole, batch)
        out["select"] = dict(
            kv=plan.layout().kv, loss=(float(loss), float(loss1)),
            token_losses=bool(torch.equal(step.token_losses(params, batch),
                                          one.token_losses(whole, batch))),
            differ=[n for (n, x), (_, y) in zip(
                spec.named_leaves(g), spec.named_leaves(step.data_parallel.shard(g1)))
                if not torch.equal(x, y)])
    argv = CLI + ["--steps", "2", "--mesh", f"{mesh[0]}x{mesh[1]}"]
    if ckdir:
        argv += ["--ckpt-dir", ckdir, "--ckpt-every", "100"]
    run = train_cli.main(argv)
    out["cli_losses"] = [r["loss"] for r in run.records]
    if ckdir:
        out["cli_final"] = {n: x.numpy() for n, x in
                            spec.named_leaves(run.step_fn.data_parallel.gather(run.params))}
    return out


def _reference(width):
    """The reference's seed-0 parameters, its batches and its loss and
    gradients at the first batch (``jax.grad`` of ``registry.loss_fn``)."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.core.policy import PAPER_FAITHFUL as J_PF
    from repro.data import pipeline as jpipeline
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, width)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    shape = JC.ShapeConfig("t", SEQ, BATCH, "train")
    batches = [{k: np.array(v).astype(np.float32 if k == "mask" else np.int64)
                for k, v in jpipeline.make_batch(jcfg, shape, s).items()}
               for s in range(STEPS)]
    grads = jax.jit(jax.grad(lambda p: jreg.loss_fn(jcfg, J_PF, p, batches[0])))(jp)
    named = lambda t: {k: np.asarray(v) for k, v in _flatten_with_names(t)[0].items()}  # noqa: E731
    return named(jp), batches, named(grads)


@pytest.fixture(scope="module")
def reference():
    return {w: _reference(w) for w in WIDTHS}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    from repro_torch.parallel import collectives

    cases = {w: reference[w][:2] for w in WIDTHS}
    ckdir = str(tmp_path_factory.mktemp("tp_ckpt"))
    return {(1, 2): collectives.spawn(_rank_cases, 2, (1, 2), cases, ckdir, device="cpu",
                                      threads=1),
            (2, 2): collectives.spawn(_rank_cases, 4, (2, 2), cases, "", device="cpu",
                                      threads=1)}, ckdir


MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_first_step_token_losses_bit_for_bit(worlds, mesh, width):
    for res in worlds[0][mesh]:
        ours, one = res[width]["token_losses"]
        assert ours.shape == (BATCH // mesh[0], SEQ)
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_quantizer_scales_equal_one_rank(worlds, mesh, width):
    for res in worlds[0][mesh]:
        ours, one = res[width]["scales"]
        assert len(ours) == len(one) > 0
        assert [k for k, _ in ours].count("g") == [k for k, _ in one].count("g") > 0
        assert ours == one


@pytest.mark.parametrize("width", WIDTHS)
def test_one_data_rank_gradients_bit_for_bit(worlds, width):
    for res in worlds[0][(1, 2)]:
        bad = {n: v for n, v in res[width]["grads"].items() if not v[0]}
        assert not bad, bad


@pytest.mark.parametrize("width", WIDTHS)
def test_two_data_rank_gradients_within_bound(worlds, width):
    for res in worlds[0][(2, 2)]:
        for name, (_, diff, top) in res[width]["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_three_step_losses_within_bound(worlds, mesh, width):
    ranks = worlds[0][mesh]
    for res in ranks:
        np.testing.assert_allclose(res[width]["tp_losses"], res[width]["one_losses"],
                                   rtol=LOSS_RTOL)
        assert res[width]["tp_losses"] == ranks[0][width]["tp_losses"]


@pytest.mark.parametrize("width", WIDTHS)
def test_chains_run_where_shards_are_whole_chunks(worlds, width):
    """Per step, the forward's folds (wo and the down projection, twice
    under remat) and the backward's chains (5 column-parallel linears and
    2 row-parallel ones a layer, and the head) where a rank's shard is
    whole 128-chunks; none at the smoke width, where the gathers run."""
    layers = 2
    for res in worlds[0][(1, 2)]:
        stats = res[width]["stats"]  # over one step's grads (and one rank's)
        if width == "chunked":
            assert stats["folds"] == 2 * 2 * layers
            assert stats["bwd_folds"] == 7 * layers + 1
        else:
            assert stats["folds"] == stats["bwd_folds"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_model_and_data_shards(worlds, reference, mesh):
    for res in worlds[0][mesh]:
        for width in WIDTHS:
            whole = reference[width][0]
            for name, (shape, mdim, ddim) in res[width]["shapes"].items():
                want = list(whole[name].shape)
                for dim, n in ((mdim, mesh[1]), (ddim, mesh[0])):
                    if dim is not None:
                        want[dim] //= n
                assert shape == tuple(want), (name, shape, want)
            split = {n for n, v in res[width]["shapes"].items() if v[1] is not None}
            folded = {"layers/wo/w", "layers/mlp/wo/w"} if width == "chunked" else set()
            assert split == folded | {"embed", "lm_head/w", "layers/wq/w", "layers/wk/w",
                                      "layers/wv/w", "layers/mlp/wi_gate/w",
                                      "layers/mlp/wi_up/w"}


@pytest.mark.parametrize("width", WIDTHS)
def test_gradients_vs_reference_jax_grad(worlds, reference, width):
    _, _, jgrads = reference[width]
    for res in worlds[0][(1, 2)]:
        for name, g in res[width]["whole_grads"].items():
            ref = jgrads[name]
            err = np.abs(g - ref).max()
            assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)


def test_select_kv_heads_train_bit_for_bit(worlds):
    """K/V heads selected from a whole product (olmo-1b's smoke config with
    one K/V head) train on (1, 2): the loss, the per-token losses and
    every gradient leaf's shard are one rank's bit for bit."""
    for res in worlds[0][(1, 2)]:
        sel = res["select"]
        assert sel["kv"] == "select"
        assert sel["loss"][0] == sel["loss"][1]
        assert sel["token_losses"] and not sel["differ"], sel["differ"]


def test_two_by_two_cli_trains(worlds):
    ranks = worlds[0][(2, 2)]
    losses = ranks[0]["cli_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(res["cli_losses"] == losses for res in ranks)


def test_model_axis_checkpoint_restores_in_one_rank_and_reference(worlds, capsys):
    """The (1, 2) CLI run's checkpoint (step 2): the port's one-rank CLI
    restores it and runs on; the reference's manager restores the same
    values bit for bit."""
    import jax

    from repro import configs as C
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    from repro.ckpt.manager import _flatten_with_names
    from repro.models import registry as jreg, spec as jspec
    from repro.optim import optimizers as joptim
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    ranks, ckdir = worlds[0][(1, 2)], worlds[1]
    assert ranks[0]["cli_losses"] == ranks[1]["cli_losses"]
    final = ranks[0]["cli_final"]
    run = train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", ckdir, "--ckpt-every", "100"])
    assert "restoring checkpoint step 2" in capsys.readouterr().out
    assert run.start_step == 2 and len(run.records) == 1
    two = CheckpointManager(ckdir).restore(
        2, {"params": spec.params_from_numpy(final, "cpu")})["params"]
    for name, x in spec.named_leaves(two):
        assert x.numpy().view(np.uint32).tolist() == final[name].view(np.uint32).tolist()
    jcfg = C.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 20, 3))
    jtwo = JCheckpointManager(ckdir).restore(2, {"params": jp, "opt_state": jopt.init(jp)})
    for name, x in _flatten_with_names(jtwo["params"])[0].items():
        assert np.asarray(x).view(np.uint32).tolist() == final[name].view(
            np.uint32).tolist(), name


# ---------------------------------------------------------------------------
# K2's chain on its plain version
# ---------------------------------------------------------------------------

def _grad_operands(m, k, n, seed=0):
    from repro_torch.core import potq

    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal((m, k)) * 1.7).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05 + 0.003).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((m, n)) * 1e-3).astype(np.float32))
    wq = potq.pot_quantize(w - w.mean(), 5).bfloat16()
    beta = potq.compute_beta(g, 5)
    t = a.abs().amax() * 0.95
    return a, g, wq, torch.stack([potq.exp2i(-beta), potq.exp2i(beta), t])


def _bits(x):
    return x.contiguous().view(torch.int32).tolist()


# whole 128-chunks a rank but the last, whose range is ragged
SPLITS = {2: (256, 70), 3: (128, 256, 71)}


@pytest.mark.parametrize("prc", [True, False])
@pytest.mark.parametrize("ranks", sorted(SPLITS))
def test_grad_da_chain_over_split_n_equals_unsplit(ranks, prc):
    """A column-parallel linear's dA: rank r continues K2's fold over its N
    columns from rank r-1's raw running sum; the last dequantizes and runs
    the PRC epilogue.  Equals the unsplit call bit for bit, dgamma rows
    included."""
    from repro_torch.kernels import potq_grad as KG

    widths = SPLITS[ranks]
    a, g, wq, s = _grad_operands(37, 200, sum(widths))
    whole, rows = KG.grad_da_plain(g, wq, a if prc else None, s, emax_g=15, prc=prc)
    start, lo = None, 0
    for r, n in enumerate(widths):
        last = r == ranks - 1
        got, got_rows = KG.grad_da_plain(g[:, lo:lo + n], wq[:, lo:lo + n],
                                         a if prc and last else None, s, emax_g=15,
                                         prc=prc and last, start=start, last=last)
        start, lo = got, lo + n
        if not last:
            assert got_rows is None
    assert _bits(got) == _bits(whole)
    if prc:
        assert _bits(got_rows) == _bits(rows)


@pytest.mark.parametrize("ranks", sorted(SPLITS))
def test_grad_rows_chain_over_split_k_equals_unsplit(ranks):
    """A row-parallel linear's dgamma rows: each rank's K2 runs on its K
    columns, and its rows' fold continues from rank r-1's; dA is each
    rank's columns of the unsplit dA, bit for bit."""
    from repro_torch.kernels import potq_grad as KG

    widths = SPLITS[ranks]
    a, g, wq, s = _grad_operands(33, sum(widths), 150, seed=1)
    whole, rows = KG.grad_da_plain(g, wq, a, s, emax_g=15, prc=True)
    start, lo = None, 0
    for n in widths:
        da, start = KG.grad_da_plain(g, wq[lo:lo + n], a[:, lo:lo + n], s, emax_g=15,
                                     prc=True, rows_start=start)
        assert _bits(da) == _bits(whole[:, lo:lo + n])
        lo += n
    assert _bits(start) == _bits(rows)


def test_chain_arguments_are_checked():
    from repro_torch.kernels import potq_grad as KG

    a, g, wq, s = _grad_operands(8, 16, 24)
    with pytest.raises(ValueError, match="last"):
        KG.grad_da_plain(g, wq, a, s, emax_g=15, prc=True, last=False)
    with pytest.raises(ValueError, match="start"):
        KG.grad_da_plain(g, wq, None, s, emax_g=15, prc=False, start=torch.zeros(8, 24))
    with pytest.raises(ValueError, match="rows_start"):
        KG.grad_da_plain(g, wq, None, s, emax_g=15, prc=False, rows_start=torch.zeros(8))
