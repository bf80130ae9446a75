"""Tensor-parallel training of repro_torch's ssm (mamba2-2.7b) and hybrid
(recurrentgemma-2b) over gloo ranks on the CPU, at smoke width and at the
``wide`` widths of ``tests/_parallel_recurrent.py`` (whole 128-chunks a
rank: mamba2's out_proj folds; recurrentgemma's wout, wo and down
projection fold and its wx, wy, wa, wi, gate, up and q products chain K2
across the ranks), on the (1, 2) (data, model) mesh, and the smoke
configs on (2, 2), each against one rank at the same global batch (4 x
16: two SSD chunks of 8), under ``PAPER_FAITHFUL``, from the reference's
seed-0 parameters and batches.

What must hold, and why:

* the smoke forward on (1, 2), its vocabulary split, gives one rank's
  logits bit for bit (each rank looks its tokens up in its vocab shard,
  ``transformer._embed``), and so do the first step's per-token losses;
* under autograd every rank runs mamba2's mixer whole from in_proj's
  output on (the zero-padded SSD otherwise): the two give the same
  forward bits;
* every quantizer scale of the step equals one rank's, call by call;
* on (1, 2) each gradient leaf's shard is one rank's slice bit for bit:
  in_proj's (its replicated B and C columns the same on both ranks),
  ``conv_w``/``conv_b``, ``A_log``/``D``/``dt_bias``, every gamma, the
  gates' and the norms' included;
* on (2, 2) a gradient is also a sum over the data ranks of partial MAC
  folds: within ``1e-4`` of the leaf's largest magnitude; the losses of
  3 AdamW steps within ``1e-5`` relative on both meshes;
* the backward's chains and gathers are the layout's: in_proj always
  over G and Wq gathered and placed by its pieces, a column-parallel
  product chained where a shard is whole 128-chunks, gathered below;
* the sharded step reassembles the packed leaves (in_proj, conv_w,
  conv_b) whole bit for bit, and its global norm is one rank's within
  rounding (the replicated pieces counted once);
* the gathered gradients agree with the reference's ``jax.grad`` of
  ``registry.loss_fn`` within ``1e-4`` of each leaf's largest magnitude;
* ``launch.train --mesh 1x2`` trains and checkpoints whole, the
  checkpoint restoring in one rank of the port's CLI and in the
  reference's manager bit for bit; ``--mesh 2x2`` trains.

The worlds run once per module; the tests read what they returned.
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

import _parallel_recurrent as R  # noqa: E402

STEPS = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BATCH, SEQ = 4, 16
SSM, HYBRID = "mamba2-2.7b", "recurrentgemma-2b"
# name -> (arch, ``_parallel_recurrent.CONFIGS`` variant)
CASES = {"mamba2": (SSM, "smoke"), "mamba2_wide": (SSM, "wide"),
         "rg": (HYBRID, "smoke"), "rg_wide": (HYBRID, "wide")}
SMOKE_CASES = ("mamba2", "rg")
MESHES = [(1, 2), (2, 2)]
CLI_ARCHS = (SSM, HYBRID)
PACKED = ("layers/in_proj/w", "layers/conv_w", "layers/conv_b")


def _cases(mesh):
    return tuple(CASES) if mesh == (1, 2) else SMOKE_CASES


# (mesh, case) of every run
RUNS = [(mesh, case) for mesh in MESHES for case in _cases(mesh)]


def _cli(arch):
    return ["--arch", arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
            "--log-every", "1", "--device", "cpu"]


def _config(pkg, case):
    arch, name = CASES[case]
    return R.cfg_of(pkg, arch, name)


def _forward_bits(step_fn, plan, shards, batch):
    """The (1, 2) forward's logits on this rank without grad and with it
    (mamba2's mixer zero-padded, then whole), and the collective calls of
    each."""
    import dataclasses

    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.parallel import actshard, collectives

    pol = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    with actshard.use_plan(plan):
        inputs = step_fn.data_parallel.inputs(shards, PAPER_FAITHFUL)
        out = []
        for grad in (False, True):
            tree = spec.tree_map(lambda x: x.detach().requires_grad_(grad), inputs)
            collectives.reset_stats()
            with torch.set_grad_enabled(grad):
                logits = registry.forward(plan.local_config(), pol, tree, batch)
            out.append((logits.detach().numpy(), collectives.stats["calls"]))
    return out


def _case(mesh, cfg, params_np, batches_np):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, global_norm, warmup_cosine_schedule
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
    batches = [{k: torch.from_numpy(v) for k, v in x.items()} for x in batches_np]
    d = plan.mesh.coord("data")
    rows = slice(d * BATCH // mesh[0], (d + 1) * BATCH // mesh[0])
    res = {"token_losses": (tp_step.token_losses(shards, batches[0]).numpy(),
                            one_step.token_losses(whole, batches[0])[rows].numpy())}
    if mesh == (1, 2):
        with torch.no_grad():
            one = registry.forward(cfg, PAPER_FAITHFUL, whole, batches[0])
        res["forward"] = (_forward_bits(tp_step, plan, shards, batches[0]), one.numpy())
    collectives.reset_stats()
    (_, g), scales = R._record_scales(lambda: tp_step.grads(shards, batches[0]))
    res["stats"] = dict(collectives.stats)
    (_, g1), one_scales = R._record_scales(lambda: one_step.grads(whole, batches[0]))
    res["scales"] = (scales, one_scales)
    g = sharded.reduce(g)
    res["grads"] = {n: (bool(torch.equal(x, y)), float((x - y).abs().max()),
                        float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g),
                                              spec.named_leaves(sharded.shard(g1)))}
    res["norm"] = (float(sharded.global_norm(g)), float(global_norm(g1)))
    # the pieces of each packed gradient shard that every model rank holds
    grads = dict(spec.named_leaves(g))
    res["replicated"] = {}
    for name in PACKED if cfg.family == "ssm" else ():
        seg = plan.shard_segments(name)
        if seg is not None:
            off, parts = 0, []
            for _, n, split in seg[1]:
                if not split:
                    parts.append(grads[name].narrow(seg[0], off, n).numpy())
                off += n
            res["replicated"][name] = parts
    res["whole_grads"] = {n: x.numpy() for n, x in spec.named_leaves(sharded.gather(g))}
    res["reassembled"] = {n: bool(torch.equal(x, y)) for (n, x), (_, y) in
                          zip(spec.named_leaves(sharded.gather(shards)),
                              spec.named_leaves(whole))}
    res["split"] = {n: plan.model_split_dim(n) for n, _ in spec.named_leaves(shards)}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for i in range(STEPS):
            params, state, m = step_fn(params, state, batches[i], i)
            losses.append(float(m["loss"]))
        return losses

    # fresh parameters for each run: the updates are in place
    res["tp_losses"] = run(tp_step, sharded.shard(spec.params_from_numpy(params_np, "cpu")))
    res["one_losses"] = run(one_step, spec.params_from_numpy(params_np, "cpu"))
    return res


def _rank_cases(rank, mesh, inputs, ckdirs):
    from repro_torch import configs as TC
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    torch.set_num_threads(1)
    out = {c: _case(mesh, _config(TC, c), *inputs[c]) for c in _cases(mesh)}
    for arch in CLI_ARCHS:
        argv = _cli(arch) + ["--steps", "2", "--mesh", f"{mesh[0]}x{mesh[1]}"]
        if ckdirs:
            argv += ["--ckpt-dir", ckdirs[arch], "--ckpt-every", "100"]
        run = train_cli.main(argv)
        out[arch] = {"cli_losses": [r["loss"] for r in run.records]}
        if ckdirs:
            out[arch]["cli_final"] = {
                n: x.numpy() for n, x in
                spec.named_leaves(run.step_fn.data_parallel.gather(run.params))}
    return out


def _reference_inputs(case):
    """The reference's seed-0 parameters and its batches."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.data import pipeline as jpipeline
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, case)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    shape = JC.ShapeConfig("t", SEQ, BATCH, "train")
    kinds = {"tokens": np.int64, "labels": np.int64}
    batches = [{k: np.array(v).astype(kinds.get(k, np.float32))
                for k, v in jpipeline.make_batch(jcfg, shape, i).items()}
               for i in range(STEPS)]
    return {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}, batches


def _reference_grads(case, params, batch):
    """The reference's gradients at ``batch`` (``jax.grad`` of
    ``registry.loss_fn``), by name."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.core.policy import PAPER_FAITHFUL as J_PF
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, case)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    grads = jax.jit(jax.grad(lambda p: jreg.loss_fn(jcfg, J_PF, p, batch)))(jp)
    return {k: np.asarray(v) for k, v in _flatten_with_names(grads)[0].items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The (1, 2) and (2, 2) worlds' results, the CLI's checkpoint
    directories and the reference's gradients, which this process
    computes while the worlds run."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.parallel import collectives

    inputs = {c: _reference_inputs(c) for c in CASES}
    ckdirs = {a: str(tmp_path_factory.mktemp("tp_recurrent_ckpt")) for a in CLI_ARCHS}

    def run():
        return {(1, 2): collectives.spawn(_rank_cases, 2, (1, 2), inputs, ckdirs,
                                          device="cpu", threads=1),
                (2, 2): collectives.spawn(_rank_cases, 4, (2, 2),
                                          {c: inputs[c] for c in SMOKE_CASES}, None,
                                          device="cpu", threads=1)}

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run)
        grads = {c: _reference_grads(c, inputs[c][0], inputs[c][1][0]) for c in CASES}
        return ranks.result(), ckdirs, grads


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32).tolist()


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_vocab_split_forward_equals_one_rank(worlds, case):
    """The smoke forward on (1, 2), each rank's embedding rows a vocab
    shard: one rank's logits bit for bit, without grad and with it."""
    for res in worlds[0][(1, 2)]:
        (nograd, _), (grad, _) = res[case]["forward"][0]
        one = res[case]["forward"][1]
        assert nograd.shape == one.shape
        assert _bits(nograd) == _bits(one) and _bits(grad) == _bits(one)


@pytest.mark.parametrize("case", ("mamba2", "mamba2_wide"))
def test_whole_ssd_under_autograd_equals_padded_forward(worlds, case):
    """Under autograd every rank runs the mixer whole (more collectives:
    the gathers of z, x, dt and the per-head leaves); without grad its
    heads padded to the whole head count: the same logits, bit for bit."""
    for res in worlds[0][(1, 2)]:
        (nograd, calls_nograd), (grad, calls_grad) = res[case]["forward"][0]
        assert calls_grad > calls_nograd
        assert _bits(grad) == _bits(nograd)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_first_step_token_losses_bit_for_bit(worlds, mesh, case):
    for res in worlds[0][mesh]:
        ours, one = res[case]["token_losses"]
        assert ours.shape == one.shape == (BATCH // mesh[0], SEQ)
        assert _bits(ours) == _bits(one)


@pytest.mark.parametrize("case", CASES)
def test_quantizer_scales_equal_one_rank(worlds, case):
    for res in worlds[0][(1, 2)]:
        ours, one = res[case]["scales"]
        assert len(ours) == len(one) > 0
        assert [k for k, _ in ours].count("g") == [k for k, _ in one].count("g") > 0
        assert ours == one


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_two_by_two_quantizer_scales_equal_one_rank(worlds, case):
    for res in worlds[0][(2, 2)]:
        ours, one = res[case]["scales"]
        assert len(ours) == len(one) > 0 and ours == one


@pytest.mark.parametrize("case", CASES)
def test_one_data_rank_gradients_bit_for_bit(worlds, case):
    """Every leaf's shard: in_proj's, the conv's and the per-head leaves'
    (mamba2), the RG-LRU's, the gates' and the norms' (recurrentgemma),
    every gamma's."""
    arch = CASES[case][0]
    want = ({"layers/in_proj/w", "layers/conv_w", "layers/conv_b", "layers/A_log", "layers/D",
             "layers/dt_bias", "layers/in_proj/gamma", "layers/out_norm/scale"}
            if arch == SSM else
            {"layers/0/wa/w", "layers/0/wi/gamma", "layers/0/lam", "layers/0/conv_w",
             "layers/0/conv_b", "layers/0/ln1/scale", "layers/2/wq/w", "layers/2/wk/w"})
    for res in worlds[0][(1, 2)]:
        assert want <= set(res[case]["grads"])
        bad = {n: v for n, v in res[case]["grads"].items() if not v[0]}
        assert not bad, bad


@pytest.mark.parametrize("case", ("mamba2", "mamba2_wide"))
def test_replicated_pieces_equal_on_both_ranks(worlds, case):
    """in_proj's B and C columns and the conv's B and C channels: every
    model rank holds them, and their gradients are the same on each."""
    ranks = worlds[0][(1, 2)]
    got = [res[case]["replicated"] for res in ranks]
    assert set(got[0]) == set(PACKED)
    for name in PACKED:
        assert len(got[0][name]) == 1
        assert _bits(got[0][name][0]) == _bits(got[1][name][0]), name
        assert np.abs(got[0][name][0]).max() > 0


@pytest.mark.parametrize("case", SMOKE_CASES)
def test_two_data_rank_gradients_within_bound(worlds, case):
    for res in worlds[0][(2, 2)]:
        for name, (_, diff, top) in res[case]["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_three_step_losses_within_bound(worlds, mesh, case):
    ranks = worlds[0][mesh]
    for res in ranks:
        np.testing.assert_allclose(res[case]["tp_losses"], res[case]["one_losses"],
                                   rtol=LOSS_RTOL)
        assert res[case]["tp_losses"] == ranks[0][case]["tp_losses"]


def _layout_counts(case):
    """(forward folds, backward chains, backward gathers) of one (1, 2)
    step's gradients a rank, from the layout (remat: a fold twice)."""
    from repro_torch import configs as TC

    cfg = _config(TC, case)
    wide = CASES[case][1] == "wide"
    if cfg.family == "ssm":
        # out_proj folds (wide) or runs whole; in_proj gathers; the head's
        # 160-column vocab shard gathers
        per = 1 if wide else 0
        return 2 * per * cfg.n_layers, per * cfg.n_layers, cfg.n_layers + 1
    # two RG-LRU layers (wx, wy, wa, wi, gate, up) and one attention layer
    # (q, gate, up; K/V selected whole); wide: every one chains and wout,
    # wo and the down projections fold; smoke: every one gathers
    cols = 2 * 6 + 3
    folds = 2 * 3 if wide else 0
    return 2 * folds, folds + (cols if wide else 0), (0 if wide else cols) + 1


@pytest.mark.parametrize("case", CASES)
def test_layout_chains_and_gathers(worlds, case):
    for res in worlds[0][(1, 2)]:
        st = res[case]["stats"]
        assert (st["folds"], st["bwd_folds"], st["bwd_gathers"], st["selects"]) == \
            _layout_counts(case) + (0,)


@pytest.mark.parametrize("case", CASES)
def test_packed_leaves_reassemble_and_norm_counts_once(worlds, case):
    """``gather`` of the rank's shards is the whole tree bit for bit (the
    packed in_proj, conv_w and conv_b placed by every rank's pieces); the
    global norm is one rank's within rounding."""
    for res in worlds[0][(1, 2)]:
        r = res[case]
        assert all(r["reassembled"].values()), r["reassembled"]
        if CASES[case][0] == SSM:
            assert all(r["split"][n] is not None for n in PACKED)
        ours, one = r["norm"]
        assert ours == pytest.approx(one, rel=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_gradients_vs_reference_jax_grad(worlds, case):
    jgrads = worlds[2][case]
    for res in worlds[0][(1, 2)]:
        assert set(res[case]["whole_grads"]) == set(jgrads)
        for name, g in res[case]["whole_grads"].items():
            ref = jgrads[name]
            err = np.abs(g - ref).max()
            assert err <= GRAD_TOL * max(np.abs(ref).max(), 1e-30), (name, err)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_two_by_two_cli_trains(worlds, arch):
    ranks = worlds[0][(2, 2)]
    losses = ranks[0][arch]["cli_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(res[arch]["cli_losses"] == losses for res in ranks)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_model_axis_checkpoint_restores_in_one_rank_and_reference(worlds, arch, capsys):
    """The (1, 2) CLI run's checkpoint (step 2), an ssm's packed leaves
    gathered whole: the port's one-rank CLI restores it and runs on; the
    reference's manager restores the same values bit for bit."""
    import jax

    from repro import configs as C
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    from repro.ckpt.manager import _flatten_with_names
    from repro.models import registry as jreg, spec as jspec
    from repro.optim import optimizers as joptim
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    ranks, ckdir = worlds[0][(1, 2)], worlds[1][arch]
    assert ranks[0][arch]["cli_losses"] == ranks[1][arch]["cli_losses"]
    final = ranks[0][arch]["cli_final"]
    run = train_cli.main(_cli(arch) + ["--steps", "3", "--ckpt-dir", ckdir,
                                       "--ckpt-every", "100"])
    assert "restoring checkpoint step 2" in capsys.readouterr().out
    assert run.start_step == 2 and len(run.records) == 1
    two = CheckpointManager(ckdir).restore(
        2, {"params": spec.params_from_numpy(final, "cpu")})["params"]
    for name, x in spec.named_leaves(two):
        assert _bits(x.numpy()) == _bits(final[name]), name
    jcfg = C.smoke_config(arch)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 20, 3))
    jtwo = JCheckpointManager(ckdir).restore(2, {"params": jp, "opt_state": jopt.init(jp)})
    for name, x in _flatten_with_names(jtwo["params"])[0].items():
        assert _bits(np.asarray(x)) == _bits(final[name]), name
