"""Data-parallel training of repro_torch over two gloo ranks on the CPU:
olmo-1b at smoke width on the (2, 1) (data, model) mesh against one rank
at the same global batch (4 x 16), under ``PAPER_FAITHFUL``.

What must hold, and why:

* the first step's per-token losses are one rank's bit for bit: the
  forward of a rank's rows runs with the global activation maxima (an
  all-reduce max per linear) on the masters gathered whole, and every op
  in it is row-independent on the CPU;
* every quantizer scale of the step (weights, activations, and the
  backward's G, from the global max|G|) equals one rank's, call by call;
* a gradient is the sum over ranks of partial MAC folds (K3 over each
  rank's rows, then an all-reduce), so it agrees with one rank's to
  rounding: within 1e-4 of the leaf's largest magnitude, and the losses
  of 3 steps within 1e-5 relative (ROADMAP's stated bounds);
* each rank holds half of every master and optimizer-state leaf whose
  ``embed`` dim divides (the plan's embed-over-data rule), the rest whole;
* a checkpoint written by 2 ranks (``launch.train --mesh 2x1``) restores
  in one rank of the port's CLI and in the reference's manager, bit for
  bit.

The ranks run once per module (one spawned world); the tests read what
they returned.
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

BATCH, SEQ, STEPS = 4, 16, 3
CLI = ["--arch", "olmo-1b", "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
       "--log-every", "1", "--device", "cpu"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _record_scales(fn):
    """Every quantizer scale ``fn`` takes, in call order: the beta of each
    ``potq.pot_quantize`` (weights, activations) and of each G
    (``ops._g_scalars``)."""
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


def _skewed(batch, vocab):
    """The pipeline's batch with the second half's token ids mirrored
    (id -> vocab - 1 - id) and its loss weights cut to 1/16: the second
    rank's gradients are then 16x smaller than the first's, so a
    rank-local G scale (or a local token count) would show in the scales
    and the gradients."""
    half = batch["tokens"].shape[0] // 2
    out = dict(batch)
    for key in ("tokens", "labels"):
        x = batch[key].clone()
        x[half:] = vocab - 1 - x[half:]
        out[key] = x
    out["mask"] = batch["mask"].clone()
    out["mask"][half:] *= 1.0 / 16
    return out


def _rank_cases(rank, ckdir):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    torch.set_num_threads(1)
    cfg = TC.smoke_config("olmo-1b")
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
    res = {}

    res["token_losses"] = (dp_step.token_losses(shards, batches[0]).numpy(),
                           one_step.token_losses(whole, batches[0])[rows].numpy())
    res["scales"] = (_record_scales(lambda: dp_step.grads(shards, batches[0])),
                     _record_scales(lambda: one_step.grads(whole, batches[0])))
    _, g = dp_step.grads(shards, batches[0])
    g = dp.gather(dp.reduce(g))
    _, g1 = one_step.grads(whole, batches[0])
    res["grads"] = {n: (float((x - y).abs().max()), float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g), spec.named_leaves(g1))}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for s in range(STEPS):
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
        return params, state, losses

    p_dp, s_dp, res["dp_losses"] = run(dp_step, dp.shard(whole))
    _, _, res["one_losses"] = run(one_step, {k: v for k, v in whole.items()})
    res["shapes"] = {
        "whole": {n: tuple(x.shape) for n, x in spec.named_leaves(whole)},
        "params": {n: tuple(x.shape) for n, x in spec.named_leaves(p_dp)},
        "opt": {n: tuple(x.shape) for n, x in spec.named_leaves(s_dp)},
        "split": {n: plan.data_split_dim(n) for n, _ in spec.named_leaves(whole)},
    }
    run2 = train_cli.main(CLI + ["--steps", "2", "--mesh", "2x1", "--ckpt-dir", ckdir,
                                 "--ckpt-every", "100"])
    res["cli_losses"] = [r["loss"] for r in run2.records]
    res["cli_final"] = {n: x.numpy() for n, x in spec.named_leaves(dp.gather(run2.params))}
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.parallel import collectives

    ckdir = str(tmp_path_factory.mktemp("dp_ckpt"))
    return ckdir, collectives.spawn(_rank_cases, 2, ckdir, device="cpu", threads=1)


def test_first_step_token_losses_bit_for_bit(world):
    _, results = world
    for res in results:
        ours, one = res["token_losses"]
        assert ours.shape == (BATCH // 2, SEQ)
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()


def test_quantizer_scales_equal_one_rank(world):
    _, results = world
    for res in results:
        ours, one = res["scales"]
        assert len(ours) == len(one) > 0
        assert [k for k, _ in ours].count("g") == [k for k, _ in one].count("g") > 0
        assert ours == one


def test_gradients_within_bound(world):
    _, results = world
    for res in results:
        for name, (diff, top) in res["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)


def test_three_step_losses_within_bound(world):
    _, results = world
    for res in results:
        np.testing.assert_allclose(res["dp_losses"], res["one_losses"], rtol=LOSS_RTOL)
    assert results[0]["dp_losses"] == results[1]["dp_losses"]


def test_each_rank_holds_half_of_what_divides(world):
    _, results = world
    for res in results:
        sh = res["shapes"]
        assert any(d is not None for d in sh["split"].values())
        for name, full in sh["whole"].items():
            d = sh["split"][name]
            want = tuple(s // 2 if i == d else s for i, s in enumerate(full))
            assert sh["params"][name] == want, name
            for group in ("m", "v"):
                assert sh["opt"][f"{group}/{name}"] == want, (group, name)


def test_two_rank_checkpoint_restores_in_one_rank_and_reference(world, capsys):
    """The 2-rank CLI run's checkpoint (step 2): the port's one-rank CLI
    restores it and runs on; the reference's manager restores the same
    values bit for bit."""
    import jax

    from repro import configs as C
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    from repro.ckpt.manager import _flatten_with_names
    from repro.models import registry as jreg, spec as jspec
    from repro.optim import optimizers as joptim
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    ckdir, results = world
    assert results[0]["cli_losses"] == results[1]["cli_losses"]
    final = results[0]["cli_final"]
    run = train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", ckdir, "--ckpt-every", "100"])
    assert "restoring checkpoint step 2" in capsys.readouterr().out
    assert run.start_step == 2 and len(run.records) == 1
    jcfg = C.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 20, 3))
    step, got = JCheckpointManager(ckdir).restore_latest({"params": jp,
                                                          "opt_state": jopt.init(jp)})
    assert step == 3  # the one-rank continuation's own final save
    from repro_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(ckdir)
    tmpl = {"params": spec.params_from_numpy(final, "cpu")}
    two = mgr.restore(2, tmpl)["params"]
    for name, x in spec.named_leaves(two):
        assert x.numpy().view(np.uint32).tolist() == final[name].view(np.uint32).tolist()
    jtwo = JCheckpointManager(ckdir).restore(2, {"params": jp, "opt_state": jopt.init(jp)})
    for name, x in _flatten_with_names(jtwo["params"])[0].items():
        assert np.asarray(x).view(np.uint32).tolist() == final[name].view(
            np.uint32).tolist(), name


def test_model_axis_training_is_refused():
    from repro_torch.launch import train as train_cli

    with pytest.raises(NotImplementedError, match="model axis"):
        train_cli.main(CLI + ["--steps", "1", "--mesh", "1x2"])
