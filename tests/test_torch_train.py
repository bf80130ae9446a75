"""repro_torch training slice vs the JAX reference on the CPU: ``lm_loss``
and its gradients, the optimizers and schedules, three steps of
``make_train_step`` against ``jax.jit(repro.train.make_train_step(...))``,
the data pipeline, the CLI, and the port's own convergence check.

Tolerances and their reasons:
* Schedules, optimizers and clipping: the same float32 arithmetic step for
  step; pow, cos and sqrt may differ from XLA's in the last ulp, so
  ``rtol = 1e-6`` (~8 ulps).
* Loss: the MACs differ by one rounding per 128-chunk and rope, rsqrt,
  softmax and logsumexp by a few ulps: ``rtol = 1e-5``.
* Gradients: the same per-element differences, each through a few layers,
  plus the rare activation or gradient that a last-ulp difference moves
  across a PoT rounding boundary (a factor of √2 on one element):
  ``|dg| <= 1e-4 * max|g|`` per leaf.
* Parameters after 3 AdamW steps: every step moves an element by at most
  ~lr = 3e-3 and the step's relative error is that of the gradient ratio
  m/sqrt(v), a few ulps; f32 rounding of the parameters adds ~1e-8 a
  step.  ``atol = 1e-6`` (the largest difference seen is ~6e-8) still
  catches an element that stepped the other way (2*lr).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as JC  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.policy import FP32_BASELINE as J_FP32  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.train import TrainConfig, loss_and_grads, make_train_step  # noqa: E402

torch.set_num_threads(1)

SCHED_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6

# the conv-test config of tests/test_train_convergence.py
CFG_KW = dict(name="conv-test", family="decoder", n_layers=2, d_model=64, n_heads=4,
              kv_heads=2, d_ff=128, vocab=64, head_dim=16, vocab_pad_multiple=64)
J_CFG, CFG = JModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
J_SHAPE, SHAPE = JShapeConfig("t", 64, 8, "train"), ShapeConfig("t", 64, 8, "train")
POLICIES = {"paper": (PAPER_FAITHFUL, J_PF), "fp32": (FP32_BASELINE, J_FP32)}


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _ref_params(cfg):
    jp = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    return jp, spec.params_from_numpy(_named(jp), "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).to(torch.float32 if k == "mask" else torch.int64)
            for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_lm_loss_and_grads_vs_reference(name):
    pol, jpol = POLICIES[name]
    jcfg, cfg = JC.smoke_config("olmo-1b"), TC.smoke_config("olmo-1b")
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()}
    jp, tp = _ref_params(jcfg)
    jb = jpipeline.make_batch(jcfg, JShapeConfig("t", 16, 2, "train"), 0)

    def jloss(p):
        return jtr.lm_loss(jcfg, jpol, p, jb["tokens"], jb["labels"], jb["mask"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = loss_and_grads(cfg, pol, tp, _torch_batch(jb))
    print(f"{name}: loss {float(loss)!r} vs {float(jl)!r}")
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    jgn = _named(jg)
    for leaf, g in spec.named_leaves(grads):
        ref = jgn[leaf]
        err = np.abs(g.numpy() - ref).max()
        print(f"  {leaf}: max |dg| {err:.3g} of max |g| {np.abs(ref).max():.3g}")
        assert g.dtype == torch.float32 and err <= GRAD_RTOL * np.abs(ref).max(), leaf


def test_schedules_vs_reference():
    steps = [0, 1, 4, 5, 6, 11, 17, 29, 30, 45]
    pairs = [(optim.warmup_cosine_schedule(3e-3, 5, 30), joptim.warmup_cosine_schedule(3e-3, 5, 30)),
             (optim.warmup_cosine_schedule(1e-2, 0, 7), joptim.warmup_cosine_schedule(1e-2, 0, 7)),
             (optim.step_decay_schedule(0.1, [3, 7], 0.5), joptim.step_decay_schedule(0.1, [3, 7], 0.5))]
    for ours, theirs in pairs:
        for s in steps:
            got = float(ours(s))
            np.testing.assert_allclose(got, float(theirs(jnp.int32(s))), rtol=SCHED_RTOL)
            assert torch.as_tensor(ours(s)).dtype == torch.float32


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((3,)).astype(np.float32),
                  "d": (rng.standard_normal((2, 4)) * 1e-6).astype(np.float32)}}


def _to_torch(tree):
    return optim.optimizers.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("which", ["adamw", "adamw_wd", "sgd", "sgd_wd"])
def test_optimizers_vs_reference(which):
    if which.startswith("adamw"):
        wd = 0.1 if which.endswith("wd") else 0.0
        ours = optim.adamw(optim.warmup_cosine_schedule(3e-3, 2, 10), weight_decay=wd)
        theirs = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 2, 10), weight_decay=wd)
    else:
        wd = 1e-2 if which.endswith("wd") else 0.0
        ours = optim.sgd_momentum(optim.step_decay_schedule(0.05, [2]), weight_decay=wd)
        theirs = joptim.sgd_momentum(joptim.step_decay_schedule(0.05, [2]), weight_decay=wd)
    p_np = _np_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = _to_torch(p_np)
    js, ts = theirs.init(jp), ours.init(tp)
    for step in range(4):
        g_np = _np_tree(10 + step)
        jp, js = theirs.update(jax.tree_util.tree_map(jnp.asarray, g_np), js, jp, jnp.int32(step))
        tp, ts = ours.update(_to_torch(g_np), ts, tp, step)
    for x, y in zip(_leaves(jp) + _leaves(js),
                    [t.numpy() for t in optim.optimizers.tree_leaves(tp)]
                    + [t.numpy() for k in sorted(ts) for t in optim.optimizers.tree_leaves(ts[k])]):
        np.testing.assert_allclose(y, x, rtol=SCHED_RTOL, atol=1e-12)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_vs_reference(max_norm):
    g_np = _np_tree(3)
    jg, jn = joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g_np), max_norm)
    tg, tn = optim.clip_by_global_norm(_to_torch(g_np), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=SCHED_RTOL)
    for x, y in zip(_leaves(jg), optim.optimizers.tree_leaves(tg)):
        np.testing.assert_allclose(y.numpy(), x, rtol=SCHED_RTOL, atol=1e-12)


@pytest.mark.parametrize("name,micro", [("paper", 1), ("paper", 2), ("fp32", 1)])
def test_train_steps_vs_reference(name, micro):
    """Three steps from the same parameters and batches, AdamW with the
    convergence test's schedule: losses and parameters agree."""
    pol, jpol = POLICIES[name]
    jp, tp = _ref_params(J_CFG)
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 5, 30))
    opt = optim.adamw(optim.warmup_cosine_schedule(3e-3, 5, 30))
    jstep = jax.jit(j_make_train_step(J_CFG, jpol, jopt, JTrainConfig(microbatches=micro)))
    tstep = make_train_step(CFG, pol, opt, TrainConfig(microbatches=micro))
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        jb = jpipeline.make_batch(J_CFG, J_SHAPE, step)
        jp, js, jm = jstep(jp, js, jb, jnp.int32(step))
        tp, ts, tm = tstep(tp, ts, _torch_batch(jb), step)
        print(f"step {step}: loss {float(tm['loss'])!r} vs {float(jm['loss'])!r}")
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    jn = _named(jp)
    worst = 0.0
    for leaf, x in spec.named_leaves(tp):
        err = np.abs(x.numpy() - jn[leaf]).max()
        worst = max(worst, err)
        assert err <= PARAM_ATOL, (leaf, err)
    print(f"largest parameter difference after 3 steps: {worst:.3g}")


def test_train_step_without_clipping_vs_reference():
    """``TrainConfig(clip_norm=None)``: no clipping, the global norm is
    still reported.  One olmo-1b smoke step against the reference's step,
    with a learning rate large enough that an unclipped update (the
    norm is above 1 here) differs from a clipped one by far more than
    ``PARAM_ATOL``."""
    jcfg, cfg = JC.smoke_config("olmo-1b"), TC.smoke_config("olmo-1b")
    jp, tp = _ref_params(jcfg)
    jopt, opt = joptim.sgd_momentum(lambda s: 0.5), optim.sgd_momentum(lambda s: 0.5)
    jstep = jax.jit(j_make_train_step(jcfg, J_PF, jopt, JTrainConfig(clip_norm=None)))
    tstep = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(clip_norm=None))
    jb = jpipeline.make_batch(jcfg, J_SHAPE, 0)
    jp, _, jm = jstep(jp, jopt.init(jp), jb, jnp.int32(0))
    tp, _, tm = tstep(tp, opt.init(tp), _torch_batch(jb), 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_RTOL)
    assert float(tm["grad_norm"]) > 1.0  # a clip at 1 would have scaled the step
    jn = _named(jp)
    for leaf, x in spec.named_leaves(tp):
        np.testing.assert_allclose(x.numpy(), jn[leaf], rtol=0, atol=PARAM_ATOL,
                                   err_msg=leaf)


def _run_training(policy, steps=30, lr=3e-3):
    params = spec.materialize(registry.param_specs(CFG), torch.Generator().manual_seed(0))
    opt = optim.adamw(optim.warmup_cosine_schedule(lr, 5, steps))
    tstep = make_train_step(CFG, policy, opt, TrainConfig())
    state = opt.init(params)
    losses = []
    for step in range(steps):
        batch = pipeline.make_batch(CFG, SHAPE, step, device="cpu")
        params, state, m = tstep(params, state, batch, step)
        losses.append(float(m["loss"]))
    return losses


def test_fp32_and_potq_both_learn():
    """The port's own version of tests/test_train_convergence.py's check:
    both policies fit the synthetic induction structure, and quantized
    training tracks FP32 closely."""
    fp32 = _run_training(FP32_BASELINE)
    potq = _run_training(PAPER_FAITHFUL)
    assert fp32[-1] < fp32[0] - 0.4, fp32
    assert potq[-1] < potq[0] - 0.4, potq
    assert potq[-1] < fp32[-1] + 0.7, (potq[-1], fp32[-1])


def test_make_batch_structure():
    cfg = TC.smoke_config("olmo-1b")
    shape = ShapeConfig("t", 20, 3, "train")
    b = pipeline.make_batch(cfg, shape, 4, seed=1, device="cpu")
    shapes = pipeline.batch_shapes(cfg, shape)
    assert set(b) == set(shapes) == {"tokens", "labels", "mask"}
    for k, (shp, dt) in shapes.items():
        assert tuple(b[k].shape) == shp and b[k].dtype == dt
    tok = b["tokens"]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab
    assert torch.equal(tok[:, 10:], tok[:, :10])  # induction period s//2
    assert torch.equal(b["labels"], torch.roll(tok, -1, dims=1))
    assert torch.all(b["mask"][:, :-1] == 1) and torch.all(b["mask"][:, -1] == 0)
    again = pipeline.make_batch(cfg, shape, 4, seed=1, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)  # a function of (seed, step)
    other = pipeline.make_batch(cfg, shape, 5, seed=1, device="cpu")
    assert not torch.equal(b["tokens"], other["tokens"])
    big = pipeline.make_batch(cfg, ShapeConfig("t", 512, 8, "train"), 0, device="cpu")
    ids = big["tokens"].flatten()
    assert float((ids < cfg.vocab // 8).float().mean()) > 0.4  # Zipf-ish: u^3 mass on small ids


def test_train_cli_smoke(capsys):
    run = train_cli.main(["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--log-every", "1", "--device", "cpu",
                          "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "done" in out and out.count("step ") == 3
    assert len(run.records) == 3
    for r in run.records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0


def test_ste_gradients_are_float32():
    cfg = TC.smoke_config("olmo-1b")
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    step = make_train_step(cfg, PAPER_FAITHFUL, optim.adamw(optim.warmup_cosine_schedule(1e-3, 1, 3)))
    batch = pipeline.make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, device="cpu")
    _, grads = step.grads(params, batch)
    for name, g in spec.named_leaves(grads):
        assert g.dtype == torch.float32, name
        if name.endswith("/w"):
            assert float(g.abs().max()) > 0, name


def test_launch_counts_per_step(monkeypatch):
    """One step runs K1 once per linear forward plus once per recomputed
    layer linear, and K2 and K3 once per linear backward."""
    cfg = TC.smoke_config("olmo-1b")
    counts = {"k1": 0, "k2": 0, "k3": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops._k, "potq_matmul_plain", counting("k1", ops._k.potq_matmul_plain))
    monkeypatch.setattr(ops._kg, "grad_da_plain", counting("k2", ops._kg.grad_da_plain))
    monkeypatch.setattr(ops._kg, "grad_dw_plain", counting("k3", ops._kg.grad_dw_plain))
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 1, 3))
    step = make_train_step(cfg, PAPER_FAITHFUL, opt)
    batch = pipeline.make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, device="cpu")
    step(params, opt.init(params), batch, 0)
    per_pass = 7 * cfg.n_layers + 1
    assert counts == {"k1": per_pass + 7 * cfg.n_layers, "k2": per_pass, "k3": per_pass}
    # without recomputation the forward runs once
    counts.update(k1=0, k2=0, k3=0)
    with torch.enable_grad():
        loss = transformer.lm_loss(cfg, PAPER_FAITHFUL, params, batch["tokens"],
                                   batch["labels"], batch["mask"], remat=False)
    assert counts["k1"] == per_pass and loss.dim() == 0


def test_weight_shadow_off_vs_reference():
    """``TrainConfig(weight_shadow=False)``: every ``mf_linear`` quantizes
    its float32 master at use.  Three steps against the reference's
    shadow-off steps: losses within ``LOSS_RTOL``, parameters within
    ``PARAM_ATOL``; and against the port's shadow-on run, whose losses
    and parameters it equals bit for bit (the shadow is the same WBC and
    quantization of each layer's weight, made once a step)."""
    jp, tp = _ref_params(J_CFG)
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 5, 30))
    opt = optim.adamw(optim.warmup_cosine_schedule(3e-3, 5, 30))
    jstep = jax.jit(j_make_train_step(J_CFG, J_PF, jopt, JTrainConfig(weight_shadow=False)))
    tstep = make_train_step(CFG, PAPER_FAITHFUL, opt, TrainConfig(weight_shadow=False))
    on_step = make_train_step(CFG, PAPER_FAITHFUL, opt, TrainConfig())
    on = spec.tree_map(lambda x: x.clone(), tp)
    js, ts, ts_on = jopt.init(jp), opt.init(tp), opt.init(on)
    for step in range(3):
        jb = jpipeline.make_batch(J_CFG, J_SHAPE, step)
        jp, js, jm = jstep(jp, js, jb, jnp.int32(step))
        tp, ts, tm = tstep(tp, ts, _torch_batch(jb), step)
        on, ts_on, m_on = on_step(on, ts_on, _torch_batch(jb), step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        assert torch.equal(tm["loss"], m_on["loss"])
    jn = _named(jp)
    for leaf, x in spec.named_leaves(tp):
        assert np.abs(x.numpy() - jn[leaf]).max() <= PARAM_ATOL, leaf
    for (_, x), (_, y) in zip(spec.named_leaves(tp), spec.named_leaves(on)):
        assert torch.equal(x, y)


def test_bits_for_matches_reference():
    from repro.core.policy import QuantPolicy as JQuantPolicy

    from repro_torch.core.policy import QuantPolicy

    ours, theirs = QuantPolicy(bits_w=4, bits_a=3, bits_g=6, bits_g_last=7), \
        JQuantPolicy(bits_w=4, bits_a=3, bits_g=6, bits_g_last=7)
    for kind in ("w", "a", "g"):
        for last in (False, True):
            assert ours.bits_for(kind, last) == theirs.bits_for(kind, last)
    for pol in (ours, theirs):
        with pytest.raises(ValueError, match="unknown tensor kind"):
            pol.bits_for("x")
