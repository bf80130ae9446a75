"""repro_torch's checkpoint manager and CLI restart, alone and against the
JAX reference's (``repro/ckpt/manager.py``, ``repro/launch/train.py``) on
the CPU.

Tolerances and their reasons:
* A checkpoint stores every leaf's bits, so save/restore round trips,
  cross-restores between the packages and a port run resumed from its own
  checkpoint are compared bit for bit.
* The reference continuing the port's run from the port's checkpoint is
  held to the port's own continuation: each step's loss within
  tests/test_torch_train.py's ``LOSS_RTOL = 1e-5`` (the MACs differ by one
  rounding per 128-chunk, transcendentals by ulps), the parameters after
  4 AdamW steps within ``CONT_ATOL = 1e-5``.  test_torch_train.py's
  ``PARAM_ATOL = 1e-6`` covers 3 steps; over these 4 (steps 4-7 of this
  config) a last-ulp difference moves one gradient element of
  ``layers/wo/w`` across a PoT rounding boundary at step 5, its Adam
  moment ``m`` then differs by ~1.5%, and 17 parameters drift apart by up
  to 2.1e-6 — the same drift, to the bit, as the two packages trained
  from scratch without any checkpoint.  An element that stepped the other
  way would be off by ~2·lr = 2e-3, far outside ``CONT_ATOL``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as JC  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ckpt import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.optim.optimizers import tree_map  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
CONT_ATOL = 1e-5

# the config of tests/test_ckpt.py
CFG_KW = dict(name="ck", family="decoder", n_layers=2, d_model=32, n_heads=2,
              kv_heads=1, d_ff=64, vocab=64, head_dim=16, vocab_pad_multiple=64)
J_CFG, CFG = JModelConfig(**CFG_KW), ModelConfig(**CFG_KW)
J_SHAPE = JShapeConfig("t", 32, 4, "train")
CLI = ["--arch", "olmo-1b", "--smoke", "--batch", "4", "--seq", "32", "--log-every", "2",
       "--device", "cpu"]


def _state(seed=0):
    params = spec.materialize(registry.param_specs(CFG), torch.Generator().manual_seed(seed))
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 2, 50))
    return params, opt


def _leaves(tree):
    return list(spec.named_leaves(tree))


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def _named_np(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def test_roundtrip(tmp_path):
    params, opt = _state()
    opt_state = opt.init(params)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(7, {"params": params, "opt_state": opt_state}, blocking=True)
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "step_0000000007")) == [
        "manifest.json", "opt_state.npz", "params.npz"]
    restored = mgr.restore(7, {"params": params, "opt_state": opt_state}, device="cpu")
    _assert_trees_equal(restored["params"], params)
    _assert_trees_equal(restored["opt_state"], opt_state)
    for _, x in _leaves(restored):
        assert x.is_contiguous() and x.device.type == "cpu"
    assert [t["op"] for t in mgr.timings] == ["save", "restore"]


def test_gc_keeps_latest(tmp_path):
    params, _ = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": params}, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_atomicity_tmp_ignored(tmp_path):
    params, _ = _state()
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"params": params}, blocking=True)
    # a crash mid-write of a later step
    os.makedirs(tmp_path / "tmp.2")
    (tmp_path / "tmp.2" / "params.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_0000000002")  # no manifest => incomplete
    assert mgr.latest_step() == 1
    assert mgr.restore_latest({"params": params})[0] == 1


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The optimizers update in place: a step taken while a background
    write is pending must not reach the file.  The write is held back until
    after the update, so a snapshot that shared memory would be caught."""
    import threading

    params, opt = _state()
    state = opt.init(params)
    mgr = CheckpointManager(str(tmp_path))  # async
    gate = threading.Event()
    write = mgr._write

    def held_write(*a, **kw):
        gate.wait(30)
        return write(*a, **kw)

    monkeypatch.setattr(mgr, "_write", held_write)
    before = tree_map(torch.clone, params)
    mgr.save(1, {"params": params, "opt_state": state})
    grads = tree_map(torch.ones_like, params)
    opt.update(grads, state, params, 1)  # in place (lr is 0 at step 0)
    assert not torch.equal(params["embed"], before["embed"])
    gate.set()
    mgr.wait()
    _assert_trees_equal(mgr.restore(1, {"params": params})["params"], before)


def test_restore_checks_leaves(tmp_path):
    params, _ = _state()
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"params": params}, blocking=True)
    bad = tree_map(lambda x: x, params)
    bad["embed"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="embed"):
        mgr.restore(1, {"params": bad})
    bad["embed"] = params["embed"].to(torch.float64)
    with pytest.raises(ValueError, match="embed"):
        mgr.restore(1, {"params": bad})
    extra = dict(params, more=torch.zeros(2))
    with pytest.raises(KeyError, match="more"):
        mgr.restore(1, {"params": extra})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(2, {"params": {"w": torch.zeros(2, dtype=torch.bfloat16)}})


def _jax_olmo_state(optimizer):
    """A smoke olmo-1b state in the reference: params and an optimizer
    state filled with seeded values (not zeros, so that every leaf's bits
    are checked)."""
    cfg = JC.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    jopt = (joptim.adamw(joptim.warmup_cosine_schedule(1e-3, 2, 50)) if optimizer == "adamw"
            else joptim.sgd_momentum(joptim.step_decay_schedule(0.1, [5])))
    rng = np.random.default_rng(1)
    js = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), jopt.init(jp))
    return cfg, jp, js


def _port_template(jp, js):
    tp = spec.params_from_numpy(_named_np(jp), "cpu")
    ts = spec.params_from_numpy(_named_np(js), "cpu")
    return {"params": tree_map(torch.zeros_like, tp), "opt_state": tree_map(torch.zeros_like, ts)}


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_port_restores_reference_checkpoint(tmp_path, optimizer):
    _, jp, js = _jax_olmo_state(optimizer)
    JCheckpointManager(str(tmp_path), async_write=False).save(
        5, {"params": jp, "opt_state": js}, blocking=True)
    template = _port_template(jp, js)
    # the port's own optimizer names its state as the reference does
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 2, 50)) if optimizer == "adamw" \
        else optim.sgd_momentum(optim.step_decay_schedule(0.1, [5]))
    assert [n for n, _ in spec.named_leaves(opt.init(template["params"]))] == \
        [n for n, _ in spec.named_leaves(template["opt_state"])]
    mgr = CheckpointManager(str(tmp_path))
    step, got = mgr.restore_latest(template)
    assert step == 5
    for group, ref in (("params", jp), ("opt_state", js)):
        want = _named_np(ref)
        for name, x in spec.named_leaves(got[group]):
            assert x.dtype == torch.float32
            assert x.numpy().view(np.uint32).tolist() == want[name].view(np.uint32).tolist()


def test_reference_restores_port_checkpoint(tmp_path):
    _, jp, js = _jax_olmo_state("adamw")
    state = {"params": spec.params_from_numpy(_named_np(jp), "cpu"),
             "opt_state": spec.params_from_numpy(_named_np(js), "cpu")}
    state["opt_state"]["m"]["embed"].mul_(3.0)  # the port's own values
    CheckpointManager(str(tmp_path), async_write=False).save(4, state, blocking=True)
    with open(tmp_path / "step_0000000004" / "manifest.json") as f:
        import json
        manifest = json.load(f)
    assert manifest["step"] == 4 and sorted(manifest["groups"]) == ["opt_state", "params"]
    assert manifest["groups"]["params"]["names"] == sorted(_named_np(jp))
    step, got = JCheckpointManager(str(tmp_path)).restore_latest(
        {"params": jp, "opt_state": js})
    assert step == 4
    for group in ("params", "opt_state"):
        want = {n: x.numpy() for n, x in spec.named_leaves(state[group])}
        for name, x in _named_np(got[group]).items():
            assert x.view(np.uint32).tolist() == want[name].view(np.uint32).tolist(), name


def test_restart_continuity_and_reference_continuation(tmp_path):
    """From one JAX-materialized state: 4 port steps, save, restore, 4 more
    equal 8 uninterrupted port steps bit for bit; the reference continuing
    from the port's checkpoint stays within LOSS_RTOL / CONT_ATOL of the
    port."""
    jp = jspec.materialize(jreg.param_specs(J_CFG), jax.random.PRNGKey(0))
    batches = [jpipeline.make_batch(J_CFG, J_SHAPE, s) for s in range(8)]
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 2, 50))
    tstep = make_train_step(CFG, PAPER_FAITHFUL, opt)

    def torch_batch(b):
        return {k: torch.from_numpy(np.array(v)).to(torch.float32 if k == "mask" else torch.int64)
                for k, v in b.items()}

    losses = {}

    def run(p, s, s0, s1):
        for step in range(s0, s1):
            p, s, m = tstep(p, s, torch_batch(batches[step]), step)
            losses[step] = float(m["loss"])
        return p, s

    fresh = spec.params_from_numpy(_named_np(jp), "cpu")
    pA, sA = run(fresh, opt.init(fresh), 0, 8)
    fresh = spec.params_from_numpy(_named_np(jp), "cpu")
    pB, sB = run(fresh, opt.init(fresh), 0, 4)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(4, {"params": pB, "opt_state": sB}, blocking=True)
    step, st = mgr.restore_latest({"params": pB, "opt_state": sB})
    assert step == 4
    pD, sD = run(st["params"], st["opt_state"], 4, 8)
    _assert_trees_equal(pD, pA)
    _assert_trees_equal(sD, sA)

    # the reference picks up the port's checkpoint and runs steps 4..7
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(1e-3, 2, 50))
    jtemplate = {"params": jp, "opt_state": jopt.init(jp)}
    _, jst = JCheckpointManager(str(tmp_path)).restore_latest(jtemplate)
    jparams = jax.tree_util.tree_map(jnp.asarray, jst["params"])
    jstate = jax.tree_util.tree_map(jnp.asarray, jst["opt_state"])
    jstep = jax.jit(j_make_train_step(J_CFG, J_PF, jopt, JTrainConfig()))
    for s in range(4, 8):
        jparams, jstate, jm = jstep(jparams, jstate, batches[s], jnp.int32(s))
        np.testing.assert_allclose(float(jm["loss"]), losses[s], rtol=LOSS_RTOL)
    want = _named_np(jparams)
    worst = max(float(np.abs(x.numpy() - want[n]).max()) for n, x in spec.named_leaves(pA))
    print(f"reference continuation vs port: largest parameter difference {worst:.3g}")
    assert worst <= CONT_ATOL


def test_cli_restart_restores_final_step(tmp_path, capsys):
    """tests/test_system.py's restart check, on the port's CLI."""
    args = CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    run = train_cli.main(args)
    out = capsys.readouterr().out
    assert "step     5" in out and "restoring" not in out
    assert run.start_step == 0 and len(run.records) == 6
    assert run.ckpt.all_steps() == [3, 6]
    run = train_cli.main(args)  # restores step 6 and has nothing left to run
    out = capsys.readouterr().out
    assert "restoring checkpoint step 6" in out
    assert run.start_step == 6 and run.records == []


def test_cli_resumed_run_equals_uninterrupted(tmp_path):
    """--steps 5 then a rerun with --steps 6 equals one --steps 6 run, bit
    for bit (all steps lie in the 20-step warmup, where the schedule does
    not depend on --steps)."""
    d = str(tmp_path / "resumed")
    train_cli.main(CLI + ["--steps", "5", "--ckpt-dir", d, "--ckpt-every", "100"])
    resumed = train_cli.main(CLI + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "100"])
    assert resumed.start_step == 5 and [r["step"] for r in resumed.records] == [5]
    whole = train_cli.main(CLI + ["--steps", "6"])
    _assert_trees_equal(resumed.params, whole.params)
    _assert_trees_equal(resumed.opt_state, whole.opt_state)
    assert resumed.records[0]["loss"] == whole.records[5]["loss"]


def test_cli_mid_run_checkpoint_label(tmp_path):
    """The reference's labels: the save after step 3's update is labelled
    3 but holds 4 updates (so a restart from it runs step 3 again); only
    the final save is labelled by its number of updates."""
    d = str(tmp_path)
    run = train_cli.main(CLI + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    four = train_cli.main(CLI + ["--steps", "4"])
    template = {"params": run.params, "opt_state": run.opt_state}
    got = CheckpointManager(d).restore(3, template)
    _assert_trees_equal(got["params"], four.params)
    _assert_trees_equal(got["opt_state"], four.opt_state)
    final = CheckpointManager(d).restore(6, template)
    _assert_trees_equal(final["params"], run.params)
