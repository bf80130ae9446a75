"""Training the recurrent families in repro_torch against the JAX
reference at smoke size: two AdamW steps of mamba2-2.7b (ssm) and
recurrentgemma-2b (hybrid, a tuple of per-layer parameter dicts) through
``make_train_step`` on the reference's batches (tokens only), and the
training CLI's ``--smoke`` run with a checkpoint and a restart.

Tolerances (tests/test_torch_train.py's): each loss and gradient norm
within ``LOSS_RTOL`` = 1e-5 relative, every parameter after the steps
within ``PARAM_ATOL`` = 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import spec  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
J_SHAPE = JShapeConfig("t", 16, 2, "train")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_vs_reference(arch):
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = spec.params_from_numpy({k: np.asarray(v) for k, v in
                                 _flatten_with_names(jp)[0].items()}, "cpu")
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 5, 30))
    opt = optim.adamw(optim.warmup_cosine_schedule(3e-3, 5, 30))
    jstep = jax.jit(j_make_train_step(jcfg, J_PF, jopt))
    tstep = make_train_step(tcfg, PAPER_FAITHFUL, opt)
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(2):
        jb = jpipeline.make_batch(jcfg, J_SHAPE, step)
        assert set(jb) == {"tokens", "labels", "mask"}
        jp, js, jm = jstep(jp, js, jb, jnp.int32(step))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
        tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
        tp, ts, tm = tstep(tp, ts, tb, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    jn = {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}
    assert [n for n, _ in spec.named_leaves(tp)] == list(jn)
    for leaf, x in spec.named_leaves(tp):
        err = np.abs(x.numpy() - jn[leaf]).max()
        assert err <= PARAM_ATOL, (leaf, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_smoke_and_restart(arch, tmp_path, capsys):
    """``--smoke`` for 2 steps with a checkpoint, then a rerun to 3 steps
    restores step 2 and runs step 2 only; the batches are tokens only."""
    cfg = TC.smoke_config(arch)
    batch = pipeline.make_batch(cfg, ShapeConfig("t", 16, 2, "train"), 0, device="cpu")
    assert set(batch) == {"tokens", "labels", "mask"}
    cli = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16", "--log-every", "1",
           "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    run = train_cli.main(cli + ["--steps", "2"])
    assert len(run.records) == 2 and run.ckpt.latest_step() == 2
    for r in run.records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
    again = train_cli.main(cli + ["--steps", "3"])
    assert again.start_step == 2 and [r["step"] for r in again.records] == [2]
    assert "restoring checkpoint step 2" in capsys.readouterr().out
