"""repro_torch's MoE layer vs the JAX reference at smoke size: the expert
linear ``mf_expert_linear`` (forward, backward, per-slot form), the
capacity dispatch ``_moe_apply`` (routing, drops, pad rows), the loss and
gradients of both MoE smoke configs (llama4-scout-17b-a16e: 4 experts
top-1 + a shared expert; grok-1-314b: 4 experts top-2, gelu), the
training CLI's restart and a checkpoint the reference restores.

Tolerances and their reasons:
* Routing decisions (expert, queue position, keep), pad rows' experts,
  configs, parameter shapes and checkpoint bytes: equal.
* ``mf_expert_linear``'s forward: ``ceil(K/128) * eps_f32 * (|Aq| @ |Wq|)``
  per output (tests/test_torch_mfmac.py's bound): the same PoT operands,
  the reference sums over K in the backend's order, the port each
  128-chunk exactly and the chunks left-folded.
* Its backward and the model gradients: ``GRAD_RTOL`` = 1e-4 of the
  leaf's largest |gradient| (tests/test_torch_train.py's bound), except
  where the exact gradient is zero: a top-1 gate is g / g = 1, so the
  router of llama4-scout gets only rounding noise in both packages; that
  noise is held below ``GRAD_RTOL`` of the tree's largest |gradient|.
* The MoE output and the loss: ``MOE_ATOL`` = 1e-3 absolute (the serving
  slice's logit bound) and ``LOSS_RTOL`` = 1e-5 relative.
* ``mf_expert_linear`` under ``FP32_BASELINE`` (plain float32 products):
  ``FP32_RTOL`` = 1e-5 relative to the output's largest magnitude, the
  two backends' float32 summation orders over K = 200.
* Inside the port (per-slot form = each slot alone, batched = one expert
  at a time): bit for bit.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import mfmac as jmfmac  # noqa: E402
from repro.core.policy import FP32_BASELINE as J_FP32  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import warmup_cosine_schedule as j_schedule  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import mfmac  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
EPS = np.finfo(np.float32).eps
GAMMA = 0.95
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
MOE_ATOL = 1e-3
FP32_RTOL = 1e-5
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
CLI = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--batch", "2", "--seq", "16",
       "--log-every", "1", "--device", "cpu"]


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@functools.lru_cache(maxsize=None)
def _model(arch, capacity_factor=None):
    """(reference cfg, port cfg, reference params, port params) at smoke
    size, one parameter draw; ``capacity_factor`` overrides the config's."""
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, params, spec.params_from_numpy(_named(params), "cpu")


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_specs_match_reference(arch):
    """get_config and smoke_config equal the reference's field for field,
    and every parameter leaf at full width has the reference's name and
    shape, grok-1's unused ``up`` included."""
    for tcfg, jcfg in ((TC.get_config(arch), C.get_config(arch)),
                       (TC.smoke_config(arch), C.smoke_config(arch))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tspecs = dict(spec.named_leaves(registry.param_specs(TC.get_config(arch))))
    jspecs = _flatten_with_names(jreg.param_specs(C.get_config(arch)))[0]
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert "layers/moe/up/w" in tspecs


def _expert_inputs(e, t, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((e, t, k)).astype(np.float32)
    a[1] *= 8.0  # the experts' scales differ
    w = (rng.standard_normal((e, k, n)) * 0.02 + 0.001).astype(np.float32)
    g = rng.standard_normal((e, t, n)).astype(np.float32)
    return a, w, g


def _expert_bound(a, w, policy, axes):
    """ceil(K/128)·eps·(|Aq|@|Wq|) from the port's quantized operands."""
    k = a.shape[-1]
    aq = mfmac._quantize_a(torch.from_numpy(a), torch.tensor(GAMMA), policy, axes=axes)
    wq = mfmac._quantize_w(torch.from_numpy(w), policy, axes=(1, 2))
    aq = aq.double().abs().reshape(a.shape[0], -1, k)
    mag = torch.bmm(aq, wq.double().abs())
    return (math.ceil(k / 128) * EPS * mag).numpy().reshape(a.shape[:-1] + (-1,))


@pytest.mark.parametrize("prc", [True, False], ids=["prc", "no_prc"])
def test_mf_expert_linear_vs_reference(prc):
    """Forward within the chunk bound; dA, dW and dgamma through K2/K3 per
    expert within ``GRAD_RTOL`` of the reference's vjp (dgamma the sum of
    the experts' PRC terms; zero with PRC off)."""
    a, w, g = _expert_inputs(3, 20, 200, 130, seed=7)
    pol = PAPER_FAITHFUL if prc else dataclasses.replace(PAPER_FAITHFUL, ratio_clip_init=None)
    jpol = J_PF if prc else dataclasses.replace(J_PF, ratio_clip_init=None)
    assert pol.prc_enabled == prc and jpol.prc_enabled == prc

    def jf(a_, w_, gm):
        return jmfmac.mf_expert_linear(a_, w_, gm, policy=jpol)

    jout, vjp = jax.vjp(jf, jnp.asarray(a), jnp.asarray(w), jnp.float32(GAMMA))
    jda, jdw, jdg = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tg = torch.tensor(GAMMA).requires_grad_(True)
    out = mfmac.mf_expert_linear(ta, tw, tg, policy=pol)
    out.backward(torch.from_numpy(g))
    err = np.abs(out.detach().numpy() - np.asarray(jout))
    assert out.shape == (3, 20, 130) and out.dtype == torch.float32
    assert np.all(err <= _expert_bound(a, w, pol, (1, 2)))
    for name, got, ref in (("da", ta.grad, jda), ("dw", tw.grad, jdw)):
        ref = np.asarray(ref)
        diff = np.abs(got.numpy() - ref).max()
        print(f"{name}: max diff {diff:.3g} of max {np.abs(ref).max():.3g}")
        assert got.dtype == torch.float32 and diff <= GRAD_RTOL * np.abs(ref).max(), name
    if prc:
        np.testing.assert_allclose(float(tg.grad), float(jdg), rtol=GRAD_RTOL)
        assert float(tg.grad) != 0.0
    else:
        assert float(tg.grad) == 0.0 and float(jdg) == 0.0


def test_mf_expert_linear_per_slot_vs_reference_vmap():
    """The per-slot form (E, G, C, K): within the chunk bound of the
    reference's vmap over the slot axis; inside the port, bit for bit
    each slot run alone (its (expert, slot) scale groups are its own)."""
    a, w, _ = _expert_inputs(3, 12, 200, 130, seed=8)
    a = a.reshape(3, 4, 3, 200)
    a[:, 2] *= 0.01  # a slot far below the others: its own scale
    jw = jmfmac._quantize_w(jnp.asarray(w), J_PF, axes=(1, 2))
    tw = torch.from_numpy(np.asarray(jw, np.float32)).bfloat16()
    ref = jax.vmap(lambda h: jmfmac.mf_expert_linear(h, jw, jnp.float32(GAMMA),
                                                     policy=J_SERVE_POL),
                   in_axes=1, out_axes=1)(jnp.asarray(a))
    with torch.no_grad():
        out = mfmac.mf_expert_linear(torch.from_numpy(a), tw, GAMMA, policy=SERVE_POL,
                                     per_slot=True)
        alone = [mfmac.mf_expert_linear(torch.from_numpy(a[:, s]), tw, GAMMA, policy=SERVE_POL)
                 for s in range(4)]
    wq = np.asarray(jw, np.float32)
    bound = np.stack([_expert_bound(a[:, s], wq, SERVE_POL, (1, 2)) for s in range(4)], 1)
    assert out.shape == (3, 4, 3, 130)
    assert np.all(np.abs(out.numpy() - np.asarray(ref)) <= bound)
    for s in range(4):
        assert torch.equal(out[:, s], alone[s])


def _served(tree):
    """The serving form of a layer's weights: every matrix PoT-quantized by
    the reference (per expert for the expert leaves), as bf16."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _served(v)
        elif k == "w":
            out[k] = jmfmac._quantize_w(v, J_PF, axes=(1, 2) if v.ndim == 3 else None)
        else:
            out[k] = v
    return out


def test_mf_expert_linear_fp32_baseline_vs_reference():
    """With the policy disabled the expert linear is a plain float32
    product per expert (and, per slot, per (expert, slot)): within
    ``FP32_RTOL`` of the reference's, and the per-slot form equals each
    slot's product alone bit for bit."""
    a, w, _ = _expert_inputs(3, 12, 200, 130, seed=9)
    ref = np.asarray(jmfmac.mf_expert_linear(jnp.asarray(a), jnp.asarray(w), policy=J_FP32))
    with torch.no_grad():
        out = mfmac.mf_expert_linear(torch.from_numpy(a), torch.from_numpy(w),
                                     policy=FP32_BASELINE)
        slots4 = mfmac.mf_expert_linear(torch.from_numpy(a.reshape(3, 4, 3, 200)),
                                        torch.from_numpy(w), policy=FP32_BASELINE,
                                        per_slot=True)
    assert out.shape == (3, 12, 130)
    assert float(np.abs(out.numpy() - ref).max()) <= FP32_RTOL * float(np.abs(ref).max())
    for s in range(4):
        alone = torch.stack([torch.from_numpy(a.reshape(3, 4, 3, 200)[i, s])
                             @ torch.from_numpy(w[i]) for i in range(3)])
        assert torch.equal(slots4[:, s], alone)


def _ref_route(jcfg, policy, lp, xg):
    """The reference's routing lines (repro/models/transformer.py
    ``_moe_apply``): (expert, pos, keep) over the (G, T*k) token slots."""
    m = jcfg.moe
    g, t, _ = xg.shape
    logits = jmfmac.mf_linear(xg, lp["router"]["w"], lp["router"]["gamma"],
                              policy=policy).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    cap = max(4, ((int(t * m.top_k / m.num_experts * m.capacity_factor) + 3) // 4) * 4)
    idx = idx.reshape(g, t * m.top_k)
    onehot = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.float32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1.0
    return np.asarray(idx), np.asarray(pos).astype(np.int64), np.asarray(pos < cap), cap


def _port_route(tcfg, policy, lp, xg):
    logits = mfmac.mf_linear(xg, lp["router"]["w"], lp["router"]["gamma"],
                             policy=policy).float()
    _, expert, pos, keep, cap = transformer.moe_route(tcfg, transformer._softmax_rows(logits))
    return expert.numpy(), pos.numpy(), keep.numpy(), cap


@pytest.mark.parametrize("per_slot", [False, True], ids=["grouped", "per_slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_vs_reference(arch, per_slot):
    """_moe_apply, grouped (groups of 16 tokens) and per slot, at capacity
    factor 1.0 (tests/test_models_units.py's drop case): the routing
    (expert, queue position, keep) equal to the reference's, some tokens
    dropped, and the output within ``MOE_ATOL``."""
    jcfg, tcfg, params, tparams = _model(arch, 1.0)
    jlp, tlp = _layer0(params["layers"]["moe"]), _layer0(tparams["layers"]["moe"])
    pol, jpol = (SERVE_POL, J_SERVE_POL) if per_slot else (PAPER_FAITHFUL, J_PF)
    if per_slot:  # served weights: prequantized by the reference, carried across
        jlp = _served(jlp)
        tlp = spec.params_from_numpy(_named(jlp), "cpu")
    x = np.random.default_rng(5).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    xg = x if per_slot else x.reshape(2, 16, -1)
    ref = np.asarray(jtr._moe_apply(jcfg, jpol, jlp, jnp.asarray(x), group_size=16,
                                    per_slot=per_slot))
    with torch.no_grad():
        out = transformer._moe_apply(tcfg, pol, tlp, torch.from_numpy(x), group_size=16,
                                     per_slot=per_slot).numpy()
        got = _port_route(tcfg, pol, tlp, torch.from_numpy(xg))
    want = _ref_route(jcfg, jpol, jlp, jnp.asarray(xg))
    for name, a, b in zip(("expert", "pos", "keep", "cap"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not got[2].all(), "no token was dropped"
    err = float(np.abs(out - ref).max())
    print(f"{arch}: {(~got[2]).sum()} dropped; max |out diff| {err:.3g}")
    assert out.shape == ref.shape and err <= MOE_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_rows_pick_expert_zero(arch):
    """Zeroed rows (a chunk step's pads) have router logits 0 and uniform
    probabilities: they pick expert 0 (then 1 for top-2), as jax's top_k
    does, and the whole routing equals the reference's."""
    jcfg, tcfg, params, tparams = _model(arch)
    jlp = _served(_layer0(params["layers"]["moe"]))
    tlp = spec.params_from_numpy(_named(jlp), "cpu")
    x = np.zeros((2, 5, jcfg.d_model), np.float32)
    x[0, :2] = np.random.default_rng(3).standard_normal((2, jcfg.d_model))
    with torch.no_grad():
        got = _port_route(tcfg, SERVE_POL, tlp, torch.from_numpy(x))
    want = _ref_route(jcfg, J_SERVE_POL, jlp, jnp.asarray(x))
    for name, a, b in zip(("expert", "pos", "keep", "cap"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    k = tcfg.moe.top_k
    pads = got[0].reshape(2, 5, k)[np.array([[False] * 2 + [True] * 3, [True] * 5])]
    assert pads.shape == (8, k) and (pads == np.arange(k)).all()


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).to(torch.float32 if k == "mask" else torch.int64)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_vs_reference(arch):
    """Loss within ``LOSS_RTOL`` and every gradient within ``GRAD_RTOL`` of
    its leaf's largest (the reference's jax.grad through the one-hot
    einsums vs the port's index-op dispatch); grok-1's unused ``up``
    gets zeros in both."""
    jcfg, tcfg, params, tparams = _model(arch)
    jb = jpipeline.make_batch(jcfg, JShapeConfig("t", 16, 2, "train"), 0)

    def jloss(p):
        return jtr.lm_loss(jcfg, J_PF, p, jb["tokens"], jb["labels"], jb["mask"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss, grads = loss_and_grads(tcfg, PAPER_FAITHFUL, tparams, _torch_batch(jb))
    print(f"{arch}: loss {float(loss)!r} vs {float(jl)!r}")
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    jgn = _named(jg)
    top = max(float(np.abs(v).max()) for v in jgn.values())
    for leaf, g in spec.named_leaves(grads):
        ref = jgn[leaf]
        err = float(np.abs(g.numpy() - ref).max())
        print(f"  {leaf}: max |dg| {err:.3g} of max |g| {np.abs(ref).max():.3g}")
        assert g.dtype == torch.float32 and g.shape == ref.shape, leaf
        if tcfg.moe.top_k == 1 and "/router/" in leaf:
            # g / g = 1: the exact gradient is zero, both hold noise
            assert err <= GRAD_RTOL * top and float(g.abs().max()) <= GRAD_RTOL * top, leaf
        else:
            assert err <= GRAD_RTOL * np.abs(ref).max(), leaf
    if tcfg.act == "gelu":
        assert float(grads["layers"]["moe"]["up"]["w"].abs().max()) == 0.0
        assert float(np.abs(jgn["layers/moe/up/w"]).max()) == 0.0


def test_train_cli_restart_and_reference_restore(tmp_path, capsys):
    """The smoke trainer on llama4-scout: 3 steps with a checkpoint at
    step 2, rerun to 4 steps from it, equals an uninterrupted 4-step run
    bit for bit; the reference's manager restores the port's checkpoint
    (every byte of params and AdamW state)."""
    d = str(tmp_path / "ck")
    train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", d, "--ckpt-every", "100"])
    resumed = train_cli.main(CLI + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "100"])
    assert "restoring checkpoint step 3" in capsys.readouterr().out
    whole = train_cli.main(CLI + ["--steps", "4"])
    assert resumed.start_step == 3 and [r["step"] for r in resumed.records] == [3]
    assert resumed.records[0]["loss"] == whole.records[3]["loss"]
    for a, b in ((resumed.params, whole.params), (resumed.opt_state, whole.opt_state)):
        la, lb = list(spec.named_leaves(a)), list(spec.named_leaves(b))
        assert [n for n, _ in la] == [n for n, _ in lb]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    for r in whole.records:
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0

    jcfg = C.smoke_config("llama4-scout-17b-a16e")
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(1))
    jopt = j_adamw(j_schedule(1e-3, 2, 50))
    step, got = JCheckpointManager(d).restore_latest({"params": jp, "opt_state": jopt.init(jp)})
    assert step == 4
    for group, tree in (("params", resumed.params), ("opt_state", resumed.opt_state)):
        want = {n: x.numpy() for n, x in spec.named_leaves(tree)}
        have = _named(got[group])
        assert sorted(have) == sorted(want)
        for name, x in have.items():
            assert x.view(np.uint32).tolist() == want[name].view(np.uint32).tolist(), name
