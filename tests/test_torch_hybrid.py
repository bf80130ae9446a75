"""repro_torch's Griffin hybrid (models/recurrent.py: RG-LRU blocks and
local attention) vs the JAX reference at smoke size (recurrentgemma-2b's
smoke config: 3 layers rglru, rglru, attn; d_model 64, an RG-LRU of width
96, 4 heads and 1 KV head of 16, window 8), on the reference's parameters
carried across with ``params_from_numpy``; and the tuple-of-layers tree
through the port's checkpoint manager, against the reference's.

Tolerances and their reasons:
* The RG-LRU scan: ``SCAN_RTOL`` = 1e-5 of the largest |reference value|:
  the port scans by log2(S) doubling steps, the reference by
  ``jax.lax.associative_scan``, whose order is its backend's; measured at
  up to 1.3e-7 over 40 random cases of ``test_rglru_scan_vs_reference``'s
  shapes.
* Block outputs, states and logits ``LOGIT_ATOL`` = 1e-3, the loss
  ``LOSS_RTOL`` = 1e-5 relative, gradients ``GRAD_RTOL`` = 1e-4 of each
  leaf's largest |gradient| (tests/test_torch_serve.py,
  tests/test_torch_train.py).
* Decode against the port's own forward under FP32_BASELINE:
  ``CONSISTENCY_ATOL`` = 2e-4, the reference's own bound
  (tests/test_decode_consistency.py).
* ``pos`` and ``len`` equal; checkpoints bit for bit; a pooled decode row
  = the request alone, bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import recurrent, registry, spec  # noqa: E402
from repro_torch.serve import slots  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
SCAN_RTOL = 1e-5
LOGIT_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CONSISTENCY_ATOL = 2e-4
MAX_LEN = 32  # the ring's span is the window, 8
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
LOCK_POL = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
J_LOCK_POL = dataclasses.replace(J_PF, weights_prequantized=True)


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=LOGIT_ATOL):
    got = got.numpy() if torch.is_tensor(got) else _np(got)
    return float(np.abs(got - _np(ref)).max()) <= atol


@functools.lru_cache(maxsize=None)
def _model():
    """(reference cfg, port cfg, reference params and served weights, the
    port's copies of both)."""
    jcfg, tcfg = C.smoke_config(ARCH), TC.smoke_config(ARCH)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    params_q = jqw.quantize_for_serving(jcfg, J_PF, params)
    return (jcfg, tcfg, params, params_q, spec.params_from_numpy(_named(params), "cpu"),
            spec.params_from_numpy(_named(params_q), "cpu"))


@functools.lru_cache(maxsize=None)
def _jsteps(pol):
    """The reference's jitted prefill and decode steps under ``pol``: the
    decode step returns (token, logits, cache)."""
    jcfg = C.smoke_config(ARCH)
    return make_prefill_step(jcfg, pol), make_decode_step(jcfg, pol)


@functools.lru_cache(maxsize=None)
def _jfn(name):
    """A jitted reference function of (params or a layer, x, ...)."""
    jcfg = C.smoke_config(ARCH)
    if name == "forward":
        return jax.jit(functools.partial(jrec.forward, jcfg, J_PF))
    return jax.jit(functools.partial(jrec._rglru_block, jcfg, J_PF))


def test_config_and_param_specs_match_reference():
    """Both configs equal the reference's; the layers are a tuple in the
    reference's order, every leaf at full width has its name
    (``layers/<i>/...``, index 10 after 8) and shape; 3.550 B parameters."""
    for tcfg, jcfg in ((TC.get_config(ARCH), C.get_config(ARCH)),
                       (TC.smoke_config(ARCH), C.smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    cfg = TC.get_config(ARCH)
    full = registry.param_specs(cfg)
    assert isinstance(full["layers"], tuple) and len(full["layers"]) == 26
    assert recurrent.layer_kinds(cfg) == jrec.layer_kinds(C.get_config(ARCH))
    names = [n for n, _ in spec.named_leaves(full)]
    jspecs = _flatten_with_names(jreg.param_specs(C.get_config(ARCH)))[0]
    assert names == list(jspecs)
    assert names.index("layers/10/conv_b") > names.index("layers/8/wv/w")
    tspecs = dict(spec.named_leaves(full))
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert round(spec.count_params(full) / 1e9, 3) == 3.550


def test_rglru_scan_vs_reference():
    """The doubling scan against ``associative_scan``, from zero and from a
    given state, over odd and power-of-two lengths."""
    rng = np.random.default_rng(0)
    for s in (1, 7, 16, 33):
        a = rng.uniform(0.0, 1.0, (2, s, 24)).astype(np.float32)
        bx = rng.standard_normal((2, s, 24)).astype(np.float32)
        h0 = rng.standard_normal((2, 24)).astype(np.float32)
        for init in (None, h0):
            got = recurrent._rglru_scan(_t(a), _t(bx), None if init is None else _t(init))
            ref = _np(jrec._rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                                       None if init is None else jnp.asarray(init)))
            assert float(np.abs(got.numpy() - ref).max()) <= SCAN_RTOL * np.abs(ref).max()


def test_rglru_block_vs_reference():
    """Layer 0 over a 12-token sequence (output, conv window, last state),
    then one decode step from random states."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    jy, (jc, jl) = _jfn("rglru")(params["layers"][0], jnp.asarray(x))
    y, (c, lru) = recurrent._rglru_block(tcfg, PAPER_FAITHFUL, tparams["layers"][0], _t(x))
    assert _close(y, jy) and _close(c, jc) and _close(lru, jl)
    lw = tcfg.lru_width
    x1 = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, tcfg.conv_width - 1, lw)).astype(np.float32)
    state = rng.standard_normal((3, lw)).astype(np.float32)
    jy, (jc, jl) = _jfn("rglru")(params["layers"][1], jnp.asarray(x1),
                                 conv_state=jnp.asarray(conv), lru_state=jnp.asarray(state))
    y, (c, lru) = recurrent._rglru_block(tcfg, PAPER_FAITHFUL, tparams["layers"][1], _t(x1),
                                         conv_state=_t(conv), lru_state=_t(state))
    assert _close(y, jy) and _close(c, jc) and _close(lru, jl)
    assert c.dtype == lru.dtype == torch.float32


def test_forward_loss_and_grads_vs_reference():
    """Logits within ``LOGIT_ATOL`` over 12 tokens (past the window), the
    loss within ``LOSS_RTOL`` and every gradient (the ``kind_attn``
    marker's zero included) within ``GRAD_RTOL`` of the reference's."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((2, 12), np.float32)
    mask[:, -1] = 0.0
    with torch.no_grad():
        logits = recurrent.forward(tcfg, PAPER_FAITHFUL, tparams, _t(tokens).long())
    assert _close(logits, _jfn("forward")(params, jnp.asarray(tokens)))

    def jloss(p):
        return jreg.loss_fn(jcfg, J_PF, p, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels),
                                            "mask": jnp.asarray(mask)})

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long(), "mask": _t(mask)}
    loss, grads = loss_and_grads(tcfg, PAPER_FAITHFUL, tparams, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    jgn = _named(jg)
    assert [n for n, _ in spec.named_leaves(grads)] == list(jgn)
    assert isinstance(grads["layers"], tuple)
    for leaf, g in spec.named_leaves(grads):
        ref = jgn[leaf]
        err = np.abs(g.numpy() - ref).max()
        assert g.dtype == torch.float32 and err <= GRAD_RTOL * np.abs(ref).max(), (leaf, err)


@pytest.mark.parametrize("plen", [5, 11], ids=["under-span", "ring-wrap"])
def test_prefill_and_lockstep_decode_vs_reference(plen):
    """A batch-2 prefill of ``plen`` tokens (under the span of 8, and over
    it: the ring rolled so position p sits in slot p % 8), then 6 lockstep
    decode steps (wrapping): logits within ``LOGIT_ATOL``, every layer's
    K/V within it, ``pos`` and ``len`` equal, the RG-LRU states within it."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    rng = np.random.default_rng(plen)
    toks = rng.integers(0, jcfg.vocab, (2, plen + 6)).astype(np.int32)
    jprefill, jdecode = _jsteps(J_LOCK_POL)
    lj, jc = jprefill(params_q, {"tokens": jnp.asarray(toks[:, :plen])},
                      jreg.init_cache(jcfg, 2, MAX_LEN))
    with torch.inference_mode():
        tc = registry.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        lt, tc = registry.prefill(tcfg, LOCK_POL, tparams_q,
                                  {"tokens": _t(toks[:, :plen]).long()}, tc)
        assert _close(lt, lj)
        for i in range(plen, plen + 6):
            for c, j in zip(tc["layers"], jc["layers"]):
                for key in c:
                    if key == "pos":
                        np.testing.assert_array_equal(c[key].numpy(), np.asarray(j[key]))
                    else:
                        assert c[key].dtype == (torch.bfloat16 if key in "kv"
                                                else torch.float32), key
                        assert _close(c[key].float(), j[key]), (key, i)
            assert int(tc["len"]) == int(jc["len"]) == i
            _, lj, jc = jdecode(params_q, jnp.asarray(toks[:, i]), jc)
            lt, tc = registry.decode_step(tcfg, LOCK_POL, tparams_q, _t(toks[:, i]).long(), tc)
            assert _close(lt, lj), i


def _mini(cfg, params, prompt):
    with torch.inference_mode():
        return registry.prefill(cfg, SERVE_POL, params, {"tokens": torch.tensor([prompt])},
                                registry.init_cache(cfg, 1, MAX_LEN, device="cpu"))


def test_prefill_and_pooled_decode_vs_reference():
    """Solo prefills of 10 and 3 tokens written into slots 0 and 2 of a
    3-slot lifted pool (per-slot ``len``, each attention layer's ``pos``
    (3, 8)), then 6 teacher-forced pooled decode steps, slot 2 wrapping its
    ring: logits within ``LOGIT_ATOL``; ``len`` and every ``pos`` equal."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    prompts = [[5, 7, 9, 11, 2, 13, 1, 4, 6, 8], [3, 1, 4]]
    rows = np.array([[21, 3, 40, 7, 8, 9], [0] * 6, [11, 12, 13, 14, 15, 16]])
    jprefill, jdecode = _jsteps(J_SERVE_POL)
    jpool = jslots.lift_cache(jreg.init_cache(jcfg, 3, MAX_LEN), 3)
    with torch.inference_mode():
        pool = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu")
        assert pool["len"].shape == (3,) and pool["layers"][2]["pos"].shape == (3, 8)
        for slot, prompt in zip((0, 2), prompts):
            lj, jc = jprefill(params_q, {"tokens": jnp.asarray([prompt], jnp.int32)},
                              jreg.init_cache(jcfg, 1, MAX_LEN))
            lt, tc = _mini(tcfg, tparams_q, prompt)
            assert _close(lt, lj)
            jpool = jslots.write_slot(jpool, jc, slot)
            slots.write_slot(pool, tc, slot)
        for i in range(rows.shape[1]):
            _, lj, jpool = jdecode(params_q, jnp.asarray(rows[:, i], jnp.int32), jpool)
            lt, pool = registry.decode_step(tcfg, SERVE_POL, tparams_q, _t(rows[:, i]).long(),
                                            pool)
            assert _close(lt, lj), i
            np.testing.assert_array_equal(pool["len"].numpy(), np.asarray(jpool["len"]))
            np.testing.assert_array_equal(pool["layers"][2]["pos"].numpy(),
                                          np.asarray(jpool["layers"][2]["pos"]))


def test_pooled_decode_rows_equal_alone():
    """A pooled decode row equals the request decoded alone in a one-slot
    pool, bit for bit (logits and every state), across a ring wrap; then
    ``reset_slot`` rewinds the slot's ``len`` and ``pos``."""
    _, tcfg, _, _, _, tparams_q = _model()
    prompts = [[5, 7, 9, 11, 2, 13, 1], [3, 1, 4, 1]]
    rows = np.array([[21, 3, 40, 7, 8], [11, 12, 13, 14, 15]])
    minis = [_mini(tcfg, tparams_q, p)[1] for p in prompts]
    with torch.inference_mode():
        pool = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu")
        alone = [registry.init_pool_cache(tcfg, 1, MAX_LEN, device="cpu") for _ in prompts]
        for s, mini in enumerate(minis):
            slots.write_slot(pool, mini, s)
            slots.write_slot(alone[s], mini, 0)
        for i in range(rows.shape[1]):
            lp, pool = registry.decode_step(tcfg, SERVE_POL, tparams_q, _t(rows[:, i]), pool)
            for s in range(2):
                la, alone[s] = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                                    _t(rows[s, i:i + 1]), alone[s])
                assert torch.equal(la[0], lp[s])
        for s in range(2):
            for c, a in zip(pool["layers"], alone[s]["layers"]):
                for key in c:
                    assert torch.equal(c[key][s], a[key][0]), key
        slots.reset_slot(pool, 1)
        assert pool["len"].tolist() == [12, 0]
        assert bool((pool["layers"][2]["pos"][1] == -1).all())
        assert bool((pool["layers"][2]["pos"][0] >= 0).all())


def test_decode_matches_forward():
    """Prefill 16 tokens then decode 8 against the port's own full forward
    (ring wraps included), under FP32_BASELINE, within
    ``CONSISTENCY_ATOL``."""
    _, tcfg, _, _, tparams, _ = _model()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab, (2, 24)))
    with torch.inference_mode():
        full = recurrent.forward(tcfg, FP32_BASELINE, tparams, toks)
        cache = registry.init_cache(tcfg, 2, 48, dtype=torch.float32, device="cpu")
        last, cache = registry.prefill(tcfg, FP32_BASELINE, tparams, {"tokens": toks[:, :16]},
                                       cache)
        np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(), atol=CONSISTENCY_ATOL)
        for i in range(16, 24):
            lg, cache = registry.decode_step(tcfg, FP32_BASELINE, tparams, toks[:, i], cache)
            np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), atol=CONSISTENCY_ATOL,
                                       err_msg=f"step {i}")


def test_refusals_match_reference():
    """No chunk or verify step, no paged cache, as in the reference."""
    jcfg, tcfg, _, _, tparams, _ = _model()
    cache = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu")
    for fn in (registry.chunk_step, registry.verify_step):
        with pytest.raises(NotImplementedError, match="hybrid"):
            fn(tcfg, SERVE_POL, tparams, torch.zeros((2, 4), dtype=torch.long), [1, 1], cache)
    with pytest.raises(ValueError, match="has no encoder"):
        registry.encode_cross_kv(tcfg, SERVE_POL, tparams, torch.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="has no paged cache") as ours:
        registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4)
    with pytest.raises(ValueError) as theirs:
        jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=4)
    assert str(ours.value) == str(theirs.value)


def test_checkpoint_of_tuple_tree_roundtrip_and_cross_restore(tmp_path):
    """The hybrid's params and AdamW state (tuples of per-layer dicts)
    through the port's manager: the names in the file are the reference's
    ``_flatten_with_names``, the restore gives the tree back (tuples
    included) bit for bit, the reference's manager restores the port's
    checkpoint and the port restores the reference's."""
    _, tcfg, params, _, tparams, _ = _model()
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 2, 50))
    state = {"params": tparams, "opt_state": opt.init(tparams)}
    mgr = CheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(3, state, blocking=True)
    with np.load(tmp_path / "port" / "step_0000000003" / "params.npz") as z:
        assert sorted(z.files) == sorted(_named(params))
    step, got = mgr.restore_latest(state)
    assert step == 3 and isinstance(got["params"]["layers"], tuple)
    assert isinstance(got["opt_state"]["m"]["layers"], tuple)
    for (n, x), (m, y) in zip(spec.named_leaves(state), spec.named_leaves(got)):
        assert n == m and torch.equal(x, y), n
    jtemplate = {"params": params}
    _, jgot = JCheckpointManager(str(tmp_path / "port")).restore_latest(jtemplate)
    for name, arr in _named(jgot["params"]).items():
        np.testing.assert_array_equal(arr, dict(spec.named_leaves(tparams))[name].numpy())
    JCheckpointManager(str(tmp_path / "ref"), async_write=False).save(5, jtemplate,
                                                                      blocking=True)
    step, back = CheckpointManager(str(tmp_path / "ref")).restore_latest({"params": tparams})
    assert step == 5
    for (n, x), (m, y) in zip(spec.named_leaves(tparams), spec.named_leaves(back["params"])):
        assert n == m and torch.equal(x, y), n
