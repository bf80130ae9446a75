"""repro_torch's Mamba2 SSD backbone (models/ssm.py) vs the JAX reference
at smoke size (mamba2-2.7b's smoke config: 2 layers, d_model 64, 2 heads
of 64, a state of 16, chunks of 8), on the reference's parameters carried
across with ``params_from_numpy``.

Tolerances and their reasons:
* The conv and the SSD scan: ``SCAN_RTOL`` = 1e-5 of the largest
  |reference value|: the same f32 operations, but the reference's einsums
  and its head-group scan (``HEAD_GROUP``) sum in another order than
  torch's; measured at up to 8.1e-7 over 20 random cases of
  ``test_ssd_chunked_vs_reference``'s shapes (outputs up to ~70).
* Logits ``LOGIT_ATOL`` = 1e-3, the loss ``LOSS_RTOL`` = 1e-5 relative,
  gradients ``GRAD_RTOL`` = 1e-4 of each leaf's largest |gradient|: the
  serving and training slices' bounds (tests/test_torch_serve.py,
  tests/test_torch_train.py).
* Decode against the port's own forward under FP32_BASELINE:
  ``CONSISTENCY_ATOL`` = 2e-4, the reference's own bound
  (tests/test_decode_consistency.py): the chunked SSD and the step
  recurrence sum in different orders.
* ``len`` equal; pooled decode = each row alone, bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core.policy import FP32_BASELINE as J_FP32  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec, ssm, transformer  # noqa: E402
from repro_torch.serve import slots  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
SCAN_RTOL = 1e-5
LOGIT_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CONSISTENCY_ATOL = 2e-4
MAX_LEN = 32
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
# lockstep on the served weights: per-tensor activation scales
LOCK_POL = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
J_LOCK_POL = dataclasses.replace(J_PF, weights_prequantized=True)


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scan_close(got, ref):
    ref = _np(ref)
    got = got.numpy() if torch.is_tensor(got) else _np(got)
    return float(np.abs(got - ref).max()) <= SCAN_RTOL * float(np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _model(d_model=None):
    """(reference cfg, port cfg, reference params and served weights, the
    port's copies of both); ``d_model`` widens the smoke config."""
    jcfg, tcfg = C.smoke_config(ARCH), TC.smoke_config(ARCH)
    if d_model is not None:
        jcfg = dataclasses.replace(jcfg, d_model=d_model)
        tcfg = dataclasses.replace(tcfg, d_model=d_model)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    params_q = jqw.quantize_for_serving(jcfg, J_PF, params)
    return (jcfg, tcfg, params, params_q, spec.params_from_numpy(_named(params), "cpu"),
            spec.params_from_numpy(_named(params_q), "cpu"))


def test_config_and_param_specs_match_reference():
    """Both configs equal the reference's (the smoke one keeps kv_heads 0:
    no head fields are derived), and every leaf at full width has the
    reference's name and shape; 2.833 B parameters."""
    for tcfg, jcfg in ((TC.get_config(ARCH), C.get_config(ARCH)),
                       (TC.smoke_config(ARCH), C.smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TC.smoke_config(ARCH).kv_heads == 0
    full = registry.param_specs(TC.get_config(ARCH))
    tspecs = dict(spec.named_leaves(full))
    jspecs = _flatten_with_names(jreg.param_specs(C.get_config(ARCH)))[0]
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert tspecs["layers/in_proj/w"].shape == (64, 2560, 10576)
    assert spec.count_params(full) == jspec.count_params(jreg.param_specs(C.get_config(ARCH)))
    assert round(spec.count_params(full) / 1e9, 3) == 2.833


def test_causal_conv_vs_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 40)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4, 40))).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    got = ssm._causal_conv(_t(x), _t(w), _t(b)).numpy()
    ref = _np(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    assert _scan_close(got, ref)


@pytest.mark.parametrize("heads", [2, 4], ids=["head-fallback", "head-groups"])
@pytest.mark.parametrize("seq,chunk", [(8, 8), (32, 8)], ids=["one-chunk", "four-chunks"])
def test_ssd_chunked_vs_reference(heads, seq, chunk):
    """y and the final state, at one chunk and four, for 2 heads (the
    reference's HEAD_GROUP fallback, as at smoke width) and 4 (its
    grouped path, as at d_model 128)."""
    rng = np.random.default_rng(heads * 100 + seq)
    n, p = 16, ssm.HEADDIM
    x = rng.standard_normal((2, seq, heads, p)).astype(np.float32)
    dt = rng.standard_normal((2, seq, heads)).astype(np.float32)
    a_log = (0.5 * rng.standard_normal((heads,))).astype(np.float32)
    b = rng.standard_normal((2, seq, n)).astype(np.float32)
    c = rng.standard_normal((2, seq, n)).astype(np.float32)
    d = rng.standard_normal((heads,)).astype(np.float32)
    y, hf = ssm._ssd_chunked(*map(_t, (x, dt, a_log, b, c, d)), chunk, with_final=True)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a_log, b, c, d)), chunk,
                               with_final=True)
    assert _scan_close(y, jy) and _scan_close(hf, jh)
    y1 = ssm._ssd_chunked(*map(_t, (x, dt, a_log, b, c, d)), chunk)
    assert torch.equal(y1, y)


def test_ssd_length_rule():
    """Past one chunk the length must be a multiple of it, as in the
    reference (no padding: it would change the final state)."""
    x = torch.zeros((1, 12, 2, ssm.HEADDIM))
    z = torch.zeros((1, 12, 2))
    bc = torch.zeros((1, 12, 16))
    with pytest.raises(ValueError, match=r"\(12, 8\)"):
        ssm._ssd_chunked(x, z, torch.zeros(2), bc, bc, torch.zeros(2), 8)
    jcfg, tcfg, _, _, tparams, _ = _model()
    cache = registry.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        registry.prefill(tcfg, PAPER_FAITHFUL, tparams, {"tokens": torch.zeros((1, 12),
                                                                               dtype=torch.long)},
                         cache)


def test_block_decode_vs_reference():
    """One decode step of layer 0 from random conv and SSM states: the
    output and both new states."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    d_inner, nheads, n, _ = ssm._dims(tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, tcfg.conv_width - 1, d_inner + 2 * n)).astype(np.float32)
    st = rng.standard_normal((3, nheads, n, ssm.HEADDIM)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    jy, jc, js = jssm._block_decode(jcfg, J_PF, jlp, jnp.asarray(x), jnp.asarray(conv),
                                    jnp.asarray(st))
    lp = transformer._layer(tparams["layers"], 0)
    y, c, s = ssm._block_decode(tcfg, PAPER_FAITHFUL, lp, _t(x), _t(conv), _t(st))
    assert float(np.abs(y.numpy() - _np(jy)).max()) <= LOGIT_ATOL
    np.testing.assert_array_equal(c.numpy(), _np(jc))
    assert _scan_close(s, js)


def _loss_and_grads_pair(d_model, jpol, tpol, tokens):
    """(reference loss, its named gradients, the port's loss, gradients) of
    ``tokens`` under the given policies."""
    jcfg, tcfg, params, _, tparams, _ = _model(d_model)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones(tokens.shape, np.float32)
    mask[:, -1] = 0.0

    def jloss(p):
        return jreg.loss_fn(jcfg, jpol, p, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels),
                                            "mask": jnp.asarray(mask)})

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long(), "mask": _t(mask)}
    loss, grads = loss_and_grads(tcfg, tpol, tparams, batch)
    return float(jl), _named(jg), float(loss), grads


def _check_grads(jgn, grads):
    assert [n for n, _ in spec.named_leaves(grads)] == list(jgn)
    for leaf, g in spec.named_leaves(grads):
        ref = jgn[leaf]
        err = np.abs(g.numpy() - ref).max()
        assert g.dtype == torch.float32 and err <= GRAD_RTOL * np.abs(ref).max(), (leaf, err)


def test_forward_loss_and_grads_vs_reference():
    """Logits within ``LOGIT_ATOL``, the loss within ``LOSS_RTOL`` and every
    leaf's gradient within ``GRAD_RTOL`` of the reference's, over two SSD
    chunks."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    with torch.no_grad():
        logits = ssm.forward(tcfg, PAPER_FAITHFUL, tparams, _t(tokens).long())
    jlogits = jssm.forward(jcfg, J_PF, params, jnp.asarray(tokens))
    assert float(np.abs(logits.numpy() - _np(jlogits)).max()) <= LOGIT_ATOL
    jl, jgn, loss, grads = _loss_and_grads_pair(None, J_PF, PAPER_FAITHFUL, tokens)
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    _check_grads(jgn, grads)


def test_four_heads_vs_reference():
    """d_model 128: 4 heads, the reference's head-group path.  Logits and
    the loss under PAPER_FAITHFUL within ``LOGIT_ATOL`` / ``LOSS_RTOL``;
    every gradient under FP32_BASELINE within ``GRAD_RTOL``.  (Under
    PAPER_FAITHFUL the reference's f32 sum of one 128-wide MAC chunk
    cancels: layer 1's in_proj output (0, 2, 296) reads -0.45241 there and
    -0.46022, the exact value, in the port; three PoT activation codes of
    the layer's out_proj then differ, and the backward with them.)"""
    jcfg, tcfg, params, _, tparams, _ = _model(128)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    with torch.no_grad():
        logits = ssm.forward(tcfg, PAPER_FAITHFUL, tparams, _t(tokens).long())
    jlogits = jssm.forward(jcfg, J_PF, params, jnp.asarray(tokens))
    assert float(np.abs(logits.numpy() - _np(jlogits)).max()) <= LOGIT_ATOL
    jl, _, loss, _ = _loss_and_grads_pair(128, J_PF, PAPER_FAITHFUL, tokens)
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    jl, jgn, loss, grads = _loss_and_grads_pair(128, J_FP32, FP32_BASELINE, tokens)
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    _check_grads(jgn, grads)


def test_prefill_and_pooled_decode_vs_reference():
    """Two requests solo-prefilled (8 and 3 tokens) in both packages on
    the served weights, written into a 3-slot lifted pool (slot 1 left
    empty) and decoded teacher-forced for 5 steps: every logit within
    ``LOGIT_ATOL``, the prefill states within ``SCAN_RTOL``, ``len``
    equal.  Then a batch-2 lockstep prefill and decode."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    prompts = [[5, 7, 9, 11, 2, 13, 1, 4], [3, 1, 4]]
    rows = np.array([[21, 3, 40, 7, 8], [0, 0, 0, 0, 0], [11, 12, 13, 14, 15]])
    jpool = jslots.lift_cache(jreg.init_cache(jcfg, 3, MAX_LEN), 3)
    with torch.inference_mode():
        pool = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu")
        for slot, prompt in zip((0, 2), prompts):
            lj, jc = jreg.prefill(jcfg, J_SERVE_POL, params_q,
                                  {"tokens": jnp.asarray([prompt], jnp.int32)},
                                  jreg.init_cache(jcfg, 1, MAX_LEN))
            lt, tc = registry.prefill(tcfg, SERVE_POL, tparams_q,
                                      {"tokens": torch.tensor([prompt])},
                                      registry.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
            assert float(np.abs(lt.numpy() - _np(lj)).max()) <= LOGIT_ATOL
            assert tc["conv"].dtype == tc["ssm"].dtype == torch.float32
            for key in ("conv", "ssm"):
                assert _scan_close(tc[key], jc[key])
            assert int(tc["len"]) == int(jc["len"]) == len(prompt)
            jpool = jslots.write_slot(jpool, jc, slot)
            slots.write_slot(pool, tc, slot)
        for i in range(rows.shape[1]):
            lj, jpool = jreg.decode_step(jcfg, J_SERVE_POL, params_q,
                                         jnp.asarray(rows[:, i], jnp.int32), jpool)
            lt, pool = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                            torch.from_numpy(rows[:, i]).long(), pool)
            assert float(np.abs(lt.numpy() - _np(lj)).max()) <= LOGIT_ATOL, i
        np.testing.assert_array_equal(pool["len"].numpy(), np.asarray(jpool["len"]))
        # lockstep: a batch-2 prefill and decode, per-tensor scales
        toks = np.array([[5, 7, 9, 11, 2, 13, 1, 4], [8, 6, 7, 5, 3, 0, 9, 2]])
        lj, jc = jreg.prefill(jcfg, J_LOCK_POL, params_q,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              jreg.init_cache(jcfg, 2, MAX_LEN))
        lt, tc = registry.prefill(tcfg, LOCK_POL, tparams_q, {"tokens": torch.from_numpy(toks)},
                                  registry.init_cache(tcfg, 2, MAX_LEN, device="cpu"))
        assert float(np.abs(lt.numpy() - _np(lj)).max()) <= LOGIT_ATOL
        for i in range(3):
            lj, jc = jreg.decode_step(jcfg, J_LOCK_POL, params_q,
                                      jnp.asarray(toks[:, i], jnp.int32), jc)
            lt, tc = registry.decode_step(tcfg, LOCK_POL, tparams_q,
                                          torch.from_numpy(toks[:, i]), tc)
            assert float(np.abs(lt.numpy() - _np(lj)).max()) <= LOGIT_ATOL, i
        assert tc["len"].dim() == 0 and int(tc["len"]) == int(jc["len"]) == 11


def test_pooled_decode_rows_equal_alone():
    """A pooled decode row equals the same request decoded alone in a
    one-slot pool, bit for bit (logits and states)."""
    _, tcfg, _, _, _, tparams_q = _model()
    prompts = [[5, 7, 9, 11, 2, 13, 1, 4], [3, 1, 4, 1, 5]]
    rows = np.array([[21, 3, 40], [11, 12, 13]])
    with torch.inference_mode():
        minis = []
        for prompt in prompts:
            _, tc = registry.prefill(tcfg, SERVE_POL, tparams_q,
                                     {"tokens": torch.tensor([prompt])},
                                     registry.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
            minis.append(tc)
        pool = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu")
        alone = [registry.init_pool_cache(tcfg, 1, MAX_LEN, device="cpu") for _ in prompts]
        for s, mini in enumerate(minis):
            slots.write_slot(pool, mini, s)
            slots.write_slot(alone[s], mini, 0)
        for i in range(rows.shape[1]):
            lp, pool = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                            torch.from_numpy(rows[:, i]), pool)
            for s in range(2):
                la, alone[s] = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                                    torch.from_numpy(rows[s, i:i + 1]), alone[s])
                assert torch.equal(la[0], lp[s])
        for s in range(2):
            for key in ("conv", "ssm"):
                assert torch.equal(alone[s][key][:, 0], pool[key][:, s])
        slots.reset_slot(pool, 1)
        assert pool["len"].tolist() == [11, 0]


def test_decode_matches_forward():
    """Prefill 16 tokens (two chunks) then decode 8 against the port's own
    full forward, under FP32_BASELINE, within ``CONSISTENCY_ATOL``."""
    _, tcfg, _, _, tparams, _ = _model()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab, (2, 24)))
    with torch.inference_mode():
        full = ssm.forward(tcfg, FP32_BASELINE, tparams, toks)
        cache = registry.init_cache(tcfg, 2, 48, dtype=torch.float32, device="cpu")
        last, cache = registry.prefill(tcfg, FP32_BASELINE, tparams, {"tokens": toks[:, :16]},
                                       cache)
        np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(), atol=CONSISTENCY_ATOL)
        for i in range(16, 24):
            lg, cache = registry.decode_step(tcfg, FP32_BASELINE, tparams, toks[:, i], cache)
            np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), atol=CONSISTENCY_ATOL,
                                       err_msg=f"step {i}")


def test_refusals_match_reference():
    """ssm has no chunk or verify step and no paged cache, as in the
    reference; a short prompt (under the conv window) is refused."""
    jcfg, tcfg, _, _, tparams, _ = _model()
    cache = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu")
    for fn in (registry.chunk_step, registry.verify_step):
        with pytest.raises(NotImplementedError, match="ssm"):
            fn(tcfg, SERVE_POL, tparams, torch.zeros((2, 4), dtype=torch.long), [1, 1], cache)
    for kw in (dict(page_size=8), dict(num_pages=4)):
        with pytest.raises(ValueError, match="has no paged cache") as ours:
            registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jreg.init_pool_cache(jcfg, 2, MAX_LEN, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="conv window"):
        registry.prefill(tcfg, PAPER_FAITHFUL, tparams, {"tokens": torch.zeros((1, 2),
                                                                               dtype=torch.long)},
                         registry.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
