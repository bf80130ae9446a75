"""repro_torch's quantized attention (``mfmac.mf_act_dot`` under
``policy.quantize_attention``) vs the JAX reference on the CPU: the
product forward against the reference's ``mf_act_dot``, its backward
against the reference's own backward rule ``_mf_act_dot_bwd`` (called
directly: ``jax.grad`` through it fails on this jax, see
:func:`test_reference_cannot_train_under_quantize_attention`), forward
losses of olmo-1b, whisper-large-v3 and recurrentgemma-2b at smoke width,
and ``PoolEngine``'s default, page-4 chunked and n-gram speculative
engines (tokens, counters, pool = solo) and lockstep generation.

Tolerances and their reasons:
* Quantized operands: bit for bit outside the √2 band of the log2 rule
  (tests/test_torch_grad.py); where they differ there the bounds below add
  the exact effect (``|dxq| @ |y| + |x| @ |dyq|``).
* Products: PoT products are exact in float32, the two packages sum the K
  terms of an output in different orders: ``K * eps_f32 * (|xq| @ |yq|)``.
* Backward: the same reorder bound over the contraction (and the
  broadcast sum), then both round to bf16: plus one bf16 ulp of the
  value, ``2^-7 * |value|``.
* Losses: ``LOSS_RTOL`` = 1e-5 relative (tests/test_torch_train.py).
* Engine tokens and counters: exact; pool = solo bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import mfmac as jmfmac  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import NgramDrafter as JNgramDrafter  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve.engine import lockstep_generate as j_lockstep_generate  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import mfmac  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.serve import NgramDrafter, PoolEngine, lockstep_generate, poisson_trace  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
BF16_ULP = 2.0 ** -7
LOSS_RTOL = 1e-5
SQRT_HALF = 0.7071067811865476
BAND = 2.0 ** -18

QA = dataclasses.replace(PAPER_FAITHFUL, quantize_attention=True)
J_QA = dataclasses.replace(jpolicy.PAPER_FAITHFUL, quantize_attention=True)
SAMPLE = dict(per_sample_act_scales=True)
# the layouts of the port's attention products: (x shape, y shape, y in
# the reference's layout, back to the port's, the reference's dot_general
# numbers)
#   QK^T: qg (B, KV, rep, Sq, hd) @ kt (B, KV, 1, hd, Skv); reference kt (B, KV, Skv, hd)
#   PV:   probs (B, KV, rep, Sq, Skv) @ vt (B, KV, 1, Skv, hd); reference vt (B, KV, Skv, hd)
LAYOUTS = {
    "qk": ((2, 2, 3, 5, 16), (2, 2, 1, 16, 7), lambda y: y[:, :, 0].swapaxes(-1, -2),
           lambda y: y.swapaxes(-1, -2)[:, :, None], (((4,), (3,)), ((0, 1), (0, 1)))),
    "pv": ((2, 2, 3, 5, 7), (2, 2, 1, 7, 16), lambda y: y[:, :, 0],
           lambda y: y[:, :, None], (((4,), (2,)), ((0, 1), (0, 1)))),
}


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _in_band(x):
    m, _ = np.frexp(np.abs(x).astype(np.float32))
    return (np.abs(m - SQRT_HALF) < BAND) & (x != 0)


def _operands(layout, seed):
    xs, ys, to_ref, from_ref, dn = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(xs) * 1.3).astype(np.float32)
    y = (rng.standard_normal(ys) * 0.7).astype(np.float32)
    if layout == "pv":
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)  # probabilities
    return x, y, to_ref, from_ref, dn


def _matmul_abs(x, y):
    return np.matmul(np.abs(x).astype(np.float64), np.abs(y).astype(np.float64))


def _axes(x, per_sample):
    return tuple(range(1, x.ndim)) if per_sample else None


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("per_sample", [False, True], ids=["tensor", "sample"])
def test_mf_act_dot_forward_vs_reference(layout, per_sample):
    x, y, to_ref, from_ref, dn = _operands(layout, seed=len(layout) + per_sample)
    pol = dataclasses.replace(QA, per_sample_act_scales=per_sample)
    jpol = dataclasses.replace(J_QA, per_sample_act_scales=per_sample)
    ours = mfmac.mf_act_dot(torch.from_numpy(x), torch.from_numpy(y), policy=pol).numpy()
    yr = np.ascontiguousarray(to_ref(y))
    theirs = np.asarray(jmfmac.mf_act_dot(jnp.asarray(x), jnp.asarray(yr), dn, policy=jpol))
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    # each package's quantized operands: equal outside the band
    xq, yq = (mfmac._qact(torch.from_numpy(t), 5, _axes(t, per_sample)).float().numpy()
              for t in (x, y))
    jxq, jyq = (np.asarray(jmfmac._qact(jnp.asarray(t), 5, _axes(t, per_sample)),
                           np.float32) for t in (x, yr))
    np.testing.assert_array_equal(xq[~_in_band(x)], jxq[~_in_band(x)])
    np.testing.assert_array_equal(to_ref(yq)[~_in_band(yr)], jyq[~_in_band(yr)])
    jyq = from_ref(jyq)
    dxq, dyq = np.abs(xq - jxq), np.abs(yq - jyq)
    bound = (x.shape[-1] * EPS * _matmul_abs(xq, yq) + _matmul_abs(dxq, jyq)
             + _matmul_abs(xq, dyq))
    err = np.abs(ours.astype(np.float64) - theirs)
    print(f"{np.sum(ours != theirs)} of {ours.size} differ, max err {err.max():.3g}")
    assert np.all(err <= bound)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mf_act_dot_backward_vs_reference_rule(layout):
    """The port's autograd backward against ``_mf_act_dot_bwd`` on the
    reference's own residuals: Gq per tensor at ``bits_g``, dx = Gq @ yq^T
    and dy = xq^T @ Gq summed over the broadcast dims, rounded to bf16."""
    x, y, to_ref, from_ref, dn = _operands(layout, seed=11)
    rng = np.random.default_rng(12)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = mfmac.mf_act_dot(xt, yt, policy=QA)
    g = (rng.standard_normal(out.shape) * 1e-2).astype(np.float32)
    dx, dy = torch.autograd.grad(out, (xt, yt), torch.from_numpy(g))
    assert dx.dtype == torch.float32 and dy.dtype == torch.float32
    assert torch.equal(dx, dx.bfloat16().float()) and torch.equal(dy, dy.bfloat16().float())
    yr = np.ascontiguousarray(to_ref(y))
    _, res = jmfmac._mf_act_dot_fwd(J_QA, dn, jnp.asarray(x), jnp.asarray(yr))
    jdx, jdy = (np.asarray(t).astype(np.float32)
                for t in jmfmac._mf_act_dot_bwd(J_QA, dn, res, jnp.asarray(g)))
    xq, yq = (np.asarray(t).astype(np.float32) for t in res)
    gq = np.asarray(jmfmac._qact(jnp.asarray(g), QA.bits_g)).astype(np.float32)
    # (the residuals and Gq are the reference's; the port's equal them
    # outside the band, which this draw does not hit)
    assert not _in_band(x).any() and not _in_band(g).any() and not _in_band(yr).any()
    dx_bound = _matmul_abs(gq, from_ref(yq).swapaxes(-1, -2))
    dy_full = _matmul_abs(xq.swapaxes(-1, -2), gq).sum(axis=2)  # summed over rep
    dy_ref_layout = dy_full.swapaxes(-1, -2) if layout == "qk" else dy_full
    for ours, theirs, mag, c in ((dx.numpy(), jdx, dx_bound, g.shape[-1]),
                                 (to_ref(dy.numpy()), jdy, dy_ref_layout, x.shape[2] * x.shape[3])):
        err = np.abs(ours.astype(np.float64) - theirs)
        bound = c * EPS * mag + BF16_ULP * np.maximum(np.abs(ours), np.abs(theirs))
        print(f"{np.sum(ours != theirs)} of {ours.size} differ, max err {err.max():.3g}")
        assert ours.shape == theirs.shape and np.all(err <= bound)


def test_mf_act_dot_off_is_the_plain_product():
    """Not enabled, or enabled with quantize_attention off: today's product,
    bit for bit, and plain autograd."""
    x, y, *_ = _operands("qk", seed=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for pol in (PAPER_FAITHFUL, dataclasses.replace(PAPER_FAITHFUL, enabled=False)):
        assert torch.equal(mfmac.mf_act_dot(xt, yt, policy=pol), torch.matmul(xt, yt))


def test_reference_cannot_train_under_quantize_attention():
    """ROADMAP Queue 3 item 7, pinned: ``jax.grad`` of the reference's loss
    under ``quantize_attention`` fails on this jax, because
    ``_mf_act_dot_bwd`` returns bf16 cotangents for float32 inputs
    (``core/mfmac.py:349``) and the attention's next op
    (``models/transformer.py:297``) multiplies them with float32.  So the
    port's backward is held to that rule called directly, not to
    ``jax.grad``; its forward loss is the reference's
    (:func:`test_forward_loss_vs_reference`)."""
    jcfg = C.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    jb = jpipeline.make_batch(jcfg, JShapeConfig("t", 8, 2, "train"), 0)
    float(jreg.loss_fn(jcfg, J_QA, jp, jb))  # the forward runs
    with pytest.raises(TypeError, match="requires arguments to have the same dtypes"):
        jax.grad(lambda p: jreg.loss_fn(jcfg, J_QA, p, jb))(jp)


def _batch(jb):
    out = {}
    for k, v in jb.items():
        v = torch.from_numpy(np.array(v))
        out[k] = v.long() if k in ("tokens", "labels") else v.to(torch.float32)
    return out


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-large-v3", "recurrentgemma-2b"])
def test_forward_loss_vs_reference(arch):
    """The smoke model's loss under quantize_attention equals the
    reference's; the port's backward runs and gives finite gradients."""
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = spec.params_from_numpy(_named(jp), "cpu")
    jb = jpipeline.make_batch(jcfg, JShapeConfig("t", 16, 2, "train"), 0)
    theirs = float(jreg.loss_fn(jcfg, J_QA, jp, jb))
    loss, grads = loss_and_grads(tcfg, QA, tp, _batch(jb))
    plain = float(registry.loss_fn(tcfg, PAPER_FAITHFUL, tp, _batch(jb)))
    print(f"{arch}: {float(loss)!r} vs {theirs!r} (quantize_attention off: {plain!r})")
    np.testing.assert_allclose(float(loss), theirs, rtol=LOSS_RTOL)
    assert float(loss) != plain
    assert all(bool(torch.isfinite(g).all()) for _, g in spec.named_leaves(grads))


# ---------------------------------------------------------------------------
# Serving under quantize_attention
# ---------------------------------------------------------------------------

MAX_LEN = 24
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=9, seed=3)
ENGINES = {
    "default": (dict(), dict()),
    "page4": (dict(prefill_chunk=4, page_size=4), dict(prefill_chunk=4, page_size=4)),
    "ngram": (dict(prefill_chunk=4, page_size=4, spec=NgramDrafter(max_draft=3)),
              dict(prefill_chunk=4, page_size=4, spec=JNgramDrafter(max_draft=3))),
}
FIELDS = ("weight_passes", "decode_steps", "prefills", "emitted_tokens", "ttft_passes",
          "accepted_tokens", "draft_weight_passes", "pages_in_use_sum", "kv_page_bytes")


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = C.smoke_config("llama3-8b"), TC.smoke_config("llama3-8b")
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, spec.params_from_numpy(_named(jp), "cpu")


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_vs_reference_and_solo(llama, name):
    """Tokens and counters equal the reference's engine under
    quantize_attention, the tokens differ from quantize_attention off's
    somewhere, and each request served alone gives its pooled tokens."""
    jcfg, tcfg, jp, tp = llama
    kw, jkw = ENGINES[name]
    eng = PoolEngine(tcfg, QA, tp, max_slots=2, max_len=MAX_LEN, device="cpu", **kw)
    reqs = poisson_trace(tcfg, **TRACE)
    ours = eng.run(reqs)
    jeng = JPoolEngine(jcfg, J_QA, jp, max_slots=2, max_len=MAX_LEN, **jkw)
    theirs = {k: np.asarray(v) for k, v in jeng.run(j_poisson_trace(jcfg, **TRACE)).items()}
    assert ours.keys() == theirs.keys()
    for uid in ours:
        np.testing.assert_array_equal(ours[uid], theirs[uid], err_msg=str(uid))
    for field in FIELDS:
        assert getattr(eng.last_stats, field) == getattr(jeng.last_stats, field), field
    off = PoolEngine(tcfg, PAPER_FAITHFUL, tp, max_slots=2, max_len=MAX_LEN, device="cpu",
                     **kw).run(reqs)
    assert any(not np.array_equal(ours[u], off[u]) for u in ours)
    solo = PoolEngine(tcfg, QA, tp, max_slots=1, max_len=MAX_LEN, device="cpu", **kw)
    for req in reqs:
        alone = solo.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(alone[req.uid], ours[req.uid], err_msg=str(req.uid))


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-large-v3"])
def test_lockstep_vs_reference(arch):
    """Lockstep generation under quantize_attention and per-tensor scales:
    the batch's attention products (and whisper's cross attention) share
    one scale group, so the port's decode step attends the batch at once,
    as the reference does."""
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = spec.params_from_numpy(_named(jp), "cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (3, 6))}
    if tcfg.family == "encdec":
        batch["frames"] = rng.standard_normal((3, tcfg.enc_seq, tcfg.frame_dim)).astype(np.float32)
    ours = lockstep_generate(tcfg, QA, tp, batch, max_new_tokens=5, max_len=16,
                             device="cpu").numpy()
    theirs = np.asarray(j_lockstep_generate(jcfg, J_QA, jp,
                                            {k: jnp.asarray(v) for k, v in batch.items()},
                                            max_new_tokens=5, max_len=16))
    np.testing.assert_array_equal(ours, theirs)


def test_slot_steps_need_per_sample_scales(llama):
    """chunk_step and verify_step attend slot by slot, which is the
    reference's scale group under quantize_attention only with per-sample
    scales: without them they refuse."""
    _, tcfg, _, tp = llama
    cache = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4)
    toks = torch.zeros((2, 4), dtype=torch.int64)
    for step in (registry.chunk_step, registry.verify_step):
        with pytest.raises(ValueError, match="per_sample_act_scales"):
            step(tcfg, QA, tp, toks, [1, 1], cache)
    pol = dataclasses.replace(QA, **SAMPLE)
    logits, _ = registry.chunk_step(tcfg, pol, tp, toks, [1, 1], cache)
    assert bool(torch.isfinite(logits).all())


def test_lockstep_attention_is_one_scale_group(llama):
    """A lockstep decode step under per-tensor scales attends the batch as
    one scale group: with row 1's values 2^-16 the size of row 0's, they
    underflow under the batch's scale and row 1's output is zero, as in
    the reference's ``_sdpa``; a row-by-row split would keep them."""
    from repro.models import transformer as jtr

    from repro_torch.models import transformer

    jcfg, tcfg, _, _ = llama
    rng = np.random.default_rng(9)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    cache = transformer.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    cache["k"].copy_(normal(cache["k"].shape))
    cache["v"].copy_(normal(cache["v"].shape))
    cache["v"][:, 1] *= 2.0 ** -16
    cache["pos"][:5] = torch.arange(5)
    cache["len"] = torch.tensor(5)
    q = normal((2, 1, tcfg.n_heads, tcfg.head_dim))
    k, v = normal((2, 1, tcfg.kv_heads, tcfg.head_dim)), normal((2, 1, tcfg.kv_heads, tcfg.head_dim))
    v[1] *= 2.0 ** -16
    st = transformer.DecodeSlots(cache, torch.zeros(2, dtype=torch.int64), None)
    ours = st.attend(tcfg, QA, cache, 0, q, k, v).numpy()
    theirs = np.asarray(jtr._sdpa(jcfg, J_QA, jnp.asarray(q.numpy()),
                                  jnp.asarray(cache["k"][0].numpy()),
                                  jnp.asarray(cache["v"][0].numpy()),
                                  jnp.asarray(st.qpos.numpy()), jnp.asarray(st.kpos.numpy()),
                                  None))
    assert np.all(theirs[1] == 0) and np.all(ours[1] == 0)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=1e-5)
