"""repro_torch ``mf_linear`` forward, serving weight quantization and
parameter import vs the JAX reference.

Tolerance of the quantized forward and its reason: the same PoT operands
enter both MACs; the reference's jnp path sums each output over the whole
K in the backend's order while the port sums each 128-chunk exactly and
left-folds the chunk partials, so they agree within
``ceil(K/128) * eps_f32 * (|Aq| @ |Wq|)`` (docs/DESIGN_kernels.md §3).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core import mfmac as jmfmac  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import mfmac, potq  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.serve import quantized_weights as qw  # noqa: E402

torch.set_num_threads(1)

EPS = np.finfo(np.float32).eps
GAMMA = 0.95


def _inputs(shape_a, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape_a + (k,)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02 + 0.001).astype(np.float32)
    return a, w


def _bound(a, w, policy, k):
    """ceil(K/128)·eps·(|Aq|@|Wq|) from the port's quantized operands."""
    pol = dataclasses.replace(policy, enabled=True)
    aq = mfmac._quantize_a(torch.from_numpy(a), torch.tensor(GAMMA), pol).float()
    wq = mfmac._quantize_w(torch.from_numpy(w), pol).float()
    mag = aq.abs().double().reshape(-1, k) @ wq.abs().double()
    return (math.ceil(k / 128) * EPS * mag).numpy().reshape(a.shape[:-1] + (-1,))


@pytest.mark.parametrize("shape_a,k,n", [((2, 5), 200, 130), ((4, 1), 256, 96),
                                         ((1, 9), 384, 64)])
@pytest.mark.parametrize("serving", [False, True], ids=["train_policy", "serve_policy"])
def test_mf_linear_forward_vs_reference(shape_a, k, n, serving):
    a, w = _inputs(shape_a, k, n, seed=k + n)
    jpol = J_PF
    pol = PAPER_FAITHFUL
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if serving:
        # per-sample scales + weights prequantized by the reference, carried
        # across as bf16: isolates the MAC from the WBC mean's summation
        jpol = dataclasses.replace(J_PF, per_sample_act_scales=True,
                                   weights_prequantized=True)
        pol = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                  weights_prequantized=True)
        jw = jmfmac._quantize_w(jnp.asarray(w), J_PF)
        tw = torch.from_numpy(np.asarray(jw, np.float32)).bfloat16()
    ours = mfmac.mf_linear(torch.from_numpy(a), tw, GAMMA, policy=pol).numpy()
    theirs = np.asarray(jmfmac.mf_linear(jnp.asarray(a), jw, jnp.float32(GAMMA),
                                         policy=jpol))
    bound = _bound(a, np.asarray(jw, np.float32) if serving else w, pol, k)
    err = np.abs(ours - theirs)
    print(f"{np.sum(ours != theirs)} of {ours.size} differ, max err {err.max():.3g}")
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    assert np.all(err <= bound)


def test_fp32_policy_matches_reference():
    """Disabled policy: full-f32 matmul (the reference's HIGHEST dot);
    row order aside, both are f32 sums of the same products."""
    a, w = _inputs((3, 1), 96, 40, seed=5)
    ours = mfmac.mf_linear(torch.from_numpy(a), torch.from_numpy(w),
                           policy=FP32_BASELINE).numpy()
    theirs = np.asarray(jmfmac.mf_linear(
        jnp.asarray(a), jnp.asarray(w),
        policy=dataclasses.replace(J_PF, enabled=False)))
    mag = np.abs(a) @ np.abs(w)
    assert np.all(np.abs(ours - theirs) <= 96 * EPS * mag)


@pytest.fixture(scope="module")
def smoke_params():
    cfg = C.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    named, _ = _flatten_with_names(params)
    return cfg, params, {k: np.asarray(v) for k, v in named.items()}


def test_params_from_numpy_names_and_shapes(smoke_params):
    cfg, _, named = smoke_params
    ours = spec.params_from_numpy(named, "cpu")
    port_specs = dict(spec.named_leaves(registry.param_specs(TC.smoke_config("llama3-8b"))))
    ref_specs, _ = _flatten_with_names(jreg.param_specs(cfg))
    assert sorted(port_specs) == sorted(ref_specs) == sorted(named) == \
        sorted(dict(spec.named_leaves(ours)))
    for name, t in spec.named_leaves(ours):
        assert tuple(t.shape) == port_specs[name].shape == named[name].shape
        np.testing.assert_array_equal(t.numpy(), named[name])
    assert "layers/wq/w" in named and named["layers/wq/w"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert spec.count_params(registry.param_specs(TC.smoke_config("llama3-8b"))) == \
        jspec.count_params(jreg.param_specs(cfg))


def test_quantize_for_serving_vs_reference(smoke_params):
    """Same PoT codes as the reference's quantize_for_serving, up to codes
    flipped by the WBC mean: ``jnp.mean`` and ``torch.mean`` sum in other
    orders, so the mean (and with it an element at a rounding boundary)
    may differ by an ulp.  Bound: at most 0.1% of the codes, each off by
    one exponent step."""
    cfg, params, named = smoke_params
    ours = qw.quantize_for_serving(None, PAPER_FAITHFUL,
                                   spec.params_from_numpy(named, "cpu"))
    theirs, _ = _flatten_with_names(jqw.quantize_for_serving(cfg, J_PF, params))
    total = flipped = 0
    for name, t in spec.named_leaves(ours):
        ref = np.asarray(theirs[name], np.float32)
        got = t.float().numpy()
        if not qw.is_linear_weight(name, t):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(got, ref)
            continue
        assert t.dtype == torch.bfloat16
        diff = got != ref
        total += got.size
        flipped += int(diff.sum())
        ratio = np.abs(got[diff]) / np.maximum(np.abs(ref[diff]), 1e-38)
        assert np.all((ratio == 2) | (ratio == 0.5) | (got[diff] == 0) | (ref[diff] == 0))
    print(f"quantize_for_serving: {flipped} of {total} codes differ")
    assert flipped <= total // 1000


def test_prequantized_weights_are_fixed_points():
    """Serving from prequantized bf16 weights reproduces quantize-at-use
    bit for bit (re-quantization of the stored PoT values is not needed)."""
    a, w = _inputs((2, 3), 128, 32, seed=11)
    wq = qw.quantize_leaf("proj/w", torch.from_numpy(w), PAPER_FAITHFUL)
    assert wq.dtype == torch.bfloat16
    pre = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    at = torch.from_numpy(a)
    np.testing.assert_array_equal(
        mfmac.mf_linear(at, wq, GAMMA, policy=pre).numpy(),
        mfmac.mf_linear(at, torch.from_numpy(w), GAMMA, policy=PAPER_FAITHFUL).numpy())
    # stacked leaves: one WBC mean and beta per trailing matrix
    stack = torch.from_numpy(np.stack([w, 3 * w]))
    sq = qw.quantize_leaf("layers/x/w", stack, PAPER_FAITHFUL)
    np.testing.assert_array_equal(sq[1].float().numpy(),
                                  qw.quantize_leaf("w", stack[1], PAPER_FAITHFUL).float().numpy())
    assert int(potq.compute_beta(sq[1].float(), 5)) == int(potq.compute_beta(sq[0].float(), 5)) + 2


@pytest.mark.parametrize("wbc", [True, False], ids=["wbc", "no_wbc"])
def test_quantize_w_in_row_blocks_keeps_every_bit(wbc, monkeypatch):
    """A matrix larger than ``W_BLOCK_ELEMS`` is rounded a block of rows at
    a time, its mean and beta taken over the whole matrix (beta from each
    block's extremes): the same bits as in one block and as the
    reference's ``_quantize_w``, a ragged last block included, whichever
    block holds the largest |w - mean|; ``quantize_leaf`` quantizes each
    matrix of a stack so."""
    policy = dataclasses.replace(PAPER_FAITHFUL, weight_bias_correction=wbc)
    jpol = dataclasses.replace(J_PF, weight_bias_correction=wbc)
    _, w = _inputs((1,), 300, 70, seed=12)
    for big in (0.5, -0.5):
        w[17, 3] = big  # the largest value lies in one block only
        whole = mfmac._quantize_w(torch.from_numpy(w), policy)
        want = np.asarray(jmfmac._quantize_w(jnp.asarray(w), jpol)).astype(np.float32)
        with monkeypatch.context() as m:
            m.setattr(mfmac, "W_BLOCK_ELEMS", 70 * 64)
            blocked = mfmac._quantize_w(torch.from_numpy(w), policy)
            stack = torch.from_numpy(np.stack([w, -2 * w]))
            leaf = qw.quantize_leaf("layers/w", stack, policy)
        assert blocked.dtype == torch.bfloat16
        assert torch.equal(blocked, whole)
        np.testing.assert_array_equal(blocked.float().numpy(), want)
        assert torch.equal(leaf[0], whole)
        assert torch.equal(leaf[1], mfmac._quantize_w(stack[1], policy))
