"""repro_torch's CNN slice vs the JAX reference on the CPU: ``mf_conv2d``
(im2col + ``mf_linear``), ``models/cnn.py`` and the SGD loop of
``examples/cnn_classification_torch.py``, at width 4, 8 x 8 images,
batch 4, under FP32, 5/5/5 (``PAPER_FAITHFUL``) and 4/4/4 (``BITS444``).

Tolerances and their reasons:
* im2col patches: pure data movement, bit for bit (padding included: JAX's
  "SAME" pads (0, 1) for a 3 x 3 stride-2 conv on 8 x 8).
* Quantized operands (Aq of the patches, Wq of the filter matrix, Gq):
  bit for bit (these draws stay off the √2 band of the log2 rule).
* Forward and dW: the MAC bound of tests/test_torch_mfmac.py and
  tests/test_torch_grad.py, ``ceil(C/128) * eps_f32 * (|x| @ |y|)`` for a
  contraction of C.  dgamma: the reorder bound of its sum plus the dA
  bound of every clipped term, times max|a| (tests/test_torch_grad.py).
* dX: both fold the same patch gradient back onto the pixels in their own
  order, so on top of the dA bound folded onto the pixels they differ by
  the reorder bound of tests/conformance/test_conv_grad.py,
  ``KH * KW * eps_f32 * fold(|dPatches|)``.
* The whole CNN: loss within ``LOSS_RTOL`` = 1e-5 relative, each
  gradient leaf within ``GRAD_RTOL`` = 1e-4 of its largest element
  (tests/test_torch_train.py's); after 3 SGD steps at lr 0.05, momentum
  0.9, the losses within ``LOSS_RTOL`` and every parameter within
  ``PARAM_ATOL`` = 3 steps x lr x (1 + 0.9 + 0.81) x ``GRAD_RTOL`` x the
  largest gradient seen (the gradient bound carried through the momentum
  sum).
* Prototypes: the two linspaces may differ in the last ulp (6e-8 below
  1), which the argument 2 pi (k+1) x / 3 + k multiplies by up to 21, and
  that argument reaches 30 (float32 ulp 1.9e-6) before sin rounds it:
  ``PROTO_ATOL`` = 4e-6.
"""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import optim as joptim  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core import mfmac as jmfmac  # noqa: E402
from repro.core.policy import FP32_BASELINE as J_FP32  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro_torch.core import mfmac, potq  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.kernels import potq_grad as KG  # noqa: E402
from repro_torch.models import cnn, spec  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

torch.set_num_threads(1)

_EX = pathlib.Path(__file__).resolve().parents[1] / "examples" / "cnn_classification_torch.py"
_spec = importlib.util.spec_from_file_location("cnn_classification_torch", _EX)
example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(example)

EPS = float(np.finfo(np.float32).eps)
GAMMA = 0.95
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PROTO_ATOL = 4e-6
WIDTH, RES, BATCH = 4, 8, 4
J_BITS444 = dataclasses.replace(J_PF, bits_w=4, bits_a=4, bits_g=4, bits_g_last=5)
POLICIES = {"fp32": (FP32_BASELINE, J_FP32), "555": (PAPER_FAITHFUL, J_PF),
            "444": (example.BITS444, J_BITS444)}


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _ref_patches(x, k, stride, padding):
    return np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC")))


@pytest.mark.parametrize("h,w,k,stride,padding", [
    (8, 8, 3, 1, "SAME"), (8, 8, 3, 2, "SAME"), (8, 8, 1, 2, "SAME"), (7, 9, 3, 2, "SAME"),
    (8, 8, 3, 1, "VALID"), (9, 7, 3, 2, "VALID")])
def test_conv_patches_vs_reference(h, w, k, stride, padding):
    x = np.random.default_rng(h * w + k + stride).standard_normal((2, h, w, 3)).astype(np.float32)
    ours = mfmac.conv_patches(torch.from_numpy(x), k, k, stride, padding).numpy()
    np.testing.assert_array_equal(ours, _ref_patches(x, k, stride, padding))


def test_conv_patches_refuses_other_padding():
    with pytest.raises(ValueError, match="SAME"):
        mfmac.conv_patches(torch.zeros(1, 4, 4, 1), 3, 3, 1, "FULL")


def _quantize_g(g2, bits):
    gt = torch.from_numpy(g2)
    beta = potq.compute_beta(gt, bits)
    s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), torch.tensor(float("inf"))])
    return (KG._quantize_g(gt, s, potq.pot_emax(bits)) * s[1]).numpy()


def _abs_mm(x, y):
    return np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64)


def _check(ours, theirs, bound, what):
    err = np.abs(ours.astype(np.float64) - theirs.astype(np.float64))
    print(f"{what}: {np.sum(ours != theirs)} of {ours.size} differ, max err {err.max():.3g}")
    assert ours.shape == theirs.shape and np.all(err <= bound), (what, err.max())


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
@pytest.mark.parametrize("pol_name", ["555", "444"])
def test_mf_conv2d_vjp_vs_reference(k, stride, pol_name):
    pol, jpol = POLICIES[pol_name]
    rng = np.random.default_rng(10 * k + stride)
    x = (rng.standard_normal((2, 8, 8, 3)) * 1.5).astype(np.float32)
    w = (rng.standard_normal((k, k, 3, 5)) * 0.1).astype(np.float32)
    ho = 8 // stride
    cot = (rng.standard_normal((2, ho, ho, 5)) * 1e-2).astype(np.float32)
    xt, wt = (torch.from_numpy(t).requires_grad_(True) for t in (x, w))
    gt = torch.tensor(GAMMA, requires_grad=True)
    out = mfmac.mf_conv2d(xt, wt, gt, policy=pol, stride=stride)
    dx, dw, dg = (t.numpy() for t in torch.autograd.grad(out, (xt, wt, gt),
                                                          torch.from_numpy(cot)))
    fn = lambda x_, w_, g_: jmfmac.mf_conv2d(x_, w_, g_, policy=jpol, stride=stride)  # noqa: E731
    jout, jdx, jdw, jdg = (np.asarray(t) for t in jax.jit(
        lambda *a: (lambda o, vjp: (o, *vjp(jnp.asarray(cot))))(*jax.vjp(fn, *a)))(
            jnp.asarray(x), jnp.asarray(w), jnp.float32(GAMMA)))
    # the operands both packages quantize: equal here (off the band)
    m, kk, n = 2 * ho * ho, 3 * k * k, 5
    p2 = _ref_patches(x, k, stride, "SAME").reshape(m, kk)
    wm = w.transpose(2, 0, 1, 3).reshape(kk, n)
    g2 = cot.reshape(m, n)
    p2 = np.array(p2)
    aq = mfmac._quantize_a(torch.from_numpy(p2), torch.tensor(GAMMA), pol).float().numpy()
    wq = mfmac._quantize_w(torch.from_numpy(wm), pol).float().numpy()
    gq = _quantize_g(g2, pol.bits_g)
    np.testing.assert_array_equal(aq, np.asarray(jmfmac._quantize_a(
        jnp.asarray(p2), jnp.float32(GAMMA), jpol), np.float32))
    np.testing.assert_array_equal(wq, np.asarray(jmfmac._quantize_w(jnp.asarray(wm), jpol),
                                                 np.float32))
    np.testing.assert_array_equal(gq, np.asarray(jmfmac._quantize_g(jnp.asarray(g2), jpol, False)))
    _check(out.detach().numpy().reshape(m, n), np.asarray(jout).reshape(m, n),
           math.ceil(kk / 128) * EPS * _abs_mm(aq, wq), "out")
    dw_bound = math.ceil(m / 128) * EPS * _abs_mm(aq.T, gq)
    _check(dw.transpose(2, 0, 1, 3).reshape(kk, n), jdw.transpose(2, 0, 1, 3).reshape(kk, n),
           dw_bound, "dW")
    # dX: the patch gradient (masked where PRC clipped) folded onto the pixels
    t = np.abs(p2).max() * np.float32(GAMMA)
    clipped = np.abs(p2) > t
    dpatch = np.where(clipped, 0.0, gq.astype(np.float64) @ wq.T.astype(np.float64))
    e_dpatch = math.ceil(n / 128) * EPS * _abs_mm(gq, wq.T)
    x64 = torch.zeros((2, 8, 8, 3), dtype=torch.float64, requires_grad=True)
    pat = mfmac.conv_patches(x64, k, k, stride, "SAME").reshape(m, kk)
    fold_err, fold_abs = (t_.numpy() for t_ in torch.autograd.grad(
        pat, x64, torch.from_numpy(np.where(clipped, 0.0, e_dpatch)), retain_graph=True)
        + torch.autograd.grad(pat, x64, torch.from_numpy(np.abs(dpatch))))
    _check(dx, jdx, fold_err + k * k * EPS * fold_abs, "dX")
    contrib = np.where(clipped, dpatch * np.sign(p2), 0)
    dg_bound = float(np.abs(p2).max()) * (float(e_dpatch[clipped].sum())
                                          + contrib.size * EPS * float(np.abs(contrib).sum()))
    print(f"dgamma {float(dg)!r} vs {float(jdg)!r} (bound {dg_bound:.3g})")
    assert abs(float(dg) - float(jdg)) <= dg_bound


@pytest.fixture(scope="module")
def ref_state():
    """The reference's CNN parameters (seed 0), 3 training batches and an
    eval set, each also as torch tensors."""
    jp = jspec.materialize(jcnn.cnn_specs(width=WIDTH), jax.random.PRNGKey(0))
    jbatches = [jcnn.make_dataset(jax.random.fold_in(jax.random.PRNGKey(1), s), BATCH, res=RES)
                for s in range(3)]
    jeval = jcnn.make_dataset(jax.random.PRNGKey(999), 32, res=RES)

    def conv(b):
        return torch.from_numpy(np.array(b[0])), torch.from_numpy(np.array(b[1])).long()

    return jp, jbatches, jeval, [conv(b) for b in jbatches], conv(jeval)


def _torch_params(jp):
    return spec.params_from_numpy(_named(jp), "cpu")


def _grad_err(ours, theirs):
    return max(float(np.abs(ours[n] - theirs[n]).max() / max(np.abs(theirs[n]).max(), 1e-30))
               for n in theirs)


@pytest.mark.parametrize("pol_name", list(POLICIES))
def test_cnn_loss_and_grads_vs_reference(ref_state, pol_name):
    pol, jpol = POLICIES[pol_name]
    jp, jbatches, _, batches, _ = ref_state
    (jx, jy), (x, y) = jbatches[0], batches[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jcnn.loss_fn(jpol, p, jx, jy)))(jp)
    loss, grads = value_and_grad(lambda p: cnn.loss_fn(pol, p, x, y), _torch_params(jp))
    print(f"{pol_name}: loss {float(loss)!r} vs {float(jloss)!r}")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    ours = {n: g.numpy() for n, g in spec.named_leaves(grads)}
    theirs = _named(jgrads)
    assert sorted(ours) == sorted(theirs)
    assert all(ours[n].dtype == np.float32 and ours[n].shape == theirs[n].shape for n in ours)
    assert _grad_err(ours, theirs) <= GRAD_RTOL


@pytest.mark.parametrize("pol_name", list(POLICIES))
def test_example_sgd_steps_vs_reference(ref_state, pol_name):
    """3 steps of the example's loop (SGD, momentum 0.9, lr 0.05) from the
    reference's parameters on its batches, against the reference's
    ``value_and_grad`` + ``sgd_momentum`` loop (``benchmarks/accuracy_proxy.py``'s),
    then the eval accuracy on the reference's eval set."""
    pol, jpol = POLICIES[pol_name]
    jp, jbatches, jeval, batches, eval_set = ref_state
    opt = joptim.sgd_momentum(joptim.step_decay_schedule(0.05, [80, 110]), momentum=0.9)
    vg = jax.jit(jax.value_and_grad(lambda p, x, y: jcnn.loss_fn(jpol, p, x, y)))
    state, jlosses, gmax = opt.init(jp), [], 0.0
    for step, (x, y) in enumerate(jbatches):
        loss, grads = vg(jp, x, y)
        gmax = max(gmax, max(float(jnp.abs(g).max()) for g in jax.tree_util.tree_leaves(grads)))
        jp, state = opt.update(grads, state, jp, jnp.int32(step))
        jlosses.append(float(loss))
    jacc = float(jnp.mean(jnp.argmax(jcnn.forward(jpol, jp, jeval[0]), -1) == jeval[1]))
    losses = []
    acc, last, tp = example.train_cnn(
        pol, steps=3, device="cpu", params=_torch_params(ref_state[0]),
        batches=lambda s: batches[s], eval_set=eval_set,
        on_step=lambda s, loss: losses.append(float(loss)))
    print(f"{pol_name}: losses {losses} vs {jlosses}; accuracy {acc} vs {jacc}")
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert last == losses[-1]
    param_atol = 3 * 0.05 * (1 + 0.9 + 0.81) * GRAD_RTOL * gmax
    jn = _named(jp)
    for name, x in spec.named_leaves(tp):
        assert np.abs(x.numpy() - jn[name]).max() <= param_atol, name
    assert acc == jacc


def test_make_dataset_prototypes_vs_reference():
    """The reference's images minus its own noise (redrawn from its key
    split) are the port's prototypes of its labels."""
    key = jax.random.PRNGKey(5)
    jimgs, jlabels = jcnn.make_dataset(key, 16, res=RES)
    _, kn, _ = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(kn, jimgs.shape) * 0.5)
    protos = cnn.prototypes(10, RES, "cpu").numpy()
    base = np.repeat(protos[np.asarray(jlabels)][..., None], 3, axis=-1)
    np.testing.assert_allclose(base + noise, np.asarray(jimgs), rtol=0, atol=PROTO_ATOL)
    # "xy" indexing: x runs along the width
    xs = np.linspace(0, 1, RES, dtype=np.float32)
    np.testing.assert_allclose(protos[0, 0], np.sin(2 * np.pi * xs / 3) + 1.0, atol=PROTO_ATOL)


def test_make_dataset_draws():
    """Labels in range, images (n, res, res, 3) float32 with 3 equal
    channels up to the noise, and the same draw on any device for one CPU
    generator seed."""
    x, y = cnn.make_dataset(torch.Generator().manual_seed(0), 64, res=RES, device="cpu")
    assert x.shape == (64, RES, RES, 3) and x.dtype == torch.float32 and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) < 10 and len(set(y.tolist())) > 5
    x2, y2 = cnn.make_dataset(torch.Generator().manual_seed(0), 64, res=RES, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    noise = x - cnn.prototypes(10, RES, "cpu")[y][..., None]
    assert 0.4 < float(noise.std()) < 0.6
