"""repro_torch backward MACs (K2/K3 plain versions on the CPU) and the
``mf_linear`` backward vs the JAX reference: ``repro.kernels.ref.potq_grad_ref``,
``ops.potq_grad_matmuls`` in Pallas interpret mode, and ``jax.vjp`` of
``repro.core.mfmac.mf_linear`` on its jnp path.

Tolerances and their reasons:
* Gq: bit for bit outside the √2 band (the port rounds log2 from the
  float's bits, the reference by ``round(log2(x))``); the band is counted,
  and where the two Gq differ there, the products' bounds below add that
  difference's exact effect (``|x| @ |dGq|``).
* dA and dW: the port's 128-chunk partial is the exact sum rounded once,
  the reference's follows XLA's order inside a chunk (or over the whole
  contraction on its jnp path); both left-fold in f32, so they differ by
  at most ``ceil(C/128) * eps_f32 * (|x| @ |y|)`` for a contraction of C.
* dgamma: the two sum the same M*K clipped terms in different orders; any
  order of n terms is within ``(n-1) * eps/2 * sum|x|`` of the exact sum,
  so the two differ by at most ``n * eps * sum|x|`` plus the dA bound of
  every clipped term, all times max|a|.
* The FP32 policy path (plain autograd, no quantization): the reference's
  HIGHEST dot and PyTorch's CPU matmul order a K-term f32 sum differently:
  ``K * eps_f32 * (|x| @ |y|)``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import mfmac as jmfmac  # noqa: E402
from repro.core.policy import FP32_BASELINE as J_FP32  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import mfmac, potq  # noqa: E402
from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import potq_grad as KG  # noqa: E402
from repro_torch.kernels import potq_matmul as KM  # noqa: E402

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
GAMMA = 0.95
# ragged (M, K, N), and one over several chunks of every axis; the
# reference's own 128x640x256 Pallas case is left out (it fails on jax 0.9.0)
SHAPES = [(200, 130, 300), (260, 257, 384)]
SQRT_HALF = 0.7071067811865476
BAND = 2.0 ** -18


def _in_band(x: np.ndarray) -> np.ndarray:
    m, _ = np.frexp(np.abs(x).astype(np.float32))
    return (np.abs(m - SQRT_HALF) < BAND) & (x != 0)


def _operands(m, k, n, seed=0):
    """a, w, g as training makes them, and the forward's residuals: Aq of
    the PRC-clipped a (one scale), Wq after WBC (one scale)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * 1.7).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05 + 0.003).astype(np.float32)
    g = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    g[0, :4] = [1e-40, -3e-39, 0.0, -0.0]  # subnormal and zero entries
    amax = np.float32(np.abs(a).max())
    t = np.float32(amax * np.float32(GAMMA))
    at = torch.from_numpy(a)
    aq = potq.pot_quantize(torch.clamp(at, -t, t), 5).bfloat16()
    wt = torch.from_numpy(w)
    wq = potq.pot_quantize(wt - wt.mean(), 5).bfloat16()
    return a, g, aq, wq, amax, t


def _quantize_g(g: np.ndarray, bits: int) -> np.ndarray:
    """Gq as the backward makes it: the kernels' scaled-domain rounding
    (``potq_grad._quantize_g``), dequantized by 2^beta_g."""
    gt = torch.from_numpy(g)
    beta = potq.compute_beta(gt, bits)
    s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), torch.tensor(float("inf"))])
    return (KG._quantize_g(gt, s, potq.pot_emax(bits)) * s[1]).numpy()


def _bound_check(ours, theirs, x, y, contraction, what, extra=0.0):
    mag = np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64)
    bound = math.ceil(contraction / ref.CANONICAL_BK) * EPS * mag + extra
    err = np.abs(ours.astype(np.float64) - theirs.astype(np.float64))
    print(f"{what}: {np.sum(ours != theirs)} of {ours.size} differ, max err {err.max():.3g}")
    assert np.all(err <= bound), (what, err.max())


def _dgamma_bound(contrib, e_da_clipped, amax):
    n = contrib.size
    return float(amax) * (float(e_da_clipped) + n * EPS * float(np.abs(contrib).sum()))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bits_g", [5, 6])
@pytest.mark.parametrize("prc", [True, False], ids=["prc", "noprc"])
def test_backward_matmuls_vs_reference(m, k, n, bits_g, prc):
    a, g, aq, wq, amax, t = _operands(m, k, n, seed=m + bits_g)
    kw = dict(a=torch.from_numpy(a), clip_t=torch.tensor(t), amax=torch.tensor(amax)) if prc else {}
    jkw = dict(a=jnp.asarray(a), clip_t=jnp.float32(t), amax=jnp.float32(amax)) if prc else {}
    da, dw, dg = ops.potq_grad_matmuls(torch.from_numpy(g), aq, wq, bits_g=bits_g, **kw)
    aqn, wqn = aq.float().numpy(), wq.float().numpy()
    assert (dg is None) == (not prc)

    gq = _quantize_g(g, bits_g)
    jgq = np.asarray(jmfmac._quantize_g(jnp.asarray(g), J_PF, bits_g == 6)).astype(np.float32)
    dgq = np.abs(gq.astype(np.float64) - jgq)
    print(f"Gq differs in {np.sum(dgq > 0)} of {g.size} elements (√2 band)")
    band_dw = np.abs(aqn.T).astype(np.float64) @ dgq
    band_da = dgq @ np.abs(wqn.T).astype(np.float64)
    theirs = {
        "oracle": jref.potq_grad_ref(jnp.asarray(g), jnp.asarray(aqn), jnp.asarray(wqn),
                                     bits_g=bits_g, **jkw),
        "pallas": jops.potq_grad_matmuls(jnp.asarray(g), jnp.asarray(aqn), jnp.asarray(wqn),
                                         bits_g=bits_g, interpret=True, **jkw),
    }
    for name, (jda, jdw, jdg) in theirs.items():
        jda, jdw = np.asarray(jda), np.asarray(jdw)
        _bound_check(dw.numpy(), jdw, aqn.T, gq, m, f"{name} dW", band_dw)
        if not prc:
            _bound_check(da.numpy(), jda, gq, wqn.T, n, f"{name} dA", band_da)
            continue
        clipped = np.abs(a) > t
        e_da = math.ceil(n / 128) * EPS * (np.abs(gq).astype(np.float64) @ np.abs(wqn.T)) + band_da
        # dA is zero where clipped on both sides; elsewhere the MAC bound
        _bound_check(np.where(clipped, 0, da.numpy()), np.where(clipped, 0, jda),
                     gq, wqn.T, n, f"{name} dA", band_da)
        assert np.all(da.numpy()[clipped] == 0) and np.all(jda[clipped] == 0)
        contrib = np.where(clipped, (gq.astype(np.float64) @ wqn.T) * np.sign(a), 0)
        bound = _dgamma_bound(contrib, e_da[clipped].sum(), amax)
        err = abs(float(dg) - float(jdg))
        print(f"{name} dgamma: {float(dg)!r} vs {float(jdg)!r}, err {err:.3g} (bound {bound:.3g})")
        assert err <= bound


@pytest.mark.parametrize("is_last", [False, True], ids=["bits_g", "bits_g_last"])
def test_quantize_g_bit_for_bit_outside_the_band(is_last):
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((64, 300)) * 1e-3).astype(np.float32)
    g[0, :5] = [1e-40, -3e-39, 0.0, -0.0, 2.0 ** -130]
    bits = J_PF.bits_g_last if is_last else J_PF.bits_g
    ours = _quantize_g(g, bits)
    theirs = np.asarray(jmfmac._quantize_g(jnp.asarray(g), J_PF, is_last)).astype(np.float32)
    beta = int(potq.compute_beta(torch.from_numpy(g), bits))
    keep = ~_in_band(g * np.float32(2.0 ** -beta))
    print(f"bits={bits}: {np.sum(~keep)} of {g.size} elements in the √2 band")
    np.testing.assert_array_equal(ours[keep], theirs[keep])
    # the kernels' scaled-domain Gq, dequantized, is the real-domain Gq
    real = potq.pot_quantize(torch.from_numpy(g), bits)
    np.testing.assert_array_equal(real.numpy(), ours)


@pytest.mark.parametrize("product", ["dA", "dW"])
def test_chunk_partials_are_exact_in_any_order(product):
    """Each 128-chunk partial is the exact sum: a reverse-order fp64 sum of
    every chunk, rounded once and left-folded, gives the same bits."""
    m, k, n = 300, 70, 260
    _, g, aq, wq, _, _ = _operands(m, k, n, seed=3)
    gt = torch.from_numpy(g)
    bits = 6  # the widest supported pair: 2*15 + 2*7 + 8 = 52 bits
    beta = potq.compute_beta(gt, bits)
    s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), torch.tensor(float("inf"))])
    gq = ref.quantize_tile_ref(gt * s[0], potq.pot_emax(bits)).numpy()
    if product == "dA":
        ours = KG.grad_da_plain(gt, wq, None, s, emax_g=potq.pot_emax(bits), prc=False)[0]
        x, y = gq, wq.float().numpy().T
    else:
        ours = KG.grad_dw_plain(aq, gt, s, emax_g=potq.pot_emax(bits))
        x, y = aq.float().numpy().T, gq
    acc = np.zeros((x.shape[0], y.shape[1]), np.float32)
    for c in range(0, x.shape[1], 128):
        prods = x[:, c:c + 128, None].astype(np.float64) * y[None, c:c + 128]
        part = np.zeros(acc.shape, np.float64)
        for i in reversed(range(prods.shape[1])):
            part += prods[:, i]
        acc = acc + part.astype(np.float32)
    np.testing.assert_array_equal(ours.numpy(), acc * np.float32(s[1]))


def _lattice_extreme_chunks(rows, cols, emax_x, emax_y, seed):
    """x (rows, C) and y (C, cols) PoT operands, C = 2 chunks, whose
    products reach both ends of the chunk lattice, ±2^(emax_x + emax_y)
    beside ±2^-(emax_x + emax_y), with alternating signs and a second half
    of each chunk that cancels the first's large terms."""
    rng = np.random.default_rng(seed)
    c = 2 * ref.CANONICAL_BK
    j = np.arange(c)
    ex = np.where((j[None, :] + np.arange(rows)[:, None]) % 2 == 0, emax_x, -emax_x)
    ey = np.where((j[:, None] + np.arange(cols)[None, :]) % 2 == 0, emax_y, -emax_y)
    sx = rng.choice([-1.0, 1.0], (rows, c))
    half = ref.CANONICAL_BK // 2
    for start in range(0, c, ref.CANONICAL_BK):
        # the large x of a chunk's second half cancel the first half's, the
        # small ones add up: only the bottom of the lattice is left
        first = slice(start, start + half)
        second = slice(start + half, start + 2 * half)
        sx[:, second] = np.where(ex[:, first] > 0, -sx[:, first], sx[:, first])
    sy = np.where(((j[:, None] % half) // 3) % 2 == 0, 1.0, -1.0) * np.ones((1, cols))
    x = (sx * np.exp2(ex)).astype(np.float32)
    y = (sy * np.exp2(ey)).astype(np.float32)
    x[0, 5] = 0.0  # zeros inside a chunk
    y[7, 0] = -0.0
    return x, y


def _kernel_order_sum(x, y, order, group, dtype=np.float64):
    """x @ y in the chunk scheme, each chunk summed as the tensor-core
    kernel does: ``group`` products per MMA (summed in ``order``'s sequence),
    fragments accumulated across the chunk's k-steps, rounded once to f32,
    chunk partials left-folded in f32."""
    acc = np.zeros((x.shape[0], y.shape[1]), np.float32)
    for c0 in range(0, x.shape[1], ref.CANONICAL_BK):
        prods = x[:, c0:c0 + 128, None].astype(dtype) * y[None, c0:c0 + 128].astype(dtype)
        frag = np.zeros(acc.shape, dtype)
        for s in range(0, len(order), group):
            mma = np.zeros(acc.shape, dtype)
            for i in order[s:s + group]:
                mma = mma + prods[:, i]
            frag = frag + mma
        acc = acc + frag.astype(np.float32)
    return acc


@pytest.mark.parametrize("pair", [(6, 5), (5, 5)], ids=["6x5", "5x5"])
@pytest.mark.parametrize("product", ["dA", "dW", "K1"])
def test_tensor_core_order_is_exact_at_the_lattice_ends(product, pair):
    """The FP64 tensor-core kernels add each chunk's products in k-steps of
    4, 8 or 16 and in an order the hardware picks; at the widest supported
    pairs (the LM head's 6 x 5: 2*15 + 2*7 + 8 = 52 bits) every such order
    gives the spec's bits, also on chunks built to reach both ends of the
    lattice with cancellations.  An f32 sum in the same order does not.
    K1's Aq . Wq has one beta per row of Aq (decode slots, prefill
    requests): each output still sums one row's products, on one lattice."""
    bits_g, bits_other = pair
    eg, eo = potq.pot_emax(bits_g), potq.pot_emax(bits_other)
    s = torch.tensor([1.0, 1.0, float("inf")])  # beta_g = 0: Gq is G itself
    if product == "K1":  # out = Aq . Wq over K, a different beta on every row
        x, y = _lattice_extreme_chunks(6, 5, eg, eo, seed=4)
        x = (x * np.exp2(np.array([-9, -2, 0, 3, 7, 11], np.float32))[:, None]).astype(np.float32)
        y = (y * np.float32(2.0 ** -5)).astype(np.float32)
        plain = KM.potq_matmul_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    elif product == "dA":  # dA = Gq . Wq^T over N
        gq, wt = _lattice_extreme_chunks(6, 5, eg, eo, seed=1)
        x, y = gq, wt
        plain = KG.grad_da_plain(torch.from_numpy(gq), torch.from_numpy(wt.T.copy()), None, s,
                                 emax_g=eg, prc=False)[0]
    else:  # dW = Aq^T . Gq over M
        at, gq = _lattice_extreme_chunks(5, 6, eo, eg, seed=2)
        x, y = at, gq
        plain = KG.grad_dw_plain(torch.from_numpy(at.T.copy()), torch.from_numpy(gq), s,
                                 emax_g=eg)
    spec = ref.pot_value_matmul_ref(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(plain.numpy(), spec)
    rng = np.random.default_rng(3)
    orders = [np.arange(128), np.arange(128)[::-1]] + [rng.permutation(128) for _ in range(3)]
    for group in (4, 8, 16):
        for order in orders:
            np.testing.assert_array_equal(_kernel_order_sum(x, y, order, group), spec)
    # the chunks are hard: f32 accumulation in the kernel's order loses bits
    assert not np.array_equal(_kernel_order_sum(x, y, orders[0], 8, np.float32), spec)
    # and one step wider the lattice no longer fits fp64's 53 bits
    with pytest.raises(ValueError, match="53"):
        ref.check_exact_spread(6, 6)


@pytest.mark.parametrize("bits", [5, 6])
def test_prepass_plain_version_is_bf16_exact(bits):
    """The pre-pass writes Gq as bf16: every value of its plain version
    (``potq_grad._quantize_g``) is 0 or ±2^e with |e| <= emax <= 15, which
    bf16 holds exactly, including G with subnormal, tiny and huge entries."""
    rng = np.random.default_rng(bits)
    g = (rng.standard_normal((40, 300)) * 10.0 ** rng.integers(-8, 3, (40, 300))).astype(np.float32)
    g[0, :6] = [1e-40, -3e-39, 0.0, -0.0, 3e38, -2.0 ** -126]
    gt = torch.from_numpy(g)
    beta = potq.compute_beta(gt, bits)
    s = torch.stack([potq.exp2i(-beta), potq.exp2i(beta), torch.tensor(float("inf"))])
    gq = KG._quantize_g(gt, s, potq.pot_emax(bits))
    assert gq.abs().max() <= 2.0 ** potq.pot_emax(bits)
    torch.testing.assert_close(gq.to(torch.bfloat16).float(), gq, rtol=0, atol=0)


def test_rowsum_order_is_the_halves_fold():
    """The dgamma rows' spec order, checked against a literal lane model of
    the kernel: per lane (c0 + c2) + (c1 + c3), then a butterfly."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 300)) * 10.0 ** rng.integers(-6, 3, (5, 300))).astype(np.float32)
    ours = ref.grad_rowsum_ref(torch.from_numpy(x)).numpy()
    want = np.zeros(5, np.float32)
    xp = np.pad(x, ((0, 0), (0, 84))).astype(np.float64)
    for c in range(0, 384, 128):
        ch = xp[:, c:c + 128]
        lanes = (ch[:, 0:32] + ch[:, 64:96]) + (ch[:, 32:64] + ch[:, 96:128])
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        want = want + lanes[:, 0].astype(np.float32)
    np.testing.assert_array_equal(ours, want)


def test_dw_refuses_per_sample_activation_scales():
    _, g, aq, wq, _, _ = _operands(8, 16, 24)
    with pytest.raises(ValueError, match="one activation scale"):
        ops.grad_dw_matmul(torch.from_numpy(g), aq, per_sample_act_scales=True)
    pol = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True)
    a = torch.randn(2, 4, 16, requires_grad=True)
    out = mfmac.mf_linear(a, torch.randn(16, 24), 0.95, policy=pol)
    with pytest.raises(ValueError, match="one activation scale"):
        out.sum().backward()


def _vjp_reference(a, w, gamma, cot, policy, is_last):
    fn = lambda a_, w_, g_: jmfmac.mf_linear(a_, w_, g_, policy=policy, is_last=is_last)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(w), jnp.float32(gamma))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(cot)))]


def _vjp_port(a, w, gamma, cot, policy, is_last):
    at = torch.from_numpy(a).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    gt = torch.tensor(gamma, dtype=torch.float32, requires_grad=True)
    out = mfmac.mf_linear(at, wt, gt, policy=policy, is_last=is_last)
    grads = torch.autograd.grad(out, (at, wt, gt), torch.from_numpy(cot), allow_unused=True)
    return [None if x is None else x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("is_last", [False, True], ids=["hidden", "last"])
@pytest.mark.parametrize("prc", [True, False], ids=["prc", "noprc"])
def test_mf_linear_vjp_vs_reference(is_last, prc):
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((3, 70, 130)) * 1.3).astype(np.float32)
    w = (rng.standard_normal((130, 300)) * 0.05 + 0.002).astype(np.float32)
    cot = (rng.standard_normal((3, 70, 300)) * 1e-3).astype(np.float32)
    pol = PAPER_FAITHFUL if prc else dataclasses.replace(PAPER_FAITHFUL, ratio_clip_init=None)
    jpol = J_PF if prc else dataclasses.replace(J_PF, ratio_clip_init=None)
    out, da, dw, dg = _vjp_port(a, w, GAMMA, cot, pol, is_last)
    jout, jda, jdw, jdg = _vjp_reference(a, w, GAMMA, cot, jpol, is_last)
    assert dw.dtype == np.float32 and jdw.dtype == np.float32
    # the residuals and Gq both packages use (equal outside the band here)
    m, k = 210, 130
    a2 = a.reshape(m, k)
    at = torch.from_numpy(a2)
    t = at.abs().amax() * GAMMA if prc else torch.tensor(float("inf"))
    aq = mfmac._quantize_a(at, torch.tensor(GAMMA), pol).float().numpy()
    wq = mfmac._quantize_w(torch.from_numpy(w), pol).float().numpy()
    gq = _quantize_g(cot.reshape(m, 300), pol.bits_g_last if is_last else pol.bits_g)
    # where the reference's operands differ (√2 band), add the exact effect
    jaq = np.asarray(jmfmac._quantize_a(jnp.asarray(a2), jnp.float32(GAMMA), jpol)).astype(np.float32)
    jwq = np.asarray(jmfmac._quantize_w(jnp.asarray(w), jpol)).astype(np.float32)
    jgq = np.asarray(jmfmac._quantize_g(jnp.asarray(cot.reshape(m, 300)), jpol, is_last))
    daq, dwq, dgq = (np.abs(x.astype(np.float64) - y) for x, y in ((aq, jaq), (wq, jwq), (gq, jgq)))
    print(f"band: {np.sum(daq > 0)} Aq, {np.sum(dwq > 0)} Wq, {np.sum(dgq > 0)} Gq elements differ")
    absf = lambda x: np.abs(x).astype(np.float64)  # noqa: E731
    _bound_check(out.reshape(m, -1), jout.reshape(m, -1), aq, wq, k, "out",
                 daq @ absf(jwq) + absf(aq) @ dwq)
    _bound_check(dw, jdw, aq.T, gq, m, "dW", daq.T @ absf(jgq) + absf(aq).T @ dgq)
    band_da = dgq @ absf(jwq).T + absf(gq) @ dwq.T
    clipped = (np.abs(a2) > t.numpy()) if prc else np.zeros_like(a2, bool)
    _bound_check(np.where(clipped, 0, da.reshape(m, k)), np.where(clipped, 0, jda.reshape(m, k)),
                 gq, wq.T, 300, "dA", band_da)
    assert np.all(da.reshape(m, k)[clipped] == 0) and np.all(jda.reshape(m, k)[clipped] == 0)
    if not prc:
        assert dg == 0 and jdg == 0
        return
    e_da = math.ceil(300 / 128) * EPS * (absf(gq) @ absf(wq.T)) + band_da
    contrib = np.where(clipped, (gq.astype(np.float64) @ wq.T) * np.sign(a2), 0)
    bound = _dgamma_bound(contrib, e_da[clipped].sum(), np.abs(a2).max())
    print(f"dgamma {float(dg)!r} vs {float(jdg)!r} (bound {bound:.3g})")
    assert abs(float(dg) - float(jdg)) <= bound


def test_fp32_policy_grads_are_plain_autograd():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((2, 9, 24)).astype(np.float32)
    out, da, dw, _ = _vjp_port(a, w, GAMMA, cot, FP32_BASELINE, False)
    jout, jda, jdw, _ = _vjp_reference(a, w, GAMMA, cot, J_FP32, False)
    for ours, theirs, x, y, c in ((out, jout, a.reshape(18, 40), w, 40),
                                  (da, jda, cot.reshape(18, 24), w.T, 24),
                                  (dw, jdw, a.reshape(18, 40).T, cot.reshape(18, 24), 18)):
        bound = c * EPS * (np.abs(x) @ np.abs(y))
        np.testing.assert_array_less(np.abs(ours.reshape(bound.shape) - theirs.reshape(bound.shape)),
                                     bound + 1e-30)


def _counts():
    return (KG.quantize_g_cuda.launches, KG.grad_da_cuda.launches, KG.grad_dw_cuda.launches)


def test_cpu_tensors_take_the_plain_versions():
    _, g, aq, wq, amax, t = _operands(20, 30, 40)
    before = _counts()
    ops.potq_grad_matmuls(torch.from_numpy(g), aq, wq)
    assert _counts() == before
    s = torch.tensor([1.0, 1.0, float("inf")])
    with pytest.raises(ValueError, match="CUDA"):
        KG.quantize_g_cuda(torch.from_numpy(g), s, emax_g=7)
    with pytest.raises(ValueError, match="CUDA"):
        KG.grad_da_cuda(torch.from_numpy(g), wq, None, s, emax_g=7, prc=False)
    with pytest.raises(ValueError, match="CUDA"):
        KG.grad_dw_cuda(aq, torch.from_numpy(g), s, emax_g=7)


def test_cuda_tensors_launch_the_kernels():
    """CUDA tensors launch the pre-pass, K2 and K3, which match the plain
    versions bit for bit (run on the card by chip_smoke.py as well)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, g, aq, wq, amax, t = _operands(200, 130, 300)
    kw = dict(a=torch.from_numpy(a), clip_t=torch.tensor(t), amax=torch.tensor(amax))
    cpu = ops.potq_grad_matmuls(torch.from_numpy(g), aq, wq, **kw)
    before = _counts()
    gpu = ops.potq_grad_matmuls(torch.from_numpy(g).cuda(), aq.cuda(), wq.cuda(),
                                **{k: v.cuda() for k, v in kw.items()})
    torch.cuda.synchronize()
    # one pre-pass shared by K2 and K3
    assert _counts() == tuple(c + 1 for c in before)
    for x, y in zip(cpu, gpu):
        assert torch.equal(x, y.cpu())
