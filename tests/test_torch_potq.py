"""repro_torch quantizer vs the JAX reference (repro.core.potq).

Bit for bit outside the √2 band: the port rounds log2 from the float's
bits (frexp, threshold 0x3F3504F4), the reference by round(log2(x)) on
its backend, and the two may disagree on mantissas within a few ulps of
√2·2^k.  Elements there are left out and counted.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import potq as jpotq  # noqa: E402
from repro_torch.core import potq  # noqa: E402

torch.set_num_threads(1)

SQRT_HALF = 0.7071067811865476
BAND = 2.0 ** -18  # |frexp mantissa - √2/2| below this is "in the band"


def _in_band(x: np.ndarray) -> np.ndarray:
    m, _ = np.frexp(np.abs(x).astype(np.float32))
    return (np.abs(m - SQRT_HALF) < BAND) & (x != 0)


def _inputs(seed=0):
    """Normals of several scales, subnormals, zeros and exact powers of
    two (which land on ±emax after scaling)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((32, 257)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-4, 3, (32, 1)).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1e-40, -3e-39, 2.0 ** -126, -(2.0 ** -130)]
    x[1, :4] = [2.0 ** 7, -(2.0 ** 7), 2.0 ** -7, 2.0 ** 15]
    x[2] = 0.0
    return x


def test_pot_emax_and_exp2i_bit_for_bit():
    for bits in range(3, 9):
        assert potq.pot_emax(bits) == jpotq.pot_emax(bits)
    e = np.arange(-126, 128, dtype=np.int32)
    ours = potq.exp2i(torch.from_numpy(e)).numpy()
    ref = np.asarray(jpotq.exp2i(jnp.asarray(e)))
    assert ours.view(np.uint32).tolist() == ref.view(np.uint32).tolist()
    assert np.array_equal(ours, np.ldexp(np.float32(1), e).astype(np.float32))


@pytest.mark.parametrize("bits", [4, 5, 6])
@pytest.mark.parametrize("axes", [None, (1,)], ids=["tensor", "per_row"])
def test_compute_beta_and_pot_quantize_match_reference(bits, axes):
    x = _inputs(bits)
    xt = torch.from_numpy(x)
    beta = potq.compute_beta(xt, bits, axes)
    jbeta = np.asarray(jpotq.compute_beta(jnp.asarray(x), bits, axes))
    amax = np.abs(x).max(axis=axes, keepdims=axes is not None)
    group_ok = ~_in_band(np.broadcast_to(amax, np.shape(jbeta)))
    np.testing.assert_array_equal(beta.numpy()[group_ok], jbeta[group_ok])

    q = potq.pot_quantize(xt, bits, beta).numpy()
    jq = np.asarray(jpotq.pot_quantize(jnp.asarray(x), bits, jnp.asarray(beta.numpy())))
    scaled = x / np.ldexp(np.float32(1), np.broadcast_to(beta.numpy(), x.shape))
    keep = ~_in_band(scaled) & np.broadcast_to(group_ok, x.shape)
    print(f"bits={bits} axes={axes}: {np.sum(~keep)} of {x.size} elements "
          "left out (√2 band)")
    assert np.sum(~keep) <= x.size // 100
    np.testing.assert_array_equal(q[keep], jq[keep])


@pytest.mark.parametrize("bits", [4, 5, 6])
def test_pot_encode_decode(bits):
    x = _inputs(10 + bits)
    enc = potq.pot_encode(torch.from_numpy(x), bits)
    jenc = jpotq.pot_encode(jnp.asarray(x), bits)
    beta = enc.beta.numpy()
    assert int(beta) == int(np.asarray(jenc.beta))
    keep = ~_in_band(x / np.ldexp(np.float32(1), beta))
    np.testing.assert_array_equal(enc.exp.numpy()[keep], np.asarray(jenc.exp)[keep])
    # the sign of a code that is zero is not compared: XLA:CPU flushes the
    # subnormal inputs to zero before taking it
    nz = keep & (enc.exp.numpy() != potq.EXP_ZERO)
    np.testing.assert_array_equal(enc.sign.numpy()[nz], np.asarray(jenc.sign)[nz])
    np.testing.assert_array_equal(potq.pot_decode(enc).numpy(),
                                  potq.pot_quantize(torch.from_numpy(x), bits).numpy())


@pytest.mark.parametrize("k", [-149, -130, -20, -3, 0, 1, 7, 13, 100])
def test_frexp_rule_is_exact_on_the_band(k):
    """round(log2 v) = k + 1 exactly when v >= √2·2^k, i.e. v² >= 2·4^k —
    decided in exact rational arithmetic for every float32 within 300 ulps
    of √2·2^k (subnormal binades included)."""
    centre = np.float32(np.sqrt(2.0) * 2.0 ** k) if k > -149 else np.float32(2.0 ** -149)
    v = centre.view(np.int32) + np.arange(-300, 301, dtype=np.int32)
    v = v[v > 0].view(np.float32)
    got = potq.round_log2(torch.from_numpy(v)).numpy()
    for val, r in zip(v.tolist(), got.tolist()):
        f = Fraction(val)
        m, e = np.frexp(val)  # val = m·2^e, m in [0.5, 1)
        lo = int(e) - 1  # floor(log2 val)
        up = f * f >= 2 * Fraction(2) ** (2 * lo)
        assert r == lo + int(up), (val, r, lo, up)


def test_weight_bias_correction_vs_reference():
    """The WBC shift: the two means sum in different orders, so the
    shifted weights agree within a few ulps of the mean (rtol 1e-6)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((64, 96)) * 0.05 + 0.003).astype(np.float32)
    ours = potq.weight_bias_correction(torch.from_numpy(w)).numpy()
    ref = np.asarray(jpotq.weight_bias_correction(jnp.asarray(w)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * float(np.abs(w).mean()))
    assert abs(float(ours.mean())) < 1e-8


@pytest.mark.parametrize("gamma", [0.95, 0.5, 1.0])
def test_ratio_clip_and_its_vjp_vs_reference(gamma):
    """PRC forward bit for bit (a max, a product and a clamp), its written-
    out VJP bit for bit in da, dgamma within the reorder bound of its sum
    (n eps sum|terms| times max|A|), and autograd through ``ratio_clip``
    gives the written-out VJP (at gamma = 1 the largest element sits on
    the threshold: unclipped, as the rule says)."""
    rng = np.random.default_rng(8)
    a = (rng.standard_normal((16, 40)) * 1.5).astype(np.float32)
    g = rng.standard_normal((16, 40)).astype(np.float32)
    at, gt, gam = torch.from_numpy(a), torch.from_numpy(g), torch.tensor(gamma)
    ours = potq.ratio_clip(at, gam).numpy()
    ref = np.asarray(jpotq.ratio_clip(jnp.asarray(a), jnp.float32(gamma)))
    np.testing.assert_array_equal(ours, ref)
    da, dg = potq.ratio_clip_vjp(at, gam, gt)
    jda, jdg = jpotq.ratio_clip_vjp(jnp.asarray(a), jnp.float32(gamma), jnp.asarray(g))
    np.testing.assert_array_equal(da.numpy(), np.asarray(jda))
    amax = float(np.abs(a).max())
    terms = np.where(np.abs(a) > amax * np.float32(gamma), g * np.sign(a), 0)
    bound = terms.size * 2 ** -23 * float(np.abs(terms).sum()) * amax
    assert dg.dtype == torch.float32 and abs(float(dg) - float(jdg)) <= bound
    # autograd of the forward is the written-out rule (the reference's too)
    at_g = at.clone().requires_grad_(True)
    gam_g = gam.clone().requires_grad_(True)
    auto_da, auto_dg = torch.autograd.grad(potq.ratio_clip(at_g, gam_g), (at_g, gam_g), gt)
    np.testing.assert_array_equal(auto_da.numpy(), da.numpy())
    np.testing.assert_allclose(float(auto_dg), float(dg), rtol=0, atol=bound)
