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
