"""repro_torch's PoT encode (K4's plain version behind ``ops.potq_encode``),
the wire-format decoder and int8 weight packing, against the JAX reference
on the CPU.

Tolerances and their reasons:
* Betas and codes are equal bit for bit outside the √2 band (``_in_band``
  of tests/test_torch_potq.py): the port rounds log2 by the frexp rule,
  the reference by ``round(log2(x))``, which may round a mantissa within a
  few ulps of √2/2 the other way.  Inside the band a code may differ by
  one magnitude step (a factor of 2 in value, or 0 against the smallest
  code at the underflow edge), never more; the count is printed.
* Subnormal inputs: XLA:CPU flushes them to zero, the port keeps them.
  Under the beta of a tensor whose largest value is normal a subnormal
  lies far below 2^-emax, so both give code 0, and a zero code carries no
  sign: the codes agree there without an exception.
* Decoding is exact integer and exponent arithmetic: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as JC  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import potq as jpotq  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro_torch.core import compress, potq  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import potq_encode as KE  # noqa: E402
from repro_torch.models import spec  # noqa: E402
from repro_torch.serve import quantized_weights as qw  # noqa: E402

torch.set_num_threads(1)

SQRT_HALF = 0.7071067811865476
BAND = 2.0 ** -18  # as tests/test_torch_potq.py


def _in_band(x: np.ndarray) -> np.ndarray:
    m, _ = np.frexp(np.abs(x).astype(np.float32))
    return (np.abs(m - SQRT_HALF) < BAND) & (x != 0)


def _inputs(shape, seed):
    """Normals at the reference test's scale, with zeros of both signs,
    subnormals and mantissas on both sides of √2/2 in the first row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    below = np.float32(np.array(0x3F3504F3, np.uint32).view(np.float32)) * np.float32(2 ** -10)
    above = np.float32(np.array(0x3F3504F4, np.uint32).view(np.float32)) * np.float32(2 ** -10)
    edge = np.array([0.0, -0.0, 1e-40, -3e-39, below, -above, above, 2.0 ** -126],
                    np.float32)
    flat = x.reshape(-1)
    k = min(flat.size, edge.size)
    flat[:k] = edge[:k]
    return x


def _codes_of(enc, emax):
    """int8 codes from the reference's (sign, exp) encoding."""
    exp = np.asarray(enc.exp).astype(np.int32)
    mag = np.where(exp == jpotq.EXP_ZERO, 0, exp + emax + 1)
    return np.where(np.asarray(enc.sign) == 1, -mag, mag).astype(np.int8)


@pytest.mark.parametrize("shape", [(64, 128), (100, 300), (7, 1000)])
@pytest.mark.parametrize("bits", [4, 5, 6])
def test_potq_encode_vs_reference(shape, bits):
    """The reference's own cases (tests/test_serving_quantized.py): the
    port's encode against the reference's Pallas kernel in interpret mode
    and against its ``pot_encode``."""
    x = _inputs(shape, shape[0] + bits)
    emax = potq.pot_emax(bits)
    codes, beta = ops.potq_encode(torch.from_numpy(x), bits)
    assert codes.dtype == torch.int8 and tuple(codes.shape) == shape
    assert beta.dtype == torch.int32 and beta.dim() == 0
    jcodes, jbeta = jops.potq_encode(jnp.asarray(x), bits=bits, interpret=True)
    assert not _in_band(np.abs(x).max()[None]).any()
    assert int(beta) == int(jbeta)
    for ref in (np.asarray(jcodes), _codes_of(jpotq.pot_encode(jnp.asarray(x), bits), emax)):
        band = _in_band(x / np.float32(2.0 ** int(beta)))
        got = codes.numpy()
        np.testing.assert_array_equal(got[~band], ref[~band])
        diff = np.abs(got[band].astype(np.int32) - ref[band].astype(np.int32))
        print(f"{shape} bits={bits}: {band.sum()} elements in the √2 band, "
              f"{np.count_nonzero(diff)} differ (by at most {diff.max(initial=0)})")
        assert diff.max(initial=0) <= 1


@pytest.mark.parametrize("bits", [3, 5, 6])
def test_encode_plain_spec_and_edges(bits):
    """The plain version against an independent float64 computation of the
    spec, for betas inside and outside the range where 2^-beta is a normal
    float32, and its stated non-finite behaviour."""
    emax = potq.pot_emax(bits)
    x = _inputs((9, 77), 40 + bits) * np.float32(1e3)
    xt = torch.from_numpy(x)
    beta0 = int(potq.compute_beta(xt, bits))
    for beta in (beta0, beta0 - 3, beta0 + 5, 127, 140, -127, -140):
        got = KE.potq_encode_plain(xt, torch.tensor(beta, dtype=torch.int32), emax=emax).numpy()
        m, e = np.frexp(np.abs(x).astype(np.float64) * 2.0 ** -beta)  # exact in f64
        r = e - 1 + (m >= np.float64(potq.SQRT_HALF_UP))
        want = np.where((x == 0) | (r < -emax), 0, np.minimum(r, emax) + emax + 1)
        want = np.where(x < 0, -want, want).astype(np.int8)
        np.testing.assert_array_equal(got, want, err_msg=f"beta={beta}")
        if -126 <= beta <= 126:  # 2^beta and 2^-beta are normal floats: x / 2^beta
            enc = potq.pot_encode(xt, bits, torch.tensor(beta, dtype=torch.int32))
            mag = torch.where(enc.exp == potq.EXP_ZERO, 0, enc.exp.to(torch.int32) + emax + 1)
            ref = torch.where(enc.sign == 1, -mag, mag).to(torch.int8)
            np.testing.assert_array_equal(got, ref.numpy(), err_msg=f"beta={beta}")
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 2.0 ** 30])
    got = KE.potq_encode_plain(special, torch.tensor(0, dtype=torch.int32), emax=emax)
    top = 2 * emax + 1
    assert got.tolist() == [0, top, -top, 0, 0, top]  # NaN -> 0, ±inf saturate


@pytest.mark.parametrize("bits", [4, 5, 6])
def test_decompress_vs_reference_and_roundtrip(bits):
    emax = potq.pot_emax(bits)
    rng = np.random.default_rng(bits)
    code = rng.integers(-(2 * emax + 1), 2 * emax + 2, (13, 40)).astype(np.int8)
    beta = np.int32(-9)
    ours = compress.decompress(torch.from_numpy(code), torch.tensor(beta), bits).numpy()
    theirs = np.asarray(jcompress.decompress(jnp.asarray(code), jnp.asarray(beta), bits))
    assert ours.dtype == np.float32
    assert ours.view(np.uint32).tolist() == theirs.view(np.uint32).tolist()
    # K4's round trip: decode(encode(x)) is the nearest-rounding quantizer
    x = torch.from_numpy(_inputs((100, 300), bits))
    codes, b = ops.potq_encode(x, bits)
    np.testing.assert_array_equal(compress.decompress(codes, b, bits).numpy(),
                                  potq.pot_quantize(x, bits, b).numpy())


def test_wire_bytes():
    for shape in [(3,), (7, 1000), (2, 3, 4)]:
        x = np.zeros(shape, np.float32)
        assert compress.wire_bytes(torch.from_numpy(x)) == jcompress.wire_bytes(jnp.asarray(x))


def test_cpu_tensors_take_the_plain_version():
    x = torch.from_numpy(_inputs((7, 1000), 1))
    before = KE.potq_encode_cuda.launches
    codes, beta = ops.potq_encode(x, 5)
    assert KE.potq_encode_cuda.launches == before
    np.testing.assert_array_equal(codes.numpy(), KE.potq_encode_plain(x, beta, emax=7).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        KE.potq_encode_cuda(x, beta, emax=7)


def test_cuda_tensors_launch_the_kernel():
    """A CUDA tensor launches K4, which matches the plain version bit for
    bit, ragged and unaligned views included (run on the card by
    chip_smoke.py as well)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_inputs((7, 1001), 2))
    before = KE.potq_encode_cuda.launches
    for view in (x, x[:, 1:]):
        cpu, beta = ops.potq_encode(view, 5)
        gpu, gbeta = ops.potq_encode(view.cuda(), 5)
        torch.cuda.synchronize()
        assert torch.equal(gpu.cpu(), cpu) and int(gbeta) == int(beta)
    assert KE.potq_encode_cuda.launches == before + 2


def _olmo_smoke():
    cfg = JC.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}
    return cfg, jp, spec.params_from_numpy(named, "cpu")


def _named_np(tree):
    out = {}
    for k, v in _flatten_with_names(tree)[0].items():
        v = np.asarray(v)
        out[k] = v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    return out


@pytest.mark.parametrize("tree", ["raw", "served"])
def test_pack_unpack_vs_reference(tree):
    """pack_int8 / unpack_int8 on a smoke olmo-1b tree: raw parameters
    (codes bit for bit outside the √2 band) and the reference's
    ``quantize_for_serving`` output carried across (exact PoT values, so
    every code is bit for bit)."""
    cfg, jp, tp = _olmo_smoke()
    if tree == "served":
        jp = jqw.quantize_for_serving(cfg, J_PF, jp)
        tp = spec.params_from_numpy(
            {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}, "cpu")
    ours = {k: v.numpy() for k, v in spec.named_leaves(qw.pack_int8(tp))}
    theirs = _named_np(jqw.pack_int8(jp))
    assert sorted(ours) == sorted(theirs)
    n_band = 0
    for name, got in ours.items():
        ref = theirs[name]
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if name.endswith("/code"):
            beta = int(ours[name[:-len("code")] + "beta"])
            x = {k: v.float().numpy() for k, v in spec.named_leaves(tp)}[name[:-len("/code")]]
            band = _in_band(x / np.float32(2.0 ** beta))
            if tree == "served":
                assert not band.any()
            n_band += int(np.count_nonzero(got[band] != ref[band]))
            np.testing.assert_array_equal(got[~band], ref[~band], err_msg=name)
            assert np.abs(got[band].astype(np.int32) - ref[band]).max(initial=0) <= 1
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    print(f"{tree}: {n_band} codes differ inside the √2 band")
    # unpack: bf16 PoT values, equal to the reference's unpack of its codes
    unpacked = qw.unpack_int8(qw.pack_int8(tp))
    for name, x in spec.named_leaves(unpacked):
        if name.endswith("/w"):
            assert x.dtype == torch.bfloat16, name
    if tree == "served":
        ref_unpacked = _named_np(jqw.unpack_int8(jqw.pack_int8(jp)))
        for name, x in spec.named_leaves(unpacked):
            np.testing.assert_array_equal(x.float().numpy(), ref_unpacked[name], err_msg=name)


def test_pack_int8_roundtrip_is_exact_per_matrix():
    """The reference's round-trip assertion
    (tests/conformance/test_matmul_paths.py), held by the port: one served
    matrix packs to int8 and back to the same bf16 values bit for bit."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((96, 200)) * 0.05 + 3e-3).astype(np.float32))
    served = qw.quantize_for_serving(None, PAPER_FAITHFUL, {"proj": {"w": w}})
    assert served["proj"]["w"].dtype == torch.bfloat16
    back = qw.unpack_int8(qw.pack_int8(served))
    assert torch.equal(back["proj"]["w"], served["proj"]["w"])


def test_pack_int8_one_beta_per_stacked_leaf():
    """As in the reference, a stacked (L, K, N) leaf is packed under ONE
    beta: a layer whose values lie far below the stack's top loses the
    codes that fall under 2^(beta - emax), and keeps the rest exactly."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 32, 48)).astype(np.float32) * 0.02
    w[1] *= np.float32(2.0 ** -6)
    served = qw.quantize_for_serving(None, PAPER_FAITHFUL, {"l": {"w": torch.from_numpy(w)}})
    packed = qw.pack_int8(served)
    assert packed["l"]["w"]["beta"].dim() == 0
    back = qw.unpack_int8(packed)["l"]["w"].float()
    s = served["l"]["w"].float()
    assert torch.equal(back[0], s[0])
    lost = back[1] != s[1]
    assert lost.any() and torch.all(back[1][lost] == 0)
    floor = 2.0 ** (int(packed["l"]["w"]["beta"]) - potq.pot_emax(5))
    assert torch.all(s[1][lost].abs() < floor)
