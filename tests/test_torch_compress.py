"""The port's stochastic PoT rounding and gradient compressor
(``core/potq.py`` ``pot_quantize(stochastic=True)``, ``core/compress.py``
``compress`` / ``compressed_psum``) against their definition and the
reference's wire format.

Bounds and their reasons:
* unbiasedness: each element's rounding is a two-point draw between
  the PoT values below and above it with E[q] = x, so the mean of T
  draws lies within ``Z`` standard errors sqrt((hi - x)(x - lo) / T) of
  x; Z = 6 over a few thousand elements keeps a false alarm below 1e-5;
* grid membership, the conservative beta's headroom, decoding under the
  reference's ``decompress`` and ``compressed_psum`` = the sum of the
  ranks' own decoded values: exact.

``compressed_psum`` runs on two gloo ranks spawned once for the module.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:
    pytest.skip("the reference needs jax", allow_module_level=True)

from repro_torch.core import compress, potq  # noqa: E402

Z = 6.0
BITS = 5
REF_SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"


def _sample(n=4096, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,), generator=gen) * torch.exp(torch.randn((n,), generator=gen))


def _two_point(x, beta, bits):
    """(variance of one stochastic rounding of each x, mask of the x on
    the grid's range): the draw takes the PoT values just below and above
    |x| (under scale 2^beta).  Below the smallest grid value the rounding
    underflows to 0 and is not unbiased, in the reference too; those
    elements are left out."""
    emax = potq.pot_emax(bits)
    scale = potq.exp2i(beta)
    mag = (x / scale).abs()
    inside = mag >= potq.exp2i(torch.tensor(-emax))
    lo = torch.where(inside, potq.exp2i(torch.frexp(mag)[1] - 1), torch.ones_like(mag))
    var = ((2 * lo - mag) * (mag - lo)).clamp(min=0) * scale ** 2
    return torch.where(inside, var, torch.zeros_like(var)), inside


@pytest.mark.parametrize("bits", [4, 5, 6])
def test_stochastic_rounding_is_unbiased(bits):
    x = _sample()
    beta = potq.compute_beta(x, bits, conservative=True)
    t = 400
    gen = torch.Generator().manual_seed(1)
    draws = potq.pot_quantize(x.expand(t, -1), bits, beta, stochastic=True, generator=gen)
    var, inside = _two_point(x, beta, bits)
    se = torch.sqrt(var / t)
    dev = (draws.mean(0) - x).abs()
    assert int(inside.sum()) > 500
    assert bool((dev[inside] <= Z * se[inside] + 1e-30).all()), float(
        (dev[inside] / (se[inside] + 1e-30)).max())


@pytest.mark.parametrize("bits", [3, 5, 6])
def test_values_on_the_grid_and_conservative_beta_never_saturates(bits):
    emax = potq.pot_emax(bits)
    for seed in range(4):
        x = _sample(seed=seed)
        beta = potq.compute_beta(x, bits, conservative=True)
        top = potq.exp2i(beta + emax)
        assert float(x.abs().max()) <= float(top)  # no saturation
        assert int(beta) >= int(potq.compute_beta(x, bits))  # ceil >= round
        q = potq.pot_quantize(x, bits, beta, stochastic=True,
                              generator=torch.Generator().manual_seed(seed))
        nz = q[q != 0].abs()
        e = torch.frexp(nz)[1] - 1 - beta
        assert bool((nz == potq.exp2i(e + beta)).all())  # powers of two
        assert int(e.min()) >= -emax and int(e.max()) <= emax
        assert bool(((q == 0) | (torch.sign(q) == torch.sign(x))).all())


def test_compress_codes_decode_identically_under_the_reference():
    import jax.numpy as jnp

    from repro.core import compress as jcompress

    for seed in range(3):
        g = _sample(seed=seed)
        code, beta = compress.compress(g, torch.Generator().manual_seed(seed))
        assert code.dtype == torch.int8 and beta.dtype == torch.int32
        assert int(beta) == int(potq.compute_beta(g, BITS, conservative=True))
        ours = compress.decompress(code, beta)
        theirs = np.asarray(jcompress.decompress(jnp.asarray(code.numpy()),
                                                 jnp.asarray(beta.numpy())))
        assert ours.numpy().view(np.uint32).tolist() == theirs.view(np.uint32).tolist()
        # the codes are the stochastic quantizer's values under the same draws
        q = potq.pot_quantize(g, BITS, beta, stochastic=True,
                              generator=torch.Generator().manual_seed(seed))
        assert torch.equal(ours, q)
        assert compress.wire_bytes(g) == g.numel() + 4


def test_stochastic_rounding_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        potq.pot_quantize(_sample(), BITS, stochastic=True)


def _psum_rank(rank):
    from repro_torch.parallel import meshes

    group = meshes.make_mesh((2, 1), ("data", "model")).group("data")
    g = _sample(1024, seed=10 + rank)
    amax = torch.stack([_sample(1024, seed=10 + r).abs().max() for r in range(2)]).max()
    beta = potq.compute_beta(amax, BITS, conservative=True)
    out = compress.compressed_psum(g, torch.Generator().manual_seed(rank), group)
    own = potq.pot_quantize(g, BITS, beta, stochastic=True,
                            generator=torch.Generator().manual_seed(rank))
    t = 200
    gen = torch.Generator().manual_seed(100 + rank)
    mean = torch.stack([compress.compressed_psum(g, gen, group) for _ in range(t)]).mean(0)
    return out.numpy(), own.numpy(), mean.numpy()


@pytest.fixture(scope="module")
def psum():
    from repro_torch.parallel import collectives

    return collectives.spawn(_psum_rank, 2, device="cpu", threads=1)


def test_compressed_psum_is_the_sum_of_decoded_values(psum):
    (o0, q0, _), (o1, q1, _) = psum
    assert o0.view(np.uint32).tolist() == o1.view(np.uint32).tolist()
    assert o0.view(np.uint32).tolist() == (q0 + q1).view(np.uint32).tolist()


def test_compressed_psum_is_unbiased(psum):
    """The mean of 200 compressed sums is the exact sum within Z standard
    errors, over the elements both ranks hold on the grid's range."""
    mean = psum[0][2]
    gs = [_sample(1024, seed=10 + r) for r in range(2)]
    beta = potq.compute_beta(torch.stack([g.abs().max() for g in gs]).max(), BITS,
                             conservative=True)
    (v0, in0), (v1, in1) = (_two_point(g, beta, BITS) for g in gs)
    inside = (in0 & in1).numpy()
    se = torch.sqrt((v0 + v1) / 200).numpy()
    dev = np.abs(mean - (gs[0] + gs[1]).numpy())
    assert inside.sum() > 700
    assert np.all(dev[inside] <= Z * se[inside] + 1e-30)


def test_reference_reads_neither_flag_and_the_port_refuses_both():
    """The reference declares ``QuantPolicy.stochastic_rounding`` and
    ``TrainConfig.grad_compression`` and reads neither (no attribute
    access anywhere in its package); the port refuses both."""
    reads = []
    for path in REF_SRC.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\.(stochastic_rounding|grad_compression)\b", line):
                reads.append((str(path), i, line))
    assert reads == []
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.train import TrainConfig

    with pytest.raises(NotImplementedError, match="reads it nowhere"):
        QuantPolicy(stochastic_rounding=True)
    with pytest.raises(NotImplementedError, match="reads it nowhere"):
        TrainConfig(grad_compression=True)
