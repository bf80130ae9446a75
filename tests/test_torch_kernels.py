"""repro_torch K1 (plain versions on the CPU) vs the JAX reference:
``ops.pot_value_matmul`` / ``ops.potq_matmul`` in Pallas interpret mode and
the ``ref.*`` oracles.

Tolerance and reason: the port's chunk partial is the exact sum rounded
once; the reference's follows the XLA backend's summation order inside a
128-wide chunk.  Both left-fold the partials in f32, so they differ by at
most one rounding per chunk: ``ceil(K/128) * eps_f32 * (|Aq| @ |Wq|)``
(docs/DESIGN_kernels.md §3).  The mismatch count is reported.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import potq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import potq_matmul as K  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(3, 200, 130), (64, 1024, 96)]
EPS = np.finfo(np.float32).eps


def _pot_operands(m, k, n, seed=0, bits_a=5, bits_w=5):
    """Operands as the quantizer makes them: one beta per row of A, one
    for all of W (the exactness precondition of the port's MAC)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    aq = potq.pot_quantize(at, bits_a, potq.compute_beta(at, bits_a, (1,)))
    wq = potq.pot_quantize(wt, bits_w)
    return aq.numpy(), wq.numpy()


def _check_bound(ours, theirs, aq, wq, what):
    k = aq.shape[1]
    mag = np.abs(aq).astype(np.float64) @ np.abs(wq).astype(np.float64)
    bound = math.ceil(k / ref.CANONICAL_BK) * EPS * mag
    err = np.abs(ours.astype(np.float64) - theirs.astype(np.float64))
    print(f"{what}: {np.sum(ours != theirs)} of {ours.size} elements differ, "
          f"max err {err.max():.3g}")
    assert np.all(err <= bound), (err.max(), bound[err > bound].min())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_pot_value_matmul_vs_reference(m, k, n):
    aq, wq = _pot_operands(m, k, n, seed=m)
    ours = ops.pot_value_matmul(torch.from_numpy(aq).bfloat16(),
                                torch.from_numpy(wq).bfloat16()).numpy()
    pallas = np.asarray(jops.pot_value_matmul(jnp.asarray(aq), jnp.asarray(wq),
                                              interpret=True))
    oracle = np.asarray(jref.pot_value_matmul_ref(jnp.asarray(aq), jnp.asarray(wq)))
    _check_bound(ours, pallas, aq, wq, "vs ops.pot_value_matmul(interpret)")
    _check_bound(ours, oracle, aq, wq, "vs ref.pot_value_matmul_ref")


def test_chunk_partial_is_exact_in_any_order():
    """The spec's chunk partial is the exact sum: summing each chunk's
    products in fp64 in reverse order gives the same bits."""
    aq, wq = _pot_operands(5, 300, 7, seed=3, bits_a=6, bits_w=5)
    ours = ref.pot_value_matmul_ref(torch.from_numpy(aq), torch.from_numpy(wq)).numpy()
    acc = np.zeros((5, 7), np.float32)
    for c in range(0, 300, 128):
        prods = aq[:, c:c + 128, None].astype(np.float64) * wq[None, c:c + 128]
        part = np.zeros((5, 7), np.float64)
        for i in reversed(range(prods.shape[1])):
            part += prods[:, i]
        acc = acc + part.astype(np.float32)
    np.testing.assert_array_equal(ours, acc)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("prc_wbc", [False, True], ids=["plain", "prc_wbc"])
def test_potq_matmul_vs_reference(m, k, n, prc_wbc):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02 + 0.003).astype(np.float32)
    kw, jkw = {}, {}
    if prc_wbc:
        w_mean = np.float32(w.mean())
        clip_t = np.float32(np.abs(a).max() * 0.95)
        kw = dict(w_mean=torch.tensor(w_mean), clip_t=torch.tensor(clip_t))
        jkw = dict(w_mean=jnp.float32(w_mean), clip_t=jnp.float32(clip_t))
    ours = ops.potq_matmul(torch.from_numpy(a), torch.from_numpy(w), **kw).numpy()
    pallas = np.asarray(jops.potq_matmul(jnp.asarray(a), jnp.asarray(w),
                                         interpret=True, **jkw))
    oracle = np.asarray(jref.potq_matmul_ref(jnp.asarray(a), jnp.asarray(w), **jkw))
    # the same quantized operands, in the real domain, set the bound
    ac = np.clip(a, -clip_t, clip_t) if prc_wbc else a
    wc = w - w_mean if prc_wbc else w
    aq = potq.pot_quantize(torch.from_numpy(ac), 5).numpy()
    wq = potq.pot_quantize(torch.from_numpy(wc), 5).numpy()
    _check_bound(ours, pallas, aq, wq, "vs ops.potq_matmul(interpret)")
    _check_bound(ours, oracle, aq, wq, "vs ref.potq_matmul_ref")
    # the port's own oracle equals the dispatching wrapper bit for bit
    ref_ours = ref.potq_matmul_ref(torch.from_numpy(a), torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(ours, ref_ours.numpy())


def test_exact_spread_precondition():
    ref.check_exact_spread(6, 5)
    ref.check_exact_spread(5, 6)
    with pytest.raises(ValueError, match="53"):
        ref.check_exact_spread(6, 6)
    with pytest.raises(ValueError):
        ops.pot_value_matmul(torch.zeros(2, 4), torch.zeros(4, 3), bits_a=6, bits_w=6)


def _cpu_operands():
    aq, wq = _pot_operands(4, 300, 70, seed=9)
    return torch.from_numpy(aq).bfloat16(), torch.from_numpy(wq).bfloat16()


def test_cpu_tensors_take_the_plain_version():
    x, y = _cpu_operands()
    before = K.potq_matmul_cuda.launches
    cpu = ops.pot_value_matmul(x, y)
    assert K.potq_matmul_cuda.launches == before
    np.testing.assert_array_equal(cpu.numpy(), K.potq_matmul_plain(x, y).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        K.potq_matmul_cuda(x, y)


def test_cuda_tensors_launch_the_kernel():
    """A CUDA tensor launches the kernel, which matches the plain version
    bit for bit (run on the card by chip_smoke.py as well)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = _cpu_operands()
    before = K.potq_matmul_cuda.launches
    cpu = ops.pot_value_matmul(x, y)
    gpu = ops.pot_value_matmul(x.cuda(), y.cuda())
    torch.cuda.synchronize()
    assert K.potq_matmul_cuda.launches == before + 1
    assert torch.equal(gpu.cpu(), cpu)


def test_build_reads_registers_and_spills_from_ptxas():
    """The build helper keeps what ``ptxas -v`` says of each kernel, under a
    readable name, for the chip run to print."""
    from repro_torch.kernels import _build

    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN45_GLOBAL__N__dab37072_12_potq_grad_cu_bc30f36414grad_da_kernelILb1ELb0EEEvPKtS2_' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 220 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN45_GLOBAL__N__dab37072_12_potq_grad_cu_bc30f36424grad_da_rows_fold_kernelEPKfPfii' "
        "for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers\n"
    )
    assert _build.ptxas_resources(log) == {"grad_da_kernel<1,0>": (220, 8, 12),
                                           "grad_da_rows_fold_kernel": (32, 0, 0)}
    assert "-v" in _build.NVCC_FLAGS  # the log exists only with ptxas -v
