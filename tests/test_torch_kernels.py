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


def test_build_reads_int_template_arguments():
    """The decode kernel's int row count reads back as a number, so ptxas's
    registers and spills of each instantiation are told apart."""
    from repro_torch.kernels import _build

    ns = "_ZN45_GLOBAL__N__dab37072_12_potq_grad_cu_bc30f364"
    assert _build._demangle(ns + "11potq_mm_decILi4ELb1ELb0EEEvPKtS2_") == "potq_mm_dec<4,1,0>"
    assert _build._demangle(ns + "10potq_mm_tcILb0ELb1EEEvPKtS2_") == "potq_mm_tc<0,1>"
    assert _build._demangle(ns + "12potq_mm_foldEPKfS1_Pfxi") == "potq_mm_fold"


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ gives every source that includes it a
    new library path, so a build never loads a library made from the old
    header; an edit elsewhere does not."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [h.name for h in _build.local_headers(csrc / "potq_matmul.cu")] == ["fp64_mma.cuh"]
    before = {s: _build.library_path(s) for s in ("potq_matmul.cu", "potq_grad.cu",
                                                   "potq_encode.cu")}
    header = csrc / "fp64_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s) for s in before}
    assert after["potq_matmul.cu"] != before["potq_matmul.cu"]
    assert after["potq_grad.cu"] != before["potq_grad.cu"]
    assert after["potq_encode.cu"] == before["potq_encode.cu"]
    # a header included only through another header counts as well
    (csrc / "inner.cuh").write_text("// v1\n")
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    first = _build.library_path("potq_matmul.cu")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert _build.library_path("potq_matmul.cu") != first


def _decode_split_model(aq, wq, deq):
    """The decode kernel's arithmetic in numpy: the lane that owns a column
    sums the 128 k-rows of a chunk in k order by fp64 FMAs (each product of
    two bf16 values is exact, so an FMA is a multiply and an add), rounds
    the chunk sum once into an f32 (nchunk, M, N) scratch; the fold kernel
    adds the scratch left to right from 0.0f and multiplies by deq."""
    m, k = aq.shape
    n = wq.shape[1]
    nchunk = -(-k // ref.CANONICAL_BK)
    part = np.empty((nchunk, m, n), np.float32)
    for c in range(nchunk):
        p = np.zeros((m, n), np.float64)
        for kk in range(c * 128, min(c * 128 + 128, k)):
            p = p + aq[:, kk:kk + 1].astype(np.float64) * wq[kk:kk + 1].astype(np.float64)
        part[c] = p.astype(np.float32)
    acc = np.zeros((m, n), np.float32)
    for c in range(nchunk):
        acc = acc + part[c]
    return acc * np.float32(deq)


@pytest.mark.parametrize("m", [1, 4, 32])
def test_decode_split_model_is_bit_exact(m):
    """Splitting the chunks across blocks into a scratch and folding them
    afterwards is the spec's order: bit for bit with the plain version at
    ragged K (two full chunks and a 44-wide one), rows on their own betas,
    an all-zero row and a dequant that is not 1."""
    aq, wq = _pot_operands(m, 300, 40, seed=20 + m)
    aq[0] = 0.0
    scal = torch.tensor([1.0, 1.0, 2.0 ** -9, 0.0, float("inf")])
    want = K.potq_matmul_plain(torch.from_numpy(aq).bfloat16(),
                               torch.from_numpy(wq).bfloat16(), scal).numpy()
    np.testing.assert_array_equal(_decode_split_model(aq, wq, 2.0 ** -9), want)


def test_quantize_prepass_model_is_bit_exact():
    """quantize=True on the card: an elementwise pre-pass writes the scaled
    PoT values of A (PRC clip) and W (WBC shift) as bf16, then the product
    runs on them and multiplies by deq.  bf16 holds every such value
    exactly, so this equals potq_matmul_plain(quantize=True) bit for bit,
    subnormal and zero inputs included."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((9, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 40)) * 0.02 + 0.003).astype(np.float32)
    a[0, :4] = [1e-40, -3e-39, 0.0, -0.0]
    w[0, :2] = [1e-41, -2e-39]
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    w_mean, clip_t = wt.mean(), at.abs().max() * 0.95
    emax = potq.pot_emax(5)
    beta_a = potq.compute_beta(torch.clamp(at, -clip_t, clip_t), 5)
    beta_w = potq.compute_beta(wt - w_mean, 5)
    scal = torch.stack([potq.exp2i(-beta_a), potq.exp2i(-beta_w), potq.exp2i(beta_a + beta_w),
                        w_mean, clip_t])
    qa = ref.quantize_tile_ref((torch.clamp(at, -clip_t, clip_t) - 0.0) * scal[0], emax)
    qw = ref.quantize_tile_ref((torch.clamp(wt, -float("inf"), float("inf")) - scal[3])
                               * scal[1], emax)
    for q in (qa, qw):
        torch.testing.assert_close(q.bfloat16().float(), q, rtol=0, atol=0)
    model = K.potq_matmul_plain(qa.bfloat16(), qw.bfloat16(), scal)
    want = K.potq_matmul_plain(at, wt, scal, emax_a=emax, emax_w=emax, quantize=True)
    assert torch.equal(model, want)
    assert torch.equal(want, ops.potq_matmul(at, wt, w_mean=w_mean, clip_t=clip_t))


@pytest.mark.parametrize("m,k,n,path,groups", [
    (4, 4096, 4096, "decode", 32),      # decode: 16 strips, a warp per chunk
    (4, 14336, 4096, "decode", 112),
    (4, 4096, 128512, "decode", 1),     # the LM head's 502 strips run unsplit
    (1, 4096, 1024, "decode", 32),
    (32, 4096, 4096, "decode", 32),     # four row groups of 8
    (32, 4096, 128512, "decode", 1),
    (33, 4096, 4096, "tc", 4),
    (128, 4096, 1024, "tc", 16),        # prefill: 8 tiles
    (128, 4096, 4096, "tc", 4),
    (128, 4096, 14336, "tc", 1),        # 112 tiles: a split would not pay
    (128, 14336, 4096, "tc", 4),
    (128, 4096, 128512, "tc", 1),
    (4096, 2048, 2048, "tc", 1),        # training: 512 tiles
    (4096, 2048, 50688, "tc", 1),
    (2, 100, 64, "decode", 1),          # one chunk: nothing to split
    (3, 200, 130, "decode", 1),         # two chunks: the fold would not pay
])
def test_plan_depends_on_the_shapes_alone(m, k, n, path, groups):
    """The path and the chunk split follow from the shapes alone (the
    serving shapes of llama3-8b, the training shapes of olmo-1b)."""
    assert K.plan(m, n, k) == (path, groups)
    assert (m <= K.DECODE_MAX_M) == (path == "decode")
    nchunk = -(-k // ref.CANONICAL_BK)
    per = -(-nchunk // groups)
    assert -(-nchunk // per) == groups  # every range holds at least one chunk


def _expert_operands(e, m, k, n, seed, zero_rows=()):
    """E experts' operands, each quantized as ``mf_expert_linear`` does in
    serving: its own W scale, a scale per row of A; ``zero_rows`` are
    zeroed in every expert (capacity padding between real rows)."""
    pairs = [_pot_operands(m, k, n, seed=seed + i) for i in range(e)]
    aq = np.stack([p[0] * 2.0 ** (3 * i) for i, p in enumerate(pairs)])
    wq = np.stack([p[1] for p in pairs])
    aq[:, list(zero_rows)] = 0.0
    return torch.from_numpy(aq).bfloat16(), torch.from_numpy(wq).bfloat16()


@pytest.mark.parametrize("e,m,k,n,zero_rows", [
    (3, 4, 300, 70, ()),
    (4, 12, 200, 16, (1, 2, 5, 6, 7)),   # a router-like ragged N, padded rows
    (2, 40, 130, 8, ()),
])
def test_pot_value_bmm_cpu_is_the_plain_loop(e, m, k, n, zero_rows):
    """On CPU tensors the expert batch is today's plain version one expert
    at a time, bit for bit, with no launch; each expert within the
    chunk bound of the reference's oracle."""
    x, y = _expert_operands(e, m, k, n, seed=e * m, zero_rows=zero_rows)
    before = K.potq_matmul_cuda.launches
    out = ops.pot_value_bmm(x, y)
    assert K.potq_matmul_cuda.launches == before
    assert out.shape == (e, m, n) and out.dtype == torch.float32
    for i in range(e):
        assert torch.equal(out[i], K.potq_matmul_plain(x[i], y[i]))
        assert torch.equal(out[i], ops.pot_value_matmul(x[i], y[i]))
        oracle = np.asarray(jref.pot_value_matmul_ref(jnp.asarray(x[i].float().numpy()),
                                                      jnp.asarray(y[i].float().numpy())))
        _check_bound(out[i].numpy(), oracle, x[i].float().numpy(), y[i].float().numpy(),
                     f"expert {i}")
    if zero_rows:
        assert float(out[:, list(zero_rows)].abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        K.potq_matmul_cuda(x, y)


def test_cuda_batched_launch_equals_single_expert_launches():
    """A CUDA tensor batch launches K1 once; it equals one launch per
    expert and the plain loop, bit for bit (run on the card by
    chip_smoke.py as well)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = _expert_operands(3, 12, 300, 70, seed=5, zero_rows=(3, 4))
    before = K.potq_matmul_cuda.launches
    gpu = ops.pot_value_bmm(x.cuda(), y.cuda())
    torch.cuda.synchronize()
    assert K.potq_matmul_cuda.launches == before + 1
    assert torch.equal(gpu.cpu(), ops.pot_value_bmm(x, y))
    for i in range(3):
        assert torch.equal(gpu[i], K.potq_matmul_cuda(x[i].cuda(), y[i].cuda()))


@pytest.mark.parametrize("e,m,k,n,path,groups", [
    (16, 16, 5120, 8192, "decode", 1),     # llama4-scout decode, 4 slots
    (16, 4, 5120, 8192, "decode", 1),
    (16, 4, 8192, 5120, "decode", 64),     # 320 warps: under three an SM
    (16, 16, 8192, 5120, "decode", 1),
    (8, 16, 32768, 6144, "decode", 256),   # grok-1 down: 384 warps
    (8, 16, 6144, 32768, "decode", 1),
    (16, 40, 5120, 8192, "tc", 1),         # a 512-token group: 1024 tiles
    (1, 4, 8192, 5120, "decode", 64),      # one expert: as plan(m, n, k)
])
def test_plan_counts_the_whole_expert_batch(e, m, k, n, path, groups):
    """The expert-batched grid holds E times one product's warps or tiles,
    and ``plan`` decides the split on that grid."""
    assert K.plan(m, n, k, 132, e) == (path, groups)
    if e == 1:
        assert K.plan(m, n, k) == (path, groups)
