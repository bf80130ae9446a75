"""repro_torch PoT-quantized KV pages vs the JAX reference at smoke size
(llama3-8b smoke config: 2 layers, d=64, one KV head of 16; a windowed
variant with window=8): the page codec, quantized paged ``decode_step``
and ``chunk_step``, and ``PoolEngine(kv_quant=KV_PINNED)``, on the same
numpy parameters.

Tolerances and their reasons:
* The codec (nibble packing, codes, betas, decoded values, wire bytes):
  integer and power-of-two arithmetic, compared bit for bit.
* Codes and betas written by the step bodies: bit for bit.  A code is the
  nearest PoT exponent of a bf16 K or V value under its token's amax, so
  an ulp of difference in a K/V value moves a code only where it crosses
  a rounding boundary; none does in these runs.
* Logits against the reference: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py).
* Engine counters: host integer bookkeeping, equal.  Tokens: equal up to
  the first step whose reference top-2 margin is under ``LOGIT_ATOL``.
* Inside the port (pool vs solo, page 4 vs page = span): bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core.policy import KV_PINNED as J_KV_PINNED  # noqa: E402
from repro.core.policy import KVQuantSpec as JKVQuantSpec  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve.engine import make_chunk_step, make_decode_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import compress  # noqa: E402
from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL, KVQuantSpec  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.serve import PoolEngine, poisson_trace, slots  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
CHUNK = 4
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=7, seed=3)
KVQ_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                              kv_quant=KV_PINNED)
J_KVQ_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, kv_quant=J_KV_PINNED)
SPECS = {"pinned": (4, True), "b4_unpacked": (4, False), "b3": (3, True),
         "b5_unpacked": (5, False)}
ENGINES = {
    "chunked": dict(prefill_chunk=CHUNK),
    "paged": dict(prefill_chunk=CHUNK, page_size=4),
    "solo_paged": dict(page_size=4),
}
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "weight_passes",
               "ttft_passes", "pages_in_use_sum", "page_size", "kv_page_bytes",
               "mean_ttft_passes", "kv_hbm_bytes_per_token")


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, port cfg, reference params, port params,
    reference prequantized params)}, one parameter draw for both archs."""
    jbase, tbase = C.smoke_config("llama3-8b"), TC.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(jbase), jax.random.PRNGKey(0))
    tparams = spec.params_from_numpy(_named(params), "cpu")
    params_q = jqw.quantize_for_serving(jbase, J_PF, params)
    return {arch: (dataclasses.replace(jbase, window=w), dataclasses.replace(tbase, window=w),
                   params, tparams, params_q)
            for arch, w in (("plain", None), ("w8", 8))}


@functools.lru_cache(maxsize=None)
def _jsteps(jcfg, jpol):
    return make_chunk_step(jcfg, jpol), make_decode_step(jcfg, jpol)


# ---------------------------------------------------------------------------
# The page codec, bit for bit
# ---------------------------------------------------------------------------

def _codec_inputs(rng):
    """(8, 3, KV=2, hd=16) K/V-like vectors: normal tokens, an all-zero
    token, tokens whose amax puts beta past each end of the window, and
    signed zeros and values far below a token's amax.  No float32
    subnormals (see :func:`test_codec_subnormal_inputs`)."""
    f = rng.standard_normal((8, 3, 2, 16)) * 3.0
    f[0, 0] = 0.0
    # beta below emax - 126 at every bit width, every element still normal
    f[0, 1] = rng.choice([-1.0, 1.0], (2, 16)) * rng.uniform(1.2e-38, 5e-38, (2, 16))
    f[0, 2] = np.clip(rng.standard_normal((2, 16)) * 3e38, -3.3e38, 3.3e38)  # above 127 - emax
    f[1, 0, 0, :4] = [-0.0, 0.0, 1e-30, -1e-30]
    f[1, 1] *= 1e30
    return f.astype(np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_codec_matches_reference(name):
    bits, pack = SPECS[name]
    spec_t, spec_j = KVQuantSpec(bits, pack), JKVQuantSpec(bits, pack)
    f = _codec_inputs(np.random.default_rng(bits + 10 * pack))
    codes, beta = compress.kv_page_encode(torch.from_numpy(f), spec_t)
    jcodes, jbeta = jcompress.kv_page_encode(jnp.asarray(f), spec_j)
    assert codes.dtype == (torch.uint8 if pack else torch.int8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    lo, hi = compress._kv_beta_window(bits)
    assert int(beta.min()) == lo and int(beta.max()) == hi  # both clamps hit
    dec = compress.kv_page_decode(codes, beta, spec_t)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jcompress.kv_page_decode(jcodes, jbeta, spec_j)))
    # decoded values are exact PoT, so a second round trip is the identity
    codes2, beta2 = compress.kv_page_encode(dec, spec_t)
    np.testing.assert_array_equal(
        compress.kv_page_decode(codes2, beta2, spec_t).numpy(), dec.numpy())
    for page, kv, hd in ((16, 8, 128), (8, 1, 16), (4, 2, 64)):
        assert compress.kv_page_wire_bytes(spec_t, page, kv, hd) == \
            jcompress.kv_page_wire_bytes(spec_j, page, kv, hd)


def test_codec_subnormal_inputs():
    """Tokens whose amax is near the smallest normal float, so some K/V
    values are subnormal after the bf16 canonicalization: the port
    flushes them to zero, as XLA does in the reference, and its codes and
    betas equal the reference's on the raw input."""
    rng = np.random.default_rng(5)
    f = rng.choice([-1.0, 1.0], (4, 2, 16)) * rng.uniform(1e-40, 6e-38, (4, 2, 16))
    f = f.astype(np.float32)
    sub = (torch.from_numpy(f).to(torch.bfloat16).float().abs()
           < np.finfo(np.float32).tiny).numpy()
    assert sub.any() and (~sub).any()
    codes, beta = compress.kv_page_encode(torch.from_numpy(f), KV_PINNED)
    jcodes, jbeta = jcompress.kv_page_encode(jnp.asarray(f), J_KV_PINNED)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    # every flushed entry codes 0, and some normal entry does not
    unpacked = compress.unpack_nibbles(codes).numpy()
    assert (unpacked[sub] == 0).all() and (unpacked[~sub] != 0).any()


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_junk_codes_decode_finite_and_match_reference(pack):
    """Every byte value (a packed -8 nibble included) under betas far
    outside the window at both ends decodes finite, as the reference's."""
    spec_t, spec_j = KVQuantSpec(4, pack), JKVQuantSpec(4, pack)
    dt = np.uint8 if pack else np.int8
    codes = np.arange(256, dtype=np.uint8).view(dt).reshape(8, 2, 16)
    beta = np.array([-(2 ** 31), -500, -124, -123, 0, 124, 125, 2 ** 31 - 1], np.int32)
    dec = compress.kv_page_decode(torch.from_numpy(codes), torch.from_numpy(beta), spec_t)
    jdec = jcompress.kv_page_decode(jnp.asarray(codes), jnp.asarray(beta), spec_j)
    assert bool(torch.isfinite(dec).all())
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    if pack:
        nib = compress.unpack_nibbles(torch.from_numpy(codes))
        np.testing.assert_array_equal(nib.numpy(), np.asarray(jcompress.unpack_nibbles(
            jnp.asarray(codes))))
        assert int(nib.min()) == -8 and int(nib.max()) == 7
        np.testing.assert_array_equal(compress.pack_nibbles(nib).numpy(), codes)
        np.testing.assert_array_equal(compress.pack_nibbles(nib).numpy(),
                                      np.asarray(jcompress.pack_nibbles(jnp.asarray(nib))))


def test_codec_rejects_bad_shapes():
    with pytest.raises(ValueError, match="odd"):
        compress.pack_nibbles(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="even head_dim"):
        compress.kv_code_width(KV_PINNED, 15)
    with pytest.raises(ValueError, match="bits <= 4"):
        KVQuantSpec(5, True)
    with pytest.raises(ValueError, match=">= 3"):
        KVQuantSpec(2, False)


# ---------------------------------------------------------------------------
# Quantized paged decode_step and chunk_step vs the reference
# ---------------------------------------------------------------------------

def _check_kv_leaves(jc, pc):
    for key in ("k", "v", "k_beta", "v_beta", "pos", "len", "table"):
        np.testing.assert_array_equal(np.asarray(jc[key]), pc[key].numpy(), err_msg=key)


@pytest.mark.parametrize("page", [MAX_LEN, 4])
def test_quantized_decode_vs_reference(models, page):
    """Two slots at different positions, teacher-forced for 10 steps
    through a shuffled page table: logits within ``LOGIT_ATOL``, every
    cache leaf (codes and betas included) equal."""
    jcfg, tcfg, params, tparams, _ = models["plain"]
    _, jdecode = _jsteps(jcfg, J_KVQ_POL)
    rng = np.random.default_rng(page)
    n = MAX_LEN // page
    table = rng.permutation(2 * n).reshape(2, n)
    jc = jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=page, kv_quant=J_KV_PINNED)
    jc["table"] = jnp.asarray(table, jnp.int32)
    jc["len"] = jnp.asarray([0, 3], jnp.int32)
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=page,
                                  kv_quant=KV_PINNED)
    pc["table"] = torch.from_numpy(table)
    pc["len"] = torch.tensor([0, 3])
    seq = rng.integers(0, jcfg.vocab, (2, 10))
    worst = 0.0
    with torch.inference_mode():
        for i in range(10):
            lp, pc = registry.decode_step(tcfg, KVQ_POL, tparams, torch.from_numpy(seq[:, i]),
                                          pc)
            _, lj, jc = jdecode(params, jnp.asarray(seq[:, i], jnp.int32), jc)
            worst = max(worst, float(np.abs(np.asarray(lj, np.float32) - lp.numpy()).max()))
    assert pc["k"].dtype == torch.uint8 and pc["k_beta"].dtype == torch.int32
    _check_kv_leaves(jc, pc)
    print(f"page {page}: max |logit diff| vs reference {worst:.3g}")
    assert worst <= LOGIT_ATOL


def _stream(step, cache, prompts, chunk, *, pt):
    bufs = [list(p) for p in prompts]
    logits = None
    while any(bufs):
        tokens = np.zeros((len(bufs), chunk), np.int64)
        n_new = np.zeros((len(bufs),), np.int64)
        for s, buf in enumerate(bufs):
            take = min(chunk, len(buf))
            tokens[s, :take] = buf[:take]
            n_new[s] = take
            bufs[s] = buf[take:]
        if pt:
            logits, cache = step(torch.from_numpy(tokens), n_new, cache)
        else:
            _, logits, cache = step(jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(n_new, jnp.int32), cache)
    return logits, cache


@pytest.mark.parametrize("arch", ["plain", "w8"])
def test_quantized_mixed_chunk_step_vs_reference(models, arch):
    """Two prompts streamed in, then one chunk step holding a decode row,
    a prefilling row and an idle row: logits of the live rows within
    ``LOGIT_ATOL``, every cache leaf equal.  The windowed arch's prompt
    wraps its 8-position ring (the encode-then-decode in-chunk path)."""
    jcfg, tcfg, params, tparams, _ = models[arch]
    jchunk, _ = _jsteps(jcfg, J_KVQ_POL)
    jc = jreg.init_pool_cache(jcfg, 3, MAX_LEN, page_size=4, kv_quant=J_KV_PINNED)
    pc = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu", page_size=4,
                                  kv_quant=KV_PINNED)
    prompts = [[5, 7, 9, 11, 2, 13, 17, 19, 23, 29], [3, 1, 4], []]
    pstep = functools.partial(registry.chunk_step, tcfg, KVQ_POL, tparams)
    with torch.inference_mode():
        lp, pc = _stream(pstep, pc, prompts, CHUNK, pt=True)
        lj, jc = _stream(functools.partial(jchunk, params), jc, prompts, CHUNK, pt=False)
        worst = float(np.abs(np.asarray(lj, np.float32)[:2] - lp[:2].numpy()).max())
        tokens = np.zeros((3, CHUNK), np.int64)
        tokens[0, 0] = 42
        tokens[1, :3] = [8, 6, 7]
        n_new = np.array([1, 3, 0])
        lp, pc = registry.chunk_step(tcfg, KVQ_POL, tparams, torch.from_numpy(tokens),
                                     n_new, pc)
        _, lj, jc = jchunk(params, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(n_new, jnp.int32), jc)
    worst = max(worst, float(np.abs(np.asarray(lj, np.float32)[:2] - lp[:2].numpy()).max()))
    _check_kv_leaves(jc, pc)
    print(f"{arch}: max |logit diff| vs reference {worst:.3g}")
    assert worst <= LOGIT_ATOL


def test_quantized_decode_fast_path_matches_chunk_step(models):
    """A chunk-step decode row equals ``decode_step`` bit for bit over the
    quantized cache: logits and every leaf, codes and betas included."""
    _, tcfg, _, tparams, _ = models["plain"]
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4,
                                  kv_quant=KV_PINNED)
    pstep = functools.partial(registry.chunk_step, tcfg, KVQ_POL, tparams)
    with torch.inference_mode():
        logits, pc = _stream(pstep, pc, [[5, 7, 9, 11, 2, 13], [3, 1, 4]], CHUNK, pt=True)
        last = torch.argmax(logits, -1)
        c1 = {k: v.clone() for k, v in pc.items()}
        c2 = {k: v.clone() for k, v in pc.items()}
        dec = torch.zeros((2, CHUNK), dtype=torch.int64)
        dec[:, 0] = last
        lg_chunk, c1 = registry.chunk_step(tcfg, KVQ_POL, tparams, dec, [1, 1], c1)
        lg_plain, c2 = registry.decode_step(tcfg, KVQ_POL, tparams, last, c2)
    assert torch.equal(lg_chunk, lg_plain)
    for key in c1:
        assert torch.equal(c1[key], c2[key]), key


def test_write_slot_encodes_like_the_step_bodies(models):
    """Solo admission encodes the bf16 mini cache; its codes and betas
    equal those the reference's write_slot makes from the same cache."""
    jcfg, tcfg, params, tparams, _ = models["plain"]
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 9))
    jmini = jreg.init_cache(jcfg, 1, MAX_LEN)
    _, jmini = jreg.prefill(jcfg, J_KVQ_POL, params, {"tokens": jnp.asarray(prompt)}, jmini)
    mini = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(torch.bfloat16)
            if k in ("k", "v") else torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in jmini.items()}
    jc = jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=4, kv_quant=J_KV_PINNED)
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4,
                                  kv_quant=KV_PINNED)
    from repro.serve import slots as jslots
    pages = [7, 2, 9, 0, 13, 13]  # drop_id (13) for the pages past the need
    jc = jslots.write_slot(jc, jmini, 1, pages=pages, kv_quant=J_KV_PINNED)
    slots.write_slot(pc, mini, 1, pages=pages, kv_quant=KV_PINNED)
    _check_kv_leaves(jc, pc)
    with pytest.raises(ValueError, match="kv_quant"):
        slots.write_slot(pc, mini, 0)


# ---------------------------------------------------------------------------
# PoolEngine(kv_quant=KV_PINNED)
# ---------------------------------------------------------------------------

_RUNS = {}


def _engine_runs(models, arch, name):
    """(reference tokens, reference stats, port tokens, port stats),
    memoised across the tests of this module."""
    key = (arch, name)
    if key not in _RUNS:
        jcfg, tcfg, params, tparams, _ = models[arch]
        kw = ENGINES[name]
        jeng = JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=MAX_LEN,
                           kv_quant=J_KV_PINNED, **kw)
        jout = {k: np.asarray(v) for k, v in jeng.run(j_poisson_trace(jcfg, **TRACE)).items()}
        teng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                          kv_quant=KV_PINNED, device="cpu", **kw)
        tout = teng.run(poisson_trace(tcfg, **TRACE))
        _RUNS[key] = (jout, jeng.last_stats, tout, teng.last_stats)
    return _RUNS[key]


@pytest.mark.parametrize("arch,name", [("plain", n) for n in ENGINES] + [("w8", "paged")])
def test_engine_counters_equal_reference(models, arch, name):
    _, jst, _, st = _engine_runs(models, arch, name)
    for key in STAT_FIELDS:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.kv_page_bytes == 2 * 2 * compress.kv_page_wire_bytes(
        KV_PINNED, st.page_size, 1, 16)


def _reference_margins(jcfg, params_q, req, tokens, solo):
    """Top-2 logit margin of the reference at each emitted token, the
    request driven alone (chunk steps, or a solo prefill into the
    quantized pool) and teacher-forced with its own tokens."""
    pol = dataclasses.replace(J_KVQ_POL, weights_prequantized=True)
    jchunk, jdecode = _jsteps(jcfg, pol)
    cache = jreg.init_pool_cache(jcfg, 1, MAX_LEN, kv_quant=J_KV_PINNED)
    prompt = np.asarray(req.tokens).reshape(-1)
    if solo:
        from repro.serve import slots as jslots
        mini = jreg.init_cache(jcfg, 1, MAX_LEN)
        logits, mini = jreg.prefill(jcfg, pol, params_q,
                                    {"tokens": jnp.asarray(prompt[None], jnp.int32)}, mini)
        cache = jslots.write_slot(cache, mini, 0, kv_quant=J_KV_PINNED)
    else:
        logits, cache = _stream(functools.partial(jchunk, params_q), cache, [prompt], CHUNK,
                                pt=False)
    margins = []
    for t in tokens:
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        _, logits, cache = jdecode(params_q, jnp.asarray([t], jnp.int32), cache)
    return margins


@pytest.mark.parametrize("arch,name", [("plain", "paged"), ("plain", "solo_paged"),
                                       ("w8", "paged")])
def test_engine_tokens_equal_reference_up_to_near_ties(models, arch, name):
    jcfg, tcfg, _, _, params_q = models[arch]
    jout, _, out, _ = _engine_runs(models, arch, name)
    near_ties = []
    for req in j_poisson_trace(jcfg, **TRACE):
        ref_toks, ours = jout[req.uid], out[req.uid]
        assert ours.shape == ref_toks.shape
        margins = _reference_margins(jcfg, params_q, req, ref_toks, name == "solo_paged")
        for step, (a, b, m) in enumerate(zip(ours, ref_toks, margins)):
            if m < LOGIT_ATOL:
                near_ties.append((req.uid, step, m))
                break  # past a near-tie the two may rightly diverge
            assert a == b, (req.uid, step, m)
    print(f"{arch}/{name} near-tie steps (uid, step, margin): {near_ties}")


@pytest.mark.parametrize("arch,name", [("plain", "paged"), ("w8", "paged"),
                                       ("plain", "solo_paged")])
def test_pool_vs_solo_and_page_span(models, arch, name):
    """Each request's pooled tokens (page 4) equal its run alone in a
    one-slot engine at page = span, bit for bit, and the pool at page =
    span gives the same tokens."""
    _, tcfg, _, tparams, _ = models[arch]
    _, _, out, _ = _engine_runs(models, arch, name)
    kw = dict(ENGINES[name], page_size=None)
    span_eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                          kv_quant=KV_PINNED, device="cpu", **kw)
    span_out = span_eng.run(poisson_trace(tcfg, **TRACE))
    solo = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=MAX_LEN,
                      kv_quant=KV_PINNED, device="cpu", **kw)
    for req in poisson_trace(tcfg, **TRACE):
        alone = solo.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(alone[req.uid], out[req.uid], err_msg=str(req.uid))
        np.testing.assert_array_equal(span_out[req.uid], out[req.uid], err_msg=str(req.uid))


def test_policy_kv_quant_and_engine_checks(models):
    """The recipe on the policy applies when the kwarg is absent; a
    quantized cache under a policy without it raises; an odd head_dim
    cannot be nibble-packed."""
    _, tcfg, _, tparams, _ = models["plain"]
    pol = dataclasses.replace(PAPER_FAITHFUL, kv_quant=KV_PINNED)
    eng = PoolEngine(tcfg, pol, tparams, max_slots=2, max_len=MAX_LEN, page_size=4,
                     device="cpu")
    assert eng.kv_quant == KV_PINNED and eng.policy.kv_quant == KV_PINNED
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", kv_quant=KV_PINNED)
    with pytest.raises(ValueError, match="kv_quant is None"):
        registry.decode_step(tcfg, dataclasses.replace(KVQ_POL, kv_quant=None), tparams,
                             torch.tensor([1, 2]), pc)
    odd = dataclasses.replace(tcfg, head_dim=15)
    with pytest.raises(ValueError, match="even head_dim"):
        PoolEngine(odd, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                   kv_quant=KV_PINNED, device="cpu")


# ---------------------------------------------------------------------------
# The JAX package's servebench smoke setup (BENCH_servebench.json)
# ---------------------------------------------------------------------------

SERVEBENCH = dict(n_requests=16, prompt_len=8, lam=2.0, new_lo=2, new_hi=40, seed=0)
SERVEBENCH_ENGINE = dict(max_slots=4, max_len=56, prefill_chunk=8, page_size=8)


def test_servebench_smoke_pool_kvq(models):
    """servebench's ``pool_kvq`` engine (4 slots, chunk 8, page 8,
    KV_PINNED, 16 requests) on the same seed-0 weights: the port's tokens
    and counters equal the live reference's, and its counters equal the
    record in BENCH_servebench.json."""
    import json
    import pathlib

    jcfg, tcfg, params, tparams, _ = models["plain"]
    jeng = JPoolEngine(jcfg, J_PF, params, kv_quant=J_KV_PINNED, **SERVEBENCH_ENGINE)
    jout = jeng.run(j_poisson_trace(jcfg, **SERVEBENCH))
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, kv_quant=KV_PINNED, device="cpu",
                     **SERVEBENCH_ENGINE)
    out = eng.run(poisson_trace(tcfg, **SERVEBENCH))
    for uid, toks in jout.items():
        np.testing.assert_array_equal(out[uid], np.asarray(toks), err_msg=str(uid))
    st, jst = eng.last_stats, jeng.last_stats
    rec = json.loads((pathlib.Path(__file__).resolve().parents[1]
                      / "BENCH_servebench.json").read_text())["pool_kvq"]
    ours = dict(weight_passes=st.weight_passes, mean_ttft_passes=st.mean_ttft_passes,
                kv_page_bytes=st.kv_page_bytes,
                kv_hbm_bytes_per_token=st.kv_hbm_bytes_per_token)
    print("port:", ours)
    for key, val in ours.items():
        assert val == getattr(jst, key) == rec[key], key
