"""repro_torch paged serving slice vs the JAX reference at smoke size
(llama3-8b smoke config: 2 layers, d=64; a windowed variant with
window=8): the page allocator, paged ``decode_step``, ``chunk_step``,
and ``PoolEngine`` with chunked piggybacked prefill, paging and the
prefix cache, on the same numpy parameters.

Tolerances and their reasons:
* Allocator, engine counters, cache ``pos``/``len``/``table``: host
  integer bookkeeping, compared exactly.
* Logits against the reference: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py): the MACs differ by one
  rounding per 128-chunk and rope, rsqrt and softmax by a few ulps; a
  last-ulp difference that moves an activation across a PoT rounding
  boundary moves the logits by far more than an ulp.
* Tokens against the reference: equal up to the first step whose
  reference top-2 margin is under ``LOGIT_ATOL`` (a near-tie).
* Inside the port (paged vs contiguous decode, a chunk-step decode row vs
  ``decode_step``, pool vs solo, prefix on vs off, stale pad rows): bit
  for bit.
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
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro.serve.engine import make_chunk_step, make_decode_step  # noqa: E402
from repro.serve.trace import shared_prefix_trace as j_shared_prefix_trace  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, Request, poisson_trace  # noqa: E402
from repro_torch.serve import shared_prefix_trace, slots  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
CHUNK = 4
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=7, seed=3)
PREFIX = dict(n_requests=4, prefix_len=8, suffix_len=4, lam=1.0, new_lo=2,
              new_hi=6, seed=3)
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True)
ARCHS = {"plain": None, "w8": 8}

# engine configurations: (trace, engine kwargs); "pressure" has too few
# pages for the trace, so admissions defer and prefix pages are evicted
ENGINES = {
    "chunked": ("poisson", dict(prefill_chunk=CHUNK)),
    "paged": ("poisson", dict(prefill_chunk=CHUNK, page_size=4)),
    "prefix_off": ("prefix", dict(prefill_chunk=CHUNK, page_size=2)),
    "prefix_on": ("prefix", dict(prefill_chunk=CHUNK, page_size=2, prefix_cache=True)),
    "pressure": ("prefix", dict(prefill_chunk=CHUNK, page_size=2, prefix_cache=True,
                                num_pages=12)),
    "solo_paged": ("poisson", dict(page_size=4)),
}
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum",
               "weight_passes", "ttft_passes", "prompt_tokens", "prefix_hit_tokens",
               "cow_copies", "evictions", "admission_deferrals", "pages_in_use_sum",
               "page_size", "kv_page_bytes", "mean_occupancy", "mean_ttft_passes",
               "prefix_hit_rate", "kv_hbm_bytes_per_token")


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
    out = {}
    for arch, window in ARCHS.items():
        out[arch] = (dataclasses.replace(jbase, window=window),
                     dataclasses.replace(tbase, window=window),
                     params, tparams, params_q)
    return out


def _traces(kind, jcfg, tcfg):
    if kind == "poisson":
        jt, tt = j_poisson_trace(jcfg, **TRACE), poisson_trace(tcfg, **TRACE)
    else:
        jt, tt = j_shared_prefix_trace(jcfg, **PREFIX), shared_prefix_trace(tcfg, **PREFIX)
        # a repeat of request 0: its whole prompt hits, so the page it
        # resumes streaming into is copied on write
        r = jt[0]
        jt.append(dataclasses.replace(r, uid=len(jt), arrival=jt[-1].arrival + 3))
        tt.append(Request(uid=len(tt), tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                          arrival=jt[-1].arrival))
    return jt, tt


_RUNS = {}


def _engine_runs(models, arch, name):
    """(reference tokens, reference stats, port tokens, port stats) of one
    engine configuration, memoised across the tests of this module."""
    key = (arch, name)
    if key not in _RUNS:
        jcfg, tcfg, params, tparams, _ = models[arch]
        kind, kw = ENGINES[name]
        jt, tt = _traces(kind, jcfg, tcfg)
        jeng = JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=MAX_LEN, **kw)
        jout = {k: np.asarray(v) for k, v in jeng.run(jt).items()}
        teng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                          device="cpu", **kw)
        tout = teng.run(tt)
        _RUNS[key] = (jout, jeng.last_stats, tout, teng.last_stats)
    return _RUNS[key]


@functools.lru_cache(maxsize=None)
def _jsteps(jcfg, jpol):
    return make_chunk_step(jcfg, jpol), make_decode_step(jcfg, jpol)


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# PageAllocator, bit for bit
# ---------------------------------------------------------------------------

def _alloc_state(a):
    return (list(a._free), a.refcount.tolist(), [list(t) for t in a.tables],
            sorted((k[0], k[1], p) for k, p in a._prefix.items()), dict(a._lru),
            a.cow_copies, a.evictions, a.pages_in_use())


@pytest.mark.parametrize("prefix", [False, True], ids=["prefix_off", "prefix_on"])
@pytest.mark.parametrize("page", [2, 4])
def test_allocator_matches_reference(page, prefix):
    """A scripted sequence of admissions (plan, reserve, bind), prefix
    registration, lookups, retirements and clock ticks on both allocators,
    small enough that eviction and copy-on-write happen; tables, free
    lists, refcounts, the prefix cache and counters equal after each op."""
    chunk, span, slots_n, num_pages = 4, 16, 3, 14
    a = slots.PageAllocator(num_pages, page, span // page, slots_n)
    ja = jslots.PageAllocator(num_pages, page, span // page, slots_n)
    rng = np.random.default_rng(page + 10 * prefix)
    heads = [rng.integers(0, 50, 16).astype(np.int32) for _ in range(2)]
    live = {}
    stats = dict(admits=0, deferrals=0)
    for clock in range(100):
        a.tick(clock)
        ja.tick(clock)
        free = [s for s in range(slots_n) if s not in live]
        if free and rng.random() < 0.6:
            head = heads[int(rng.integers(0, 2))]
            plen = int(rng.choice([6, 8, 12]))  # repeats: whole-prompt hits
            prompt = head[:plen].copy()
            if rng.random() < 0.3:  # a tail of its own
                prompt[int(rng.integers(4, plen)):] = rng.integers(50, 99)
            need = min(plen + int(rng.integers(1, 5)), span)
            args = (prompt, need, chunk) if prefix else (None, need, None)
            plan, jplan = a.plan_admission(*args), ja.plan_admission(*args)
            assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
            assert a.prefix_lookup(prompt, chunk) == ja.prefix_lookup(prompt, chunk)
            protect = set(plan.shared) | {p for p, _ in plan.cow}
            ok = a.can_admit(a.fresh_needed(plan), protect)
            assert ok == ja.can_admit(ja.fresh_needed(jplan), protect)
            if ok:
                hold, jhold = a.reserve(plan), ja.reserve(jplan)
                assert hold == jhold
                a.bind(free[0], hold)
                ja.bind(free[0], jhold)
                live[free[0]] = prompt
                stats["admits"] += 1
            else:
                stats["deferrals"] += 1
        elif live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            if prefix and rng.random() < 0.7:
                a.register_prefix(slot, live[slot], chunk)
                ja.register_prefix(slot, live[slot], chunk)
            a.release_slot(slot)
            ja.release_slot(slot)
            del live[slot]
        assert _alloc_state(a) == _alloc_state(ja), clock
        a.check_conservation()
    print(f"page {page} prefix {prefix}: {stats}, cow {a.cow_copies}, "
          f"evictions {a.evictions}")
    assert stats["admits"] >= 10
    if prefix:
        assert a.cow_copies > 0 and a.evictions > 0
    for slot in sorted(live):
        a.release_slot(slot)
        ja.release_slot(slot)
    assert _alloc_state(a) == _alloc_state(ja)
    with pytest.raises(slots.PageAllocatorError, match="double free"):
        slots.PageAllocator(4, page, 2, 1)._unref(0)


# ---------------------------------------------------------------------------
# Paged decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [MAX_LEN, 6, 4])
def test_paged_decode_vs_contiguous_and_reference(models, page):
    """Two slots at different positions, teacher-forced for 10 steps
    through a shuffled page table: the port's paged decode equals its
    contiguous decode bit for bit, and the reference's paged decode
    within ``LOGIT_ATOL``."""
    jcfg, tcfg, params, tparams, _ = models["plain"]
    _, jdecode = _jsteps(jcfg, J_SERVE_POL)
    rng = np.random.default_rng(page)
    n = MAX_LEN // page
    table = rng.permutation(2 * n).reshape(2, n)
    jc = jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=page)
    jc["table"] = jnp.asarray(table, jnp.int32)
    jc["len"] = jnp.asarray([0, 3], jnp.int32)
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=page)
    pc["table"] = torch.from_numpy(table)
    pc["len"] = torch.tensor([0, 3])
    cc = slots.lift_cache(transformer.init_cache(tcfg, 2, MAX_LEN, device="cpu"), 2)
    cc["len"] = torch.tensor([0, 3])
    seq = rng.integers(0, jcfg.vocab, (2, 10))
    worst = 0.0
    with torch.inference_mode():
        for i in range(10):
            tok = torch.from_numpy(seq[:, i])
            lp, pc = transformer.decode_step(tcfg, SERVE_POL, tparams, tok, pc)
            lc, cc = transformer.decode_step(tcfg, SERVE_POL, tparams, tok, cc)
            _, lj, jc = jdecode(params, jnp.asarray(seq[:, i], jnp.int32), jc)
            assert torch.equal(lp, lc), i
            worst = max(worst, float(np.abs(_np(lj) - lp.numpy()).max()))
        kview = slots.gather_view(pc, pc["k"][1])
        assert torch.equal(kview, cc["k"][1])
        assert torch.equal(slots.gather_view(pc, pc["pos"]), cc["pos"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    print(f"page {page}: max |logit diff| vs reference {worst:.3g}")
    assert worst <= LOGIT_ATOL


def test_dead_rows_write_nothing(models):
    """torch has no out-of-bounds drop mode: a slot whose table row is
    drop_id (retired) and pad positions must leave every page, the null
    page included, byte for byte as it was."""
    _, tcfg, _, tparams, _ = models["plain"]
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4,
                                  num_pages=8)
    pc["table"][0] = torch.tensor([0, 1, 2, 3, 4, 5])
    pc["k"].normal_()
    pc["v"].normal_()
    before = {k: v.clone() for k, v in pc.items()}
    with torch.inference_mode():
        # slot 1 (all drop_id) rides a decode step and a chunk step
        transformer.decode_step(tcfg, SERVE_POL, tparams, torch.tensor([3, 4]), pc)
        tokens = torch.zeros((2, CHUNK), dtype=torch.int64)
        registry.chunk_step(tcfg, SERVE_POL, tparams, tokens, [2, 0], pc)
    for key in ("k", "v"):  # only slot 0's positions 0..2, on page 0
        assert torch.equal(pc[key][:, 1:], before[key][:, 1:]), key
        assert torch.equal(pc[key][:, 0, 3:], before[key][:, 0, 3:]), key
    assert pc["pos"][0].tolist() == [0, 1, 2, -1]
    assert torch.equal(pc["pos"][1:], before["pos"][1:])


# ---------------------------------------------------------------------------
# chunk_step
# ---------------------------------------------------------------------------

def _stream(step, cache, prompts, chunk, *, pt):
    """Stream prompts into slots of ``cache`` by chunk steps (pool-style);
    ``pt`` selects the port's argument types.  Returns (logits, cache)."""
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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mixed_chunk_step_vs_reference(models, arch):
    """One chunk step holding a decode row, a prefilling row and an idle
    row (after streaming two prompts in), against the reference's: logits
    of the live rows within ``LOGIT_ATOL``; ``pos``, ``len`` and the
    table equal.  The windowed arch's prompt wraps its 8-position ring."""
    jcfg, tcfg, params, tparams, _ = models[arch]
    jchunk, _ = _jsteps(jcfg, J_SERVE_POL)
    page = 4
    jc = jreg.init_pool_cache(jcfg, 3, MAX_LEN, page_size=page)
    pc = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu", page_size=page)
    prompts = [[5, 7, 9, 11, 2, 13, 17, 19, 23, 29], [3, 1, 4], []]
    pstep = functools.partial(registry.chunk_step, tcfg, SERVE_POL, tparams)
    jstep = functools.partial(jchunk, params)
    worst = 0.0
    with torch.inference_mode():
        lp, pc = _stream(pstep, pc, prompts, CHUNK, pt=True)
        lj, jc = _stream(jstep, jc, prompts, CHUNK, pt=False)
        worst = max(worst, float(np.abs(_np(lj)[:2] - lp[:2].numpy()).max()))
        # slot 0 decodes, slot 1 streams 3 more prompt tokens, slot 2 idles
        tokens = np.zeros((3, CHUNK), np.int64)
        tokens[0, 0] = 42
        tokens[1, :3] = [8, 6, 7]
        n_new = np.array([1, 3, 0])
        lp, pc = registry.chunk_step(tcfg, SERVE_POL, tparams, torch.from_numpy(tokens),
                                     n_new, pc)
        _, lj, jc = jchunk(params, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(n_new, jnp.int32), jc)
    worst = max(worst, float(np.abs(_np(lj)[:2] - lp[:2].numpy()).max()))
    for key in ("pos", "len", "table"):
        np.testing.assert_array_equal(np.asarray(jc[key]), pc[key].numpy(), err_msg=key)
    print(f"{arch}: max |logit diff| vs reference {worst:.3g}")
    assert worst <= LOGIT_ATOL


def test_decode_fast_path_matches_chunk_step(models):
    """The engine's decode fast path switches step bodies mid-request, so
    a chunk-step decode row must equal ``decode_step`` bit for bit:
    logits and every cache leaf (the port's form of the reference's
    test_serve_batching.py::test_decode_fast_path_matches_chunk_step)."""
    _, tcfg, _, tparams, _ = models["plain"]
    pc = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4)
    pstep = functools.partial(registry.chunk_step, tcfg, SERVE_POL, tparams)
    with torch.inference_mode():
        logits, pc = _stream(pstep, pc, [[5, 7, 9, 11, 2, 13], [3, 1, 4]], CHUNK, pt=True)
        last = torch.argmax(logits, -1)
        c1 = {k: v.clone() for k, v in pc.items()}
        c2 = {k: v.clone() for k, v in pc.items()}
        dec = torch.zeros((2, CHUNK), dtype=torch.int64)
        dec[:, 0] = last
        lg_chunk, c1 = registry.chunk_step(tcfg, SERVE_POL, tparams, dec, [1, 1], c1)
        lg_plain, c2 = registry.decode_step(tcfg, SERVE_POL, tparams, last, c2)
    assert torch.equal(lg_chunk, lg_plain)
    for key in ("k", "v", "pos", "len", "table"):
        assert torch.equal(c1[key], c2[key]), key


def test_chunk_step_pad_rows_ignore_stale_cache(models):
    """A pad query's softmax is uniform over every key, a reused slot's
    stale K/V included; chunk_step zeroes pad rows, so valid-position
    logits are equal between a fresh cache and one whose K/V hold 1e4
    junk, and again for a decode-shaped step on top."""
    _, tcfg, _, tparams, _ = models["plain"]
    fresh = registry.init_pool_cache(tcfg, 1, MAX_LEN, device="cpu")
    junk = {k: v.clone() for k, v in fresh.items()}
    junk["k"].fill_(1e4)
    junk["v"].fill_(1e4)
    junk["pos"][:] = 7  # a previous occupant's positions ...
    slots.reset_slot(junk, 0)  # ... rewound
    tokens = torch.zeros((1, CHUNK), dtype=torch.int64)
    tokens[0, :3] = torch.tensor([5, 7, 9])
    with torch.inference_mode():
        lf, fresh = registry.chunk_step(tcfg, SERVE_POL, tparams, tokens, [3], fresh)
        lj, junk = registry.chunk_step(tcfg, SERVE_POL, tparams, tokens, [3], junk)
        assert torch.equal(lf, lj)
        dec = torch.zeros((1, CHUNK), dtype=torch.int64)
        dec[0, 0] = torch.argmax(lf, -1)[0]
        lf2, _ = registry.chunk_step(tcfg, SERVE_POL, tparams, dec, [1], fresh)
        lj2, _ = registry.chunk_step(tcfg, SERVE_POL, tparams, dec, [1], junk)
    assert torch.equal(lf2, lj2)


# ---------------------------------------------------------------------------
# PoolEngine against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,name", [("plain", n) for n in ENGINES]
                         + [("w8", "chunked"), ("w8", "paged")])
def test_engine_counters_equal_reference(models, arch, name):
    """Every ServeStats counter the port keeps, ``ttft_passes`` per uid
    included, equals the reference engine's on the same trace."""
    _, jst, _, st = _engine_runs(models, arch, name)
    for key in STAT_FIELDS:
        assert getattr(st, key) == getattr(jst, key), key
    if name == "pressure":
        assert st.admission_deferrals > 0 and st.evictions > 0
    if name == "prefix_on":
        assert st.prefix_hit_rate > 0 and st.cow_copies > 0


def _reference_margins_chunked(jcfg, params_q, req, tokens, chunk):
    """Top-2 logit margin of the reference at each emitted token, the
    request driven alone through chunk steps and teacher-forced with its
    own tokens (a decode row of the chunk step is bit-equal to decode)."""
    pol = dataclasses.replace(J_SERVE_POL, weights_prequantized=True)
    jchunk, _ = _jsteps(jcfg, pol)
    cache = jreg.init_pool_cache(jcfg, 1, MAX_LEN)
    prompt = np.asarray(req.tokens).reshape(-1)
    logits, cache = _stream(functools.partial(jchunk, params_q), cache, [prompt], chunk,
                            pt=False)
    margins = []
    for t in tokens:
        assert int(np.argmax(np.asarray(logits[0]))) == int(t)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        row = np.zeros((1, chunk), np.int32)
        row[0, 0] = t
        _, logits, cache = jchunk(params_q, jnp.asarray(row), jnp.asarray([1], jnp.int32),
                                  cache)
    return margins


@pytest.mark.parametrize("arch,name", [("plain", "paged"), ("plain", "prefix_on"),
                                       ("w8", "paged")])
def test_engine_tokens_equal_reference_up_to_near_ties(models, arch, name):
    jcfg, tcfg, _, _, params_q = models[arch]
    jout, _, out, _ = _engine_runs(models, arch, name)
    jt, _ = _traces(ENGINES[name][0], jcfg, tcfg)
    near_ties = []
    for req in jt:
        ref_toks, ours = jout[req.uid], out[req.uid]
        assert ours.shape == ref_toks.shape
        margins = _reference_margins_chunked(jcfg, params_q, req, ref_toks, CHUNK)
        for step, (a, b, m) in enumerate(zip(ours, ref_toks, margins)):
            if m < LOGIT_ATOL:
                near_ties.append((req.uid, step, m))
                break  # past a near-tie the two may rightly diverge
            assert a == b, (req.uid, step, m)
    print(f"{arch}/{name} near-tie steps (uid, step, margin): {near_ties}")


# ---------------------------------------------------------------------------
# Inside the port: pool vs solo, prefix on vs off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,name", [("plain", "chunked"), ("plain", "paged"),
                                       ("w8", "paged"), ("plain", "solo_paged")])
def test_pool_vs_solo_bit_identity(models, arch, name):
    """Each request's pooled tokens equal its run alone in a one-slot
    engine with the same admission recipe, across page sizes."""
    jcfg, tcfg, _, tparams, _ = models[arch]
    _, _, out, _ = _engine_runs(models, arch, name)
    kw = dict(ENGINES[name][1], page_size=None)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=MAX_LEN,
                     device="cpu", **kw)
    for req in _traces(ENGINES[name][0], jcfg, tcfg)[1]:
        solo = eng.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(solo[req.uid], out[req.uid], err_msg=str(req.uid))


def test_prefix_cache_keeps_tokens(models):
    """Prefix on (shared pages, copy-on-write, eviction under page
    pressure) serves the very tokens prefix off does, in fewer weight
    passes and a lower mean TTFT."""
    off = _engine_runs(models, "plain", "prefix_off")
    for name in ("prefix_on", "pressure"):
        on = _engine_runs(models, "plain", name)
        for uid, toks in off[2].items():
            np.testing.assert_array_equal(on[2][uid], toks, err_msg=f"{name} {uid}")
    on = _engine_runs(models, "plain", "prefix_on")
    assert on[3].weight_passes < off[3].weight_passes
    assert on[3].mean_ttft_passes < off[3].mean_ttft_passes


@pytest.mark.parametrize("kind", ["poisson", "shared_prefix"])
def test_traces_match_reference(models, kind):
    jcfg, tcfg, _, _, _ = models["plain"]
    if kind == "poisson":
        pairs = zip(j_poisson_trace(jcfg, **TRACE), poisson_trace(tcfg, **TRACE))
    else:
        pairs = zip(j_shared_prefix_trace(jcfg, **PREFIX), shared_prefix_trace(tcfg, **PREFIX))
    for a, b in pairs:
        assert (a.uid, a.arrival, a.max_new_tokens) == (b.uid, b.arrival, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_engine_validates_paging(models):
    _, tcfg, _, tparams, _ = models["plain"]
    kw = dict(max_slots=2, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, page_size=5, **kw)
    with pytest.raises(ValueError, match="prefix_cache needs prefill_chunk"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, prefix_cache=True, **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, prefill_chunk=MAX_LEN + 1, **kw)
    with pytest.raises(ValueError, match="num_pages"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, page_size=4, num_pages=5, **kw)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, page_size=4, prefill_chunk=CHUNK, **kw)
    toks = np.zeros((1, 20), np.int32)
    assert len(eng.run([Request(uid="full", tokens=toks, max_new_tokens=4)])["full"]) == 4
    with pytest.raises(ValueError, match="pages"):
        eng.run([Request(uid="over", tokens=toks, max_new_tokens=5)])
