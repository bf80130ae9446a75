"""repro_torch speculative decoding vs the JAX reference at smoke size
(llama3-8b smoke config: 2 layers, d=64; a windowed variant with
window=8): the drafters, greedy acceptance and ``draft_policy``,
``verify_step``, the snapshot/restore rollback, and ``PoolEngine(spec=)``
with the n-gram and the 3-bit self-draft drafters over bf16 and
PoT-quantized (``KV_PINNED``) pages, on the same numpy parameters.

Tolerances and their reasons:
* Drafters, acceptance, policies, engine counters: host integer
  bookkeeping, compared exactly.
* Inside the port, bit for bit: ``verify_step`` against C sequential
  ``decode_step`` calls (logits and every cache leaf), the rollback, and
  spec-on tokens against spec-off tokens (greedy acceptance emits exactly
  the plain decode tokens).
* ``verify_step`` logits against the reference's: ``LOGIT_ATOL`` = 1e-3,
  the serving slice's bound (tests/test_torch_serve.py); ``pos``, ``len``
  and the quantized cache's codes and betas equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as C  # noqa: E402
from repro.ckpt.manager import _flatten_with_names  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import LowBitSelfDraft as JLowBitSelfDraft  # noqa: E402
from repro.serve import NgramDrafter as JNgramDrafter  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import spec as jspec_lib  # noqa: E402
from repro.serve.engine import make_chunk_step, make_verify_step  # noqa: E402
from repro.serve.trace import shared_prefix_trace as j_shared_prefix_trace  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.serve import LowBitSelfDraft, NgramDrafter, PoolEngine, Request  # noqa: E402
from repro_torch.serve import poisson_trace, shared_prefix_trace, slots  # noqa: E402
from repro_torch.serve import spec as spec_lib  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
CHUNK = 4
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=9, seed=3)
PREFIX = dict(n_requests=4, prefix_len=8, suffix_len=4, lam=1.0, new_lo=2, new_hi=6,
              seed=3)
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True)
J_SERVE_POL = dataclasses.replace(jpolicy.PAPER_FAITHFUL, per_sample_act_scales=True)
KVQ = {"bf16": (None, None), "kvq": (KV_PINNED, jpolicy.KV_PINNED)}
DRAFTERS = {"ngram": (NgramDrafter(max_draft=3), JNgramDrafter(max_draft=3)),
            "self": (LowBitSelfDraft(max_draft=3, bits=3),
                     JLowBitSelfDraft(max_draft=3, bits=3))}
# engine configurations: (trace, engine kwargs)
ENGINES = {
    "span": ("poisson", dict(prefill_chunk=CHUNK)),
    "page4": ("poisson", dict(prefill_chunk=CHUNK, page_size=4)),
    "prefix": ("prefix", dict(prefill_chunk=CHUNK, page_size=2, prefix_cache=True)),
    "solo": ("poisson", dict(page_size=4)),
}
SPEC_FIELDS = ("weight_passes", "accepted_tokens", "draft_weight_passes", "decode_steps",
               "emitted_tokens", "ttft_passes", "pages_in_use_sum", "kv_page_bytes",
               "prefix_hit_tokens", "accepted_tokens_per_weight_pass",
               "kv_hbm_bytes_per_token")


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, port cfg, reference params, port params)}."""
    jbase, tbase = C.smoke_config("llama3-8b"), TC.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(jbase), jax.random.PRNGKey(0))
    tparams = spec.params_from_numpy(_named(params), "cpu")
    return {arch: (dataclasses.replace(jbase, window=w), dataclasses.replace(tbase, window=w),
                   params, tparams)
            for arch, w in (("plain", None), ("w8", 8))}


# ---------------------------------------------------------------------------
# Drafters, acceptance, draft_policy
# ---------------------------------------------------------------------------

def test_drafters_and_acceptance_match_reference():
    rng = np.random.default_rng(0)
    kinds = [(3, 3, 1), (2, 2, 2), (4, 1, 1)]
    for trial in range(60):
        hist = rng.integers(0, 6, int(rng.integers(0, 30)))  # a small vocab repeats
        for max_draft, max_n, min_n in kinds:
            ours = NgramDrafter(max_draft, max_n, min_n)
            ref = JNgramDrafter(max_draft, max_n, min_n)
            for k in (0, 1, 2, 5):
                a, b = ours.propose(hist, k), ref.propose(hist, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), (trial, hist, k)
        drafts = rng.integers(0, 3, int(rng.integers(0, 5)))
        verify = rng.integers(0, 3, len(drafts) + 1)
        assert spec_lib.greedy_accept(drafts, verify) == jspec_lib.greedy_accept(drafts, verify)
    for bad in (dict(max_draft=0), dict(min_n=2, max_n=1), dict(min_n=0)):
        with pytest.raises(ValueError) as ours:
            NgramDrafter(**bad)
        with pytest.raises(ValueError) as ref:
            JNgramDrafter(**bad)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="max_draft"):
        LowBitSelfDraft(max_draft=0)
    assert LowBitSelfDraft.needs_draft_pass and not NgramDrafter.needs_draft_pass


def test_draft_policy_matches_reference():
    fields = ("enabled", "bits_w", "bits_a", "bits_g", "bits_g_last", "weight_bias_correction",
              "ratio_clip_init", "weights_prequantized", "per_sample_act_scales")
    base = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True,
                               per_sample_act_scales=True, kv_quant=KV_PINNED)
    jbase = dataclasses.replace(jpolicy.PAPER_FAITHFUL, weights_prequantized=True,
                                per_sample_act_scales=True, kv_quant=jpolicy.KV_PINNED)
    for bits in (2, 3, 4):
        ours, ref = tpolicy.draft_policy(base, bits), jpolicy.draft_policy(jbase, bits)
        assert [getattr(ours, f) for f in fields] == [getattr(ref, f) for f in fields]
        assert ours.kv_quant == KV_PINNED
    for pol, jpol, bits in ((tpolicy.FP32_BASELINE, jpolicy.FP32_BASELINE, 3),
                            (base, jbase, 5), (base, jbase, 1)):
        with pytest.raises(ValueError) as ours:
            tpolicy.draft_policy(pol, bits)
        with pytest.raises(ValueError) as ref:
            jpolicy.draft_policy(jpol, bits)
        assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------

PROMPTS = [[5, 7, 9, 11, 2, 13], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8, 6, 7]]
ROWS = np.array([[21, 3, 40, 7], [11, 12, 13, 14], [2, 99, 5, 0]])


def _prompted_pool(cfg, params, pol, page, kvq):
    """A 3-slot pool whose slots hold prompts of 6, 9 and 3 tokens, each
    streamed in through chunk steps, under a shuffled page table."""
    n = MAX_LEN // page if cfg.window is None else 8 // page
    pc = registry.init_pool_cache(cfg, 3, MAX_LEN, device="cpu", page_size=page,
                                  kv_quant=kvq)
    pc["table"] = torch.from_numpy(np.random.default_rng(page).permutation(3 * n)
                                   .reshape(3, n))
    with torch.inference_mode():
        for c0 in range(0, 9, CHUNK):
            tokens = np.zeros((3, CHUNK), np.int64)
            n_new = np.zeros((3,), np.int64)
            for s, p in enumerate(PROMPTS):
                part = p[c0:c0 + CHUNK]
                tokens[s, :len(part)] = part
                n_new[s] = len(part)
            registry.chunk_step(cfg, pol, params, torch.from_numpy(tokens), n_new, pc)
    return pc


def _sequential(cfg, pol, params, cache, n_new):
    """decode_step called max(n_new) times; a slot past its count is
    voided (drop_id table row: it writes nothing).  Returns the (B, C, V)
    logits and the cache with ``len`` = start + n_new."""
    table = cache["table"].clone()
    len0 = cache["len"].clone()
    drop = slots.drop_id(cache)
    out = []
    with torch.inference_mode():
        for j in range(int(max(n_new))):
            cache["table"] = torch.where(torch.tensor(n_new)[:, None] > j, table,
                                         torch.full_like(table, drop))
            lg, cache = registry.decode_step(cfg, pol, params, torch.from_numpy(ROWS[:, j]),
                                             cache)
            out.append(lg)
    cache["table"] = table
    cache["len"] = len0 + torch.tensor(n_new)
    return torch.stack(out, dim=1), cache


@pytest.mark.parametrize("arch,page,kv", [("plain", MAX_LEN, "bf16"), ("plain", 4, "bf16"),
                                          ("plain", MAX_LEN, "kvq"), ("plain", 4, "kvq"),
                                          ("w8", 4, "bf16"), ("w8", 4, "kvq")])
@pytest.mark.parametrize("n_new", [(4, 4, 4), (4, 2, 0)], ids=["full", "ragged"])
def test_verify_equals_sequential_decode(models, arch, page, kv, n_new):
    """Logits of every valid (slot, position) and every cache leaf, codes
    and betas included, equal C sequential ``decode_step`` calls bit for
    bit.  Slot 0's row (positions 6..9) crosses a page at page 4, slot
    1's wraps the windowed arch's 8-position ring."""
    _, tcfg, _, tparams = models[arch]
    pol = dataclasses.replace(SERVE_POL, kv_quant=KVQ[kv][0])
    pc = _prompted_pool(tcfg, tparams, pol, page, KVQ[kv][0])
    seq_cache = {k: v.clone() for k, v in pc.items()}
    with torch.inference_mode():
        lv, pc = registry.verify_step(tcfg, pol, tparams, torch.from_numpy(ROWS),
                                      np.array(n_new), pc)
    ls, seq_cache = _sequential(tcfg, pol, tparams, seq_cache, n_new)
    assert lv.shape == (3, 4, tcfg.vocab_padded)
    for s, n in enumerate(n_new):
        assert torch.equal(lv[s, :n], ls[s, :n]), s
    for key in pc:
        assert torch.equal(pc[key], seq_cache[key]), key


@pytest.mark.parametrize("kv", list(KVQ))
def test_verify_vs_reference(models, kv):
    """The reference's verify step on the same pool state (3 slots, page 4,
    ragged rows): logits of the valid positions within ``LOGIT_ATOL``;
    ``pos``, ``len`` and, quantized, the codes and betas equal."""
    jcfg, tcfg, params, tparams = models["plain"]
    tkv, jkv = KVQ[kv]
    pol = dataclasses.replace(SERVE_POL, kv_quant=tkv)
    jpol = dataclasses.replace(J_SERVE_POL, kv_quant=jkv)
    pc = _prompted_pool(tcfg, tparams, pol, 4, tkv)
    jc = jreg.init_pool_cache(jcfg, 3, MAX_LEN, page_size=4, kv_quant=jkv)
    jc["table"] = jnp.asarray(pc["table"].numpy(), jnp.int32)
    jchunk = make_chunk_step(jcfg, jpol)
    for c0 in range(0, 9, CHUNK):
        tokens = np.zeros((3, CHUNK), np.int32)
        n_new = np.zeros((3,), np.int32)
        for s, p in enumerate(PROMPTS):
            part = p[c0:c0 + CHUNK]
            tokens[s, :len(part)] = part
            n_new[s] = len(part)
        _, _, jc = jchunk(params, jnp.asarray(tokens), jnp.asarray(n_new), jc)
    n_new = np.array([4, 2, 1])
    with torch.inference_mode():
        lv, pc = registry.verify_step(tcfg, pol, tparams, torch.from_numpy(ROWS), n_new, pc)
    _, jl, jc = make_verify_step(jcfg, jpol)(params, jnp.asarray(ROWS, jnp.int32),
                                             jnp.asarray(n_new, jnp.int32), jc)
    jl = np.asarray(jl, np.float32)
    worst = max(float(np.abs(jl[s, :n] - lv[s, :n].numpy()).max())
                for s, n in enumerate(n_new))
    keys = ("pos", "len", "table") + (("k", "v", "k_beta", "v_beta") if tkv else ())
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jc[key]), pc[key].numpy(), err_msg=key)
    print(f"{kv}: max |verify logit diff| vs reference {worst:.3g}")
    assert worst <= LOGIT_ATOL


@pytest.mark.parametrize("kv", list(KVQ))
def test_spec_snapshot_restore_roundtrip(models, kv):
    """Snapshot the 4 entries a round can touch, scribble junk over every
    leaf there (and everywhere else), restore with keep = (0, 2, 4, 1):
    restored positions read the snapshot, kept positions keep the junk,
    and the rest of the cache (the null page included) is untouched; the
    dead slot 3 writes nothing."""
    _, tcfg, _, _ = models["plain"]
    tkv = KVQ[kv][0]
    pc = registry.init_pool_cache(tcfg, 4, MAX_LEN, device="cpu", page_size=4,
                                  num_pages=20, kv_quant=tkv)
    gen = torch.Generator().manual_seed(1)
    for key in ("k", "v", "k_beta", "v_beta"):
        if key in pc:
            pc[key] = torch.randint(0, 100, pc[key].shape, generator=gen).to(pc[key].dtype)
    pc["pos"] = torch.randint(-1, 30, pc["pos"].shape, generator=gen)
    pc["table"][:3] = torch.from_numpy(np.random.default_rng(2).permutation(18).reshape(3, 6))
    pc["len"] = torch.tensor([5, 2, 9, 7])
    before = {k: v.clone() for k, v in pc.items()}
    snap = slots.spec_snapshot(pc, 4)
    for key in ("k", "v", "k_beta", "v_beta", "pos"):
        if key in pc:  # junk everywhere, the null page included
            pc[key] = pc[key] + 1
    pc["len"] = pc["len"] + 3
    scribbled = {k: v.clone() for k, v in pc.items()}
    keep = torch.tensor([0, 2, 4, 1])
    slots.spec_restore(pc, snap, keep)
    assert pc["len"].tolist() == [5, 4, 13, 8]
    restored = np.zeros(pc["pos"].shape, bool)
    for s in range(3):
        for j in range(int(keep[s]), 4):
            g = int(before["len"][s]) + j
            restored[int(pc["table"][s, g // 4]), g % 4] = True
    rmask = torch.from_numpy(restored)
    for key in ("k", "v", "k_beta", "v_beta", "pos"):
        if key not in pc:
            continue
        m = rmask if key == "pos" else rmask[None].expand(pc[key].shape[:3])
        assert torch.equal(pc[key][m], before[key][m]), key
        assert torch.equal(pc[key][~m], scribbled[key][~m]), key


# ---------------------------------------------------------------------------
# PoolEngine(spec=...)
# ---------------------------------------------------------------------------

_RUNS = {}


def _port_run(models, arch, name, drafter, kv):
    """(tokens, stats) of one port engine run, memoised; ``drafter`` None
    runs spec off."""
    key = ("port", arch, name, drafter, kv)
    if key not in _RUNS:
        _, tcfg, _, tparams = models[arch]
        kind, kw = ENGINES[name]
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                         device="cpu", kv_quant=KVQ[kv][0],
                         spec=DRAFTERS[drafter][0] if drafter else None, **kw)
        reqs = (shared_prefix_trace(tcfg, **PREFIX) if kind == "prefix"
                else poisson_trace(tcfg, **TRACE))
        _RUNS[key] = (eng.run(reqs), eng.last_stats)
    return _RUNS[key]


def _ref_run(models, arch, name, drafter, kv):
    key = ("ref", arch, name, drafter, kv)
    if key not in _RUNS:
        jcfg, _, params, _ = models[arch]
        kind, kw = ENGINES[name]
        eng = JPoolEngine(jcfg, jpolicy.PAPER_FAITHFUL, params, max_slots=2,
                          max_len=MAX_LEN, kv_quant=KVQ[kv][1], spec=DRAFTERS[drafter][1],
                          **kw)
        jt = (j_shared_prefix_trace(jcfg, **PREFIX) if kind == "prefix"
              else j_poisson_trace(jcfg, **TRACE))
        _RUNS[key] = ({k: np.asarray(v) for k, v in eng.run(jt).items()}, eng.last_stats)
    return _RUNS[key]


def _same(a, b):
    return all(np.array_equal(a[u], b[u]) for u in a) and a.keys() == b.keys()


@pytest.mark.parametrize("drafter", list(DRAFTERS))
@pytest.mark.parametrize("name", ["span", "page4", "prefix", "solo"])
@pytest.mark.parametrize("kv", list(KVQ))
def test_spec_tokens_equal_spec_off(models, kv, name, drafter):
    """Greedy acceptance serves exactly the spec-off tokens, for both
    drafters over bf16 and quantized pages, page = span and page 4, with
    chunked prefill and the prefix cache on, and with solo admission."""
    on, st = _port_run(models, "plain", name, drafter, kv)
    off, st_off = _port_run(models, "plain", name, None, kv)
    assert _same(on, off)
    assert st.weight_passes <= st_off.weight_passes
    assert st.emitted_tokens == st_off.emitted_tokens
    if drafter == "self":
        assert st.draft_weight_passes > 0 and st.accepted_tokens > 0
    else:
        assert st.draft_weight_passes == 0


@pytest.mark.parametrize("drafter", list(DRAFTERS))
@pytest.mark.parametrize("name", ["page4", "prefix"])
@pytest.mark.parametrize("kv", list(KVQ))
def test_spec_counters_equal_reference(models, kv, name, drafter):
    """Where the port's tokens equal the reference's, so do the counters
    (weight passes, accepted tokens, draft passes, TTFT per uid ...)."""
    ours, st = _port_run(models, "plain", name, drafter, kv)
    ref, jst = _ref_run(models, "plain", name, drafter, kv)
    assert _same(ours, ref)
    for field in SPEC_FIELDS:
        assert getattr(st, field) == getattr(jst, field), field


@pytest.mark.parametrize("drafter", list(DRAFTERS))
def test_spec_windowed_ring(models, drafter):
    """The windowed arch (ring of 8 positions, requests longer than it):
    spec on gives spec off's tokens, and the reference's counters."""
    on, st = _port_run(models, "w8", "page4", drafter, "bf16")
    off, _ = _port_run(models, "w8", "page4", None, "bf16")
    assert _same(on, off)
    ref, jst = _ref_run(models, "w8", "page4", drafter, "bf16")
    if _same(on, ref):
        for field in SPEC_FIELDS:
            assert getattr(st, field) == getattr(jst, field), field


def test_spec_eos_mid_draft_truncates(models):
    """An EOS inside the accepted run stops the request where sequential
    decode does: the spec-on output is the spec-off output cut after its
    first EOS."""
    _, tcfg, _, tparams = models["plain"]
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (1, 5))
    probe = Request(uid="p", tokens=toks, max_new_tokens=8)
    kw = dict(max_slots=2, max_len=MAX_LEN, device="cpu")
    base = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, **kw)
    ref = base.run([probe])["p"]
    eos = int(ref[3])
    req = dataclasses.replace(probe, eos_id=eos)
    ref_eos = base.run([req])["p"]
    for drafter in ("self", "ngram"):
        for kv in KVQ:
            eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, spec=DRAFTERS[drafter][0],
                             kv_quant=KVQ[kv][0], **kw)
            out = eng.run([req])["p"]
            np.testing.assert_array_equal(out, ref_eos)
            assert out[-1] == eos and eos not in out[:-1]


def test_spec_rejects_bad_config(models):
    _, tcfg, _, tparams = models["plain"]
    kw = dict(max_slots=2, max_len=MAX_LEN, device="cpu")
    with pytest.raises(TypeError, match="NgramDrafter"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, spec=object(), **kw)
    win = dataclasses.replace(tcfg, window=4)
    with pytest.raises(ValueError, match="exceeds the cache span"):
        PoolEngine(win, PAPER_FAITHFUL, tparams, spec=NgramDrafter(max_draft=5), **kw)
    with pytest.raises(ValueError, match="draft bits"):
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, spec=LowBitSelfDraft(bits=5), **kw)
    with pytest.raises(ValueError, match="draft_policy requires"):
        PoolEngine(tcfg, tpolicy.FP32_BASELINE, tparams, spec=LowBitSelfDraft(), **kw)
    other = dataclasses.replace(tcfg, family="ssm")
    with pytest.raises(NotImplementedError):
        PoolEngine(other, PAPER_FAITHFUL, tparams, spec=NgramDrafter(), **kw)
    cache = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="exceeds the cache span"):
        registry.verify_step(tcfg, SERVE_POL, tparams, torch.zeros((2, MAX_LEN + 1),
                                                                   dtype=torch.int64),
                             [1, 1], cache)



SERVEBENCH = dict(n_requests=16, prompt_len=8, lam=2.0, new_lo=2, new_hi=40, seed=0)
SERVEBENCH_ENGINE = dict(max_slots=4, max_len=56, prefill_chunk=8, page_size=8)


def test_servebench_smoke_spec_on(models):
    """servebench's ``spec_on`` engine (4 slots, chunk 8, page 8,
    LowBitSelfDraft(3, 3), 16 requests) on the same seed-0 weights: the
    port's tokens and speculation counters equal the live reference's.
    (BENCH_servebench.json records 75 weight passes, 108 accepted tokens
    and 180 draft passes; the live reference on this JAX agrees with the
    port, not with the file: PERF.md.)"""
    jcfg, tcfg, params, tparams = models["plain"]
    draft = DRAFTERS["self"]
    jeng = JPoolEngine(jcfg, jpolicy.PAPER_FAITHFUL, params, spec=draft[1],
                       **SERVEBENCH_ENGINE)
    jout = jeng.run(j_poisson_trace(jcfg, **SERVEBENCH))
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, spec=draft[0], device="cpu",
                     **SERVEBENCH_ENGINE)
    out = eng.run(poisson_trace(tcfg, **SERVEBENCH))
    for uid, toks in jout.items():
        np.testing.assert_array_equal(out[uid], np.asarray(toks), err_msg=str(uid))
    st, jst = eng.last_stats, jeng.last_stats
    print("port:", {f: getattr(st, f) for f in SPEC_FIELDS})
    for field in SPEC_FIELDS + ("mean_ttft_passes",):
        assert getattr(st, field) == getattr(jst, field), field
