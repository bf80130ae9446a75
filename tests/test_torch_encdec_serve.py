"""repro_torch's serving engines on the encoder-decoder family vs the JAX
reference at smoke size (whisper-large-v3's smoke config), each package
prequantizing the same weights: ``PoolEngine`` chunked + paged (the
encoder-side admission pass, ``encode_cross_kv``), with the prefix cache,
and over ``KV_PINNED`` pages with n-gram speculation; ``generate`` and
``lockstep_generate`` with frames; and the traces' extras.

The prefix cache is held to the reference on requests that share their
frames.  The reference keys a prefix page on the prompt alone, so it
maps pages made under another request's frames; the port keys them on
the frames too, and prefix-on tokens equal prefix-off tokens whether the
frames differ or not.

Tolerances: none.  Greedy tokens, every deterministic ``ServeStats``
counter and the traces (tokens, budgets, arrivals, frames) equal the
reference's; inside the port, pool = solo and batch-1 lockstep = a
solo-prefill pool bit for bit.  The engine runs are memoised (``_RUNS``).
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
from repro.core.policy import KV_PINNED as J_KV_PINNED  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import NgramDrafter as JNgramDrafter  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import shared_prefix_trace as j_shared_prefix_trace  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec  # noqa: E402
from repro_torch.serve import (NgramDrafter, PoolEngine, generate,  # noqa: E402
                               lockstep_generate, poisson_trace, shared_prefix_trace)
from repro_torch.serve.scheduler import Request  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
MAX_LEN = 24
TRACE = dict(n_requests=4, prompt_len=7, lam=1.0, new_lo=2, new_hi=7, seed=3)
ENGINE = dict(max_slots=2, max_len=MAX_LEN, prefill_chunk=4, page_size=4)
# the prefix cache's traces: TRACE's requests (budgets, arrivals) with
# prompts of one shared 8-token head and a 3-token tail each, and either
# their own frames or the first request's
PREFIX_LEN, SUFFIX_LEN = 8, 3


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = C.smoke_config(ARCH), TC.smoke_config(ARCH)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, params, spec.params_from_numpy(_named(params), "cpu")


def _prefix_trace(cfg, same_frames):
    """TRACE's requests with shared-head prompts (the same numpy arrays in
    both packages); with ``same_frames`` every request carries the first
    request's frames."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab, (PREFIX_LEN,))
    reqs = poisson_trace(cfg, **TRACE)
    out = []
    for r in reqs:
        tail = rng.integers(0, cfg.vocab, (SUFFIX_LEN,))
        extras = dict(reqs[0].extras) if same_frames else r.extras
        out.append(dataclasses.replace(
            r, tokens=np.concatenate([head, tail])[None].astype(np.int32), extras=extras))
    return out


def _reqs(kind):
    """(reference requests, port requests) of a run."""
    _, tcfg, _, _ = _model()
    reqs = (_prefix_trace(tcfg, same_frames=True) if kind == "prefix"
            else poisson_trace(tcfg, **TRACE))
    jreqs = [JRequest(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                      arrival=r.arrival, extras=dict(r.extras)) for r in reqs]
    return jreqs, reqs


def _engines(kind):
    jcfg, tcfg, params, tparams = _model()
    jkw, tkw = dict(ENGINE), dict(ENGINE)
    if kind == "prefix":
        jkw["prefix_cache"] = tkw["prefix_cache"] = True
    if kind == "kvq_spec":
        jkw.update(kv_quant=J_KV_PINNED, spec=JNgramDrafter(max_draft=3))
        tkw.update(kv_quant=KV_PINNED, spec=NgramDrafter(max_draft=3))
    return (JPoolEngine(jcfg, J_PF, params, **jkw),
            PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu", **tkw))


_RUNS = {}


def _engine_runs(kind):
    """(reference tokens, reference stats, port tokens, port stats) of one
    engine kind ("plain", "prefix", "kvq_spec"), run once."""
    if kind not in _RUNS:
        jeng, eng = _engines(kind)
        jreqs, reqs = _reqs(kind)
        jout = jeng.run(jreqs)
        out = eng.run(reqs)
        _RUNS[kind] = (jout, jeng.last_stats, out, eng.last_stats)
    return _RUNS[kind]


@pytest.mark.parametrize("kind", ["plain", "prefix", "kvq_spec"])
def test_engine_vs_reference(kind):
    """A chunked (4) and paged (4) PoolEngine, plain, with the prefix cache
    on a shared-head trace whose requests share their frames, and over
    ``KV_PINNED`` pages with n-gram speculation: the reference engine's
    tokens and every counter it keeps (each chunked admission's encoder
    pass is a weight pass)."""
    jout, jst, out, st = _engine_runs(kind)
    assert out.keys() == jout.keys()
    for uid in jout:
        np.testing.assert_array_equal(out[uid], np.asarray(jout[uid]), err_msg=str(uid))
    keys = [f.name for f in dataclasses.fields(jst)] + [
        "mean_occupancy", "mean_ttft_passes", "prefix_hit_rate", "kv_hbm_bytes_per_token",
        "accepted_tokens_per_weight_pass"]
    for key in keys:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.prefills == TRACE["n_requests"]
    # every admission streams its prompt: its encoder pass plus the steps
    assert st.weight_passes == st.decode_steps + TRACE["n_requests"]
    if kind == "prefix":
        assert st.prefix_hit_tokens > 0


@pytest.mark.parametrize("same_frames", [False, True])
def test_prefix_cache_keys_on_frames(same_frames):
    """Prefix-on tokens equal prefix-off tokens on the shared-head trace.
    With distinct frames no page is shared: a decoder page's K/V from
    layer 1 up see the frames through cross attention (held here on two
    solo prefills of one prompt); with the same frames the head's pages
    are."""
    _, tcfg, _, tparams = _model()
    reqs = _prefix_trace(tcfg, same_frames)
    if not same_frames:
        caches = []
        for r in reqs[:2]:
            batch = {"tokens": torch.from_numpy(reqs[0].tokens).long(),
                     "frames": torch.from_numpy(r.extras["frames"])}
            cache = registry.init_cache(tcfg, 1, MAX_LEN, device="cpu")
            caches.append(registry.prefill(tcfg, PAPER_FAITHFUL, tparams, batch, cache)[1])
        assert torch.equal(caches[0]["k"][0], caches[1]["k"][0])
        assert not torch.equal(caches[0]["k"][1:], caches[1]["k"][1:])
    runs = {}
    for on in (False, True):
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu",
                         **dict(ENGINE, prefix_cache=on))
        runs[on] = (eng.run(reqs), eng.last_stats)
    for r in reqs:
        np.testing.assert_array_equal(runs[True][0][r.uid], runs[False][0][r.uid],
                                      err_msg=str(r.uid))
    hits = runs[True][1].prefix_hit_tokens
    assert hits > 0 if same_frames else hits == 0
    assert runs[False][1].prefix_hit_tokens == 0


def test_pool_vs_solo_bit_identity():
    """Each request's pooled tokens equal its run alone in a one-slot
    engine with the same chunk, at page = span."""
    _, tcfg, _, tparams = _model()
    _, _, out, _ = _engine_runs("plain")
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu",
                     **dict(ENGINE, max_slots=1, page_size=None))
    for req in poisson_trace(tcfg, **TRACE):
        solo = eng.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(solo[req.uid], out[req.uid], err_msg=str(req.uid))


def test_generate_and_lockstep_with_frames():
    """``generate`` with a batch of frames gives the reference's tokens;
    each request by batch-1 ``lockstep_generate`` gives the tokens of a
    solo-prefill PoolEngine serving the whole trace, bit for bit."""
    jcfg, tcfg, params, tparams = _model()
    reqs = poisson_trace(tcfg, **TRACE)
    batch = {"tokens": np.concatenate([r.tokens for r in reqs[:2]]),
             "frames": np.concatenate([r.extras["frames"] for r in reqs[:2]])}
    jtoks = j_generate(jcfg, J_PF, params, {k: jnp.asarray(v) for k, v in batch.items()},
                       max_new_tokens=4, max_len=MAX_LEN)
    toks = generate(tcfg, PAPER_FAITHFUL, tparams,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    max_new_tokens=4, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                     page_size=4, device="cpu")
    pooled = eng.run(reqs)
    for r in reqs:
        solo = lockstep_generate(tcfg, PAPER_FAITHFUL, tparams,
                                 {"tokens": r.tokens, "frames": r.extras["frames"]},
                                 max_new_tokens=r.max_new_tokens, max_len=MAX_LEN, device="cpu")
        np.testing.assert_array_equal(solo[0].numpy(), pooled[r.uid], err_msg=str(r.uid))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
def test_traces_with_extras_equal_reference(arch):
    """poisson_trace draws the reference's requests bit for bit, frames or
    patch embeddings included, at smoke size and at full width;
    shared_prefix_trace (no extras, as in the reference) too."""
    for tcfg, jcfg in ((TC.smoke_config(arch), C.smoke_config(arch)),
                       (TC.get_config(arch), C.get_config(arch))):
        ours = poisson_trace(tcfg, **dict(TRACE, n_requests=3))
        theirs = j_poisson_trace(jcfg, **dict(TRACE, n_requests=3))
        key = "frames" if jcfg.family == "encdec" else "patch_embeds"
        for r, j in zip(ours, theirs):
            assert (r.uid, r.max_new_tokens, r.arrival) == (j.uid, j.max_new_tokens, j.arrival)
            np.testing.assert_array_equal(r.tokens, j.tokens)
            assert r.extras.keys() == j.extras.keys() == {key}
            assert r.extras[key].dtype == j.extras[key].dtype == np.float32
            np.testing.assert_array_equal(r.extras[key], j.extras[key])
        kw = dict(n_requests=3, prefix_len=5, suffix_len=2, lam=1.0, new_lo=1, new_hi=4)
        for r, j in zip(shared_prefix_trace(tcfg, **kw), j_shared_prefix_trace(jcfg, **kw)):
            np.testing.assert_array_equal(r.tokens, j.tokens)
            assert r.extras == j.extras == {} and r.max_new_tokens == j.max_new_tokens


def test_request_extras_and_family_gates():
    """A request's extras default to none; the port runs all five families
    and its family tuples (pooled, chunked, paged, spec) are the
    reference's; for hybrid and ssm, ``chunk_step``, ``verify_step`` and
    the paged pool knobs refuse, as the reference's do, and a
    ``PoolEngine`` with a page size or a chunk refuses too."""
    assert Request(uid=0, tokens=np.zeros((1, 3)), max_new_tokens=1).extras == {}
    for name in ("POOLED_FAMILIES", "CHUNKED_FAMILIES", "PAGED_FAMILIES", "SPEC_FAMILIES"):
        assert getattr(registry, name) == getattr(jreg, name), name
    assert registry.PORTED_FAMILIES == ("decoder", "vlm", "encdec", "hybrid", "ssm")
    assert set(registry.PORTED_FAMILIES) == set(jreg.POOLED_FAMILIES)
    _, tcfg, _, tparams = _model()
    for arch in ("recurrentgemma-2b", "mamba2-2.7b"):
        cfg, jcfg = TC.smoke_config(arch), C.smoke_config(arch)
        cache = registry.init_pool_cache(cfg, 2, MAX_LEN, device="cpu")
        for fn, jfn in ((registry.chunk_step, jreg.chunk_step),
                        (registry.verify_step, jreg.verify_step)):
            with pytest.raises(NotImplementedError) as ours:
                fn(cfg, PAPER_FAITHFUL, tparams, torch.zeros((2, 4), dtype=torch.long),
                   [1, 1], cache)
            with pytest.raises(NotImplementedError) as theirs:
                jfn(jcfg, J_PF, None, jnp.zeros((2, 4), jnp.int32), jnp.ones((2,), jnp.int32),
                    None)
            assert str(ours.value) == str(theirs.value)
        for kw in (dict(page_size=4), dict(num_pages=4), dict(kv_quant=KV_PINNED)):
            with pytest.raises(ValueError, match="has no paged cache"):
                registry.init_pool_cache(cfg, 2, MAX_LEN, device="cpu", **kw)
        for kw in (dict(page_size=4), dict(prefill_chunk=4)):
            # refused before the weights are read
            with pytest.raises((ValueError, NotImplementedError)):
                PoolEngine(cfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=MAX_LEN,
                           device="cpu", **kw)
