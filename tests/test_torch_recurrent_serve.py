"""repro_torch's serving engines on the recurrent families vs the JAX
reference at smoke size: mamba2-2.7b (ssm) and recurrentgemma-2b (hybrid:
RG-LRU and windowed attention), each package prequantizing the same
weights.  ``PoolEngine`` serves both in the lifted slot-row pool (solo
prefill admissions, no pages); ``lockstep_generate`` and ``generate``
run both.

Tolerances: none.  Greedy tokens and every ``ServeStats`` counter equal
the reference's; pool = each request alone, bit for bit; the refusals
(chunked prefill, speculation, the paged knobs, KV quantization) raise
the reference's exceptions with its messages.  The engine runs are
memoised (``_RUNS``).
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
from repro.serve import lockstep_generate as j_lockstep_generate  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import spec  # noqa: E402
from repro_torch.serve import (NgramDrafter, PoolEngine, generate,  # noqa: E402
                               lockstep_generate, poisson_trace)

torch.set_num_threads(1)

ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
# max_len under every request's prompt + budget: an ssm's state and a
# windowed ring do not grow with the length, so _validate lets them pass
MAX_LEN = 16
# prompts of two SSD chunks (ssm) and past the window of 8 (hybrid)
PROMPT_LEN = {"mamba2-2.7b": 16, "recurrentgemma-2b": 11}
TRACE = dict(n_requests=4, lam=1.0, new_lo=2, new_hi=12, seed=3)
COUNTERS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum", "weight_passes",
            "ttft_passes", "accepted_tokens", "draft_weight_passes", "prompt_tokens",
            "prefix_hit_tokens", "cow_copies", "evictions", "admission_deferrals",
            "pages_in_use_sum", "page_size", "kv_page_bytes", "data_shards", "model_shards")


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, params, spec.params_from_numpy(_named(params), "cpu")


def _reqs(arch):
    """(reference requests, port requests) of the trace."""
    _, tcfg, _, _ = _model(arch)
    reqs = poisson_trace(tcfg, prompt_len=PROMPT_LEN[arch], **TRACE)
    return [JRequest(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                     arrival=r.arrival) for r in reqs], reqs


_RUNS = {}


def _engine_runs(arch):
    """(reference tokens, reference stats, port tokens, port stats) of the
    4-request trace through a 2-slot engine, run once."""
    if arch not in _RUNS:
        jcfg, tcfg, params, tparams = _model(arch)
        jreqs, reqs = _reqs(arch)
        jeng = JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=MAX_LEN)
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                         device="cpu")
        _RUNS[arch] = (jeng.run(jreqs), jeng.last_stats, eng.run(reqs), eng.last_stats)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_and_counters_match_reference(arch):
    """Staggered arrivals through 2 slots: every request's tokens and every
    counter (weight passes, TTFT in passes, prefills, the page counters at
    0 and no page size: the slot-row pool has no pages) equal the
    reference's."""
    jout, jst, out, st = _engine_runs(arch)
    _, reqs = _reqs(arch)
    assert any(r.arrival > 0 for r in reqs)
    assert all(PROMPT_LEN[arch] + r.max_new_tokens > MAX_LEN for r in reqs[:1])
    for r in reqs:
        np.testing.assert_array_equal(out[r.uid], jout[r.uid])
        assert out[r.uid].dtype == np.int32 and len(out[r.uid]) == r.max_new_tokens
    for key in COUNTERS:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.page_size == st.kv_page_bytes == st.pages_in_use_sum == 0
    assert st.prefills == len(reqs) and st.weight_passes == st.decode_steps + st.prefills
    assert set(st.ttft_s) == {r.uid for r in reqs}


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_equals_solo(arch):
    """Each request served alone (a one-slot engine) gives its pooled
    tokens, bit for bit."""
    _, tcfg, _, tparams = _model(arch)
    _, _, out, _ = _engine_runs(arch)
    _, reqs = _reqs(arch)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=MAX_LEN, device="cpu")
    for r in reqs:
        solo = eng.run([dataclasses.replace(r, arrival=0)])
        np.testing.assert_array_equal(solo[r.uid], out[r.uid])


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_and_generate_match_reference(arch):
    """``lockstep_generate`` (a batch-2 prefill, then lockstep decode with
    per-tensor scales, as given) and ``generate`` (a one-slot-per-request
    pool) equal the reference's tokens."""
    jcfg, tcfg, params, tparams = _model(arch)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    kw = dict(max_new_tokens=6, max_len=MAX_LEN)
    ours = lockstep_generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": toks}, device="cpu", **kw)
    theirs = j_lockstep_generate(jcfg, J_PF, params, {"tokens": jnp.asarray(toks)}, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ours.dtype == torch.int32 and ours.shape == (2, 6)
    ours = generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": toks}, device="cpu", **kw)
    theirs = j_generate(jcfg, J_PF, params, {"tokens": jnp.asarray(toks)}, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


REFUSALS = {
    "prefill_chunk": dict(prefill_chunk=4),
    "spec": "spec",
    "page_size": dict(page_size=4),
    "num_pages": dict(num_pages=8),
    "prefix_cache": dict(prefix_cache=True),
    "kv_quant": "kv_quant",
}


@pytest.mark.parametrize("knob", sorted(REFUSALS))
@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_reference(arch, knob):
    """Each knob the recurrent families do not have raises the reference's
    exception type with the reference's message."""
    jcfg, tcfg, params, tparams = _model(arch)
    kw = REFUSALS[knob]
    if kw == "spec":
        jkw, tkw = dict(spec=JNgramDrafter(max_draft=2)), dict(spec=NgramDrafter(max_draft=2))
    elif kw == "kv_quant":
        jkw, tkw = dict(kv_quant=J_KV_PINNED), dict(kv_quant=KV_PINNED)
    else:
        jkw, tkw = kw, kw
    with pytest.raises(Exception) as theirs:
        JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=MAX_LEN, **jkw)
    with pytest.raises(type(theirs.value)) as ours:
        PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN, device="cpu",
                   **tkw)
    assert str(ours.value) == str(theirs.value)
