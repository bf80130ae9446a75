"""repro_torch lockstep serving, ``cache_dtype`` and the full ``ServeStats``
vs the JAX reference at smoke size (llama3-8b smoke config: 2 layers,
d=64; a windowed variant with window=8 whose ring wraps), on the same
numpy parameters.

Tolerances and their reasons:
* Logits against the reference: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py): the MACs differ by one
  rounding per 128-chunk and rope, rsqrt and softmax by a few ulps.
* Greedy tokens and engine counters against the reference: equal.
* Inside the port (batch-1 lockstep vs a solo-prefill pool): bit for bit.
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
from repro.serve import ServeStats as JServeStats  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro.serve import lockstep_generate as j_lockstep_generate  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, ServeStats, generate, lockstep_generate  # noqa: E402
from repro_torch.serve import poisson_trace  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=7, seed=3)
# benchmarks/servebench.py --smoke, as BENCH_servebench.json records it
BENCH = dict(slots=4, requests=16, prompt_len=8, lam=2.0, new_lo=2, new_hi=40, seed=0,
             max_len=56)
BENCH_LOCKSTEP = dict(decode_steps=140, prefills=4, weight_passes=144)
ARCHS = {"plain": None, "w8": 8}
# cache_dtype engines: solo-prefill admission, and chunked + paged
F32_ENGINES = {"solo": {}, "paged": dict(prefill_chunk=4, page_size=4)}


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, port cfg, reference params, port params)}."""
    jbase, tbase = C.smoke_config("llama3-8b"), TC.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(jbase), jax.random.PRNGKey(0))
    tparams = spec.params_from_numpy(_named(params), "cpu")
    return {arch: (dataclasses.replace(jbase, window=w), dataclasses.replace(tbase, window=w),
                   params, tparams) for arch, w in ARCHS.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lockstep_decode_step_vs_reference(models, arch):
    """A batch-3 prefill, then 12 teacher-forced lockstep decode steps (one
    shared position, per-tensor activation scales; the w8 ring wraps):
    logits within ``LOGIT_ATOL``, the same argmax, the same ``pos``."""
    jcfg, tcfg, params, tparams = models[arch]
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab, (3, 7)).astype(np.int32)
    seq = rng.integers(0, jcfg.vocab, (3, 12)).astype(np.int32)
    jprefill, jdecode = make_prefill_step(jcfg, J_PF), make_decode_step(jcfg, J_PF)
    lj, jc = jprefill(params, {"tokens": jnp.asarray(prompt)}, jreg.init_cache(jcfg, 3, MAX_LEN))
    worst = 0.0
    with torch.inference_mode():
        tc = registry.init_cache(tcfg, 3, MAX_LEN, device="cpu")
        lt, tc = registry.prefill(tcfg, PAPER_FAITHFUL, tparams,
                                  {"tokens": torch.from_numpy(prompt).long()}, tc)
        for i in range(seq.shape[1]):
            _, lj, jc = jdecode(params, jnp.asarray(seq[:, i]), jc)
            lt, tc = transformer.decode_step(tcfg, PAPER_FAITHFUL, tparams,
                                             torch.from_numpy(seq[:, i]).long(), tc)
            ref = np.asarray(lj, np.float32)
            worst = max(worst, float(np.abs(ref - lt.numpy()).max()))
            np.testing.assert_array_equal(lt.argmax(-1).numpy(), ref.argmax(-1))
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
            assert int(tc["len"]) == int(jc["len"])
    print(f"{arch}: max |logit diff| {worst:.3g} (tolerance {LOGIT_ATOL})")
    assert worst <= LOGIT_ATOL


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lockstep_generate_vs_reference(models, arch):
    """lockstep_generate at batch 3 gives the reference's tokens."""
    jcfg, tcfg, params, tparams = models[arch]
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 6)).astype(np.int32)
    ref = j_lockstep_generate(jcfg, J_PF, params, {"tokens": jnp.asarray(prompt)},
                              max_new_tokens=10, max_len=MAX_LEN)
    out = lockstep_generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": prompt},
                            max_new_tokens=10, max_len=MAX_LEN, device="cpu")
    assert out.dtype == torch.int32 and out.shape == (3, 10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch1_lockstep_equals_pool(models, arch):
    """Inside the port: each request run by batch-1 lockstep decode
    (scalar ``len``, per-tensor scales, weights quantized at use) gives
    the tokens of a solo-prefill PoolEngine (paged, per-sample scales,
    prequantized weights) that serves the whole trace, bit for bit."""
    _, tcfg, _, tparams = models[arch]
    reqs = poisson_trace(tcfg, **TRACE)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                     page_size=4, device="cpu")
    pooled = eng.run(reqs)
    for r in reqs:
        solo = lockstep_generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": r.tokens},
                                 max_new_tokens=r.max_new_tokens, max_len=MAX_LEN,
                                 device="cpu")
        np.testing.assert_array_equal(solo[0].numpy(), pooled[r.uid], err_msg=str(r.uid))


def _waves(reqs, slots):
    return [reqs[i:i + slots] for i in range(0, len(reqs), slots)]


def test_servebench_smoke_lockstep_waves(models):
    """servebench's lockstep engine on its smoke trace (4 slots, 16
    requests, waves decoding to the wave's longest output): the
    reference's tokens, and the prefill and decode calls the port makes
    equal BENCH_servebench.json's 4 prefills, 140 decode steps and 144
    weight passes."""
    jcfg, tcfg, params, tparams = models["plain"]
    kw = dict(n_requests=BENCH["requests"], prompt_len=BENCH["prompt_len"],
              lam=BENCH["lam"], new_lo=BENCH["new_lo"], new_hi=BENCH["new_hi"],
              seed=BENCH["seed"])
    jreqs, treqs = j_poisson_trace(jcfg, **kw), poisson_trace(tcfg, **kw)
    calls = {"prefill": 0, "decode_step": 0}

    def counted(name):
        fn = getattr(registry, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    mp = pytest.MonkeyPatch()
    for name in calls:
        mp.setattr(registry, name, counted(name))
    try:
        for jwave, twave in zip(_waves(jreqs, BENCH["slots"]), _waves(treqs, BENCH["slots"])):
            horizon = max(r.max_new_tokens for r in twave)
            jtoks = np.concatenate([r.tokens for r in jwave], axis=0)
            ref = j_lockstep_generate(jcfg, J_PF, params, {"tokens": jnp.asarray(jtoks)},
                                      max_new_tokens=horizon, max_len=BENCH["max_len"])
            out = lockstep_generate(
                tcfg, PAPER_FAITHFUL, tparams,
                {"tokens": np.concatenate([r.tokens for r in twave], axis=0)},
                max_new_tokens=horizon, max_len=BENCH["max_len"], device="cpu")
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    finally:
        mp.undo()
    got = dict(decode_steps=calls["decode_step"], prefills=calls["prefill"],
               weight_passes=calls["decode_step"] + calls["prefill"])
    assert got == BENCH_LOCKSTEP


def _stat_names(cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    props = {k for k, v in vars(cls).items() if isinstance(v, property)}
    return fields, props


def test_serve_stats_fields_match_reference():
    """The port's ServeStats has every field and property of the
    reference's, plus its own host wall-clock TTFT."""
    fields, props = _stat_names(ServeStats)
    jfields, jprops = _stat_names(JServeStats)
    assert fields == jfields | {"ttft_s"}
    assert props == jprops | {"mean_ttft_s"}
    st = ServeStats(weight_passes=7)
    assert (st.data_shards, st.model_shards, st.per_device_weight_passes) == (1, 1, 7)


@functools.lru_cache(maxsize=None)
def _f32_runs(name):
    """(reference tokens and stats, port tokens and stats) of one engine
    with float32 K/V pages on the trace; the bf16 port run's stats."""
    jcfg, tcfg = C.smoke_config("llama3-8b"), TC.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    tparams = spec.params_from_numpy(_named(params), "cpu")
    kw = F32_ENGINES[name]
    jeng = JPoolEngine(jcfg, J_PF, params, max_slots=2, max_len=MAX_LEN,
                       cache_dtype=jnp.float32, **kw)
    jout = {k: np.asarray(v) for k, v in jeng.run(j_poisson_trace(jcfg, **TRACE)).items()}
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                         cache_dtype=dt, device="cpu", **kw)
        runs[dt] = (eng.run(poisson_trace(tcfg, **TRACE)), eng.last_stats)
    return jout, jeng.last_stats, runs


@pytest.mark.parametrize("name", list(F32_ENGINES))
def test_float32_cache_engine_vs_reference(name):
    """PoolEngine(cache_dtype=float32) against the reference's with
    jnp.float32: the same tokens and every counter; its pages hold twice
    the bytes of bf16 ones."""
    jout, jst, runs = _f32_runs(name)
    out, st = runs[torch.float32]
    for uid, toks in jout.items():
        np.testing.assert_array_equal(out[uid], toks, err_msg=str(uid))
    jfields, jprops = _stat_names(JServeStats)
    for key in sorted(jfields | jprops):
        assert getattr(st, key) == getattr(jst, key), key
    assert st.kv_page_bytes == 2 * runs[torch.bfloat16][1].kv_page_bytes
    assert st.per_device_weight_passes == st.weight_passes


def test_generate_float32_cache_vs_reference(models):
    """generate(cache_dtype=float32) (one slot a request, solo prefill)
    gives the reference's tokens."""
    jcfg, tcfg, params, tparams = models["plain"]
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (3, 5)).astype(np.int32)
    ref = j_generate(jcfg, J_PF, params, {"tokens": jnp.asarray(prompt)}, max_new_tokens=6,
                     max_len=MAX_LEN, cache_dtype=jnp.float32)
    out = generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": prompt}, max_new_tokens=6,
                   max_len=MAX_LEN, cache_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
