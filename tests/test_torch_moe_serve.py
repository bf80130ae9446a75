"""repro_torch's MoE serving steps and engines vs the JAX reference at smoke
size (llama4-scout-17b-a16e: 4 experts top-1 + a shared expert;
grok-1-314b: 4 experts top-2, gelu), on the reference's prequantized
weights carried across as bf16.  Every serving step dispatches per slot.

Tolerances and their reasons:
* Logits against the reference: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py): the MACs differ by one
  rounding per 128-chunk, and rope, rsqrt and softmax by a few ulps.
* Greedy tokens, engine counters, ``pos``, ``len`` and page tables:
  equal.
* Inside the port (pool vs solo, verify vs sequential decode, a chunk
  step's decode row vs decode_step, batch-1 lockstep vs a solo-prefill
  pool): bit for bit.
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
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro.serve.engine import (make_chunk_step, make_decode_step,  # noqa: E402
                                make_prefill_step, make_verify_step)
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, lockstep_generate, poisson_trace, slots  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
LOGIT_ATOL = 1e-3
MAX_LEN = 24
CHUNK = 4
PAGE = 4
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
TRACE = dict(n_requests=4, prompt_len=7, lam=1.0, new_lo=2, new_hi=7, seed=3)
ENGINE = dict(max_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK, page_size=PAGE)
PROMPTS = [[5, 7, 9, 11, 2, 13], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8, 6, 7]]
ROWS = np.array([[21, 3, 40, 7], [11, 12, 13, 14], [2, 99, 5, 0]])


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, the reference's served
    weights, the port's copy of them) at smoke size."""
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    params_q = jqw.quantize_for_serving(jcfg, J_PF, params)
    return jcfg, tcfg, params, params_q, spec.params_from_numpy(_named(params_q), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_vs_reference(arch):
    """Prefill logits; teacher-forced pooled decode (2 slots, slot 1 three
    positions ahead); a batch-2 lockstep prefill (one dispatch group of 14
    tokens) and lockstep decode: every logit within ``LOGIT_ATOL``."""
    jcfg, tcfg, _, params_q, tparams = _model(arch)
    rng = np.random.default_rng(1)
    jprefill, jdecode = make_prefill_step(jcfg, J_SERVE_POL), make_decode_step(jcfg, J_SERVE_POL)
    worst = 0.0
    with torch.inference_mode():
        toks = rng.integers(0, jcfg.vocab, (1, 9)).astype(np.int32)
        lj, _ = jprefill(params_q, {"tokens": jnp.asarray(toks)}, jtr.init_cache(jcfg, 1, MAX_LEN))
        lt, _ = transformer.prefill(tcfg, SERVE_POL, tparams, torch.from_numpy(toks).long(),
                                    transformer.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        seq = rng.integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
        jc = jslots.lift_cache(jtr.init_cache(jcfg, 2, MAX_LEN), 2)
        tc = slots.lift_cache(transformer.init_cache(tcfg, 2, MAX_LEN, device="cpu"), 2)
        jc["len"] = jnp.asarray([0, 3], jnp.int32)
        tc["len"] = torch.tensor([0, 3])
        for i in range(seq.shape[1]):
            _, lj, jc = jdecode(params_q, jnp.asarray(seq[:, i]), jc)
            lt, tc = transformer.decode_step(tcfg, SERVE_POL, tparams,
                                             torch.from_numpy(seq[:, i]).long(), tc)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        # lockstep: per-tensor activation scales
        jlock = dataclasses.replace(J_PF, weights_prequantized=True)
        lock = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
        jpre, jdec = make_prefill_step(jcfg, jlock), make_decode_step(jcfg, jlock)
        prompt = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
        lj, jc = jpre(params_q, {"tokens": jnp.asarray(prompt)}, jreg.init_cache(jcfg, 2, MAX_LEN))
        tc = registry.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        lt, tc = registry.prefill(tcfg, lock, tparams,
                                  {"tokens": torch.from_numpy(prompt).long()}, tc)
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        for i in range(seq.shape[1]):
            _, lj, jc = jdec(params_q, jnp.asarray(seq[:, i]), jc)
            lt, tc = transformer.decode_step(tcfg, lock, tparams,
                                             torch.from_numpy(seq[:, i]).long(), tc)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    print(f"{arch}: max |logit diff| {worst:.3g} (tolerance {LOGIT_ATOL})")
    assert worst <= LOGIT_ATOL


def _chunk_rows(prompts, c0):
    tokens = np.zeros((len(prompts), CHUNK), np.int64)
    n_new = np.zeros((len(prompts),), np.int64)
    for s, p in enumerate(prompts):
        part = p[c0:c0 + CHUNK]
        tokens[s, :len(part)] = part
        n_new[s] = len(part)
    return tokens, n_new


def _prompted_pool(tcfg, tparams):
    """A 3-slot paged pool (page 4, a shuffled page table) with PROMPTS
    streamed in by chunk steps; returns (pool, the logits of each step)."""
    pc = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu", page_size=PAGE)
    pc["table"] = torch.from_numpy(np.random.default_rng(0).permutation(18).reshape(3, 6))
    logits = []
    with torch.inference_mode():
        for c0 in range(0, 9, CHUNK):
            tokens, n_new = _chunk_rows(PROMPTS, c0)
            lg, pc = registry.chunk_step(tcfg, SERVE_POL, tparams, torch.from_numpy(tokens),
                                         n_new, pc)
            logits.append((lg, n_new))
    return pc, logits


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_and_verify_steps_vs_reference(arch):
    """PROMPTS streamed in by chunk steps (capacity 4 per slot group, pads
    routed to expert 0), then a verify step over ragged rows (4, 2, 1
    positions, each (slot, position) its own dispatch group): the live
    rows' logits within ``LOGIT_ATOL``; pos, len and the table equal."""
    jcfg, tcfg, _, params_q, tparams = _model(arch)
    pc, tlogits = _prompted_pool(tcfg, tparams)
    jc = jreg.init_pool_cache(jcfg, 3, MAX_LEN, page_size=PAGE)
    jc["table"] = jnp.asarray(pc["table"].numpy(), jnp.int32)
    jchunk = make_chunk_step(jcfg, J_SERVE_POL)
    worst = 0.0
    for c0, (lt, n_new) in zip(range(0, 9, CHUNK), tlogits):
        tokens, _ = _chunk_rows(PROMPTS, c0)
        _, lj, jc = jchunk(params_q, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(n_new, jnp.int32), jc)
        live = n_new > 0
        worst = max(worst, float(np.abs(_np(lj)[live] - lt.numpy()[live]).max()))
    n_new = np.array([4, 2, 1])
    with torch.inference_mode():
        lv, pc = registry.verify_step(tcfg, SERVE_POL, tparams, torch.from_numpy(ROWS), n_new,
                                      pc)
    _, jl, jc = make_verify_step(jcfg, J_SERVE_POL)(params_q, jnp.asarray(ROWS, jnp.int32),
                                                    jnp.asarray(n_new, jnp.int32), jc)
    worst = max([worst] + [float(np.abs(_np(jl)[s, :n] - lv[s, :n].numpy()).max())
                           for s, n in enumerate(n_new)])
    for key in ("pos", "len", "table"):
        np.testing.assert_array_equal(np.asarray(jc[key]), pc[key].numpy(), err_msg=key)
    print(f"{arch}: max |chunk / verify logit diff| {worst:.3g}")
    assert worst <= LOGIT_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_port_step_identities(arch):
    """Inside the port, bit for bit: a chunk step's decode rows equal
    ``decode_step`` (the engine's decode fast path), and a verify step
    equals sequential decode steps (ragged rows; a slot past its count
    writes nothing), in logits and every cache leaf."""
    _, tcfg, _, _, tparams = _model(arch)
    pool, _ = _prompted_pool(tcfg, tparams)
    last = torch.tensor([21, 11, 2])
    rows = torch.zeros((3, CHUNK), dtype=torch.int64)
    rows[:, 0] = last
    c1 = {k: v.clone() for k, v in pool.items()}
    c2 = {k: v.clone() for k, v in pool.items()}
    with torch.inference_mode():
        lg_chunk, c1 = registry.chunk_step(tcfg, SERVE_POL, tparams, rows, [1, 1, 1], c1)
        lg_dec, c2 = registry.decode_step(tcfg, SERVE_POL, tparams, last, c2)
    assert torch.equal(lg_chunk, lg_dec)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)

    n_new = (4, 2, 0)
    seq = {k: v.clone() for k, v in pool.items()}
    with torch.inference_mode():
        lv, pool = registry.verify_step(tcfg, SERVE_POL, tparams, torch.from_numpy(ROWS),
                                        np.array(n_new), pool)
        table, len0, drop = seq["table"].clone(), seq["len"].clone(), slots.drop_id(seq)
        out = []
        for j in range(max(n_new)):
            seq["table"] = torch.where(torch.tensor(n_new)[:, None] > j, table,
                                       torch.full_like(table, drop))
            lg, seq = registry.decode_step(tcfg, SERVE_POL, tparams,
                                           torch.from_numpy(ROWS[:, j]), seq)
            out.append(lg)
    seq["table"], seq["len"] = table, len0 + torch.tensor(n_new)
    ls = torch.stack(out, dim=1)
    for s, n in enumerate(n_new):
        assert torch.equal(lv[s, :n], ls[s, :n]), s
    for key in pool:
        assert torch.equal(pool[key], seq[key]), key


_RUNS = {}


def _engine_runs(arch):
    """(reference tokens, reference stats, port tokens, port stats) of the
    chunked + paged engine on TRACE, run once per arch."""
    if arch not in _RUNS:
        jcfg, tcfg, params, _, _ = _model(arch)
        tparams = spec.params_from_numpy(_named(params), "cpu")
        jeng = JPoolEngine(jcfg, J_PF, params, **ENGINE)
        jout = jeng.run(j_poisson_trace(jcfg, **TRACE))
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu", **ENGINE)
        out = eng.run(poisson_trace(tcfg, **TRACE))
        _RUNS[arch] = (jout, jeng.last_stats, out, eng.last_stats)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_paged_engine_vs_reference(arch):
    """A chunked (4) and paged (4) PoolEngine on a Poisson trace, each
    package prequantizing its own weights: the reference engine's tokens
    and every counter it keeps."""
    jout, jst, out, st = _engine_runs(arch)
    assert out.keys() == jout.keys()
    for uid in jout:
        np.testing.assert_array_equal(out[uid], np.asarray(jout[uid]), err_msg=str(uid))
    keys = [f.name for f in dataclasses.fields(jst)] + [
        "mean_occupancy", "mean_ttft_passes", "prefix_hit_rate", "kv_hbm_bytes_per_token"]
    for key in keys:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.prefills == TRACE["n_requests"] and st.weight_passes > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_vs_solo_bit_identity(arch):
    """Each request's pooled tokens equal its run alone in a one-slot
    engine with the same chunk, at page = span."""
    _, tcfg, params, _, _ = _model(arch)
    tparams = spec.params_from_numpy(_named(params), "cpu")
    _, _, out, _ = _engine_runs(arch)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu",
                     **dict(ENGINE, max_slots=1, page_size=None))
    for req in poisson_trace(tcfg, **TRACE):
        solo = eng.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(solo[req.uid], out[req.uid], err_msg=str(req.uid))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch1_lockstep_equals_pool(arch):
    """Each request by batch-1 lockstep decode (scalar ``len``, per-tensor
    scales, weights quantized at use) gives the tokens of a solo-prefill
    PoolEngine serving the whole trace (paged, per-sample scales,
    prequantized weights), bit for bit."""
    _, tcfg, params, _, _ = _model(arch)
    tparams = spec.params_from_numpy(_named(params), "cpu")
    reqs = poisson_trace(tcfg, **TRACE)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2, max_len=MAX_LEN,
                     page_size=PAGE, device="cpu")
    pooled = eng.run(reqs)
    for r in reqs:
        solo = lockstep_generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": r.tokens},
                                 max_new_tokens=r.max_new_tokens, max_len=MAX_LEN, device="cpu")
        np.testing.assert_array_equal(solo[0].numpy(), pooled[r.uid], err_msg=str(r.uid))
