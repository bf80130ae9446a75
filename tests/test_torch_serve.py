"""repro_torch serving slice vs the JAX reference at smoke size
(llama3-8b smoke config: 2 layers, d=64), on the same numpy parameters.

Logit tolerance and its reason: ``LOGIT_ATOL``.  The two packages agree
bit for bit on PoT codes outside the √2 band and within one rounding per
128-chunk on each MAC; rope, rsqrt, softmax and exp differ from XLA's in
the last ulps.  A last-ulp difference that moves an activation across a
PoT rounding boundary changes that element by a factor of √2 and the
logits by far more than an ulp, so logits are bounded at 1e-3 (|logits|
are ~0.5 here), not bitwise.  Greedy tokens are compared up to the first
step whose reference top-2 margin is under that tolerance (a near-tie).
"""
import dataclasses

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
from repro.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, generate, poisson_trace  # noqa: E402
from repro_torch.serve import FIFOScheduler, Request, slots  # noqa: E402
from repro_torch.serve.scheduler import SchedulerError  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=7, seed=3)
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True)


@pytest.fixture(scope="module")
def model():
    cfg = C.smoke_config("llama3-8b")
    tcfg = TC.smoke_config("llama3-8b")
    params = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    named, _ = _flatten_with_names(params)
    named = {k: np.asarray(v) for k, v in named.items()}
    return cfg, tcfg, params, spec.params_from_numpy(named, "cpu")


@pytest.fixture(scope="module")
def reference_run(model):
    """One JAX PoolEngine run of the trace, shared by the tests below."""
    cfg, _, params, _ = model
    eng = JPoolEngine(cfg, J_PF, params, max_slots=2, max_len=MAX_LEN)
    out = eng.run(j_poisson_trace(cfg, **TRACE))
    return {k: np.asarray(v) for k, v in out.items()}, eng.last_stats


@pytest.fixture(scope="module")
def port_run(model):
    _, tcfg, _, tparams = model
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=2,
                     max_len=MAX_LEN, device="cpu")
    return eng.run(poisson_trace(tcfg, **TRACE)), eng


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("weights", ["same_numpy", "reference_prequantized"])
def test_prefill_and_decode_logits_vs_reference(model, weights):
    """Prefill logits, then teacher-forced pooled decode (2 slots at
    different positions), on (a) raw numpy parameters that each package
    quantizes itself and (b) the reference's prequantized bf16 weights
    carried across — separating the WBC mean from the rest."""
    cfg, tcfg, params, tparams = model
    jpol, pol = J_SERVE_POL, SERVE_POL
    if weights == "reference_prequantized":
        params = jqw.quantize_for_serving(cfg, J_PF, params)
        named, _ = _flatten_with_names(params)
        tparams = spec.params_from_numpy({k: np.asarray(v) for k, v in named.items()}, "cpu")
        jpol = dataclasses.replace(jpol, weights_prequantized=True)
        pol = dataclasses.replace(pol, weights_prequantized=True)
    rng = np.random.default_rng(1)
    worst = 0.0
    with torch.inference_mode():
        toks = rng.integers(0, cfg.vocab, (1, 9)).astype(np.int32)
        jprefill = make_prefill_step(cfg, jpol)  # the reference's jitted steps
        jdecode = make_decode_step(cfg, jpol)
        lj, _ = jprefill(params, {"tokens": jnp.asarray(toks)},
                         jtr.init_cache(cfg, 1, MAX_LEN))
        lt, _ = transformer.prefill(tcfg, pol, tparams, torch.from_numpy(toks).long(),
                                    transformer.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        # pooled decode: slot 1 starts 3 positions later than slot 0
        seq = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
        jc = jslots.lift_cache(jtr.init_cache(cfg, 2, MAX_LEN), 2)
        tc = slots.lift_cache(transformer.init_cache(tcfg, 2, MAX_LEN, device="cpu"), 2)
        jc["len"] = jnp.asarray([0, 3], jnp.int32)
        tc["len"] = torch.tensor([0, 3])
        for i in range(10):
            _, lj, jc = jdecode(params, jnp.asarray(seq[:, i]), jc)
            lt, tc = transformer.decode_step(tcfg, pol, tparams,
                                             torch.from_numpy(seq[:, i]).long(), tc)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
    print(f"{weights}: max |logit diff| {worst:.3g} (tolerance {LOGIT_ATOL})")
    assert worst <= LOGIT_ATOL


def test_pool_counters_equal_reference(reference_run, port_run):
    _, jstats = reference_run
    _, eng = port_run
    st = eng.last_stats
    for key in ("weight_passes", "decode_steps", "prefills", "emitted_tokens",
                "prompt_tokens", "ttft_passes", "mean_occupancy",
                "mean_ttft_passes"):
        assert getattr(st, key) == getattr(jstats, key), key


def _reference_margins(cfg, params, req, tokens):
    """Top-2 logit margin of the reference at each emitted token, driven
    solo and teacher-forced with the reference's own tokens."""
    params_q = jqw.quantize_for_serving(cfg, J_PF, params)
    pol = dataclasses.replace(J_SERVE_POL, weights_prequantized=True)
    logits, cache = make_prefill_step(cfg, pol)(
        params_q, {"tokens": jnp.asarray(req.tokens)}, jtr.init_cache(cfg, 1, MAX_LEN))
    decode = make_decode_step(cfg, pol)
    cache = jslots.lift_cache(cache, 1)  # per-slot pos; len set below
    cache["len"] = jnp.asarray([req.tokens.shape[-1]], jnp.int32)
    margins = []
    for t in tokens:
        # the solo teacher-forced reference reproduces its pooled tokens
        assert int(np.argmax(np.asarray(logits[0]))) == int(t)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        _, logits, cache = decode(params_q, jnp.asarray([t], jnp.int32), cache)
    return margins


def test_pool_tokens_equal_reference_up_to_near_ties(model, reference_run, port_run):
    cfg, _, params, _ = model
    jout, _ = reference_run
    out, _ = port_run
    reqs = j_poisson_trace(cfg, **TRACE)
    near_ties = []
    for req in reqs:
        ref_toks, ours = jout[req.uid], out[req.uid]
        assert ours.shape == ref_toks.shape
        margins = _reference_margins(cfg, params, req, ref_toks)
        for step, (a, b, m) in enumerate(zip(ours, ref_toks, margins)):
            if m < LOGIT_ATOL:
                near_ties.append((req.uid, step, m))
                break  # past a near-tie the two may rightly diverge
            assert a == b, (req.uid, step, m)
    print(f"near-tie steps (uid, step, margin): {near_ties}")
    # the padded vocabulary is part of the argmax, as in the reference
    assert max(int(t.max()) for t in out.values()) < cfg.vocab_padded


def test_pool_vs_solo_bit_identity(model, port_run):
    """Inside the port: each request's pooled tokens equal its solo run."""
    _, tcfg, _, tparams = model
    out, _ = port_run
    for req in poisson_trace(tcfg, **TRACE):
        solo = generate(tcfg, PAPER_FAITHFUL, tparams, {"tokens": req.tokens},
                        max_new_tokens=req.max_new_tokens, max_len=MAX_LEN,
                        prequantize=True, device="cpu")
        np.testing.assert_array_equal(solo[0].numpy(), out[req.uid])


def test_trace_matches_reference(model):
    cfg, tcfg, _, _ = model
    for a, b in zip(j_poisson_trace(cfg, **TRACE), poisson_trace(tcfg, **TRACE)):
        assert (a.uid, a.arrival, a.max_new_tokens) == (b.uid, b.arrival, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_scheduler_fifo_and_conservation():
    s = FIFOScheduler(2)
    for i, arr in enumerate([0, 0, 0, 5]):
        s.submit(Request(uid=i, tokens=None, max_new_tokens=1, arrival=arr))
    assert [(sl, r.uid) for sl, r in s.admit(0)] == [(0, 0), (1, 1)]
    s.check_conservation()
    s.retire(1)
    with pytest.raises(SchedulerError):
        s.retire(1)
    assert [(sl, r.uid) for sl, r in s.admit(1)] == [(1, 2)]
    assert s.next_arrival() == 5 and s.admit(4) == []
    s.check_conservation()


def test_engine_validates_requests(model):
    _, tcfg, _, tparams = model
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=8,
                     device="cpu")
    toks = np.zeros((1, 6), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        eng.run([Request(uid=0, tokens=toks, max_new_tokens=3)])
    with pytest.raises(ValueError, match="duplicate"):
        eng.run([Request(uid=0, tokens=toks[:, :2], max_new_tokens=1)] * 2)


def test_default_device_is_cuda():
    """Entry points default to the card; without one they raise instead of
    moving to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kind", ["rms", "ln", "nonparam_ln"])
def test_norms_and_rope_vs_reference(kind):
    """f32 norms and rope: rsqrt, exp, cos and sin may differ from XLA's in
    the last ulps, so these are bounded at a few f32 ulps, not bitwise."""
    from repro.models import common as jcommon
    from repro_torch.models import common

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    ours = common.apply_norm(kind, torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()}).numpy()
    theirs = np.asarray(jcommon.apply_norm(kind, jnp.asarray(x),
                                           {k: jnp.asarray(v) for k, v in p.items()}))
    np.testing.assert_allclose(ours, theirs, rtol=4e-6, atol=4e-6)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5))
    ours = common.rope(torch.from_numpy(q), torch.from_numpy(pos), 5e5).numpy()
    theirs = np.asarray(jcommon.rope(jnp.asarray(q), jnp.asarray(pos), 5e5))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_slot_helpers_overwrite_the_whole_row(model):
    _, tcfg, _, _ = model
    pool = slots.lift_cache(transformer.init_cache(tcfg, 3, 8, device="cpu"), 3)
    mini = transformer.init_cache(tcfg, 1, 8, device="cpu")
    mini["k"].fill_(1.0)
    mini["v"].fill_(2.0)
    mini["pos"] = torch.tensor([0, 1, 2, -1, -1, -1, -1, -1])
    mini["len"] = torch.tensor(3)
    pool["k"].fill_(7.0)  # a previous occupant's junk
    slots.write_slot(pool, mini, 1)
    assert torch.all(pool["k"][:, 1] == 1) and torch.all(pool["v"][:, 1] == 2)
    assert torch.all(pool["k"][:, 0] == 7) and torch.all(pool["k"][:, 2] == 7)
    assert pool["pos"][1].tolist() == mini["pos"].tolist()
    assert pool["len"].tolist() == [0, 3, 0]
    slots.reset_slot(pool, 1)
    assert pool["len"].tolist() == [0, 0, 0] and torch.all(pool["pos"][1] == -1)


def test_eos_retires_early_with_a_prefix_of_the_full_run(model, port_run):
    """A request whose eos_id is hit stops there: its tokens are the prefix
    of its full-budget run through the first EOS (solo, bit for bit)."""
    _, tcfg, _, tparams = model
    out, _ = port_run
    req = poisson_trace(tcfg, **TRACE)[0]
    full = out[req.uid]
    eos = int(full[2])
    cut = full[:list(full).index(eos) + 1]
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, max_slots=1, max_len=MAX_LEN,
                     device="cpu")
    got = eng.run([Request(uid=0, tokens=req.tokens,
                           max_new_tokens=req.max_new_tokens, eos_id=eos)])[0]
    np.testing.assert_array_equal(got, cut)
    assert eng.last_stats.emitted_tokens == len(cut)
