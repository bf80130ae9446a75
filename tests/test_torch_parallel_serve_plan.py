"""Serving options of repro_torch on a sharded plan over two gloo ranks on
the CPU, each against the port's single rank at smoke width (and widened
variants whose ``wo``, down projections, ssm ``out_proj`` and hybrid
``wout`` fold across the ranks):

* speculative decoding (the n-gram drafter and the 3-bit self-draft),
  over bf16 and ``KV_PINNED`` pages, for llama3-8b, llama4-scout-17b-a16e
  (EP), a 3-expert grok-1-314b (TP experts: each expert's gate and up
  split), internvl2-76b and whisper-large-v3 (and the widened llama3-8b
  and whisper-large-v3, whose n-gram runs are over ``KV_PINNED`` pages
  only) on the (1, 2) and (2, 1)
  (data, model) meshes: tokens, every counter and every draft step's
  tokens equal one rank's, and spec-on tokens equal spec-off ones on the
  plan;
* ``quantize_attention`` on (1, 2) for every family with attention:
  tokens and counters equal one rank's, and so is the beta of every
  attention operand, call by call; a rank's zero-padded heads
  (``transformer._heads_whole``) never reach a scale above its real
  heads';
* the FP32 baseline on (1, 2) for all five pooled families, each
  widened one too;
* training under ``quantize_attention`` (olmo-1b's smoke config widened
  so its shards are whole 128-chunks) on (1, 2) and (2, 1): every
  quantizer scale and the first step's per-token losses are one rank's,
  and on (1, 2) every gradient leaf too.

One rank of the port against the reference's own ``PoolEngine`` (the
self-draft over ``KV_PINNED`` pages, llama4-scout-17b-a16e, internvl2-76b
and whisper-large-v3) completes the chain to the reference.

Tolerances: none on tokens, counters, scales, per-token losses or
gradients; they are equal.  The FP32 baseline adds the ranks' partial
products of a folded linear in rank order, so its logits are one rank's
within ``FP32_LOGIT_RTOL`` of the step's largest |logit|, and a token
may differ only at a step whose top-two logits on one rank lie within
that bound (the test reports such a step).

The two worlds and the reference's runs (two processes) run at once
while this process runs one rank; the tests read what they returned.
"""
import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

SLOTS, MAX_LEN, PAGE, CHUNK = 2, 24, 4, 4
NUM_PAGES = SLOTS * (MAX_LEN // PAGE)
TRACE = dict(n_requests=4, prompt_len=7, lam=1.0, new_lo=2, new_hi=7, seed=3)
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
# widened so that every split contraction folds at model 2: the decoder's
# wo over 2 heads of 64 and its down projection over 128 of d_ff 256
WIDE_DECODER = dict(n_heads=4, kv_heads=2, head_dim=64, d_ff=256, vocab_pad_multiple=256)
CONFIGS = {"llama3": ("llama3-8b", {}),
           "llama3_wide": ("llama3-8b", WIDE_DECODER),
           "scout": ("llama4-scout-17b-a16e", {}),
           "grok3": ("grok-1-314b", dict(num_experts=3)),
           "internvl2": ("internvl2-76b", {}),
           "whisper": ("whisper-large-v3", {}),
           "whisper_wide": ("whisper-large-v3", dict(head_dim=64, d_ff=512)),
           "mamba2": ("mamba2-2.7b", {}),
           "mamba2_wide": ("mamba2-2.7b", dict(d_model=256)),
           "recurrentgemma": ("recurrentgemma-2b", {}),
           "recurrentgemma_wide": ("recurrentgemma-2b",
                                   dict(lru_width=256, d_ff=512, head_dim=64))}
SPEC_CONFIGS = ("llama3", "llama3_wide", "scout", "grok3", "internvl2", "whisper",
                "whisper_wide")
QA_CONFIGS = ("llama3", "llama3_wide", "scout", "internvl2", "whisper", "recurrentgemma",
              "recurrentgemma_wide")
FP32_CONFIGS = ("llama3", "llama3_wide", "scout", "internvl2", "whisper", "whisper_wide",
                "mamba2", "mamba2_wide", "recurrentgemma", "recurrentgemma_wide")
FOLDING = ("llama3_wide", "whisper_wide", "mamba2_wide", "recurrentgemma_wide")
DRAFTERS = ("ngram", "self")
KVQ = ("bf16", "kv_pinned")
# (config, drafter, pages) of the spec runs: the widened configs' n-gram
# drafter over KV_PINNED pages only (over bf16 pages it repeats the fold
# that its KV_PINNED case and the self-draft's two cases run)
SPEC_CASES = tuple((name, drafter, kvq) for name in SPEC_CONFIGS for drafter in DRAFTERS
                   for kvq in KVQ
                   if not (name in FOLDING and (drafter, kvq) == ("ngram", "bf16")))
REFERENCE_CONFIGS = ("scout", "internvl2", "whisper")
# the reference's runs in two processes (its compiles take most of their time)
REFERENCE_GROUPS = (("scout",), ("internvl2", "whisper"))
STAT_FIELDS = ("weight_passes", "accepted_tokens", "draft_weight_passes", "decode_steps",
               "prefills", "emitted_tokens", "occupancy_sum", "ttft_passes",
               "prompt_tokens", "pages_in_use_sum", "page_size", "kv_page_bytes",
               "accepted_tokens_per_weight_pass", "kv_hbm_bytes_per_token")
FP32_LOGIT_RTOL = 1e-4
# the repair's training cell: olmo-1b's smoke config with every shard whole
# 128-chunks (tests/test_torch_parallel_tp_train.py's ``chunked``)
TRAIN_WIDE = dict(n_heads=4, kv_heads=4, head_dim=64, d_ff=256, vocab_pad_multiple=256)
BATCH, SEQ = 4, 16


def _cfg(pkg_configs, name):
    arch, kw = CONFIGS[name]
    kw = dict(kw)
    cfg = pkg_configs.smoke_config(arch)
    if "num_experts" in kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=kw.pop("num_experts")))
    return dataclasses.replace(cfg, **kw)


def _qa_policy():
    from repro_torch.core.policy import PAPER_FAITHFUL

    return dataclasses.replace(PAPER_FAITHFUL, quantize_attention=True)


# ---------------------------------------------------------------------------
# What the ranks (and one rank) run
# ---------------------------------------------------------------------------

def _serve(name, mesh, policy=None, drafter=None, kvq="bf16", logits=False, drafts=None):
    """One engine run of config ``name`` (the port's seed-0 weights) on
    ``mesh`` (None: one rank): (tokens, counters[, each step's logits]).
    ``drafts`` (a dict) takes the self-draft's steps (``steps``: each
    ``_draft`` call's rows [lo, hi) and tokens) and the shapes of the
    shard views its whole-matrix statistics list (``stat_shapes``)."""
    from repro_torch import configs as TC
    from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.parallel import meshes, planner
    from repro_torch.serve import LowBitSelfDraft, NgramDrafter, PoolEngine, poisson_trace

    cfg = _cfg(TC, name)
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    kv_quant = KV_PINNED if kvq == "kv_pinned" else None
    paged = cfg.family in registry.PAGED_FAMILIES
    kw = dict(prefill_chunk=CHUNK, page_size=PAGE, num_pages=NUM_PAGES) if paged else {}
    plan = None
    if mesh is not None:
        plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                                TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"),
                                pool_slots=SLOTS, page_size=kw.get("page_size"),
                                num_pages=kw.get("num_pages"), kv_quant=kv_quant)
    spec_ = {None: None, "ngram": NgramDrafter(max_draft=3),
             "self": LowBitSelfDraft(max_draft=3, bits=3)}[drafter]
    eng = PoolEngine(cfg, policy or PAPER_FAITHFUL, params, max_slots=SLOTS,
                     max_len=MAX_LEN, plan=plan, spec=spec_, kv_quant=kv_quant, device="cpu",
                     **kw)
    reqs = poisson_trace(cfg, **TRACE)
    steps = []
    orig = registry.decode_step, registry.chunk_step
    if drafts is not None:
        draft, drafts["steps"] = eng._draft, []
        drafts["stat_shapes"] = sorted({shape for _, shape in eng.draft_stats})

        def recording_draft(*args):
            toks = draft(*args)
            drafts["steps"].append((eng._local_rows(), toks.tolist()))
            return toks

        eng._draft = recording_draft

    def recording(fn):
        def step(*args, **kwargs):
            out, cache = fn(*args, **kwargs)
            steps.append(out.float().numpy().copy())
            return out, cache
        return step

    if logits:
        registry.decode_step, registry.chunk_step = map(recording, orig)
    try:
        out = eng.run(reqs)
    finally:
        registry.decode_step, registry.chunk_step = orig
    st = eng.last_stats
    res = ({str(k): v.tolist() for k, v in out.items()},
           {f: getattr(st, f) for f in STAT_FIELDS})
    return res + (steps,) if logits else res


def _record_attention(fn):
    """(``fn()``, the beta of every attention operand it quantizes, in call
    order (``mfmac._qact``'s), and for each probabilities operand on a
    model axis the largest value over the rank's zero-padded heads and
    over its real heads, per sample)."""
    from repro_torch.core import mfmac, potq
    from repro_torch.models import transformer

    betas, padded, state = [], [], {"in_qact": False, "mine": None, "calls": 0}
    qact, pq, heads_whole, act_dot = (mfmac._qact, potq.pot_quantize,
                                      transformer._heads_whole, mfmac.mf_act_dot)

    def rec_qact(*args, **kw):
        state["in_qact"] = True
        try:
            return qact(*args, **kw)
        finally:
            state["in_qact"] = False

    def rec_pot_quantize(f, bits, beta=None, **kw):
        if state["in_qact"]:
            betas.append(beta.flatten().tolist())
        return pq(f, bits, beta, **kw)

    def rec_heads_whole(q, k, v):
        out = heads_whole(q, k, v)
        state["mine"], state["calls"] = out[3], 0
        return out

    def rec_act_dot(x, y, **kw):
        state["calls"] += 1
        mine = state["mine"]
        if state["calls"] == 2 and mine is not None:  # PV: x the probabilities
            p = x.float().reshape(x.shape[0], -1, *x.shape[3:])  # (B, H, Sq, Skv)
            real = torch.zeros(p.shape[1], dtype=torch.bool)
            real[mine] = True
            padded.append((p[:, ~real].amax(dim=(1, 2, 3)).tolist(),
                           p[:, real].amax(dim=(1, 2, 3)).tolist()))
        return act_dot(x, y, **kw)

    mfmac._qact, potq.pot_quantize = rec_qact, rec_pot_quantize
    transformer._heads_whole, mfmac.mf_act_dot = rec_heads_whole, rec_act_dot
    try:
        out = fn()
    finally:
        mfmac._qact, potq.pot_quantize = qact, pq
        transformer._heads_whole, mfmac.mf_act_dot = heads_whole, act_dot
    return out, betas, padded


def _train(mesh):
    """olmo-1b (``TRAIN_WIDE``) under quantize_attention on ``mesh``: the
    first step's per-token losses (this rank's rows), every quantizer
    scale, the attention operands' betas and, on (1, 2), whether each
    gradient leaf is one rank's, each beside one rank's."""
    from repro_torch import configs as TC
    from repro_torch.data import pipeline
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    cfg = dataclasses.replace(TC.smoke_config("olmo-1b"), **TRAIN_WIDE)
    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, 3))
    step = make_train_step(cfg, _qa_policy(), opt, TrainConfig(), plan=plan)
    one = make_train_step(cfg, _qa_policy(), opt, TrainConfig())
    whole = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    shards = step.data_parallel.shard(whole)
    batch = pipeline.make_batch(cfg, shape, 0, device="cpu")
    d = plan.mesh.coord("data")
    rows = slice(d * BATCH // mesh[0], (d + 1) * BATCH // mesh[0])
    (_, g), betas, _ = _record_attention(lambda: step.grads(shards, batch))
    (_, g1), one_betas, _ = _record_attention(lambda: one.grads(whole, batch))
    res = {"token_losses": (step.token_losses(shards, batch).numpy(),
                            one.token_losses(whole, batch)[rows].numpy()),
           "betas": (betas, one_betas),
           "scales": (_record_scales(lambda: step.grads(shards, batch)),
                      _record_scales(lambda: one.grads(whole, batch)))}
    if mesh == (1, 2):
        res["grads"] = {n: bool(torch.equal(x, y)) for (n, x), (_, y) in zip(
            spec.named_leaves(step.data_parallel.reduce(g)),
            spec.named_leaves(step.data_parallel.shard(g1)))}
    return res


def _record_scales(fn):
    """Every quantizer scale ``fn`` takes, in call order: each
    ``potq.pot_quantize``'s beta and each G's (``ops._g_scalars``)."""
    from repro_torch.core import potq
    from repro_torch.kernels import ops

    seen = []
    pq, gs = potq.pot_quantize, ops._g_scalars

    def pot_quantize(f, bits, beta=None, **kw):
        seen.append(("w/a", None if beta is None else beta.flatten().tolist()))
        return pq(f, bits, beta, **kw)

    def g_scalars(g, bits_g, beta_g, clip_t):
        seen.append(("g", beta_g.flatten().tolist()))
        return gs(g, bits_g, beta_g, clip_t)

    potq.pot_quantize, ops._g_scalars = pot_quantize, g_scalars
    try:
        fn()
    finally:
        potq.pot_quantize, ops._g_scalars = pq, gs
    return seen


def _rank_cases(rank, mesh):
    from repro_torch.core.policy import FP32_BASELINE

    torch.set_num_threads(1)
    res = {}
    for name in SPEC_CONFIGS:
        for kvq in KVQ:
            res[("off", name, kvq)] = _serve(name, mesh, kvq=kvq)
    for name, drafter, kvq in SPEC_CASES:
        drafts = res[("drafts", name, kvq)] = {} if drafter == "self" else None
        res[("spec", name, drafter, kvq)] = _serve(name, mesh, drafter=drafter, kvq=kvq,
                                                   drafts=drafts)
    for name in QA_CONFIGS if mesh == (1, 2) else ("llama3", "whisper"):
        res[("qa", name)] = _record_attention(lambda: _serve(name, mesh, _qa_policy()))
    if mesh == (1, 2):
        for name in FP32_CONFIGS:
            res[("fp32", name)] = _serve(name, mesh, FP32_BASELINE, logits=True)
    res["train"] = _train(mesh)
    return res


def _one_rank():
    """Every served case above on one rank (no plan)."""
    from repro_torch.core.policy import FP32_BASELINE

    out = {}
    for name, drafter, kvq in SPEC_CASES:
        drafts = out[("drafts", name, kvq)] = {} if drafter == "self" else None
        out[("spec", name, drafter, kvq)] = _serve(name, None, drafter=drafter, kvq=kvq,
                                                   drafts=drafts)
    for name in QA_CONFIGS:
        out[("qa", name)] = _record_attention(lambda: _serve(name, None, _qa_policy()))
    for name in FP32_CONFIGS:
        out[("fp32", name)] = _serve(name, None, FP32_BASELINE, logits=True)
    return out


def _reference_cases(names):
    return {name: _reference_case(name) for name in names}


def _reference_case(name):
    """The port's one rank and the reference's ``PoolEngine`` on the
    reference's seed-0 weights, the self-draft over ``KV_PINNED`` pages:
    (tokens, counters) of each."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.core import policy as jpolicy
    from repro.models import registry as jreg
    from repro.models import spec as jspec
    from repro.serve import LowBitSelfDraft as JLowBitSelfDraft
    from repro.serve import PoolEngine as JPoolEngine
    from repro.serve.scheduler import Request as JRequest
    from repro_torch import configs as TC
    from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.serve import LowBitSelfDraft, PoolEngine, poisson_trace

    jcfg = _cfg(JC, name)
    jparams = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in _flatten_with_names(jparams)[0].items()}
    cfg = _cfg(TC, name)
    reqs = poisson_trace(cfg, **TRACE)
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK, page_size=PAGE,
              num_pages=NUM_PAGES)
    ours = PoolEngine(cfg, PAPER_FAITHFUL, spec.params_from_numpy(named, "cpu"),
                      spec=LowBitSelfDraft(max_draft=3, bits=3), kv_quant=KV_PINNED,
                      device="cpu", **kw)
    theirs = JPoolEngine(jcfg, jpolicy.PAPER_FAITHFUL, jparams,
                         spec=JLowBitSelfDraft(max_draft=3, bits=3),
                         kv_quant=jpolicy.KV_PINNED, **kw)
    out = [ours.run(reqs), theirs.run([JRequest(uid=r.uid, tokens=r.tokens,
                                                max_new_tokens=r.max_new_tokens,
                                                arrival=r.arrival, extras=dict(r.extras))
                                       for r in reqs])]
    return [({str(k): np.asarray(v).tolist() for k, v in o.items()},
             {f: getattr(e.last_stats, f) for f in STAT_FIELDS})
            for o, e in zip(out, (ours, theirs))]


@pytest.fixture(scope="module")
def runs():
    """The two worlds' results (run at once, in a thread each), the
    reference cases (run at once, in a process a group), and this
    process's one-rank runs (at the ranks' one thread)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from repro_torch.parallel import collectives

    def world(mesh):
        return collectives.spawn(_rank_cases, 2, mesh, device="cpu", threads=1)

    with ThreadPoolExecutor(2) as pool, ProcessPoolExecutor(
            len(REFERENCE_GROUPS), mp_context=multiprocessing.get_context("spawn")) as refs:
        worlds = {mid: pool.submit(world, mesh) for mid, mesh in MESHES.items()}
        reference = [refs.submit(_reference_cases, names) for names in REFERENCE_GROUPS]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = _one_rank()
        finally:
            torch.set_num_threads(threads)
        return ({mid: w.result() for mid, w in worlds.items()}, one,
                {name: case for r in reference for name, case in r.result().items()})


# ---------------------------------------------------------------------------
# Speculative decoding and KV_PINNED pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,drafter,kvq", SPEC_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_spec_equals_one_rank(runs, mesh, name, drafter, kvq):
    """Tokens and every counter (accepted tokens, draft weight passes, KV
    bytes a token among them) equal one rank's on both ranks."""
    worlds, one, _ = runs
    key = ("spec", name, drafter, kvq)
    for res in worlds[mesh]:
        assert res[key] == one[key]
    if drafter == "self":
        assert one[key][1]["draft_weight_passes"] > 0


@pytest.mark.parametrize("kvq", KVQ)
@pytest.mark.parametrize("name", SPEC_CONFIGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_self_draft_steps_equal_one_rank(runs, mesh, name, kvq):
    """Every draft step's tokens on a rank's rows equal one rank's on those
    rows (the self-draft's whole-matrix statistics at work even where no
    draft is accepted); on (1, 2) the statistics list a shard view of
    every split matrix (per expert under TP experts: 3-D views)."""
    worlds, one, _ = runs
    one_steps = one[("drafts", name, kvq)]["steps"]
    assert one_steps
    for res in worlds[mesh]:
        drafts = res[("drafts", name, kvq)]
        assert len(drafts["steps"]) == len(one_steps)
        for ((lo, hi), ours), (_, theirs) in zip(drafts["steps"], one_steps):
            assert ours == theirs[lo:hi]
        shapes = drafts["stat_shapes"]
        assert bool(shapes) == (mesh == "1x2"), shapes
        if name == "grok3" and mesh == "1x2":
            assert any(len(s) == 3 for s in shapes), shapes


def test_whole_stats_refuses_unlisted_views():
    """Under a draft table a listed shard view is rounded with its listed
    statistics; another view of a listed leaf raises; a leaf the table
    does not mark keeps its own statistics."""
    from repro_torch.core import mfmac, potq
    from repro_torch.core.policy import PAPER_FAITHFUL, draft_policy

    policy = draft_policy(PAPER_FAITHFUL, 3)
    gen = torch.Generator().manual_seed(0)
    leaf, other = torch.randn(2, 8, 16, generator=gen), torch.randn(8, 16, generator=gen)
    table = mfmac.WholeStats()
    table.add_leaf(leaf)
    mean, beta = torch.tensor(0.25), torch.tensor(-3.0)
    table[mfmac.weight_key(leaf[0])] = (mean, beta)
    with mfmac.whole_stats(table):
        got = mfmac._quantize_w(leaf[0], policy)
        for view in (leaf[1], leaf[0, :4], leaf):
            with pytest.raises(ValueError, match="whole-matrix statistics"):
                mfmac._quantize_w(view, policy)
        own = mfmac._quantize_w(other, policy)
    want = potq.pot_quantize(leaf[0] - mean, policy.bits_w, beta).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(own, mfmac._quantize_w(other, policy))


@pytest.mark.parametrize("kvq", KVQ)
@pytest.mark.parametrize("name", SPEC_CONFIGS)
@pytest.mark.parametrize("mesh", MESHES)
def test_spec_on_equals_spec_off_on_the_plan(runs, mesh, name, kvq):
    worlds, _, _ = runs
    for res in worlds[mesh]:
        off = res[("off", name, kvq)][0]
        for drafter in DRAFTERS:
            if (name, drafter, kvq) in SPEC_CASES:
                assert res[("spec", name, drafter, kvq)][0] == off


@pytest.mark.parametrize("drafter", DRAFTERS)
def test_spec_accepts_drafts(runs, drafter):
    """Drafts are accepted (the comparisons above are not all of plain
    steps): the self-draft's in every config, the n-gram drafter's where
    the trace repeats itself (not in every config)."""
    accepted = {}
    for name, d, kvq in SPEC_CASES:
        if d == drafter:
            accepted.setdefault(name, []).append(
                runs[1][("spec", name, drafter, kvq)][1]["accepted_tokens"])
    if drafter == "self":
        assert all(min(n) > 0 for n in accepted.values()), accepted
    else:
        assert sum(max(n) > 0 for n in accepted.values()) >= 2, accepted


@pytest.mark.parametrize("name", REFERENCE_CONFIGS)
def test_one_rank_equals_reference(runs, name):
    """The self-draft over ``KV_PINNED`` pages on one rank: tokens and
    counters equal the reference's ``PoolEngine``."""
    ours, theirs = runs[2][name]
    assert ours == theirs
    assert ours[1]["accepted_tokens"] > 0


# ---------------------------------------------------------------------------
# quantize_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QA_CONFIGS)
def test_quantize_attention_equals_one_rank(runs, name):
    """On (1, 2): tokens, counters and every attention operand's beta,
    call by call, equal one rank's on both ranks; at each probabilities
    operand a rank's padded heads stay at or below its real heads'
    largest value, sample by sample."""
    worlds, one, _ = runs
    one_served, one_betas, _ = one[("qa", name)]
    assert len(one_betas) > 0
    for res in worlds["1x2"]:
        served, betas, padded = res[("qa", name)]
        assert served == one_served
        assert betas == one_betas
        assert padded
        for pad, real in padded:
            assert all(p <= r for p, r in zip(pad, real)), (pad, real)


@pytest.mark.parametrize("name", ("llama3", "whisper"))
def test_quantize_attention_on_the_data_axis(runs, name):
    """On (2, 1) a slot's attention scales are its own (per-slot groups):
    tokens and counters equal one rank's, and the two ranks' attention
    betas together are one rank's (a data rank runs its slots' calls)."""
    worlds, one, _ = runs
    one_served, one_betas, _ = one[("qa", name)]
    ranks = [res[("qa", name)] for res in worlds["2x1"]]
    for served, _, _ in ranks:
        assert served == one_served
    both = sorted(tuple(b) for _, betas, _ in ranks for b in betas)
    assert both == sorted(tuple(b) for b in one_betas)


# ---------------------------------------------------------------------------
# The FP32 baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FP32_CONFIGS)
def test_fp32_baseline_within_bound(runs, name):
    """On (1, 2): each pooled step's logits within ``FP32_LOGIT_RTOL`` of
    the step's largest |logit| on one rank, bit for bit where nothing
    folds; tokens and counters equal, unless a step's top-two logits on
    one rank lie within the bound (reported, and nothing after it is
    compared)."""
    worlds, one, _ = runs
    one_tokens, one_stats, one_steps = one[("fp32", name)]
    for res in worlds["1x2"]:
        tokens, stats, steps = res[("fp32", name)]
        near_tie = None
        for i, (ours, theirs) in enumerate(zip(steps, one_steps)):
            bound = FP32_LOGIT_RTOL * float(np.abs(theirs).max())
            assert float(np.abs(ours - theirs).max()) <= bound, (name, i)
            if name not in FOLDING:
                assert ours.tobytes() == theirs.tobytes(), (name, i)
            differ = np.nonzero(ours.argmax(-1) != theirs.argmax(-1))[0]
            if differ.size:
                top2 = np.sort(theirs[differ], axis=-1)[:, -2:]
                assert float((top2[:, 1] - top2[:, 0]).max()) <= 2 * bound, (name, i)
                near_tie = i
                break
        if near_tie is not None:
            print(f"{name}: a near tie at step {near_tie} flips a token")
            continue
        assert len(steps) == len(one_steps)
        assert tokens == one_tokens
        assert stats == one_stats


def test_fp32_folds_run_where_the_layout_folds():
    """The widened configs fold their row-parallel linears at model 2 (so
    the FP32 baseline's partial products are summed across the ranks);
    the smoke widths gather."""
    from repro_torch import configs as TC
    from repro_torch.parallel import planner

    assert set(FOLDING) <= set(FP32_CONFIGS)
    for name in FP32_CONFIGS:
        lay = planner.runtime_layout(_cfg(TC, name), 2)
        folds = {lay.wo, lay.mlp_wo, lay.lru_wo} & {"fold"}
        assert bool(folds) == (name in FOLDING), name


# ---------------------------------------------------------------------------
# The repair: the attention products' scales in training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_training_attention_scales_equal_one_rank(runs, mesh):
    """Every attention operand's beta and G's (``mfmac._qact``) and every
    other quantizer scale of a step, call by call, and the first step's
    per-token losses equal one rank's."""
    for res in runs[0][mesh]:
        ours, one = res["train"]["betas"]
        assert len(one) > 0 and ours == one
        ours, one = res["train"]["scales"]
        assert len(one) > 0 and ours == one
        ours, one = res["train"]["token_losses"]
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()


def test_training_gradients_bit_for_bit_on_the_model_axis(runs):
    for res in runs[0]["1x2"]:
        grads = res["train"]["grads"]
        assert grads and all(grads.values()), [n for n, ok in grads.items() if not ok]
