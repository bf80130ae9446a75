"""The sharded serving pool of repro_torch over two gloo ranks on the CPU:
llama3-8b at smoke width through ``PoolEngine(plan=...)`` on the (1, 2)
and (2, 1) (data, model) meshes, with solo prefill, chunked prefill and
the prefix cache, against the port's single-rank engine and the
reference's single-device ``PoolEngine`` under ``PAPER_FAITHFUL``, on
the same numpy weights (the reference's seed-0 draw).

Two configs run: the smoke config (4 heads of 16, one KV head, d_ff 128),
where the whole-head and whole-chunk fallbacks fire (wk/wv computed whole,
wo and the MLP's down projection over the all-gathered input), and the
smoke config widened to 4 heads of 64, 2 KV heads and d_ff 512, where
every row-parallel split lands on 128-chunks and K1's fold chains across
the ranks.

Everything the ranks compute runs in one spawned world per module (the
world takes seconds to start); the tests read its results.

No tolerance anywhere: tokens and counters are equal, and the sharded
row-parallel product equals one-rank K1's plain version bit for bit.
``smoke_requests`` draws its prompts from the reference's numpy calls, so
the reference serves the same trace.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

MAX_LEN = 24
SLOTS = 2
PREFIX = dict(n_requests=4, prefix_len=8, suffix_len=4, lam=1.0, new_lo=2, new_hi=6,
              seed=3)
RECIPES = {
    "solo": ("smoke", dict(page_size=8)),
    "chunked": ("smoke", dict(prefill_chunk=4, page_size=8)),
    "prefix": ("prefix", dict(prefill_chunk=4, page_size=4, prefix_cache=True)),
}
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
CONFIGS = ("smoke", "wide")
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum",
               "weight_passes", "ttft_passes", "prompt_tokens", "prefix_hit_tokens",
               "cow_copies", "evictions", "admission_deferrals", "pages_in_use_sum",
               "page_size", "kv_page_bytes")


def _cfg(pkg_configs, name):
    cfg = pkg_configs.smoke_config("llama3-8b")
    if name == "wide":
        cfg = dataclasses.replace(cfg, d_ff=512, head_dim=64, kv_heads=2)
    return cfg


def _requests(cfg, trace, make_request, prefix_trace):
    from repro_torch.parallel.smoke import smoke_requests

    if trace == "smoke":
        return [make_request(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                             arrival=r.arrival) for r in smoke_requests(cfg, 4)]
    reqs = prefix_trace(cfg, **PREFIX)
    r = reqs[0]  # a repeat of request 0: a whole-prompt hit, copied on write
    reqs.append(make_request(uid=len(reqs), tokens=r.tokens,
                             max_new_tokens=r.max_new_tokens, arrival=reqs[-1].arrival + 3))
    return reqs


def _num_pages(kw):
    return SLOTS * (MAX_LEN // kw["page_size"])


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

def _serve(cfg, params, recipe, mesh):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.parallel import meshes, planner
    from repro_torch.serve import PoolEngine, Request, shared_prefix_trace

    trace, kw = RECIPES[recipe]
    plan = None
    if mesh is not None:
        plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                                TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"),
                                pool_slots=SLOTS, page_size=kw["page_size"],
                                num_pages=_num_pages(kw))
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                     num_pages=_num_pages(kw), plan=plan, device="cpu", **kw)
    out = eng.run(_requests(cfg, trace, Request, shared_prefix_trace))
    st = eng.last_stats
    stats = {f: getattr(st, f) for f in STAT_FIELDS}
    stats.update(data_shards=st.data_shards, model_shards=st.model_shards,
                 per_device_weight_passes=st.per_device_weight_passes)
    return {str(k): v.tolist() for k, v in out.items()}, stats


def _fold_cases(rank):
    """The row-parallel product over the (1, 2) mesh's model group against
    one-rank K1 (plain version): PoT operands, K split at a 128-chunk."""
    from repro_torch.core import potq
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives, meshes

    group = meshes.make_mesh((1, 2), ("data", "model")).group("model")
    out = []
    for m, k, n in ((1, 512, 96), (5, 256, 64), (16, 384, 40)):
        gen = torch.Generator().manual_seed(100 + m)
        a = potq.pot_quantize(torch.randn((m, k), generator=gen), 5,
                              potq.compute_beta(torch.randn((m, k), generator=gen), 5,
                                                axes=(1,)))
        w = potq.pot_quantize(torch.randn((k, n), generator=gen) * 0.1, 5)
        whole = ops.pot_value_matmul(a, w)
        half = k // 2
        sl = slice(rank * half, (rank + 1) * half)
        split = collectives.ordered_fold(
            lambda start: ops.pot_value_matmul(a[:, sl], w[sl], start=start), (m, n),
            a.device, group)
        out.append(bool(torch.equal(whole.view(torch.int32), split.view(torch.int32))))
    return out


def _rank_cases(rank, weights):
    """Every sharded run of this module, plus the same recipes on one rank."""
    from repro_torch import configs as TC
    from repro_torch.models import spec

    torch.set_num_threads(1)
    res = {"fold": _fold_cases(rank)}
    for name in CONFIGS:
        cfg = _cfg(TC, name)
        params = spec.params_from_numpy(weights[name], "cpu")
        for recipe in RECIPES:
            res[(name, "single", recipe)] = _serve(cfg, params, recipe, None)
            for mid, mesh in MESHES.items():
                res[(name, mid, recipe)] = _serve(cfg, params, recipe, mesh)
    return res


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

def _ref_weights(name):
    """(reference cfg, its seed-0 params, the params as /-named numpy)."""
    import jax

    from repro import configs as C
    from repro.ckpt.manager import _flatten_with_names
    from repro.models import registry as jreg, spec as jspec

    cfg = _cfg(C, name)
    params = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    return cfg, params, {k: np.asarray(v) for k, v in _flatten_with_names(params)[0].items()}


@pytest.fixture(scope="module")
def world():
    from repro_torch.parallel import collectives

    weights = {name: _ref_weights(name)[2] for name in CONFIGS}
    results = collectives.spawn(_rank_cases, 2, weights, device="cpu", threads=1)
    return weights, results


_REF = {}


def _reference(name, recipe):
    """The reference's single-device PoolEngine tokens and counters."""
    if (name, recipe) not in _REF:
        from repro.core.policy import PAPER_FAITHFUL as J_PF
        from repro.serve import PoolEngine as JPoolEngine, Request as JRequest
        from repro.serve.trace import shared_prefix_trace as j_prefix_trace

        jcfg, params, _ = _ref_weights(name)
        trace, kw = RECIPES[recipe]
        eng = JPoolEngine(jcfg, J_PF, params, max_slots=SLOTS, max_len=MAX_LEN,
                          num_pages=_num_pages(kw), **kw)
        out = eng.run(_requests(jcfg, trace, JRequest, j_prefix_trace))
        st = eng.last_stats
        _REF[(name, recipe)] = ({str(k): np.asarray(v).tolist() for k, v in out.items()},
                                {f: getattr(st, f) for f in STAT_FIELDS})
    return _REF[(name, recipe)]


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_pool_equals_one_rank(world, name, mesh, recipe):
    """Tokens and every counter of the sharded pool equal the single-rank
    pool's on both ranks; the plan's shard counts are recorded."""
    _, results = world
    single_toks, single_stats = results[0][(name, "single", recipe)]
    d, m = MESHES[mesh]
    for res in results:
        toks, stats = res[(name, mesh, recipe)]
        assert toks == single_toks
        assert {f: stats[f] for f in STAT_FIELDS} == {f: single_stats[f]
                                                       for f in STAT_FIELDS}
        assert (stats["data_shards"], stats["model_shards"]) == (d, m)
        assert stats["per_device_weight_passes"] == single_stats["weight_passes"] / m
    assert results[1][(name, "single", recipe)] == results[0][(name, "single", recipe)]


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_one_rank_pool_equals_reference(world, name, recipe):
    """The port's single-rank pool against the reference's single-device
    pool: the same tokens and counters."""
    _, results = world
    toks, stats = results[0][(name, "single", recipe)]
    jtoks, jstats = _reference(name, recipe)
    assert toks == jtoks
    assert {f: stats[f] for f in STAT_FIELDS if f != "ttft_passes"} == {
        f: jstats[f] for f in STAT_FIELDS if f != "ttft_passes"}


def test_row_parallel_product_is_k1_bit_for_bit(world):
    _, results = world
    assert results[0]["fold"] == results[1]["fold"] == [True, True, True]


def test_smoke_driver_equals_reference(world, tmp_path):
    """``python -m repro_torch.parallel.smoke --world 2 --mesh 2x1`` on the
    reference's seed-0 weights prints the reference's
    ``run_smoke(sharded=False)`` tokens."""
    from repro.parallel import smoke as jsmoke

    weights, _ = world
    path = tmp_path / "w.npz"
    np.savez(path, **weights["smoke"])
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.parallel.smoke", "--world", "2",
                          "--mesh", "2x1", "--params", str(path), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    ours = json.loads(res.stdout.strip().splitlines()[-1])
    ref = jsmoke.run_smoke(sharded=False, num_pages=ours["num_pages"])
    assert ours["tokens"] == ref["tokens"]
    assert (ours["data_shards"], ours["model_shards"], ours["devices"]) == (2, 1, 2)
    assert ours["mesh"] == {"data": 2, "model": 1}
    assert ours["weight_passes"] == ref["weight_passes"]


def test_plan_refusals():
    """A sharded plan for another family, and page geometry that is not
    the plan's, are refused (the latter as in the reference)."""
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import registry, spec
    from repro_torch.parallel import meshes, planner
    from repro_torch.serve import PoolEngine

    cfg = TC.smoke_config("llama3-8b")
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    plan = planner.plan_for(cfg, meshes.make_abstract_mesh((2, 1), ("data", "model")),
                            TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"), pool_slots=SLOTS)
    with pytest.raises(ValueError, match="page geometry"):
        PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                   page_size=8, plan=plan, device="cpu")
    with pytest.raises(ValueError, match="pool_slots"):
        PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=4, max_len=MAX_LEN, plan=plan,
                   device="cpu")
    # an abstract plan keys the engine and its counters, and runs one rank
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                     num_pages=plan.num_pages, plan=plan, device="cpu")
    assert not eng.sharded


def test_k1_plain_start_and_deq():
    """K1's plain version: a product split at a 128-chunk and continued
    from the first part's fold (``start``) is the whole product bit for
    bit, and the dequant multiplies the continued fold once; the K1 spec
    (``ref.pot_value_matmul_ref``) takes the same ``start``; ``start`` is
    refused with ``quantize=True`` and at a wrong shape."""
    from repro_torch.core import potq
    from repro_torch.kernels import potq_matmul as K
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(7)
    a = torch.randn((6, 384), generator=gen)
    w = torch.randn((384, 48), generator=gen) * 0.05
    aq = potq.pot_quantize(a, 5, potq.compute_beta(a, 5, axes=(1,)))
    wq = potq.pot_quantize(w, 5)
    first = K.potq_matmul_plain(aq[:, :256], wq[:256])
    whole = K.potq_matmul_plain(aq, wq)
    assert torch.equal(K.potq_matmul_plain(aq[:, 256:], wq[256:], start=first), whole)
    assert torch.equal(ref.pot_value_matmul_ref(aq[:, 256:], wq[256:], first), whole)
    scal = torch.tensor([1.0, 1.0, 2.0 ** -3, 0.0, float("inf")])
    assert torch.equal(K.potq_matmul_plain(aq[:, 256:], wq[256:], scal, start=first),
                       whole * scal[2])
    emax = potq.pot_emax(5)
    with pytest.raises(ValueError, match="quantize=False"):
        K.potq_matmul_plain(a, w, scal, emax_a=emax, emax_w=emax, quantize=True,
                            start=torch.zeros((6, 48)))
    with pytest.raises(ValueError, match="start"):
        K.potq_matmul_plain(aq, wq, start=torch.zeros((5, 48)))
