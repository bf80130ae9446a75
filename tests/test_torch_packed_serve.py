"""Serving olmo-1b (smoke size) from int8-packed weights: the port's
``quantize_for_serving -> pack_int8 -> CheckpointManager save/restore ->
unpack_int8 -> PoolEngine`` against the reference's engine on the same
unpacked weights, on the CPU.

Tolerances and their reasons (as tests/test_torch_serve.py):
* Unpacked weights are exact PoT values: bit for bit after a round trip
  through the checkpoint.  Against the reference's own chain they differ
  only where WBC'd values lie in the √2 band, by one PoT step.
* Greedy tokens are compared up to the first step whose reference top-2
  logit margin is under ``LOGIT_ATOL = 1e-3`` (a near-tie): the MACs
  differ by one rounding per 128-chunk and rope, rsqrt, softmax and exp
  by last ulps, which may move an activation across a PoT boundary.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as JC  # noqa: E402
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
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import spec  # noqa: E402
from repro_torch.serve import PoolEngine, poisson_trace  # noqa: E402
from repro_torch.serve import quantized_weights as qw  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-3
MAX_LEN = 24
TRACE = dict(n_requests=4, prompt_len=6, lam=1.0, new_lo=2, new_hi=7, seed=3)
PRE = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
J_PRE = dataclasses.replace(J_PF, weights_prequantized=True)


@pytest.fixture(scope="module")
def packed_model(tmp_path_factory):
    """The port's chain on one smoke olmo-1b tree drawn by the reference."""
    cfg, tcfg = JC.smoke_config("olmo-1b"), TC.smoke_config("olmo-1b")
    jp = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}
    served = qw.quantize_for_serving(tcfg, PAPER_FAITHFUL, spec.params_from_numpy(named, "cpu"))
    packed = qw.pack_int8(served)
    mgr = CheckpointManager(str(tmp_path_factory.mktemp("packed")), async_write=False)
    mgr.save(0, {"packed": packed}, blocking=True)
    restored = mgr.restore(0, {"packed": packed})["packed"]
    return cfg, tcfg, jp, served, packed, restored, qw.unpack_int8(restored)


def _to_reference(jp, tree):
    """The port's tree in the reference's structure (bf16 stays bf16)."""
    names, treedef = _flatten_with_names(jp)
    flat = dict(spec.named_leaves(tree))
    leaves = [jnp.asarray(flat[n].float().numpy(), jnp.bfloat16)
              if flat[n].dtype == torch.bfloat16 else jnp.asarray(flat[n].numpy())
              for n in names]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_packed_tree_survives_the_checkpoint(packed_model):
    _, _, _, served, packed, restored, unpacked = packed_model
    for (name, x), (_, y) in zip(spec.named_leaves(packed), spec.named_leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    for name, x in spec.named_leaves(packed):
        if name.endswith("/code"):
            assert x.dtype == torch.int8
        elif name.endswith("/beta"):
            assert x.dtype == torch.int32 and x.dim() == 0
    flushed = 0
    for (name, x), (_, s) in zip(spec.named_leaves(unpacked), spec.named_leaves(served)):
        assert x.dtype == s.dtype, name
        if x.dtype == torch.bfloat16:  # packed under one beta per stacked leaf
            diff = x.float() != s.float()
            assert torch.all(x.float()[diff] == 0), name
            flushed += int(diff.sum())
        else:
            assert torch.equal(x, s), name
    print(f"elements flushed to zero by one beta per stacked leaf: {flushed}")


def test_unpacked_weights_vs_reference_chain(packed_model):
    cfg, _, jp, _, _, _, unpacked = packed_model
    ref = jqw.unpack_int8(jqw.pack_int8(jqw.quantize_for_serving(cfg, J_PF, jp)))
    ref = {k: np.asarray(v, np.float32) for k, v in _flatten_with_names(ref)[0].items()}
    n_diff = 0
    for name, x in spec.named_leaves(unpacked):
        ours = x.float().numpy()
        d = ours != ref[name]
        n_diff += int(d.sum())
        if d.any():  # one PoT step: a factor of 2, or the smallest code vs 0
            a, b = np.abs(ours[d]), np.abs(ref[name][d])
            assert np.all((a == 2 * b) | (b == 2 * a) | (a == 0) | (b == 0)), name
            assert d.mean() <= 1e-3, name
    print(f"unpacked elements that differ from the reference's chain: {n_diff}")


def _reference_margins(cfg, params, req, tokens):
    """Top-2 logit margin of the reference at each emitted token, driven
    solo and teacher-forced with its own tokens."""
    pol = dataclasses.replace(J_PRE, per_sample_act_scales=True)
    logits, cache = make_prefill_step(cfg, pol)(
        params, {"tokens": jnp.asarray(req.tokens)}, jtr.init_cache(cfg, 1, MAX_LEN))
    decode = make_decode_step(cfg, pol)
    cache = jslots.lift_cache(cache, 1)
    cache["len"] = jnp.asarray([req.tokens.shape[-1]], jnp.int32)
    margins = []
    for t in tokens:
        assert int(np.argmax(np.asarray(logits[0]))) == int(t)
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        _, logits, cache = decode(params, jnp.asarray([t], jnp.int32), cache)
    return margins


def test_serve_from_packed_weights_vs_reference(packed_model):
    """The port's engine on its unpacked weights gives the reference
    engine's tokens on the same weights, up to near-ties; the weight-pass
    counters are equal."""
    cfg, tcfg, jp, _, _, _, unpacked = packed_model
    jparams = _to_reference(jp, unpacked)
    jeng = JPoolEngine(cfg, J_PRE, jparams, max_slots=2, max_len=MAX_LEN, prequantize=False)
    jout = {k: np.asarray(v) for k, v in jeng.run(j_poisson_trace(cfg, **TRACE)).items()}
    eng = PoolEngine(tcfg, PRE, unpacked, max_slots=2, max_len=MAX_LEN, prequantize=False,
                     device="cpu")
    out = eng.run(poisson_trace(tcfg, **TRACE))
    assert eng.last_stats.weight_passes == jeng.last_stats.weight_passes
    near_ties = []
    for req in j_poisson_trace(cfg, **TRACE):
        ref_toks, ours = jout[req.uid], out[req.uid]
        assert ours.shape == ref_toks.shape
        margins = _reference_margins(cfg, jparams, req, ref_toks)
        for step, (a, b, m) in enumerate(zip(ours, ref_toks, margins)):
            if m < LOGIT_ATOL:
                near_ties.append((req.uid, step, m))
                break  # past a near-tie the two may rightly diverge
            assert a == b, (req.uid, step, m)
    print(f"near-tie steps (uid, step, margin): {near_ties}")
