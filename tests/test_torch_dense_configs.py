"""repro_torch's other dense decoders vs the JAX reference at smoke size:
mistral-nemo-12b (n_heads·head_dim ≠ d_model at full width, rope_theta
1e6, a sliding window in its long_500k cell) and starcoder2-7b
(LayerNorm with bias, a two-matrix gelu MLP, a GQA group of 9), on the
same numpy parameters.

Tolerances and their reasons:
* Configs, shape cells, parameter shapes, engine counters and tokens:
  equal.
* The loss and the prefill logits: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py): the MACs differ by one
  rounding per 128-chunk, and norms, rope, gelu and softmax by a few ulps.
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
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, poisson_trace  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mistral-nemo-12b", "starcoder2-7b")
LOGIT_ATOL = 1e-3
MAX_LEN = 32
TRACE = dict(n_requests=4, prompt_len=11, lam=1.0, new_lo=2, new_hi=7, seed=3)
ENGINE = dict(max_slots=2, max_len=MAX_LEN, prefill_chunk=8, page_size=8)
CONFIG_PROPS = ("vocab_padded", "attention_free", "subquadratic", "d_inner")


def _fields(cfg):
    return {**dataclasses.asdict(cfg), **{p: getattr(cfg, p) for p in CONFIG_PROPS}}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_shape_cells_match_reference(arch):
    """get_config, smoke_config, shapes_for and config_for_shape (the
    long_500k window of mistral-nemo) equal the reference's, field for
    field."""
    assert arch in TC.ARCH_IDS
    for tcfg, jcfg in ((TC.get_config(arch), C.get_config(arch)),
                       (TC.smoke_config(arch), C.smoke_config(arch))):
        assert _fields(tcfg) == _fields(jcfg)
        tshapes, jshapes = TC.shapes_for(tcfg), C.shapes_for(jcfg)
        assert [dataclasses.asdict(s) for s in tshapes] == \
            [dataclasses.asdict(s) for s in jshapes]
        for ts, js in zip(TC.ALL_SHAPES, C.ALL_SHAPES):
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert _fields(TC.config_for_shape(tcfg, ts)) == \
                _fields(C.config_for_shape(jcfg, js))
    long = TC.config_for_shape(TC.get_config(arch), TC.LONG_500K)
    assert long.window == (4096 if arch == "mistral-nemo-12b" else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_window_rule_matches_reference(arch, monkeypatch):
    """smoke_config of a windowed variant (the long_500k config) keeps a
    window of 8, as the reference's does."""
    tlong = TC.config_for_shape(TC.get_config(arch), TC.LONG_500K)
    jlong = C.config_for_shape(C.get_config(arch), C.LONG_500K)
    monkeypatch.setattr(TC, "get_config", lambda a: tlong)
    monkeypatch.setattr(C, "get_config", lambda a: jlong)
    tsmoke, jsmoke = TC.smoke_config(arch), C.smoke_config(arch)
    assert _fields(tsmoke) == _fields(jsmoke)
    assert tsmoke.window == (8 if arch == "mistral-nemo-12b" else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Every parameter leaf at full width has the reference's name and
    shape (mistral-nemo's wq (5120, 4096), starcoder2's LN bias and
    two-matrix MLP)."""
    tcfg, jcfg = TC.get_config(arch), C.get_config(arch)
    tspecs = dict(spec.named_leaves(registry.param_specs(tcfg)))
    jspecs = {k: v for k, v in _flatten_with_names(jreg.param_specs(jcfg))[0].items()}
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, port params) at smoke
    size, one parameter draw."""
    jcfg, tcfg = C.smoke_config(arch), TC.smoke_config(arch)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in _flatten_with_names(params)[0].items()}
    return jcfg, tcfg, params, spec.params_from_numpy(named, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_prefill_logits_vs_reference(arch):
    jcfg, tcfg, params, tparams = _model(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.8).astype(np.float32)
    jloss = float(jtr.lm_loss(jcfg, J_PF, params, jnp.asarray(toks), jnp.asarray(labels),
                              jnp.asarray(mask)))
    with torch.no_grad():
        loss = float(transformer.lm_loss(tcfg, PAPER_FAITHFUL, tparams,
                                         torch.from_numpy(toks).long(),
                                         torch.from_numpy(labels).long(),
                                         torch.from_numpy(mask)))
    assert abs(loss - jloss) <= LOGIT_ATOL, (loss, jloss)
    prompt = toks[:1, :9]
    lj, _ = jtr.prefill(jcfg, J_PF, params, jnp.asarray(prompt),
                        jtr.init_cache(jcfg, 1, MAX_LEN))
    with torch.inference_mode():
        lt, _ = transformer.prefill(tcfg, PAPER_FAITHFUL, tparams,
                                    torch.from_numpy(prompt).long(),
                                    transformer.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
    worst = float(np.abs(np.asarray(lj, np.float32) - lt.numpy()).max())
    print(f"{arch}: loss {loss} vs {jloss}; max |prefill logit diff| {worst:.3g}")
    assert worst <= LOGIT_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_paged_engine_vs_reference(arch):
    """A chunked (8) and paged (8) PoolEngine on a Poisson trace: the
    reference engine's tokens and every counter it keeps."""
    jcfg, tcfg, params, tparams = _model(arch)
    jeng = JPoolEngine(jcfg, J_PF, params, **ENGINE)
    jout = jeng.run(j_poisson_trace(jcfg, **TRACE))
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu", **ENGINE)
    out = eng.run(poisson_trace(tcfg, **TRACE))
    assert out.keys() == jout.keys()
    for uid in jout:
        np.testing.assert_array_equal(out[uid], np.asarray(jout[uid]), err_msg=str(uid))
    jst, st = jeng.last_stats, eng.last_stats
    keys = [f.name for f in dataclasses.fields(jst)] + [
        "mean_occupancy", "per_device_weight_passes", "mean_ttft_passes", "prefix_hit_rate",
        "accepted_tokens_per_weight_pass", "kv_hbm_bytes_per_token"]
    for key in keys:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.prefills == TRACE["n_requests"] and st.weight_passes > 0
