"""repro_torch's vlm family (the decoder backbone with a projected patch
prefix) vs the JAX reference at smoke size (internvl2-76b's smoke config:
2 layers, d_model 64, 4 patches of 24), under ``PAPER_FAITHFUL`` on the
reference's parameters carried across with ``params_from_numpy`` (served
steps on its prequantized weights).

Tolerances and their reasons:
* Embeddings and logits: ``LOGIT_ATOL`` = 1e-3, the serving slice's bound
  (tests/test_torch_serve.py): the MACs differ by one rounding per
  128-chunk, and rope, rsqrt and softmax by a few ulps.
* The loss: ``LOSS_RTOL`` = 1e-5 relative; its gradients ``GRAD_RTOL`` =
  1e-4 of each leaf's largest |gradient| (tests/test_torch_train.py's
  bounds).
* Engine tokens, every ``ServeStats`` counter, ``pos`` and ``len``: equal;
  pool = solo inside the port bit for bit.
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
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core.policy import PAPER_FAITHFUL as J_PF  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import PoolEngine as JPoolEngine  # noqa: E402
from repro.serve import poisson_trace as j_poisson_trace  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.policy import PAPER_FAITHFUL  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry, spec, transformer  # noqa: E402
from repro_torch.serve import PoolEngine, poisson_trace, slots  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

ARCH = "internvl2-76b"
LOGIT_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MAX_LEN = 24
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
TRACE = dict(n_requests=4, prompt_len=7, lam=1.0, new_lo=2, new_hi=7, seed=3)
ENGINE = dict(max_slots=2, max_len=MAX_LEN, prefill_chunk=4, page_size=4)


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = C.smoke_config(ARCH), TC.smoke_config(ARCH)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    params_q = jqw.quantize_for_serving(jcfg, J_PF, params)
    return (jcfg, tcfg, params, params_q, spec.params_from_numpy(_named(params), "cpu"),
            spec.params_from_numpy(_named(params_q), "cpu"))


def _inputs(b, s, seed):
    cfg = TC.smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
    return tokens, patches


def test_config_and_param_specs_match_reference():
    """get_config and smoke_config equal the reference's field for field
    (rope_theta 1e6 included), and every parameter leaf at full width has
    the reference's name and shape, ``patch_proj`` (3200, 8192) among
    them."""
    for tcfg, jcfg in ((TC.get_config(ARCH), C.get_config(ARCH)),
                       (TC.smoke_config(ARCH), C.smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tspecs = dict(spec.named_leaves(registry.param_specs(TC.get_config(ARCH))))
    jspecs = _flatten_with_names(jreg.param_specs(C.get_config(ARCH)))[0]
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert tspecs["patch_proj/w"].shape == (3200, 8192)
    assert TC.get_config(ARCH).rope_theta == 1e6


def test_embed_inputs_forward_and_loss_vs_reference():
    """embed_inputs and the forward's logits with and without patches within
    ``LOGIT_ATOL`` (the patches first); lm_loss with and without patches
    within ``LOSS_RTOL`` (its logits cut after the patches) and, with
    patches, every gradient (patch_proj's included) within ``GRAD_RTOL``."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    tokens, patches = _inputs(2, 8, 0)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((2, 8), np.float32)
    tt, tp = torch.from_numpy(tokens).long(), torch.from_numpy(patches)
    for pe, jpe in ((tp, jnp.asarray(patches)), (None, None)):
        with torch.no_grad():
            x = transformer.embed_inputs(tcfg, PAPER_FAITHFUL, tparams, tt, pe)
            lg = transformer.forward(tcfg, PAPER_FAITHFUL, tparams, tt, patch_embeds=pe)
        jx = jtr.embed_inputs(jcfg, J_PF, params, jnp.asarray(tokens), jpe)
        jlg = jtr.forward(jcfg, J_PF, params, jnp.asarray(tokens), patch_embeds=jpe)
        n = 8 + (jcfg.num_patches if pe is not None else 0)
        assert x.shape == (2, n, jcfg.d_model) and lg.shape == (2, n, jcfg.vocab_padded)
        assert float(np.abs(_np(jx) - x.numpy()).max()) <= LOGIT_ATOL
        assert float(np.abs(_np(jlg) - lg.numpy()).max()) <= LOGIT_ATOL
        batch = {"tokens": tt, "labels": torch.from_numpy(labels).long(),
                 "mask": torch.from_numpy(mask)}
        jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                  "mask": jnp.asarray(mask)}
        if pe is None:
            with torch.no_grad():
                loss = transformer.lm_loss(tcfg, PAPER_FAITHFUL, tparams, tt, batch["labels"],
                                           batch["mask"])
            jl = jtr.lm_loss(jcfg, J_PF, params, jbatch["tokens"], jbatch["labels"],
                             jbatch["mask"])
            np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
            continue
        batch["patch_embeds"], jbatch["patch_embeds"] = pe, jpe
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jreg.loss_fn(jcfg, J_PF, p, jbatch)))(params)
        loss, grads = loss_and_grads(tcfg, PAPER_FAITHFUL, tparams, batch)
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
        jgn = _named(jg)
        for leaf, g in spec.named_leaves(grads):
            err = np.abs(g.numpy() - jgn[leaf]).max()
            assert err <= GRAD_RTOL * np.abs(jgn[leaf]).max(), (leaf, err)
        assert float(grads["patch_proj"]["w"].abs().max()) > 0


def test_prefill_with_patches_then_decode_vs_reference():
    """A solo prefill with patches (the patches take positions 0..3), its
    cache written into a paged pool slot, then teacher-forced pooled decode
    beside a text-only slot: logits within ``LOGIT_ATOL``, ``pos`` and
    ``len`` equal."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    jpre, jdec = make_prefill_step(jcfg, J_SERVE_POL), make_decode_step(jcfg, J_SERVE_POL)
    tokens, patches = _inputs(1, 6, 1)
    jpool = jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=4)
    tpool = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=4)
    worst = 0.0
    for s, pe in enumerate((patches, None)):
        jb = {"tokens": jnp.asarray(tokens)}
        tb = {"tokens": torch.from_numpy(tokens).long()}
        if pe is not None:
            jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
        lj, jc = jpre(params_q, jb, jtr.init_cache(jcfg, 1, MAX_LEN))
        with torch.inference_mode():
            lt, tc = registry.prefill(tcfg, SERVE_POL, tparams_q, tb,
                                      registry.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        assert int(tc["len"]) == 6 + (jcfg.num_patches if pe is not None else 0)
        jpool = jslots.write_slot(jpool, jc, s)
        slots.write_slot(tpool, tc, s)
    seq = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 5))
    with torch.inference_mode():
        for i in range(seq.shape[1]):
            _, lj, jpool = jdec(params_q, jnp.asarray(seq[:, i], jnp.int32), jpool)
            lt, tpool = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                             torch.from_numpy(seq[:, i]), tpool)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
    for key in ("pos", "len"):
        np.testing.assert_array_equal(np.asarray(jpool[key]), tpool[key].numpy(), err_msg=key)
    print(f"max |logit diff| {worst:.3g} (tolerance {LOGIT_ATOL})")
    assert worst <= LOGIT_ATOL


_RUNS = {}


def _engine_runs():
    """(reference tokens, reference stats, port tokens, port stats) of the
    chunked + paged engine on TRACE (every request with patches), run once."""
    if not _RUNS:
        jcfg, tcfg, params, _, tparams, _ = _model()
        jeng = JPoolEngine(jcfg, J_PF, params, **ENGINE)
        jout = jeng.run(j_poisson_trace(jcfg, **TRACE))
        eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu", **ENGINE)
        out = eng.run(poisson_trace(tcfg, **TRACE))
        _RUNS["chunked"] = (jout, jeng.last_stats, out, eng.last_stats)
    return _RUNS["chunked"]


def test_engine_with_patches_vs_reference():
    """A chunked (4) and paged (4) PoolEngine whose requests carry patches
    (they solo-prefill, as in the reference): the reference engine's
    tokens and every counter it keeps (prompt_tokens counts the text
    tokens only)."""
    jout, jst, out, st = _engine_runs()
    assert out.keys() == jout.keys()
    for uid in jout:
        np.testing.assert_array_equal(out[uid], np.asarray(jout[uid]), err_msg=str(uid))
    keys = [f.name for f in dataclasses.fields(jst)] + [
        "mean_occupancy", "mean_ttft_passes", "prefix_hit_rate", "kv_hbm_bytes_per_token"]
    for key in keys:
        assert getattr(st, key) == getattr(jst, key), key
    assert st.prompt_tokens == TRACE["n_requests"] * TRACE["prompt_len"]
    assert st.prefills == TRACE["n_requests"]


def test_pool_vs_solo_with_patches():
    """Each request's pooled tokens equal its run alone in a one-slot
    engine with the same chunk, at page = span."""
    _, tcfg, _, _, tparams, _ = _model()
    _, _, out, _ = _engine_runs()
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu",
                     **dict(ENGINE, max_slots=1, page_size=None))
    for req in poisson_trace(tcfg, **TRACE):
        solo = eng.run([dataclasses.replace(req, arrival=0)])
        np.testing.assert_array_equal(solo[req.uid], out[req.uid], err_msg=str(req.uid))


def test_request_needs_room_for_its_patches():
    """The page budget counts the patch positions: 4 patches + 7 tokens + 14
    new exceed max_len 24."""
    _, tcfg, _, _, tparams, _ = _model()
    req = dataclasses.replace(poisson_trace(tcfg, **TRACE)[0], max_new_tokens=14)
    eng = PoolEngine(tcfg, PAPER_FAITHFUL, tparams, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match=r"prompt \(11\)"):
        eng.run([req])


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-large-v3"])
def test_pipeline_batch_shapes(arch):
    """batch_shapes equals the reference's key for key and shape for shape
    (a vlm's patches and text fill seq_len); make_batch draws every key at
    its shape, deterministically."""
    tcfg, jcfg = TC.smoke_config(arch), C.smoke_config(arch)
    shape, jshape = ShapeConfig("t", 16, 2, "train"), JShapeConfig("t", 16, 2, "train")
    ours, theirs = pipeline.batch_shapes(tcfg, shape), jpipeline.batch_shapes(jcfg, jshape)
    assert {k: s for k, (s, _) in ours.items()} == {k: s for k, (s, _) in theirs.items()}
    b = pipeline.make_batch(tcfg, shape, 3, device="cpu")
    for k, (shp, dt) in ours.items():
        assert tuple(b[k].shape) == shp and b[k].dtype == dt, k
    extra = "patch_embeds" if arch == ARCH else "frames"
    assert float(b[extra].std()) < 0.2 and float(b[extra].abs().max()) > 0
    again = pipeline.make_batch(tcfg, shape, 3, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    if arch == ARCH:
        assert b["tokens"].shape[1] + tcfg.num_patches == 16


def test_train_cli_smoke(capsys):
    """The training CLI takes ``--arch internvl2-76b --smoke``: finite
    losses, two microbatches."""
    run = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "12", "--log-every", "1", "--device", "cpu",
                          "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "done" in out and len(run.records) == 2
    for r in run.records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
