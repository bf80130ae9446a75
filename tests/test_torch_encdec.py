"""repro_torch's encoder-decoder (models/encdec.py) vs the JAX reference at
smoke size (whisper-large-v3's smoke config: 2 encoder and 2 decoder
layers, 12 frames of 24, d_model 64), under ``PAPER_FAITHFUL`` on the
reference's parameters carried across with ``params_from_numpy`` (served
steps on its prequantized weights).

Tolerances and their reasons:
* The encoder output and all logits: ``LOGIT_ATOL`` = 1e-3, the serving
  slice's bound (tests/test_torch_serve.py): the MACs differ by one
  rounding per 128-chunk, and rope, rsqrt and softmax by a few ulps.
* The loss: ``LOSS_RTOL`` = 1e-5 relative; its gradients ``GRAD_RTOL`` =
  1e-4 of each leaf's largest |gradient| (tests/test_torch_train.py's
  bounds: a last-ulp difference may move one element across a PoT
  rounding boundary).
* ``pos``, ``len``, page tables and the KV page codes and betas: equal.
* Inside the port (a chunk step's decode row vs ``decode_step``, a verify
  step vs sequential decode): bit for bit.
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
from repro.models import encdec as jenc  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import spec as jspec  # noqa: E402
from repro.serve import quantized_weights as jqw  # noqa: E402
from repro.serve import slots as jslots  # noqa: E402
from repro.serve.engine import (make_chunk_step, make_decode_step,  # noqa: E402
                                make_prefill_step, make_verify_step)
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.policy import KV_PINNED, PAPER_FAITHFUL  # noqa: E402
from repro_torch.models import encdec, registry, spec  # noqa: E402
from repro_torch.serve import slots  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
LOGIT_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MAX_LEN = 24
CHUNK = 4
PAGE = 4
SERVE_POL = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                                weights_prequantized=True)
J_SERVE_POL = dataclasses.replace(J_PF, per_sample_act_scales=True, weights_prequantized=True)
PROMPTS = [[5, 7, 9, 11, 2, 13], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8, 6, 7]]
ROWS = np.array([[21, 3, 40, 7], [11, 12, 13, 14], [2, 99, 5, 0]])


def _named(tree):
    return {k: np.asarray(v) for k, v in _flatten_with_names(tree)[0].items()}


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _model():
    """(reference cfg, port cfg, reference params and served weights, the
    port's copies of both)."""
    jcfg, tcfg = C.smoke_config(ARCH), TC.smoke_config(ARCH)
    params = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    params_q = jqw.quantize_for_serving(jcfg, J_PF, params)
    return (jcfg, tcfg, params, params_q, spec.params_from_numpy(_named(params), "cpu"),
            spec.params_from_numpy(_named(params_q), "cpu"))


def _frames(n, seed):
    cfg = TC.smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.enc_seq, cfg.frame_dim)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jsteps(pol):
    jcfg = C.smoke_config(ARCH)
    return (make_prefill_step(jcfg, pol), make_decode_step(jcfg, pol),
            make_chunk_step(jcfg, pol), make_verify_step(jcfg, pol))


def test_config_and_param_specs_match_reference():
    """get_config and smoke_config equal the reference's field for field,
    and every parameter leaf at full width has the reference's name and
    shape (the tied head: no lm_head leaf)."""
    for tcfg, jcfg in ((TC.get_config(ARCH), C.get_config(ARCH)),
                       (TC.smoke_config(ARCH), C.smoke_config(ARCH))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tspecs = dict(spec.named_leaves(registry.param_specs(TC.get_config(ARCH))))
    jspecs = _flatten_with_names(jreg.param_specs(C.get_config(ARCH)))[0]
    assert {k: tuple(v.shape) for k, v in tspecs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert tspecs["embed"].shape == (52224, 1280) and "lm_head/w" not in tspecs


def test_encode_forward_loss_and_grads_vs_reference():
    """The encoder output and the decoder logits within ``LOGIT_ATOL``, the
    loss within ``LOSS_RTOL`` and every gradient (frame_proj, enc_pos, both
    stacks, the tied embedding) within ``GRAD_RTOL`` of the reference's."""
    jcfg, tcfg, params, _, tparams, _ = _model()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((2, 8), np.float32)
    mask[:, -1] = 0.0
    frames = _frames(2, 1)
    with torch.no_grad():
        enc_t = encdec.encode(tcfg, PAPER_FAITHFUL, tparams, torch.from_numpy(frames))
        log_t = encdec.forward(tcfg, PAPER_FAITHFUL, tparams, torch.from_numpy(tokens).long(),
                               torch.from_numpy(frames))
    enc_j = jenc.encode(jcfg, J_PF, params, jnp.asarray(frames))
    log_j = jenc.forward(jcfg, J_PF, params, jnp.asarray(tokens), jnp.asarray(frames))
    assert enc_t.shape == (2, jcfg.enc_seq, jcfg.d_model)
    assert float(np.abs(_np(enc_j) - enc_t.numpy()).max()) <= LOGIT_ATOL
    assert float(np.abs(_np(log_j) - log_t.numpy()).max()) <= LOGIT_ATOL

    def jloss(p):
        return jenc.lm_loss(jcfg, J_PF, p, jnp.asarray(tokens), jnp.asarray(frames),
                            jnp.asarray(labels), jnp.asarray(mask))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask), "frames": torch.from_numpy(frames)}
    loss, grads = loss_and_grads(tcfg, PAPER_FAITHFUL, tparams, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    jgn = _named(jg)
    assert {n for n, _ in spec.named_leaves(grads)} == set(jgn)
    for leaf, g in spec.named_leaves(grads):
        ref = jgn[leaf]
        err = np.abs(g.numpy() - ref).max()
        assert g.dtype == torch.float32 and err <= GRAD_RTOL * np.abs(ref).max(), (leaf, err)


def _prefill_pair(prompt, frames):
    """Solo prefill of one prompt in both packages: (reference logits and
    mini cache, port logits and mini cache)."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    jpre = _jsteps(J_SERVE_POL)[0]
    lj, jc = jpre(params_q, {"tokens": jnp.asarray([prompt], jnp.int32),
                             "frames": jnp.asarray(frames)}, jenc.init_cache(jcfg, 1, MAX_LEN))
    with torch.inference_mode():
        lt, tc = registry.prefill(tcfg, SERVE_POL, tparams_q,
                                  {"tokens": torch.tensor([prompt]),
                                   "frames": torch.from_numpy(frames)},
                                  registry.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
    return lj, jc, lt, tc


def test_prefill_and_decode_vs_reference():
    """Solo prefill of two requests (each its own frames), written into a
    paged pool through shuffled pages, then teacher-forced pooled decode;
    and a batch-2 lockstep prefill and decode (per-tensor scales): every
    logit within ``LOGIT_ATOL``; pos, len and table equal; the cross K/V
    rows equal the prefill's."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    jdecode = _jsteps(J_SERVE_POL)[1]
    frames = _frames(2, 2)
    table = np.random.default_rng(0).permutation(12).reshape(2, 6)
    jpool = jreg.init_pool_cache(jcfg, 2, MAX_LEN, page_size=PAGE)
    tpool = registry.init_pool_cache(tcfg, 2, MAX_LEN, device="cpu", page_size=PAGE)
    worst = 0.0
    for s, prompt in enumerate(PROMPTS[:2]):
        lj, jc, lt, tc = _prefill_pair(prompt, frames[s:s + 1])
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        jpool = jslots.write_slot(jpool, jc, s, pages=list(table[s]))
        slots.write_slot(tpool, tc, s, pages=list(table[s]))
        assert torch.equal(tpool["ck"][:, s], tc["ck"][:, 0])
    seq = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 5))
    with torch.inference_mode():
        for i in range(seq.shape[1]):
            _, lj, jpool = jdecode(params_q, jnp.asarray(seq[:, i], jnp.int32), jpool)
            lt, tpool = registry.decode_step(tcfg, SERVE_POL, tparams_q,
                                             torch.from_numpy(seq[:, i]), tpool)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
    for key in ("pos", "len", "table"):
        np.testing.assert_array_equal(np.asarray(jpool[key]), tpool[key].numpy(), err_msg=key)
    # lockstep: one batched prefill, one shared position
    jlock = dataclasses.replace(J_PF, weights_prequantized=True)
    lock = dataclasses.replace(PAPER_FAITHFUL, weights_prequantized=True)
    jpre, jdec = _jsteps(jlock)[:2]
    prompt = np.array([PROMPTS[0], PROMPTS[1][:6]], np.int32)
    lj, jc = jpre(params_q, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)},
                  jreg.init_cache(jcfg, 2, MAX_LEN))
    with torch.inference_mode():
        lt, tc = registry.prefill(tcfg, lock, tparams_q,
                                  {"tokens": torch.from_numpy(prompt).long(),
                                   "frames": torch.from_numpy(frames)},
                                  registry.init_cache(tcfg, 2, MAX_LEN, device="cpu"))
        worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
        for i in range(seq.shape[1]):
            _, lj, jc = jdec(params_q, jnp.asarray(seq[:, i], jnp.int32), jc)
            lt, tc = registry.decode_step(tcfg, lock, tparams_q, torch.from_numpy(seq[:, i]), tc)
            worst = max(worst, float(np.abs(_np(lj) - lt.numpy()).max()))
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    print(f"max |logit diff| {worst:.3g} (tolerance {LOGIT_ATOL})")
    assert worst <= LOGIT_ATOL


def _chunk_rows(prompts, c0):
    tokens = np.zeros((len(prompts), CHUNK), np.int64)
    n_new = np.zeros((len(prompts),), np.int64)
    for s, p in enumerate(prompts):
        part = p[c0:c0 + CHUNK]
        tokens[s, :len(part)] = part
        n_new[s] = len(part)
    return tokens, n_new


@functools.lru_cache(maxsize=None)
def _cross_kv():
    """encode_cross_kv of three requests' frames (one at a time, as the
    engine admits them) in both packages."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    frames = _frames(3, 3)
    out = []
    for s in range(3):
        jk, jv = jenc.encode_cross_kv(jcfg, J_SERVE_POL, params_q, jnp.asarray(frames[s:s + 1]))
        with torch.inference_mode():
            tk, tv = registry.encode_cross_kv(tcfg, SERVE_POL, tparams_q,
                                              torch.from_numpy(frames[s:s + 1]))
        out.append((jk, jv, tk, tv))
    return out


def _prompted_pools(kv_quant=None):
    """A 3-slot paged pool (page 4, a shuffled page table) in each package,
    each slot's cross K/V written from the reference's ``encode_cross_kv`` and PROMPTS
    streamed in by chunk steps.  Returns (reference pool, port pool,
    [(reference logits, port logits, n_new) of each step])."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    jpol = dataclasses.replace(J_SERVE_POL, kv_quant=J_KV_PINNED if kv_quant else None)
    tpol = dataclasses.replace(SERVE_POL, kv_quant=kv_quant)
    jchunk = _jsteps(jpol)[2]
    table = np.random.default_rng(0).permutation(18).reshape(3, 6)
    jc = jreg.init_pool_cache(jcfg, 3, MAX_LEN, page_size=PAGE,
                              kv_quant=J_KV_PINNED if kv_quant else None)
    tc = registry.init_pool_cache(tcfg, 3, MAX_LEN, device="cpu", page_size=PAGE,
                                  kv_quant=kv_quant)
    jc["table"] = jnp.asarray(table, jnp.int32)
    tc["table"] = torch.from_numpy(table)
    # both pools get the reference's cross K/V, so the steps are compared
    # on the same inputs
    for s, (jk, jv, _, _) in enumerate(_cross_kv()):
        for key, x in (("ck", jk), ("cv", jv)):
            jc[key] = jc[key].at[:, s].set(x[:, 0].astype(jc[key].dtype))
            tc[key][:, s] = torch.from_numpy(np.array(x[:, 0], np.float32)).to(tc[key].dtype)
    steps = []
    with torch.inference_mode():
        for c0 in range(0, 9, CHUNK):
            tokens, n_new = _chunk_rows(PROMPTS, c0)
            _, lj, jc = jchunk(params_q, jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(n_new, jnp.int32), jc)
            lt, tc = registry.chunk_step(tcfg, tpol, tparams_q, torch.from_numpy(tokens),
                                         n_new, tc)
            steps.append((lj, lt, n_new))
    return jc, tc, steps


def test_encode_cross_kv_chunk_and_verify_vs_reference():
    """encode_cross_kv within ``LOGIT_ATOL``; PROMPTS streamed in by chunk
    steps over the written cross K/V, then a verify step over ragged rows
    (4, 2, 1 positions): the live rows' logits within ``LOGIT_ATOL``; pos,
    len and the table equal."""
    jcfg, tcfg, _, params_q, _, tparams_q = _model()
    worst = 0.0
    for jk, jv, tk, tv in _cross_kv():
        assert tk.shape == (tcfg.n_layers, 1, tcfg.enc_seq, tcfg.kv_heads, tcfg.head_dim)
        worst = max(worst, float(np.abs(_np(jk) - tk.numpy()).max()),
                    float(np.abs(_np(jv) - tv.numpy()).max()))
    jc, tc, steps = _prompted_pools()
    for lj, lt, n_new in steps:
        live = n_new > 0
        worst = max(worst, float(np.abs(_np(lj)[live] - lt.numpy()[live]).max()))
    n_new = np.array([4, 2, 1])
    with torch.inference_mode():
        lv, tc = registry.verify_step(tcfg, SERVE_POL, tparams_q, torch.from_numpy(ROWS), n_new,
                                      tc)
    _, jl, jc = _jsteps(J_SERVE_POL)[3](params_q, jnp.asarray(ROWS, jnp.int32),
                                        jnp.asarray(n_new, jnp.int32), jc)
    worst = max([worst] + [float(np.abs(_np(jl)[s, :n] - lv[s, :n].numpy()).max())
                           for s, n in enumerate(n_new)])
    for key in ("pos", "len", "table"):
        np.testing.assert_array_equal(np.asarray(jc[key]), tc[key].numpy(), err_msg=key)
    print(f"max |cross K/V, chunk and verify logit diff| {worst:.3g}")
    assert worst <= LOGIT_ATOL


@pytest.mark.parametrize("kv", ["bf16", "kv_pinned"])
def test_port_step_identities(kv):
    """Inside the port, bit for bit, over bf16 and ``KV_PINNED`` pages: a
    chunk step's decode rows equal ``decode_step`` (the engine's decode
    fast path), and a verify step equals sequential decode steps (ragged
    rows; a slot past its count writes nothing), in logits and every
    cache leaf; no step touches the cross K/V."""
    _, tcfg, _, _, _, tparams_q = _model()
    kv_quant = KV_PINNED if kv == "kv_pinned" else None
    pol = dataclasses.replace(SERVE_POL, kv_quant=kv_quant)
    _, pool, _ = _prompted_pools(kv_quant)
    cross = {k: pool[k].clone() for k in ("ck", "cv")}
    last = torch.tensor([21, 11, 2])
    rows = torch.zeros((3, CHUNK), dtype=torch.int64)
    rows[:, 0] = last
    c1 = {k: v.clone() for k, v in pool.items()}
    c2 = {k: v.clone() for k, v in pool.items()}
    with torch.inference_mode():
        lg_chunk, c1 = registry.chunk_step(tcfg, pol, tparams_q, rows, [1, 1, 1], c1)
        lg_dec, c2 = registry.decode_step(tcfg, pol, tparams_q, last, c2)
    assert torch.equal(lg_chunk, lg_dec)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)

    n_new = (4, 2, 0)
    seq = {k: v.clone() for k, v in pool.items()}
    with torch.inference_mode():
        lv, pool = registry.verify_step(tcfg, pol, tparams_q, torch.from_numpy(ROWS),
                                        np.array(n_new), pool)
        table, len0, drop = seq["table"].clone(), seq["len"].clone(), slots.drop_id(seq)
        out = []
        for j in range(max(n_new)):
            seq["table"] = torch.where(torch.tensor(n_new)[:, None] > j, table,
                                       torch.full_like(table, drop))
            lg, seq = registry.decode_step(tcfg, pol, tparams_q, torch.from_numpy(ROWS[:, j]),
                                           seq)
            out.append(lg)
    seq["table"], seq["len"] = table, len0 + torch.tensor(n_new)
    ls = torch.stack(out, dim=1)
    for s, n in enumerate(n_new):
        assert torch.equal(lv[s, :n], ls[s, :n]), s
    for key in pool:
        assert torch.equal(pool[key], seq[key]), key
    for key, x in cross.items():
        assert torch.equal(pool[key], x) and torch.equal(c1[key], x), key


def test_quantized_pages_with_raw_cross_kv_vs_reference():
    """``KV_PINNED`` pages: the self-attention K/V are uint8 codes with
    int32 betas equal to the reference's, the cross K/V stay raw bf16;
    chunk-step logits within ``LOGIT_ATOL``; a speculative snapshot and
    rollback leaves the cross K/V as they were."""
    jc, tc, steps = _prompted_pools(KV_PINNED)
    assert tc["k"].dtype == torch.uint8 and tc["k_beta"].dtype == torch.int32
    assert tc["ck"].dtype == torch.bfloat16 and tc["ck"].shape[1] == 3
    for key in ("k", "v", "k_beta", "v_beta", "ck", "cv", "pos", "len"):
        np.testing.assert_array_equal(np.asarray(jc[key]).astype(np.float32),
                                      tc[key].to(torch.float32).numpy(), err_msg=key)
    worst = max(float(np.abs(_np(lj)[n > 0] - lt.numpy()[n > 0]).max()) for lj, lt, n in steps)
    assert worst <= LOGIT_ATOL
    cross = {k: tc[k].clone() for k in ("ck", "cv")}
    snap = slots.spec_snapshot(tc, 4)
    assert "ck" not in snap
    slots.spec_restore(tc, snap, torch.zeros(3, dtype=torch.int64))
    assert all(torch.equal(tc[k], x) for k, x in cross.items())


def test_training_launch_counts_and_cli(monkeypatch, capsys):
    """One training step runs K1 once per linear forward (frame_proj, 6 an
    encoder layer, 10 a decoder layer, the tied head) and again per
    recomputed layer linear (not frame_proj, not the head); K2 and K3 once
    per linear backward: frame_proj's dA too, whose frames need no
    gradient, since its PRC gamma's gradient comes from K2's row sums.
    The training CLI takes ``--arch whisper-large-v3 --smoke``."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.train import make_train_step

    cfg = TC.smoke_config(ARCH)
    counts = {"k1": 0, "k2": 0, "k3": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops._k, "potq_matmul_plain", counting("k1", ops._k.potq_matmul_plain))
    monkeypatch.setattr(ops._kg, "grad_da_plain", counting("k2", ops._kg.grad_da_plain))
    monkeypatch.setattr(ops._kg, "grad_dw_plain", counting("k3", ops._kg.grad_dw_plain))
    params = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    opt = optim.adamw(optim.warmup_cosine_schedule(1e-3, 1, 3))
    step = make_train_step(cfg, PAPER_FAITHFUL, opt)
    batch = pipeline.make_batch(cfg, ShapeConfig("t", 8, 2, "train"), 0, device="cpu")
    step(params, opt.init(params), batch, 0)
    layers = 6 * cfg.enc_layers + 10 * cfg.n_layers
    assert counts == {"k1": 2 * layers + 2, "k2": layers + 2, "k3": layers + 2}

    run = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                          "--seq", "8", "--log-every", "1", "--device", "cpu"])
    assert "done" in capsys.readouterr().out and len(run.records) == 2
    for r in run.records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
