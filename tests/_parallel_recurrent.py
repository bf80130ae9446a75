"""What ``test_torch_parallel_ssm.py`` and ``test_torch_parallel_hybrid.py``
run: one recurrent arch of repro_torch on a sharded plan over two gloo
ranks on the CPU, at smoke width and widened so that the split
contractions fold (K1's fold continued across the ranks), against the
port's single rank and the reference's single-device ``PoolEngine`` under
``PAPER_FAITHFUL`` on the same numpy weights (the reference's seed-0 draw,
quantized for serving by each engine).

* Serving: ``PoolEngine(plan=...)`` on the (1, 2) and (2, 1) (data,
  model) meshes, the slot-row pool, solo-prefill admissions.
* Shards: each rank's serving weights, leaf by leaf, against its cut of
  the whole leaf's serving form (an ssm's ``in_proj`` and conv by their
  index sets).
* Data-parallel training on (2, 1) with the second rank's rows skewed
  (``_skewed``): first-step per-token losses and every quantizer scale
  equal one rank's, gradients within ``GRAD_TOL`` of a leaf's largest
  magnitude, 3-step losses within ``LOSS_RTOL`` relative; and
  ``launch.train --mesh 2x1``.
* The smoke entry point (``parallel.smoke.run_smoke``) on both meshes.

The test files spawn one world each (``collectives.spawn``, which imports
:func:`rank_cases` by name) and read its results.
"""
import dataclasses

import numpy as np

import torch

MAX_LEN = 24
SLOTS = 2
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
TRACE = dict(n_requests=4, lam=1.0, new_lo=2, new_hi=7, seed=3)
STAT_FIELDS = ("decode_steps", "prefills", "emitted_tokens", "occupancy_sum",
               "weight_passes", "ttft_passes", "prompt_tokens", "prefix_hit_tokens",
               "cow_copies", "evictions", "admission_deferrals", "pages_in_use_sum",
               "page_size", "kv_page_bytes")
BATCH, SEQ, STEPS = 4, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# the smoke width, and a widened variant whose split contractions are
# whole 128-chunks a rank at model = 2: mamba2's out_proj (8 SSD heads of
# 64, 4 a rank), recurrentgemma's wout, MLP down projection and wo
CONFIGS = {"mamba2-2.7b": {"smoke": {}, "wide": dict(d_model=256)},
           "recurrentgemma-2b": {"smoke": {},
                                 "wide": dict(lru_width=256, d_ff=512, head_dim=64)}}
# two SSD chunks of 8 (ssm); past the window of 8 (hybrid)
PROMPT = {"mamba2-2.7b": 16, "recurrentgemma-2b": 11}


def cfg_of(pkg_configs, arch, name):
    return dataclasses.replace(pkg_configs.smoke_config(arch), **CONFIGS[arch][name])


def requests(cfg, arch):
    from repro_torch.serve import poisson_trace

    return poisson_trace(cfg, prompt_len=PROMPT[arch], **TRACE)


def folds_a_pass(cfg, name):
    """Row-parallel folds of one weight pass on (1, 2): mamba2's out_proj
    a layer; recurrentgemma's wout, or wo, and its MLP's down projection a
    layer; none at smoke width (under a 128-chunk a rank: gathered)."""
    if name == "smoke":
        return 0
    return cfg.n_layers * (1 if cfg.family == "ssm" else 2)


def _plan(cfg, mesh):
    from repro_torch import configs as TC
    from repro_torch.parallel import meshes, planner

    return planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")),
                            TC.ShapeConfig("s", MAX_LEN, SLOTS, "decode"), pool_slots=SLOTS)


def _serve(cfg, params, mesh, reqs):
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.parallel import collectives
    from repro_torch.serve import PoolEngine

    plan = None if mesh is None else _plan(cfg, mesh)
    eng = PoolEngine(cfg, PAPER_FAITHFUL, params, max_slots=SLOTS, max_len=MAX_LEN,
                     plan=plan, device="cpu")
    collectives.reset_stats()
    out = eng.run(reqs)
    st = eng.last_stats
    stats = {f: getattr(st, f) for f in STAT_FIELDS}
    stats.update(data_shards=st.data_shards, model_shards=st.model_shards,
                 n_heads=eng.step_cfg.n_heads, lru_width=eng.step_cfg.lru_width,
                 folds=collectives.stats["folds"])
    # as float32 numpy (bf16 serving values are exact there): a tensor
    # result would cross to the parent through shared memory
    held = {n: x.to(torch.float32).numpy() for n, x in spec.named_leaves(eng.params)}
    return {str(k): v.tolist() for k, v in out.items()}, stats, held


def _skewed(batch, vocab):
    """The pipeline's batch with the second half's token ids mirrored and
    its loss weights cut to 1/16 (as ``test_torch_parallel_train.py``)."""
    half = batch["tokens"].shape[0] // 2
    out = dict(batch)
    for key in ("tokens", "labels"):
        x = batch[key].clone()
        x[half:] = vocab - 1 - x[half:]
        out[key] = x
    out["mask"] = batch["mask"].clone()
    out["mask"][half:] *= 1.0 / 16
    return out


def _record_scales(fn):
    """(``fn()``, every quantizer scale it takes, in call order: each
    ``potq.pot_quantize``'s beta and each G's (``ops._g_scalars``))."""
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
        out = fn()
    finally:
        potq.pot_quantize, ops._g_scalars = pq, gs
    return out, seen


def _train(rank, arch):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    cfg = TC.smoke_config(arch)
    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh((2, 1), ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    dp_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    dp = dp_step.data_parallel
    whole = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    shards = dp.shard(whole)
    batches = [_skewed(pipeline.make_batch(cfg, shape, s, device="cpu"), cfg.vocab)
               for s in range(STEPS)]
    rows = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
    (_, g), dp_scales = _record_scales(lambda: dp_step.grads(shards, batches[0]))
    (_, g1), one_scales = _record_scales(lambda: one_step.grads(whole, batches[0]))
    res = {"token_losses": (dp_step.token_losses(shards, batches[0]).numpy(),
                            one_step.token_losses(whole, batches[0])[rows].numpy()),
           "scales": (dp_scales, one_scales),
           "split": sorted(n for (n, x), (_, y) in zip(spec.named_leaves(shards),
                                                       spec.named_leaves(whole))
                           if x.shape != y.shape)}
    g = dp.gather(dp.reduce(g))
    res["grads"] = {n: (float((x - y).abs().max()), float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g), spec.named_leaves(g1))}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for s in range(STEPS):
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
        return losses

    # the updates run in place: each run starts from its own copy
    res["dp_losses"] = run(dp_step, dp.shard(spec.tree_map(torch.clone, whole)))
    res["one_losses"] = run(one_step, spec.tree_map(torch.clone, whole))
    cli = ["--arch", arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
           "--steps", "2", "--log-every", "1", "--device", "cpu"]
    res["cli_dp"] = [r["loss"] for r in train_cli.main(cli + ["--mesh", "2x1"]).records]
    res["cli_one"] = [r["loss"] for r in train_cli.main(cli).records]
    return res


def _unit(rank, arch):
    """The family's model-axis hook on (1, 2) against the whole product,
    on this rank's cut of random inputs: mamba2's SSD over this rank's
    heads placed among zeros of the whole head count; recurrentgemma's
    gates, this rank's columns over the gathered conv output."""
    from repro_torch import configs as TC
    from repro_torch.core import mfmac
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import recurrent, ssm
    from repro_torch.parallel import actshard

    cfg = cfg_of(TC, arch, "wide")
    plan = _plan(cfg, (1, 2))
    gen = torch.Generator().manual_seed(11)
    if arch == "mamba2-2.7b":
        h, p, n, s = 8, ssm.HEADDIM, cfg.ssm_state, 16
        x, dt = torch.randn((1, s, h, p), generator=gen), torch.randn((1, s, h), generator=gen)
        a_log, d = torch.randn((h,), generator=gen), torch.randn((h,), generator=gen)
        b, c = torch.randn((1, s, n), generator=gen), torch.randn((1, s, n), generator=gen)
        y, fin = ssm._ssd_chunked(x, dt, a_log, b, c, d, 8, with_final=True)
        mine = slice(rank * h // 2, (rank + 1) * h // 2)
        with actshard.use_plan(plan):
            yr, fr = ssm._ssd_heads_whole(x[:, :, mine], dt[:, :, mine], a_log[mine], b, c,
                                          d[mine], 8)
        return dict(equal=bool(torch.equal(yr, y[:, :, mine]) and torch.equal(fr, fin[:, mine])),
                    shapes=(tuple(yr.shape), tuple(fr.shape)))
    lw = cfg.lru_width
    conv = torch.randn((2, 3, lw), generator=gen)
    # serving's weights: quantized whole, then cut
    p = {k: {"w": mfmac._quantize_w(torch.randn((lw, lw), generator=gen) * 0.05,
                                    PAPER_FAITHFUL),
             "gamma": torch.full((), 0.95)} for k in ("wa", "wi")}
    pol = dataclasses.replace(PAPER_FAITHFUL, per_sample_act_scales=True,
                              weights_prequantized=True)
    whole = recurrent._gates(pol, p, conv)
    mine = slice(rank * lw // 2, (rank + 1) * lw // 2)
    mp = {k: {"w": v["w"][:, mine].contiguous(), "gamma": v["gamma"]} for k, v in p.items()}
    with actshard.use_plan(plan):
        got = recurrent._gates(pol, mp, conv[..., mine].contiguous())
    return dict(equal=all(torch.equal(a, b[..., mine]) for a, b in zip(got, whole)),
                shapes=tuple(tuple(a.shape) for a in got))


def rank_cases(rank, arch, weights):
    """Everything one rank computes for ``arch``."""
    from repro_torch import configs as TC
    from repro_torch.models import spec
    from repro_torch.parallel.smoke import run_smoke

    torch.set_num_threads(1)
    res = {}
    for name in CONFIGS[arch]:
        cfg = cfg_of(TC, arch, name)
        params = spec.params_from_numpy(weights[name], "cpu")
        reqs = requests(cfg, arch)
        if rank == 0:
            res[(name, "single")] = _serve(cfg, params, None, reqs)
        for mid, mesh in MESHES.items():
            res[(name, mid)] = _serve(cfg, params, mesh, reqs)
    params = spec.params_from_numpy(weights["smoke"], "cpu")
    for mid, mesh in MESHES.items():
        res[("smoke_cli", mid)] = run_smoke(arch, mesh=mesh, params=params, device="cpu")
    res["train"] = _train(rank, arch)
    res["unit"] = _unit(rank, arch)
    return res


# ---------------------------------------------------------------------------
# The parent's side: the reference
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def ref_weights(arch, name):
    """(reference cfg, its seed-0 params, the params as /-named numpy)."""
    if (arch, name) not in _WEIGHTS:
        import jax

        from repro import configs as C
        from repro.ckpt.manager import _flatten_with_names
        from repro.models import registry as jreg, spec as jspec

        cfg = cfg_of(C, arch, name)
        params = jspec.materialize(jreg.param_specs(cfg), jax.random.PRNGKey(0))
        _WEIGHTS[(arch, name)] = (cfg, params, {k: np.asarray(v) for k, v in
                                                _flatten_with_names(params)[0].items()})
    return _WEIGHTS[(arch, name)]


def spawn_world(arch):
    from repro_torch.parallel import collectives

    weights = {name: ref_weights(arch, name)[2] for name in CONFIGS[arch]}
    return collectives.spawn(rank_cases, 2, arch, weights, device="cpu", threads=1)


_REF = {}


def reference(arch, name, reqs):
    """The reference's single-device PoolEngine tokens and counters on
    ``reqs`` (the port's requests: the same numpy arrays), on the weights
    of config ``name`` (``smoke_cli``: the smoke config's, two slots of
    ``parallel.smoke.MAX_LEN``)."""
    key = (arch, name)
    if key not in _REF:
        from repro.core.policy import PAPER_FAITHFUL as J_PF
        from repro.serve import PoolEngine as JPoolEngine
        from repro.serve.scheduler import Request as JRequest
        from repro_torch.parallel import smoke

        jcfg, params, _ = ref_weights(arch, "smoke" if name == "smoke_cli" else name)
        max_len = smoke.MAX_LEN if name == "smoke_cli" else MAX_LEN
        eng = JPoolEngine(jcfg, J_PF, params, max_slots=SLOTS, max_len=max_len)
        out = eng.run([JRequest(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                                arrival=r.arrival) for r in reqs])
        st = eng.last_stats
        _REF[key] = ({str(k): np.asarray(v).tolist() for k, v in out.items()},
                     {f: getattr(st, f) for f in STAT_FIELDS})
    return _REF[key]


def expected_shard(plan, name, whole_leaf):
    """This model rank's cut of a whole serving leaf (numpy), by the layout's
    rule stated independently of the planner: an ssm's in_proj takes its
    heads' z, x and dt columns and B and C whole, its conv its heads' x
    channels and B and C; every other split leaf an even contiguous
    share along its split dim."""
    cfg, lay = plan.cfg, plan.layout()
    r, m = plan.mesh.coord("model"), plan.model_shards
    dim = plan.model_split_dim(name)
    if dim is None:
        return whole_leaf
    if cfg.family == "ssm" and name in ("layers/in_proj/w", "layers/conv_w", "layers/conv_b"):
        di, n, hl = cfg.d_inner, cfg.ssm_state, lay.heads_local
        dil = hl * 64
        idx = list(range(r * dil, (r + 1) * dil))
        if name == "layers/in_proj/w":
            idx += list(range(di + r * dil, di + (r + 1) * dil))
            idx += list(range(2 * di, 2 * di + 2 * n))
            idx += list(range(2 * di + 2 * n + r * hl, 2 * di + 2 * n + (r + 1) * hl))
        else:
            idx += list(range(di, di + 2 * n))
        return np.take(whole_leaf, idx, axis=dim)
    size = whole_leaf.shape[dim] // m
    return np.take(whole_leaf, range(r * size, (r + 1) * size), axis=dim)
