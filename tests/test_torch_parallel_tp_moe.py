"""Tensor-parallel training of repro_torch's MoE decoder over gloo ranks on
the CPU: llama4-scout-17b-a16e's and grok-1-314b's smoke configs under EP
(2 of their 4 experts a rank; one K/V head for 4 q heads, so ``select``
is met too), a 3-expert grok-1 (``grok3``) under TP experts (gate's hidden
width split, the down projection over the gathered hidden state) and its
widening to whole 128-chunks a rank (``grok3_chunked``: d_ff 256, so each
expert's dA chains K2 across the ranks), on the (1, 2) and (2, 2) (data,
model) meshes against one rank at the same global batch, under
``PAPER_FAITHFUL``, from the reference's seed-0 parameters and batches.

The (1, 2) world steps a 4 x 16 batch (one dispatch group); the (2, 2)
one a 4 x 256 batch, so that each data rank holds whole 512-token groups
(a MoE batch may not straddle them).

What must hold, and why:

* the first step's per-token losses are one rank's bit for bit;
* every quantizer scale of the step equals one rank's: the ones outside
  the experts call by call; the experts' (their shadow, activation and G
  scales) per expert, the EP ranks' together being one rank's;
* on (1, 2) each gradient leaf's shard is one rank's slice bit for bit,
  the router's and every gamma's included, and every expert's dgamma
  (before the layer's fold) is one rank's: under EP each rank's experts'
  dgammas in turn, under TP every expert's on each rank;
* on (2, 2) a gradient is also a sum over the data ranks of partial MAC
  folds: within ``1e-4`` of the leaf's largest magnitude; the losses of
  3 AdamW steps within ``1e-5`` relative on both meshes;
* the experts' backward chains K2 across the ranks only where a shard is
  whole 128-chunks (``grok3_chunked``), and an EP layer selects from the
  owners three times a step (its forward, the recomputation, the
  dispatch's backward);
* an EP rank's shadow quantizes its experts on their shard: bit for bit
  the whole leaf's quantized shard;
* the gathered gradients agree with the reference's ``jax.grad`` of
  ``registry.loss_fn`` within ``1e-4`` of each leaf's largest magnitude
  (a top-1 router's, whose exact gradient is zero, of the tree's);
* ``launch.train --mesh 1x2`` trains and checkpoints whole, the
  checkpoint restoring in one rank of the port's CLI and in the
  reference's manager bit for bit; ``--mesh 2x2`` trains.

The worlds run once per module; the tests read what they returned.
"""
import collections
import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

STEPS = 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LLAMA4, GROK = "llama4-scout-17b-a16e", "grok-1-314b"
# name -> (arch, expert count, d_ff)
CASES = {"llama4": (LLAMA4, None, None), "grok": (GROK, None, None),
         "grok3": (GROK, 3, None), "grok3_chunked": (GROK, 3, 256)}
EP_CASES = ("llama4", "grok")
MESHES = [(1, 2), (2, 2)]
# (batch, seq) of each mesh's steps
BATCHES = {(1, 2): (4, 16), (2, 2): (4, 256)}
CLI_ARCHS = (LLAMA4, GROK)


def _cli(arch, mesh):
    b, s = BATCHES[mesh]
    return ["--arch", arch, "--smoke", "--batch", str(b), "--seq", str(s), "--log-every", "1",
            "--device", "cpu"]


def _config(pkg, case):
    arch, experts, d_ff = CASES[case]
    cfg = pkg.smoke_config(arch)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg if d_ff is None else dataclasses.replace(cfg, d_ff=d_ff)


def _record(fn):
    """(``fn()``, every quantizer scale it takes in call order, tagged
    whether an expert took it, and each expert linear backward's
    per-expert dgammas).  A scale is the beta of each
    ``potq.pot_quantize`` and of each G (``ops._g_scalars``); the experts'
    are those of their shadow (4-D leaves), their forward and their
    backward."""
    from repro_torch.core import mfmac, potq
    from repro_torch.kernels import ops
    from repro_torch.train import step

    seen, dgammas, inside = [], [], [False]
    saved = (potq.pot_quantize, ops._g_scalars, step._quantize_leaf,
             mfmac._MFExpertLinear.__dict__["forward"], ops.potq_expert_grad_matmuls,
             mfmac._expert_column_grads)
    pq, gs, leaf, fwd, ep_grads, tp_grads = saved
    fwd = fwd.__func__

    def tagged(f, record=False):
        def run(*a, **kw):
            inside[0] = True
            try:
                out = f(*a, **kw)
            finally:
                inside[0] = False
            if record and out[2] is not None:
                dgammas.append(out[2].tolist())
            return out
        return run

    def pot_quantize(f, bits, beta=None, **kw):
        seen.append(("w/a", inside[0], None if beta is None else beta.flatten().tolist()))
        return pq(f, bits, beta, **kw)

    def g_scalars(g, bits_g, beta_g, clip_t):
        seen.append(("g", inside[0], beta_g.flatten().tolist()))
        return gs(g, bits_g, beta_g, clip_t)

    def quantize_leaf(x, policy):
        return tagged(leaf)(x, policy) if x.dim() == 4 else leaf(x, policy)

    potq.pot_quantize, ops._g_scalars, step._quantize_leaf = pot_quantize, g_scalars, quantize_leaf
    mfmac._MFExpertLinear.forward = staticmethod(tagged(fwd))
    ops.potq_expert_grad_matmuls = tagged(ep_grads, True)
    mfmac._expert_column_grads = tagged(tp_grads, True)
    try:
        out = fn()
    finally:
        (potq.pot_quantize, ops._g_scalars, step._quantize_leaf, mfmac._MFExpertLinear.forward,
         ops.potq_expert_grad_matmuls, mfmac._expert_column_grads) = saved
    return out, seen, dgammas


def _case(mesh, cfg, params_np, batches_np):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import step as step_lib

    b, s = BATCHES[mesh]
    shape = TC.ShapeConfig("t", s, b, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    tp_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    sharded = tp_step.data_parallel
    whole = spec.params_from_numpy(params_np, "cpu")
    shards = sharded.shard(whole)
    batches = [{k: torch.from_numpy(v) for k, v in x.items()} for x in batches_np]
    d = plan.mesh.coord("data")
    rows = slice(d * b // mesh[0], (d + 1) * b // mesh[0])
    res = {"experts": plan.layout().experts}
    res["token_losses"] = (tp_step.token_losses(shards, batches[0]).numpy(),
                           one_step.token_losses(whole, batches[0])[rows].numpy())
    collectives.reset_stats()
    (_, g), scales, dgammas = _record(lambda: tp_step.grads(shards, batches[0]))
    res["stats"] = dict(collectives.stats)
    (_, g1), one_scales, one_dgammas = _record(lambda: one_step.grads(whole, batches[0]))
    res["scales"] = (scales, one_scales)
    res["dgammas"] = (dgammas, one_dgammas)
    g = sharded.reduce(g)
    res["grads"] = {n: (bool(torch.equal(x, y)), float((x - y).abs().max()),
                        float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g),
                                              spec.named_leaves(sharded.shard(g1)))}
    res["whole_grads"] = {n: x.numpy() for n, x in spec.named_leaves(sharded.gather(g))}
    # the shadow's experts: quantized on this rank's shard, against the
    # whole leaf quantized and cut (over the data ranks, gathered whole)
    inputs = dict(spec.named_leaves(sharded.inputs(shards, PAPER_FAITHFUL)))
    res["shadow"] = {
        n: bool(torch.equal(inputs[n], plan.shard_leaf(n, step_lib._quantize_leaf(x, PAPER_FAITHFUL))))
        for n, x in spec.named_leaves(whole) if n.startswith("layers/moe/") and x.dim() == 4}
    res["split"] = {n: plan.model_split_dim(n) for n, _ in spec.named_leaves(shards)}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for i in range(STEPS):
            params, state, m = step_fn(params, state, batches[i], i)
            losses.append(float(m["loss"]))
        return losses

    # fresh parameters for each run: the updates are in place
    res["tp_losses"] = run(tp_step, sharded.shard(spec.params_from_numpy(params_np, "cpu")))
    res["one_losses"] = run(one_step, spec.params_from_numpy(params_np, "cpu"))
    return res


def _rank_cases(rank, mesh, inputs, ckdirs):
    from repro_torch import configs as TC
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    torch.set_num_threads(1)
    out = {c: _case(mesh, _config(TC, c), *inputs[c]) for c in CASES}
    for arch in CLI_ARCHS:
        argv = _cli(arch, mesh) + ["--steps", "2", "--mesh", f"{mesh[0]}x{mesh[1]}"]
        if ckdirs:
            argv += ["--ckpt-dir", ckdirs[arch], "--ckpt-every", "100"]
        run = train_cli.main(argv)
        out[arch] = {"cli_losses": [r["loss"] for r in run.records]}
        if ckdirs:
            out[arch]["cli_final"] = {
                n: x.numpy() for n, x in
                spec.named_leaves(run.step_fn.data_parallel.gather(run.params))}
    return out


def _reference_inputs(case, mesh):
    """The reference's seed-0 parameters and its batches at ``mesh``'s
    batch size."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.data import pipeline as jpipeline
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, case)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    b, s = BATCHES[mesh]
    shape = JC.ShapeConfig("t", s, b, "train")
    kinds = {"tokens": np.int64, "labels": np.int64}
    batches = [{k: np.array(v).astype(kinds.get(k, np.float32))
                for k, v in jpipeline.make_batch(jcfg, shape, i).items()}
               for i in range(STEPS)]
    return {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}, batches


def _reference_grads(case, params, batch):
    """The reference's gradients at ``batch`` (``jax.grad`` of
    ``registry.loss_fn``), by name."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.core.policy import PAPER_FAITHFUL as J_PF
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, case)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    grads = jax.jit(jax.grad(lambda p: jreg.loss_fn(jcfg, J_PF, p, batch)))(jp)
    return {k: np.asarray(v) for k, v in _flatten_with_names(grads)[0].items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The (1, 2) and (2, 2) worlds' results, the CLI's checkpoint
    directories and the reference's gradients at the (1, 2) batch, which
    this process computes while the worlds run."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.parallel import collectives

    inputs = {m: {c: _reference_inputs(c, m) for c in CASES} for m in MESHES}
    ckdirs = {a: str(tmp_path_factory.mktemp("tp_moe_ckpt")) for a in CLI_ARCHS}

    def run():
        return {(1, 2): collectives.spawn(_rank_cases, 2, (1, 2), inputs[(1, 2)], ckdirs,
                                          device="cpu", threads=1),
                (2, 2): collectives.spawn(_rank_cases, 4, (2, 2), inputs[(2, 2)], None,
                                          device="cpu", threads=1)}

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run)
        grads = {c: _reference_grads(c, inputs[(1, 2)][c][0], inputs[(1, 2)][c][1][0])
                 for c in CASES}
        return ranks.result(), ckdirs, grads


def _model_ranks(ranks):
    """The results of data rank 0's model ranks (a (D, 2) mesh in row-major
    rank order)."""
    return ranks[:2]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_first_step_token_losses_bit_for_bit(worlds, mesh, case):
    for res in worlds[0][mesh]:
        ours, one = res[case]["token_losses"]
        assert ours.shape == one.shape and ours.shape[0] == BATCHES[mesh][0] // mesh[0]
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_quantizer_scales_equal_one_rank(worlds, mesh, case):
    """Outside the experts call by call; the experts' scales as a multiset
    of (kind, beta) over the model ranks that hold them: under EP the two
    ranks' together, under TP each rank's, are one rank's."""
    def experts(seen):
        return collections.Counter((k, b) for k, tag, betas in seen if tag for b in betas)

    ranks = _model_ranks(worlds[0][mesh])
    for res in ranks:
        ours, one = res[case]["scales"]
        assert [(k, b) for k, tag, b in ours if not tag] == [(k, b) for k, tag, b in one
                                                              if not tag]
        assert [k for k, _, _ in ours].count("g") > 0 and experts(one)
    got = [experts(res[case]["scales"][0]) for res in ranks]
    want = experts(ranks[0][case]["scales"][1])
    if case in EP_CASES:
        assert got[0] + got[1] == want
    else:
        assert got[0] == got[1] == want


@pytest.mark.parametrize("case", CASES)
def test_one_data_rank_gradients_bit_for_bit(worlds, case):
    """Every leaf's shard, the router's and every gamma's included."""
    for res in worlds[0][(1, 2)]:
        assert {"layers/moe/router/w", "layers/moe/gate/gamma"} <= set(res[case]["grads"])
        bad = {n: v for n, v in res[case]["grads"].items() if not v[0]}
        assert not bad, bad


@pytest.mark.parametrize("case", CASES)
def test_expert_dgammas_equal_one_rank(worlds, case):
    """Each expert linear's per-expert dgammas (before the layer's fold):
    under EP rank 0's experts then rank 1's are one rank's, under TP each
    rank's are."""
    ranks = worlds[0][(1, 2)]
    mine = [res[case]["dgammas"][0] for res in ranks]
    one = ranks[0][case]["dgammas"][1]
    assert one and all(len(m) == len(one) for m in mine)
    for i, want in enumerate(one):
        got = mine[0][i] + mine[1][i] if case in EP_CASES else mine[0][i]
        assert np.array(got, np.float32).view(np.uint32).tolist() == \
            np.array(want, np.float32).view(np.uint32).tolist()
        if case not in EP_CASES:
            assert mine[1][i] == mine[0][i]


@pytest.mark.parametrize("case", CASES)
def test_two_data_rank_gradients_within_bound(worlds, case):
    for res in worlds[0][(2, 2)]:
        for name, (_, diff, top) in res[case]["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_three_step_losses_within_bound(worlds, mesh, case):
    ranks = worlds[0][mesh]
    for res in ranks:
        np.testing.assert_allclose(res[case]["tp_losses"], res[case]["one_losses"],
                                   rtol=LOSS_RTOL)
        assert res[case]["tp_losses"] == ranks[0][case]["tp_losses"]


@pytest.mark.parametrize("case", CASES)
def test_layout_chains_and_selects(worlds, case):
    """EP splits the experts (dim 1 of gate, up and down), TP gate's and
    up's hidden width (dim 3), down whole; the router and every gamma
    whole.  One K2 chain a layer (gelu: gate only) where a TP shard is
    whole 128-chunks, none elsewhere (the smoke widths gather; the
    attention's 16-wide heads and the 160-row vocab shard too); three
    owner selections a layer under EP."""
    cfg_layers = 2
    for res in worlds[0][(1, 2)]:
        r = res[case]
        split = r["split"]
        assert split["layers/moe/router/w"] is None
        assert not any(d is not None for n, d in split.items() if n.endswith("gamma"))
        if case in EP_CASES:
            assert r["experts"] == "EP"
            assert [split[f"layers/moe/{m}/w"] for m in ("gate", "up", "down")] == [1, 1, 1]
        else:
            assert r["experts"] == "TP"
            assert [split[f"layers/moe/{m}/w"] for m in ("gate", "up", "down")] == [3, 3, None]
        chains = cfg_layers if case == "grok3_chunked" else 0
        selects = 3 * cfg_layers if case in EP_CASES else 0
        assert (r["stats"]["folds"], r["stats"]["bwd_folds"], r["stats"]["selects"]) == \
            (0, chains, selects)


@pytest.mark.parametrize("case", EP_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_ep_shadow_quantized_on_shard_bit_for_bit(worlds, mesh, case):
    for res in worlds[0][mesh]:
        shadow = res[case]["shadow"]
        assert set(shadow) == {f"layers/moe/{m}/w" for m in ("gate", "up", "down")}
        assert all(shadow.values()), shadow


@pytest.mark.parametrize("case", CASES)
def test_gradients_vs_reference_jax_grad(worlds, case):
    jgrads = worlds[2][case]
    top = max(float(np.abs(v).max()) for v in jgrads.values())
    for res in worlds[0][(1, 2)]:
        for name, g in res[case]["whole_grads"].items():
            ref = jgrads[name]
            err = np.abs(g - ref).max()
            if case == "llama4" and "/router/" in name:  # top-1: g / g, noise in both
                assert err <= GRAD_TOL * top, (name, err)
            else:
                assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_two_by_two_cli_trains(worlds, arch):
    ranks = worlds[0][(2, 2)]
    losses = ranks[0][arch]["cli_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(res[arch]["cli_losses"] == losses for res in ranks)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_model_axis_checkpoint_restores_in_one_rank_and_reference(worlds, arch, capsys):
    """The (1, 2) CLI run's checkpoint (step 2): the port's one-rank CLI
    restores it and runs on; the reference's manager restores the same
    values bit for bit."""
    import jax

    from repro import configs as C
    from repro.ckpt.manager import CheckpointManager as JCheckpointManager
    from repro.ckpt.manager import _flatten_with_names
    from repro.models import registry as jreg, spec as jspec
    from repro.optim import optimizers as joptim
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    ranks, ckdir = worlds[0][(1, 2)], worlds[1][arch]
    assert ranks[0][arch]["cli_losses"] == ranks[1][arch]["cli_losses"]
    final = ranks[0][arch]["cli_final"]
    run = train_cli.main(_cli(arch, (1, 2)) + ["--steps", "3", "--ckpt-dir", ckdir,
                                               "--ckpt-every", "100"])
    assert "restoring checkpoint step 2" in capsys.readouterr().out
    assert run.start_step == 2 and len(run.records) == 1
    two = CheckpointManager(ckdir).restore(
        2, {"params": spec.params_from_numpy(final, "cpu")})["params"]
    for name, x in spec.named_leaves(two):
        assert x.numpy().view(np.uint32).tolist() == final[name].view(np.uint32).tolist()
    jcfg = C.smoke_config(arch)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    jopt = joptim.adamw(joptim.warmup_cosine_schedule(3e-3, 20, 3))
    jtwo = JCheckpointManager(ckdir).restore(2, {"params": jp, "opt_state": jopt.init(jp)})
    for name, x in _flatten_with_names(jtwo["params"])[0].items():
        assert np.asarray(x).view(np.uint32).tolist() == final[name].view(
            np.uint32).tolist(), name
