"""Tensor-parallel training of repro_torch's vlm and encoder-decoder over
gloo ranks on the CPU: internvl2-76b's and whisper-large-v3's smoke
configs on the (1, 2) and (2, 2) (data, model) meshes against one rank
at the same global batch (4 x 16), under ``PAPER_FAITHFUL``, from the
reference's seed-0 parameters and batches (patch embeddings, frames).

Two widths of each smoke config run in each world:

* ``smoke``: the config as it is.  Its shards are narrower than one
  128-chunk, so the row-parallel products run over their gathered input
  and a column-parallel linear's dA over G and Wq gathered whole
  (``core/mfmac.py``).  The vlm's one K/V head for 4 q heads is selected
  from a whole product on each rank (``kv == 'select'``);
* ``chunked``: 4 heads of 64 and d_ff 256 (the vlm's vocabulary padded to
  512, its one K/V head kept), so every shard is whole 128-chunks a
  rank: ``wo``, ``co``, ``wo2`` and the down projection fold across the
  ranks (K1's ``start``), every column-parallel dA chains K2 across them
  (q, the split K/V and cross K/V heads, ``wi``, the vlm's gate, up and
  vocab head), and the vlm's ``select`` meets a K2 chain on wq.

Under ``select`` every rank attends with the whole q over the whole K and
V (``transformer._heads_whole``), so wk and wv take one rank's gradient
on every rank.  The encdec's encoder output gathers the cross K/V chains
of every decoder layer and stays replicated; ``frame_proj``,
``enc_pos``, ``patch_proj``, the norms and the tied embedding stay whole
on every model rank.

What must hold, and why:

* the first step's per-token losses are one rank's bit for bit, and
  every quantizer scale of the step equals one rank's, call by call;
* on (1, 2) each gradient leaf's shard is one rank's slice bit for bit;
* on (2, 2) a gradient is also a sum over the data ranks of partial MAC
  folds: within ``1e-4`` of the leaf's largest magnitude; the losses of
  3 AdamW steps within ``1e-5`` relative on both meshes;
* the forward's folds and the backward's chains run where the shards are
  whole 128-chunks, none at the smoke width;
* the gathered gradients agree with the reference's ``jax.grad`` of
  ``registry.loss_fn`` within ``1e-4`` of each leaf's largest magnitude;
* ``launch.train --mesh 1x2`` trains and checkpoints whole, the
  checkpoint restoring in one rank of the port's CLI and in the
  reference's manager bit for bit; ``--mesh 2x2`` trains;
* whisper's smoke config with one K/V head (its self and cross attention
  under ``select``) on (1, 2) is one rank's bit for bit.

The worlds run once per module; the tests read what they returned.
"""
import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:  # the ranks never import it
    pytest.skip("the reference needs jax", allow_module_level=True)

BATCH, SEQ, STEPS = 4, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
VLM, ENCDEC = "internvl2-76b", "whisper-large-v3"
ARCHS = (VLM, ENCDEC)
WIDTHS = ("smoke", "chunked")
CASES = [(a, w) for a in ARCHS for w in WIDTHS]
CHUNKED = {VLM: dict(n_heads=4, kv_heads=1, head_dim=64, d_ff=256, vocab_pad_multiple=256),
           ENCDEC: dict(n_heads=4, kv_heads=4, head_dim=64, d_ff=256)}
MESHES = [(1, 2), (2, 2)]


def _cli(arch):
    return ["--arch", arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
            "--log-every", "1", "--device", "cpu"]


def _config(pkg, arch, width):
    cfg = pkg.smoke_config(arch)
    return dataclasses.replace(cfg, **CHUNKED[arch]) if width == "chunked" else cfg


def _record_scales(fn):
    """Every quantizer scale ``fn`` takes, in call order (the beta of each
    ``potq.pot_quantize`` and of each G, ``ops._g_scalars``), and what
    ``fn`` returned."""
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
    return seen, out


def _case(mesh, cfg, params_np, batches_np):
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.models import spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import collectives, meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    tp_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one_step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    sharded = tp_step.data_parallel
    whole = spec.params_from_numpy(params_np, "cpu")
    shards = sharded.shard(whole)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches_np]
    d = plan.mesh.coord("data")
    rows = slice(d * BATCH // mesh[0], (d + 1) * BATCH // mesh[0])
    res = {"kv": plan.layout().kv}
    res["token_losses"] = (tp_step.token_losses(shards, batches[0]).numpy(),
                           one_step.token_losses(whole, batches[0])[rows].numpy())
    collectives.reset_stats()
    scales, (_, g) = _record_scales(lambda: tp_step.grads(shards, batches[0]))
    res["stats"] = dict(collectives.stats)
    one_scales, (_, g1) = _record_scales(lambda: one_step.grads(whole, batches[0]))
    res["scales"] = (scales, one_scales)
    g = sharded.reduce(g)
    res["grads"] = {n: (bool(torch.equal(x, y)), float((x - y).abs().max()),
                        float(y.abs().max()))
                    for (n, x), (_, y) in zip(spec.named_leaves(g),
                                              spec.named_leaves(sharded.shard(g1)))}
    res["whole_grads"] = {n: x.numpy() for n, x in spec.named_leaves(sharded.gather(g))}
    res["split"] = {n for n, _ in spec.named_leaves(shards)
                    if plan.model_split_dim(n) is not None}

    def run(step_fn, params):
        state = opt.init(params)
        losses = []
        for s in range(STEPS):
            params, state, m = step_fn(params, state, batches[s], s)
            losses.append(float(m["loss"]))
        return losses

    # fresh parameters for each run: the updates are in place
    res["tp_losses"] = run(tp_step, sharded.shard(spec.params_from_numpy(params_np, "cpu")))
    res["one_losses"] = run(one_step, spec.params_from_numpy(params_np, "cpu"))
    return res


def _select_case(mesh, cfg):
    """``cfg`` (K/V heads selected from a whole product) on ``mesh`` against
    one rank, from the port's seed-0 draw: the layout, both losses, the
    per-token losses equal, the gradient leaves whose shard differs."""
    from repro_torch import configs as TC
    from repro_torch.core.policy import PAPER_FAITHFUL
    from repro_torch.data import pipeline
    from repro_torch.models import registry, spec
    from repro_torch.optim import adamw, warmup_cosine_schedule
    from repro_torch.parallel import meshes, planner
    from repro_torch.train import TrainConfig, make_train_step

    shape = TC.ShapeConfig("t", SEQ, BATCH, "train")
    plan = planner.plan_for(cfg, meshes.make_mesh(mesh, ("data", "model")), shape)
    opt = adamw(warmup_cosine_schedule(3e-3, 20, STEPS))
    step = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig(), plan=plan)
    one = make_train_step(cfg, PAPER_FAITHFUL, opt, TrainConfig())
    whole = spec.materialize(registry.param_specs(cfg), torch.Generator().manual_seed(0))
    params = step.data_parallel.shard(whole)
    batch = pipeline.make_batch(cfg, shape, 0, device="cpu")
    loss, g = step.grads(params, batch)
    loss1, g1 = one.grads(whole, batch)
    return dict(kv=plan.layout().kv, loss=(float(loss), float(loss1)),
                token_losses=bool(torch.equal(step.token_losses(params, batch),
                                              one.token_losses(whole, batch))),
                differ=[n for (n, x), (_, y) in zip(
                    spec.named_leaves(g), spec.named_leaves(step.data_parallel.shard(g1)))
                    if not torch.equal(x, y)])


def _rank_cases(rank, mesh, cases, ckdirs):
    from repro_torch import configs as TC
    from repro_torch.launch import train as train_cli
    from repro_torch.models import spec

    torch.set_num_threads(1)
    out = {c: _case(mesh, _config(TC, *c), *cases[c]) for c in CASES}
    if mesh == (1, 2):  # the encdec's self and cross attention under `select`
        out["encdec_select"] = _select_case(
            mesh, dataclasses.replace(TC.smoke_config(ENCDEC), kv_heads=1))
    for arch in ARCHS:
        argv = _cli(arch) + ["--steps", "2", "--mesh", f"{mesh[0]}x{mesh[1]}"]
        if ckdirs:
            argv += ["--ckpt-dir", ckdirs[arch], "--ckpt-every", "100"]
        run = train_cli.main(argv)
        out[arch] = {"cli_losses": [r["loss"] for r in run.records]}
        if ckdirs:
            out[arch]["cli_final"] = {
                n: x.numpy() for n, x in
                spec.named_leaves(run.step_fn.data_parallel.gather(run.params))}
    return out


def _reference_inputs(arch, width):
    """The reference's seed-0 parameters and its batches."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.data import pipeline as jpipeline
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, arch, width)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    shape = JC.ShapeConfig("t", SEQ, BATCH, "train")
    kinds = {"tokens": np.int64, "labels": np.int64}
    batches = [{k: np.array(v).astype(kinds.get(k, np.float32))
                for k, v in jpipeline.make_batch(jcfg, shape, s).items()}
               for s in range(STEPS)]
    return {k: np.asarray(v) for k, v in _flatten_with_names(jp)[0].items()}, batches


def _reference_grads(arch, width, params, batch):
    """The reference's gradients at ``batch`` (``jax.grad`` of
    ``registry.loss_fn``), by name."""
    import jax

    from repro import configs as JC
    from repro.ckpt.manager import _flatten_with_names
    from repro.core.policy import PAPER_FAITHFUL as J_PF
    from repro.models import registry as jreg
    from repro.models import spec as jspec

    jcfg = _config(JC, arch, width)
    jp = jspec.materialize(jreg.param_specs(jcfg), jax.random.PRNGKey(0))
    grads = jax.jit(jax.grad(lambda p: jreg.loss_fn(jcfg, J_PF, p, batch)))(jp)
    return {k: np.asarray(v) for k, v in _flatten_with_names(grads)[0].items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The (1, 2) and (2, 2) worlds' results, the CLI's checkpoint
    directories and the reference's gradients, which this process computes
    while the worlds run."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.parallel import collectives

    cases = {c: _reference_inputs(*c) for c in CASES}
    ckdirs = {a: str(tmp_path_factory.mktemp("tp_families_ckpt")) for a in ARCHS}

    def run():
        return {(1, 2): collectives.spawn(_rank_cases, 2, (1, 2), cases, ckdirs,
                                          device="cpu", threads=1),
                (2, 2): collectives.spawn(_rank_cases, 4, (2, 2), cases, None, device="cpu",
                                          threads=1)}

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run)
        grads = {c: _reference_grads(*c, cases[c][0], cases[c][1][0]) for c in CASES}
        return ranks.result(), ckdirs, grads


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("mesh", MESHES)
def test_first_step_token_losses_bit_for_bit(worlds, mesh, case):
    for res in worlds[0][mesh]:
        ours, one = res[case]["token_losses"]
        assert ours.shape == one.shape and ours.shape[0] == BATCH // mesh[0]
        assert ours.view(np.uint32).tolist() == one.view(np.uint32).tolist()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("mesh", MESHES)
def test_quantizer_scales_equal_one_rank(worlds, mesh, case):
    for res in worlds[0][mesh]:
        ours, one = res[case]["scales"]
        assert len(ours) == len(one) > 0
        assert [k for k, _ in ours].count("g") == [k for k, _ in one].count("g") > 0
        assert ours == one


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_one_data_rank_gradients_bit_for_bit(worlds, case):
    for res in worlds[0][(1, 2)]:
        bad = {n: v for n, v in res[case]["grads"].items() if not v[0]}
        assert not bad, bad


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_two_data_rank_gradients_within_bound(worlds, case):
    for res in worlds[0][(2, 2)]:
        for name, (_, diff, top) in res[case]["grads"].items():
            assert diff <= GRAD_TOL * max(top, 1e-30), (name, diff, top)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("mesh", MESHES)
def test_three_step_losses_within_bound(worlds, mesh, case):
    ranks = worlds[0][mesh]
    for res in ranks:
        np.testing.assert_allclose(res[case]["tp_losses"], res[case]["one_losses"],
                                   rtol=LOSS_RTOL)
        assert res[case]["tp_losses"] == ranks[0][case]["tp_losses"]


def _expected_chains(arch, width):
    """(forward folds, backward chains) of one step's grads at 2 layers
    (the encdec's 2 encoder layers too): each fold twice under remat;
    the column-parallel dA chains (q, the split K/V heads, the MLP's
    input products, the vocab-split head) and the row-parallel dgamma
    rows; none at the smoke width."""
    if width == "smoke":
        return 0, 0
    if arch == VLM:  # wo + down folds; wq, gate, up, wo, down a layer + the head
        return 2 * 2 * 2, 5 * 2 + 1
    # encoder: wo, wo2; decoder: wo, co, wo2 / encoder: wq, wk, wv, wi, wo,
    # wo2; decoder: wq, wk, wv, cq, ck, cv, wi, wo, co, wo2 (the tied head
    # is whole)
    return 2 * (2 * 2 + 3 * 2), 6 * 2 + 10 * 2


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_chains_run_where_shards_are_whole_chunks(worlds, case):
    want = _expected_chains(*case)
    for res in worlds[0][(1, 2)]:
        stats = res[case]["stats"]
        assert (stats["folds"], stats["bwd_folds"]) == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_layout_and_replicated_leaves(worlds, case):
    """The vlm selects its one K/V head (wk and wv whole on every rank),
    the encdec splits its 4; frame_proj, enc_pos, patch_proj, the norms
    and the tied embedding are whole on every model rank."""
    arch, _ = case
    for res in worlds[0][(1, 2)]:
        r = res[case]
        assert r["kv"] == ("select" if arch == VLM else "split")
        names = set(r["whole_grads"])
        whole = {n for n in names if n not in r["split"]}
        if arch == VLM:
            assert {"layers/wk/w", "layers/wv/w", "patch_proj/w"} <= whole
            assert {"layers/wq/w", "embed", "lm_head/w"} <= r["split"]
        else:
            assert {"frame_proj/w", "enc_pos", "embed"} <= whole
            for stack in ("enc_layers", "dec_layers"):
                assert {f"{stack}/wq/w", f"{stack}/wk/w", f"{stack}/wv/w",
                        f"{stack}/wi/w"} <= r["split"]
            assert {"dec_layers/cq/w", "dec_layers/ck/w", "dec_layers/cv/w"} <= r["split"]
        assert not any(n.endswith(("scale", "bias", "gamma")) for n in r["split"])


def test_encdec_select_kv_heads_bit_for_bit(worlds):
    """whisper's smoke config with one K/V head for its 4 q heads: its
    self and cross attention select K/V heads from a whole product, and
    on (1, 2) the loss, the per-token losses and every gradient leaf's
    shard (wk, wv, ck, cv whole on both ranks) are one rank's bit for
    bit."""
    for res in worlds[0][(1, 2)]:
        sel = res["encdec_select"]
        assert sel["kv"] == "select"
        assert sel["loss"][0] == sel["loss"][1]
        assert sel["token_losses"] and not sel["differ"], sel["differ"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_gradients_vs_reference_jax_grad(worlds, case):
    jgrads = worlds[2][case]
    for res in worlds[0][(1, 2)]:
        for name, g in res[case]["whole_grads"].items():
            ref = jgrads[name]
            err = np.abs(g - ref).max()
            assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_by_two_cli_trains(worlds, arch):
    ranks = worlds[0][(2, 2)]
    losses = ranks[0][arch]["cli_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(res[arch]["cli_losses"] == losses for res in ranks)


@pytest.mark.parametrize("arch", ARCHS)
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
    run = train_cli.main(_cli(arch) + ["--steps", "3", "--ckpt-dir", ckdir,
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
