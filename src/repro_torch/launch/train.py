"""Training CLI (port of ``repro/launch/train.py``): one device, or a
launched world as a (data, model) mesh (``--mesh DxM``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --steps 3 --batch 2 --seq 16 --device cpu --ckpt-dir /tmp/ckpt

Every arch the port registers trains through ``registry.loss_fn``, the
vlm (internvl2-76b, its batches with patch embeddings; ``--smoke`` on one
card), encdec (whisper-large-v3, with frames, at full width), ssm
(mamba2-2.7b) and hybrid (recurrentgemma-2b: tokens-only batches, a tuple
of per-layer parameter dicts; ``--smoke`` on one card) ones included.  Runs on the card by default (``--device cuda``); there is no
CPU fallback.
Parameters are drawn from seed 0 on the device, batches come from the
step-indexed synthetic pipeline, and the schedules are the reference's
(AdamW: warmup 20 then cosine; SGD: step decay).  On the card the run is
deterministic: two runs from the same state give the same bits.

Restart: with ``--ckpt-dir`` the run restores the newest checkpoint there
(if any) and continues from its step; kill it at any point and rerun the
same command (or one with more ``--steps``) to continue.  The rules are
the reference's (``repro/launch/train.py:125-157``), so the two packages'
checkpoints mean the same and restore into each other:

* after the update of step ``s``, when ``s and s % ckpt_every == 0``, the
  state is saved (in the background) labelled ``s`` — it holds ``s + 1``
  updates, and a restart from it runs step ``s`` again;
* at the end the state is saved, blocking, labelled ``--steps``, the
  number of updates it holds.

Sharded: ``--mesh DxM`` (default ``host``, one process) takes the
launched world of D*M ranks as a (data, model) grid: ``torchrun
--nproc-per-node 2 -m repro_torch.launch.train ... --mesh 2x1`` (or
``1x2``, ``2x2`` with 4), or ``main`` called on each rank of a world
started by ``parallel.collectives.spawn``.  The backend follows the
topology (``parallel/collectives.py``: NCCL with a card a rank, gloo when
ranks share a card or on the CPU).  Each rank draws the whole seed-0
parameters, keeps its shards (``train.step.DataParallel``) and steps on
its rows of the batch (the model ranks of one data group on the same
rows).  On (D, 1) every family trains so (a MoE batch's dispatch groups
must not straddle two ranks).  On a model axis M > 1 every family trains
tensor-parallel (``train/step.py``; ``--arch whisper-large-v3 --mesh
1x2`` or ``2x2``, ``--arch internvl2-76b --smoke --mesh 1x2`` or
``2x2``, their batches carrying frames or patch embeddings; ``--arch
llama4-scout-17b-a16e --smoke --mesh 1x2``, its experts under EP, or
``2x2`` with ``--batch 4 --seq 256``, whole dispatch groups a data rank;
``--arch mamba2-2.7b --smoke --mesh 1x2`` or ``2x2`` and
``recurrentgemma-2b`` the same); ``--microbatches`` > 1 is refused
there (ROADMAP item 9.4).  Checkpoints are gathered whole, a leaf at a
time over the data and model ranks (an ssm's packed in_proj and conv
placed by every rank's pieces), and written by rank 0 in the reference's
layout, so a checkpoint written by D*M ranks restores in one, and in
``repro.launch.train``; a restore reads the whole state on every rank
and keeps its shards.  Only rank 0 prints.

``--pallas`` and ``--autotune`` are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import configs as C
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import policy as policy_lib
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import registry, spec
from repro_torch.optim import (adamw, sgd_momentum, step_decay_schedule,
                               warmup_cosine_schedule)
from repro_torch.parallel import collectives, meshes, planner
from repro_torch.train import TrainConfig, make_train_step

# cuBLAS reads its workspace setting when its first handle is made, so it
# is fixed here, before any CUDA call, for make_deterministic's sake
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

POLICIES = {
    "paper": policy_lib.PAPER_FAITHFUL,
    "fp32": policy_lib.FP32_BASELINE,
    "no_wbc": policy_lib.ABLATION_NO_WBC,
    "no_prc": policy_lib.ABLATION_NO_PRC,
}


@dataclasses.dataclass
class TrainRun:
    """What a run leaves behind: its state (restored and trained), its
    step function, one record per step it ran (loss, grad_norm, seconds,
    tokens_per_s), the step it started from and its checkpoint manager."""

    cfg: ModelConfig
    shape: ShapeConfig
    step_fn: Any
    params: Dict
    opt_state: Dict
    records: List[Dict]
    start_step: int = 0
    ckpt: Optional[CheckpointManager] = None


def make_deterministic() -> None:
    """Run-to-run identical steps on the card: deterministic algorithms
    wherever PyTorch has a choice (e.g. index accumulation); an op that
    has none raises.  The fixed cuBLAS workspace is set at import."""
    torch.use_deterministic_algorithms(True)


def _world_plan(cfg, shape, mesh_arg: str, device: str):
    """The training plan over the launched world for ``--mesh DxM`` (the
    world joined from torchrun's environment when it is not up yet)."""
    d, m = meshes.parse_mesh(mesh_arg)
    if collectives.world_size() == 1 and d * m > 1:
        env = collectives.world_from_env()
        if env is None:
            raise RuntimeError(f"--mesh {mesh_arg} needs a launched world of {d * m} ranks "
                               "(torchrun, or parallel.collectives.spawn)")
        collectives.init(*env, device=device)
    return planner.plan_for(cfg, meshes.make_mesh((d, m), ("data", "model")), shape)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--policy", default="paper", choices=sorted(POLICIES))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="host",
                    help="host (one process) or DxM: the launched world as a (data, model) "
                    "grid")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        make_deterministic()
    cfg = C.smoke_config(args.arch) if args.smoke else C.get_config(args.arch)
    policy = POLICIES[args.policy]
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = None if args.mesh == "host" else _world_plan(cfg, shape, args.mesh, args.device)
    if plan is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = collectives.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    specs = registry.param_specs(cfg)
    say(f"arch={cfg.name} params={spec.count_params(specs) / 1e6:.2f}M "
        f"policy={args.policy} device={dev}"
        + (f" mesh={plan.mesh_shape()}" if plan is not None else ""), flush=True)

    if args.optimizer == "sgd":
        opt = sgd_momentum(step_decay_schedule(args.lr, [10 ** 9]))
    else:
        opt = adamw(warmup_cosine_schedule(args.lr, 20, args.steps))
    tstep = make_train_step(cfg, policy, opt, TrainConfig(microbatches=args.microbatches),
                            plan=plan)
    dp = tstep.data_parallel
    params = spec.materialize(specs, torch.Generator(device=dev).manual_seed(0))
    opt_state = None

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_step()
        if latest is not None:
            say(f"restoring checkpoint step {latest}", flush=True)
            _, state = mgr.restore_latest({"params": params, "opt_state": opt.init(params)})
            params, opt_state = state["params"], state["opt_state"]
            del state
            start_step = latest
    if dp is not None:  # each rank keeps its shards of the whole state
        params = dp.shard(params)
        if opt_state is not None:
            opt_state = {k: dp.shard(v) for k, v in opt_state.items()}
    if opt_state is None:
        opt_state = opt.init(params)

    def save(step, blocking=False):
        state = {"params": params, "opt_state": opt_state}
        if dp is not None:  # gathered whole on every rank, written by rank 0
            state = {"params": dp.gather(params),
                     "opt_state": {k: dp.gather(v) for k, v in opt_state.items()}}
        if lead:
            mgr.save(step, state, blocking=blocking)

    records = []
    for step in range(start_step, args.steps):
        batch = pipeline.make_batch(cfg, shape, step, device=dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = tstep(params, opt_state, batch, step)
        loss = float(metrics["loss"])  # waits for the device
        gn = float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        rec = dict(step=step, loss=loss, grad_norm=gn, seconds=dt,
                   tokens_per_s=args.batch * args.seq / dt)
        records.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} |g| {gn:.3f} ({dt:.2f}s, "
                f"{rec['tokens_per_s']:.0f} tokens/s)", flush=True)
        if mgr and step and step % args.ckpt_every == 0:
            save(step)
    if mgr:
        save(args.steps, blocking=True)
    if dev.type == "cuda":
        say(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    say("done")
    return TrainRun(cfg, shape, tstep, params, opt_state, records, start_step, mgr)


if __name__ == "__main__":
    main()
