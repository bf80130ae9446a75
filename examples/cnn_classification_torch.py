"""Paper-faithful CNN training with the PyTorch/CUDA port (the paper's
Table 3 setting, proxy scale): the ResNet-style CNN of
``repro_torch.models.cnn`` (conv = im2col + MF-MAC) trained three ways —
FP32, ours (5/5/5), low-bit (4/4/4) — on the synthetic frequency-pattern
task, printing the accuracy comparison in the paper's Table 3 order.

  PYTHONPATH=src python examples/cnn_classification_torch.py [--steps 120]
  PYTHONPATH=src python examples/cnn_classification_torch.py --device cpu

SGD with momentum 0.9, learning rate 0.05 decayed tenfold at steps 80 and
110, a fresh batch of 64 images a step; accuracy on 512 fresh images.
"""
import argparse
import dataclasses

import torch

from repro_torch.core.policy import FP32_BASELINE, PAPER_FAITHFUL, QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.models import cnn, spec
from repro_torch.optim import sgd_momentum, step_decay_schedule
from repro_torch.train import value_and_grad

#: the Ultra-low / LUQ row analogue: 4-bit W, A and G, 5-bit G into the head
BITS444 = dataclasses.replace(PAPER_FAITHFUL, bits_w=4, bits_a=4, bits_g=4, bits_g_last=5)

POLICIES = [("FP32   (32/32/32)", FP32_BASELINE),
            ("Ours   ( 5/ 5/ 5)", PAPER_FAITHFUL),
            ("LowBit ( 4/ 4/ 4)", BITS444)]

#: seeds of the data generators: step i's batch draws from DATA_SEED + i
DATA_SEED, EVAL_SEED, EVAL_N = 1 << 20, 999, 512


def batch_at(step: int, batch: int, res: int, device):
    """Step ``step``'s training batch (images, labels) on ``device``."""
    return cnn.make_dataset(torch.Generator().manual_seed(DATA_SEED + step), batch,
                            res=res, device=device)


def make_step(policy: QuantPolicy):
    """(optimizer, step): ``step(params, state, images, labels, i)`` is one
    SGD step of the CNN's loss under ``policy`` (params and state updated
    in place); returns (params, state, loss)."""
    opt = sgd_momentum(step_decay_schedule(0.05, [80, 110]), momentum=0.9)

    def step(params, state, x, y, i):
        loss, grads = value_and_grad(lambda p: cnn.loss_fn(policy, p, x, y), params)
        with torch.no_grad():
            params, state = opt.update(grads, state, params, i)
        return params, state, loss

    return opt, step


def init_params(width: int = 16, seed: int = 0, device="cuda"):
    """``cnn_specs(width=width)`` drawn from ``seed`` on the CPU (the same
    values on every device), on ``device``."""
    dev = resolve_device(device)
    return spec.tree_map(lambda x: x.to(dev), spec.materialize(
        cnn.cnn_specs(width=width), torch.Generator().manual_seed(seed)))


def train_cnn(policy: QuantPolicy, steps: int = 120, batch: int = 64, seed: int = 0, *,
              device="cuda", width: int = 16, res: int = 16, params=None, batches=None,
              eval_set=None, on_step=None):
    """Train the CNN under ``policy`` for ``steps`` SGD steps; returns
    (eval accuracy, last loss, the trained params).

    ``params`` (a tree on ``device``, default ``cnn_specs(width=width)``
    drawn from ``seed``), ``batches`` (``batches(step)`` -> (images,
    labels), default :func:`batch_at`) and ``eval_set`` ((images, labels))
    let a caller supply its own state and data; ``on_step(step, loss)``
    sees each step's loss."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(width, seed, dev)
    batches = batches or (lambda step: batch_at(step, batch, res, dev))
    opt, sgd_step = make_step(policy)
    state = opt.init(params)
    loss = None
    for step in range(steps):
        x, y = batches(step)
        params, state, loss = sgd_step(params, state, x, y, step)
        if on_step is not None:
            on_step(step, loss)
    xe, ye = eval_set if eval_set is not None else cnn.make_dataset(
        torch.Generator().manual_seed(EVAL_SEED), EVAL_N, res=res, device=dev)
    with torch.no_grad():
        logits = cnn.forward(policy, params, xe)
    acc = float((torch.argmax(logits, -1) == ye).to(torch.float32).mean())
    return acc, float(loss), params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name, pol in POLICIES:
        acc, loss, _ = train_cnn(pol, steps=args.steps, device=args.device)
        print(f"{name}: accuracy={acc:.3f} final_loss={loss:.4f}")


if __name__ == "__main__":
    main()
