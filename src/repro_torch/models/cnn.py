"""Small ResNet-style CNN on synthetic images (port of
``repro/models/cnn.py``): the paper's primary model family, every conv
through ``mfmac.mf_conv2d`` (im2col + MF-MAC: K1 forward, K2/K3 backward)
and the head through ``mf_linear``.  Images are NHWC, filters (KH, KW,
Cin, Cout).

``examples/cnn_classification_torch.py`` trains it (the paper's Table 3
setting at proxy scale).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import mfmac
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.models.spec import ParamSpec


def cnn_specs(num_classes: int = 10, width: int = 16):
    w = width

    def conv(kh, kw, ci, co):
        return {
            "w": ParamSpec((kh, kw, ci, co), (None, None, None, None), std=0.1),
            "gamma": ParamSpec((), (), init="value", value=0.95),
        }

    return {
        "stem": conv(3, 3, 3, w),
        "block1a": conv(3, 3, w, w),
        "block1b": conv(3, 3, w, w),
        "block2a": conv(3, 3, w, 2 * w),
        "block2b": conv(3, 3, 2 * w, 2 * w),
        "proj2": conv(1, 1, w, 2 * w),
        "head": {
            "w": ParamSpec((2 * w, num_classes), (None, None), std=0.1),
            "gamma": ParamSpec((), (), init="value", value=0.95),
        },
    }


def _bn_free_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free norm over H and W: population variance (ddof 0)."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def forward(policy: QuantPolicy, params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, classes)."""
    def c(p, x, stride=1):
        return mfmac.mf_conv2d(x, p["w"], p["gamma"], policy=policy, stride=stride)

    x = torch.relu(_bn_free_norm(c(params["stem"], images)))
    h = torch.relu(_bn_free_norm(c(params["block1a"], x)))
    h = _bn_free_norm(c(params["block1b"], h))
    x = torch.relu(x + h)
    h = torch.relu(_bn_free_norm(c(params["block2a"], x, stride=2)))
    h = _bn_free_norm(c(params["block2b"], h))
    x = torch.relu(c(params["proj2"], x, stride=2) + h)
    x = x.mean(dim=(1, 2))  # global average pool
    hp = params["head"]
    return mfmac.mf_linear(x, hp["w"], hp["gamma"], policy=policy, is_last=True)


def loss_fn(policy: QuantPolicy, params, images, labels) -> torch.Tensor:
    """Mean cross entropy of the logits against ``labels``."""
    logits = forward(policy, params, images).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return (logz - gold).mean()


def prototypes(num_classes: int = 10, res: int = 16, device=None) -> torch.Tensor:
    """The classes' frequency patterns (C, res, res): x runs along W and y
    along H (``indexing="xy"``, as ``jnp.meshgrid``'s default)."""
    xs = torch.linspace(0, 1, res, device=device)
    xx, yy = torch.meshgrid(xs, xs, indexing="xy")
    return torch.stack([
        torch.sin(2 * math.pi * (k + 1) * xx / 3 + k) + torch.cos(2 * math.pi * (k + 1) * yy / 4)
        for k in range(num_classes)])


def make_dataset(generator: torch.Generator, n: int, num_classes: int = 10, res: int = 16,
                 device: Optional[torch.device] = None):
    """A learnable synthetic classification set: class = its dominant
    frequency pattern, on 3 equal channels, plus N(0, 0.25) noise.
    Labels, then noise, are drawn from ``generator`` on its own device
    (so a CPU generator gives the same data to every device); the set is
    returned on ``device`` (the card by default).  Returns (images (n,
    res, res, 3), labels (n,) int64)."""
    dev = resolve_device(device)
    labels = torch.randint(0, num_classes, (n,), generator=generator,
                           device=generator.device)
    noise = torch.randn((n, res, res, 3), generator=generator, device=generator.device) * 0.5
    labels, noise = labels.to(dev), noise.to(dev)
    base = prototypes(num_classes, res, dev)[labels][..., None]  # (n, H, W, 1)
    return base.repeat(1, 1, 1, 3) + noise, labels
