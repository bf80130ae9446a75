"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

Stateless and step-indexed: batch(step) is a function of (seed, step,
config) alone, drawn from a ``torch.Generator`` seeded by (seed, step).
It cannot give the reference's jax.random bits, so the tests hand both
packages the same numpy batches; the structure is the reference's: a
Zipf-ish marginal, an induction period of s//2 (the second half repeats
the first), labels rolled by one, the last position masked out: a
decoder's, an ssm's or a hybrid's batch is these three alone.  The
modality frontends are stubs, as in the reference: an encdec batch adds
``frames`` (B, enc_seq, frame_dim) and a vlm batch ``patch_embeds`` (B,
num_patches, patch_dim), normal draws times 0.1; a vlm's patches and
text fill ``seq_len`` together.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def _text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.family == "vlm":
        return shape.seq_len - cfg.num_patches  # patches + text = seq_len
    return shape.seq_len


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    b, s = shape.global_batch, _text_len(cfg, shape)
    out = {
        "tokens": ((b, s), torch.int64),
        "labels": ((b, s), torch.int64),
        "mask": ((b, s), torch.float32),
    }
    if cfg.family == "encdec":
        out["frames"] = ((b, cfg.enc_seq, cfg.frame_dim), torch.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = ((b, cfg.num_patches, cfg.patch_dim), torch.float32)
    return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, seed: int = 0,
               *, device=None) -> Dict[str, torch.Tensor]:
    """Materialize the synthetic batch for ``step`` (deterministic), drawn
    on the CPU and moved to ``device`` (default: the card)."""
    dev = resolve_device(device)
    b, s = shape.global_batch, _text_len(cfg, shape)
    v = cfg.vocab
    gen = torch.Generator().manual_seed(seed * (1 << 32) + step)
    # Zipf-ish marginal: floor(v * u^3) concentrates mass on small ids
    u = torch.rand((b, s), generator=gen)
    base = torch.clamp((v * u ** 3).to(torch.int64), max=v - 1)
    # induction structure: the second half repeats the first (period s//2)
    period = max(s // 2, 1)
    tokens = base[:, torch.arange(s) % period]
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((b, s), dtype=torch.float32)
    mask[:, -1] = 0.0
    out = {"tokens": tokens, "labels": labels, "mask": mask}
    for key, (shp, _) in batch_shapes(cfg, shape).items():
        if key not in out:  # frames, patch_embeds
            out[key] = torch.randn(shp, generator=gen) * 0.1
    return {k: v.to(dev) for k, v in out.items()}
