"""Config registry: ``get_config(arch_id)`` + reduced smoke variants.

Only the architectures the port runs so far are registered (llama3-8b
for serving, olmo-1b for training); the rest arrive with their model
families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, MoEConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "llama3-8b": "llama3_8b",
    "olmo-1b": "olmo_1b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCH_IDS})"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    ``repro.configs.smoke_config`` cut, for the dense decoder)."""
    cfg = get_config(arch)
    kw: Dict = dict(
        n_layers=2,
        d_model=64,
        vocab=257,
        vocab_pad_multiple=64,
    )
    ratio = max(1, cfg.n_heads // cfg.kv_heads)
    kw.update(n_heads=4, kv_heads=max(1, 4 // ratio), head_dim=16, d_ff=128)
    return dataclasses.replace(cfg, **kw)
