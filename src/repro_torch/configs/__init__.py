"""Config registry: ``get_config(arch_id)``, per-shape adaptations and
reduced smoke variants.

Every architecture of the reference is registered: the decoders, dense
(llama3-8b, mistral-nemo-12b, starcoder2-7b for serving, olmo-1b for
training) and MoE (llama4-scout-17b-a16e, grok-1-314b), the vlm
internvl2-76b, the hybrid recurrentgemma-2b, the encoder-decoder
whisper-large-v3 and the ssm mamba2-2.7b.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    shapes_for,
)

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "grok-1-314b": "grok_1_314b",
    "starcoder2-7b": "starcoder2_7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3-8b": "llama3_8b",
    "olmo-1b": "olmo_1b",
    "internvl2-76b": "internvl2_76b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-2.7b": "mamba2_2p7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCH_IDS})"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def config_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-shape adaptations: mistral-nemo's long_500k cell runs with
    sliding-window attention."""
    if cfg.name == "mistral-nemo-12b" and shape.name == "long_500k":
        mod = importlib.import_module("repro_torch.configs.mistral_nemo_12b")
        return dataclasses.replace(cfg, window=mod.LONG_CONTEXT_WINDOW)
    return cfg


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    ``repro.configs.smoke_config`` cut: MoE keeps 4 experts and at most
    top-2; encdec 2 encoder layers over 12 frames of 24; vlm 4 patches
    of 24; hybrid 3 layers, an RG-LRU of width 96; ssm a state of 16 and
    chunks of 8, its head fields left as they are)."""
    cfg = get_config(arch)
    kw: Dict = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64,
        vocab=257,
        vocab_pad_multiple=64,
    )
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_chunk=8)
    else:
        ratio = max(1, cfg.n_heads // cfg.kv_heads)
        kw.update(n_heads=4, kv_heads=max(1, 4 // ratio), head_dim=16, d_ff=128)
    if cfg.moe is not None:
        kw.update(moe=dataclasses.replace(cfg.moe, num_experts=4,
                                          top_k=min(cfg.moe.top_k, 2)))
    if cfg.window is not None:
        kw.update(window=8)
    if cfg.family == "hybrid":
        kw.update(lru_width=96)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, enc_seq=12, frame_dim=24)
    if cfg.family == "vlm":
        kw.update(num_patches=4, patch_dim=24)
    return dataclasses.replace(cfg, **kw)
