"""Family dispatch (port of ``repro/models/registry.py``), for the dense
``decoder`` family.  The other families (vlm, encdec, hybrid, ssm) and
MoE come in a later slice of the port and raise here."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

#: families the port runs so far
PORTED_FAMILIES = ("decoder",)


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"family {cfg.family!r}{' (MoE)' if cfg.moe else ''} is not "
            "ported yet: the other model families come in a later slice of "
            "repro_torch (ROADMAP.md, Queue 1)"
        )


def param_specs(cfg: ModelConfig):
    _check(cfg)
    return transformer.decoder_specs(cfg)


def loss_fn(cfg: ModelConfig, policy, params, batch):
    """Training loss of a batch dict (``tokens``, ``labels``, ``mask``)."""
    _check(cfg)
    return transformer.lm_loss(cfg, policy, params, batch["tokens"],
                               batch["labels"], batch["mask"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device):
    _check(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device=device)


def init_pool_cache(cfg: ModelConfig, max_slots: int, max_len: int,
                    dtype=torch.bfloat16, *, device):
    """Pooled decode cache, built once per engine: contiguous slot rows
    with per-slot ``pos``/``len`` (serve/slots.py)."""
    from repro_torch.serve import slots

    return slots.lift_cache(init_cache(cfg, max_slots, max_len, dtype,
                                       device=device), max_slots)


def prefill(cfg, policy, params, batch, cache):
    _check(cfg)
    return transformer.prefill(cfg, policy, params, batch["tokens"], cache)


def decode_step(cfg, policy, params, token, cache):
    _check(cfg)
    return transformer.decode_step(cfg, policy, params, token, cache)
