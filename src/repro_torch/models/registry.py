"""Family dispatch (port of ``repro/models/registry.py``): one API over
every model family.  ``batch`` is a dict; its keys by family:

  decoder        tokens, labels, mask
  vlm            tokens, labels, mask, patch_embeds
  encdec         tokens, labels, mask, frames
  hybrid / ssm   tokens, labels, mask

Specs, loss, prefill, the lockstep cache, the pool cache (block-table
paged for the attention families, PoT-quantized pages or ``cache_dtype``
ones; the lifted slot-row layout for the recurrent ones), lockstep and
pooled decode, the fused chunk step of chunked piggybacked prefill, the
speculative verify step and encdec's encoder-side admission
(:func:`encode_cross_kv`).  The recurrent families (hybrid, ssm) have no
chunk or verify step, as in the reference.

Under an active sharded plan (``parallel/actshard.py``) the same
dispatch serves every family: the caller passes the plan's local config
(``plan.local_config``) and this rank's shards, and the step bodies'
model-axis hooks do the rest."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, recurrent, ssm, transformer

#: families the port runs
PORTED_FAMILIES = ("decoder", "vlm", "encdec", "hybrid", "ssm")

#: families whose ``decode_step`` takes the slot-pooled cache (per-slot
#: ``len``; the attention families' per-slot positions, the recurrent
#: state per row by construction)
POOLED_FAMILIES = ("decoder", "vlm", "encdec", "ssm", "hybrid")

#: families whose ``chunk_step`` fuses decode rows and prefill-chunk rows
#: into one pooled step
CHUNKED_FAMILIES = ("decoder", "vlm", "encdec")

#: families whose pool cache is block-table paged (serve/slots.py); the
#: recurrent state of ssm and hybrid is O(1) in length, nothing to page,
#: so they keep the lifted slot-row layout
PAGED_FAMILIES = ("decoder", "vlm", "encdec")

#: families with a speculative-decoding ``verify_step``
SPEC_FAMILIES = ("decoder", "vlm", "encdec")


_MODULES = {"decoder": transformer, "vlm": transformer, "encdec": encdec,
            "hybrid": recurrent, "ssm": ssm}


def _model(cfg: ModelConfig):
    """The module of ``cfg``'s family (vlm runs the decoder's)."""
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    return _MODULES[cfg.family]


def param_specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec.encdec_specs(cfg)
    if cfg.family == "ssm":
        return ssm.ssm_specs(cfg)
    if cfg.family == "hybrid":
        return recurrent.hybrid_specs(cfg)
    return _model(cfg).decoder_specs(cfg)


def forward(cfg: ModelConfig, policy, params, batch, *, remat: bool = False):
    """Logits (B, S, V_padded) of a batch dict's token positions (its
    family's keys; a vlm's patch positions dropped)."""
    if cfg.family == "encdec":
        return encdec.forward(cfg, policy, params, batch["tokens"], batch["frames"],
                              remat=remat)
    if cfg.family in ("ssm", "hybrid"):
        return _model(cfg).forward(cfg, policy, params, batch["tokens"], remat=remat)
    patches = batch.get("patch_embeds")
    logits = transformer.forward(cfg, policy, params, batch["tokens"], patch_embeds=patches,
                                 remat=remat)
    return logits if patches is None else logits[:, patches.shape[1]:]


def loss_fn(cfg: ModelConfig, policy, params, batch):
    """Training loss of a batch dict (its family's keys), each layer
    recomputed in the backward."""
    return transformer.next_token_loss(cfg, forward(cfg, policy, params, batch, remat=True),
                                       batch["labels"], batch["mask"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device):
    """The lockstep (and solo-prefill) cache.  An ssm's takes no dtype from
    here: its states are f32, as in the reference."""
    if cfg.family == "ssm":
        return ssm.init_cache(cfg, batch, max_len, device=device)
    return _model(cfg).init_cache(cfg, batch, max_len, dtype, device=device)


def pool_span(cfg: ModelConfig, max_len: int) -> int:
    """Logical cache span per slot (the ring window caps it)."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_pool_cache(cfg: ModelConfig, max_slots: int, max_len: int,
                    dtype=torch.bfloat16, *, device, page_size=None,
                    num_pages=None, kv_quant=None):
    """Pooled decode cache, built once per engine.  The attention families
    (``PAGED_FAMILIES``) get the block-table paged layout
    (``serve.slots.page_pool_cache``): pages of ``page_size`` positions
    (default the whole span, one page per slot), ``num_pages`` physical
    pages (default ``max_slots * span / page_size``) plus the null page,
    and a (max_slots, span / page_size) page table; ``kv_quant`` (a
    ``core.policy.KVQuantSpec``) stores the K/V pages in the PoT wire
    format with per-token ``k_beta``/``v_beta`` leaves.  The recurrent
    families keep the lifted slot-row layout (``serve.slots.lift_cache``:
    per-slot ``len`` and attention ``pos``) and refuse the paged knobs."""
    if cfg.family not in POOLED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} does not support slot-pooled decode "
            f"(supported: {POOLED_FAMILIES})")
    from repro_torch.serve import slots

    base = init_cache(cfg, max_slots, max_len, dtype, device=device)
    if cfg.family in PAGED_FAMILIES:
        return slots.page_pool_cache(base, max_slots,
                                     page_size or pool_span(cfg, max_len), num_pages,
                                     kv_quant=kv_quant)
    if page_size is not None or num_pages is not None or kv_quant is not None:
        raise ValueError(f"family {cfg.family!r} has no paged cache "
                         f"(paged: {PAGED_FAMILIES})")
    return slots.lift_cache(base, max_slots)


def prefill(cfg, policy, params, batch, cache):
    """Prefill of a batch dict: ``tokens``, and a vlm's ``patch_embeds``
    (optional) or an encdec's ``frames``."""
    if cfg.family == "encdec":
        return encdec.prefill(cfg, policy, params, batch["tokens"], batch["frames"], cache)
    if cfg.family in ("ssm", "hybrid"):
        return _model(cfg).prefill(cfg, policy, params, batch["tokens"], cache)
    return _model(cfg).prefill(cfg, policy, params, batch["tokens"], cache,
                               patch_embeds=batch.get("patch_embeds"))


def decode_step(cfg, policy, params, token, cache):
    return _model(cfg).decode_step(cfg, policy, params, token, cache)


def chunk_step(cfg, policy, params, tokens, n_new, cache):
    """One fused pooled step over ``(B, C)`` token positions: decode rows
    carry one valid token, prefilling rows up to C prompt tokens, idle
    rows none.  ``n_new`` (B,) counts each slot's valid positions and is
    read on the host.  Returns (logits (B, V) at each slot's last valid
    position, the cache updated in place).  Paged pool caches only."""
    if cfg.family not in CHUNKED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no fused chunk step "
            f"(supported: {CHUNKED_FAMILIES})")
    return _model(cfg).chunk_step(cfg, policy, params, tokens, n_new, cache)


def verify_step(cfg, policy, params, tokens, n_new, cache):
    """Speculative-decoding verifier: score each slot's ``n_new[b]``-token
    verify row (its last emitted token, then the draft) in ONE weight
    pass, bit-identical to ``n_new[b]`` sequential ``decode_step`` calls.
    Returns (logits (B, C, V), position i scoring the successor of
    ``tokens[b, i]``; the cache updated in place, ``len += n_new``).
    Paged pool caches only; serve/spec.py owns acceptance and rollback."""
    if cfg.family not in SPEC_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no speculative verify step "
            f"(supported: {SPEC_FAMILIES})")
    return _model(cfg).verify_step(cfg, policy, params, tokens, n_new, cache)


def encode_cross_kv(cfg, policy, params, frames):
    """Encoder-side admission of chunked encdec serving: the encoder pass
    and every decoder layer's cross K/V, each (L, B, enc_seq, KV, hd); the
    engine writes them into the slot, then the decoder prompt streams in
    through ``chunk_step``.  Under an active plan with a model axis
    (``parallel/actshard.py``) ``cfg`` is the plan's local config and
    ``params`` this rank's shards: KV is this rank's K/V heads."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_cross_kv: family {cfg.family!r} has no encoder")
    return encdec.encode_cross_kv(cfg, policy, params, frames)
