"""Slot-pooled KV cache helpers (port of ``repro/serve/slots.py``, the
contiguous slot-row layout):

    k/v   (L, max_slots, span, KV, hd)   one contiguous row per slot
    pos   (max_slots, span)              global position per row entry
    len   (max_slots,)                   per-slot sequence length

A slot's row holds the same (position, value) pairs the reference
engine's one-page-per-slot paged view holds, so attention reduces over
the same values.  Paging and the page allocator come in a later slice.
The helpers update the pool in place and return it.
"""
from __future__ import annotations


def lift_cache(cache, max_slots: int):
    """Lift a fresh ``init_cache(cfg, max_slots, ...)`` to the slot-pooled
    layout (per-slot ``pos``/``len``)."""
    out = dict(cache)
    out["len"] = cache["len"].new_zeros((max_slots,))
    out["pos"] = cache["pos"][None].repeat(max_slots, 1)
    return out


def reset_slot(pool, slot: int):
    """Rewind one slot: ``len`` -> 0 and its positions to -1 (the
    not-yet-written sentinel the attention mask keys on)."""
    pool["len"][slot] = 0
    pool["pos"][slot] = -1
    return pool


def write_slot(pool, mini, slot: int):
    """Copy a batch-1 cache (``init_cache(cfg, 1, max_len)`` after a solo
    prefill) into ``slot``: the slot's whole row (k, v, pos, len) is
    overwritten, so nothing of a previous occupant survives."""
    pool["k"][:, slot] = mini["k"][:, 0].to(pool["k"].dtype)
    pool["v"][:, slot] = mini["v"][:, 0].to(pool["v"].dtype)
    pool["pos"][slot] = mini["pos"]
    pool["len"][slot] = mini["len"]
    return pool
