"""Synthetic request traces (port of ``repro/serve/trace.py``).

Built on numpy exactly as the reference is, so the same seed gives the
same requests in both packages.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serve.scheduler import Request


def _check_budget_range(new_lo: int, new_hi: int) -> None:
    if new_lo > new_hi:
        raise ValueError(
            f"empty output-budget range: new_lo ({new_lo}) must be "
            f"<= new_hi ({new_hi})"
        )
    if new_lo < 1:
        raise ValueError(f"new_lo must be >= 1 (got {new_lo}): every "
                         "request emits at least one token")


def poisson_trace(cfg, *, n_requests: int, prompt_len: int, lam: float,
                  new_lo: int, new_hi: int, seed: int = 0) -> List[Request]:
    """Poisson(lam) inter-arrivals (in decode steps, first at 0) + uniform
    output budgets in [new_lo, new_hi], fixed prompt length.  An encdec
    request carries its frames and a vlm request its patch embeddings
    (standard normal), drawn between its tokens and its budget, as the
    reference draws them."""
    _check_budget_range(new_lo, new_hi)
    if n_requests <= 0:
        return []
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.poisson(lam, n_requests))
    arrivals[0] = 0
    reqs = []
    for i in range(n_requests):
        toks = rng.integers(0, cfg.vocab, (1, prompt_len)).astype(np.int32)
        extras = _extras(cfg, rng)
        reqs.append(
            Request(
                uid=i,
                tokens=toks,
                extras=extras,
                max_new_tokens=int(rng.integers(new_lo, new_hi + 1)),
                arrival=int(arrivals[i]),
            )
        )
    return reqs


def _extras(cfg, rng):
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (1, cfg.enc_seq, cfg.frame_dim)).astype(np.float32)
    if cfg.family == "vlm" and cfg.num_patches:
        extras["patch_embeds"] = rng.standard_normal(
            (1, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
    return extras


def shared_prefix_trace(cfg, *, n_requests: int, prefix_len: int,
                        suffix_len: int, lam: float, new_lo: int,
                        new_hi: int, seed: int = 0) -> List[Request]:
    """The shared-system-prompt workload: every prompt is one fixed
    ``prefix_len`` head (drawn once) + a per-request random ``suffix_len``
    tail; Poisson(lam) arrivals and uniform budgets as in
    :func:`poisson_trace`.  With the engine's prefix cache the head's
    pages are prefilled once and mapped by every later admission."""
    _check_budget_range(new_lo, new_hi)
    if n_requests <= 0:
        return []
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.poisson(lam, n_requests))
    arrivals[0] = 0
    prefix = rng.integers(0, cfg.vocab, (prefix_len,)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        suffix = rng.integers(0, cfg.vocab, (suffix_len,)).astype(np.int32)
        reqs.append(
            Request(
                uid=i,
                tokens=np.concatenate([prefix, suffix])[None, :],
                max_new_tokens=int(rng.integers(new_lo, new_hi + 1)),
                arrival=int(arrivals[i]),
            )
        )
    return reqs
