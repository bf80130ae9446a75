"""Speculative decoding for the serving pool: drafters and greedy
acceptance (port of ``repro/serve/spec.py``; numpy only).

The verifier is ``registry.verify_step``: one full-policy weight pass
scores each slot's verify row (its last emitted token, then up to C-1
draft tokens) bit-identically to sequential ``decode_step`` calls.
Greedy acceptance keeps the longest draft prefix that matches what plain
decode would emit, plus the verifier's own next token, so every served
token is the plain pooled-decode token; speculation changes only the
number of weight passes (``ServeStats.accepted_tokens_per_weight_pass``).

* :class:`NgramDrafter`: host-side prompt lookup.  The most recent
  earlier occurrence of the history's length-n suffix proposes its
  continuation; no device work.
* :class:`LowBitSelfDraft`: the same PoT weights re-quantized to 2-3 bits
  (``core.policy.draft_policy``) run ``max_draft`` decode steps on the
  live cache, counted apart in ``ServeStats.draft_weight_passes``.

Rollback is snapshot and restore (``serve.slots.spec_snapshot`` /
``spec_restore``): the engine erases the self-draft's cache writes before
the verify pass and restores the rejected tail after acceptance; table
entries of wholly rejected pages go to drop_id and are re-bound from the
allocator's table before the slot's next step.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NgramDrafter:
    """Prompt-lookup drafter: ``propose`` scans the token history (prompt
    and emitted) for the most recent earlier occurrence of its length-n
    suffix, longest n first (``max_n`` down to ``min_n``), and proposes
    the tokens that followed it."""

    max_draft: int = 3
    max_n: int = 3
    min_n: int = 1

    #: this drafter streams no weights (vs LowBitSelfDraft)
    needs_draft_pass = False

    def __post_init__(self):
        if self.max_draft < 1:
            raise ValueError(f"max_draft must be >= 1 (got {self.max_draft})")
        if not 1 <= self.min_n <= self.max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n (got {self.min_n}, {self.max_n})")

    def propose(self, history, k: int) -> np.ndarray:
        """Up to ``min(k, max_draft)`` draft tokens continuing ``history``
        (1-D int sequence); empty when no n-gram matches."""
        h = np.asarray(history, np.int64).reshape(-1)
        k = min(int(k), self.max_draft)
        if k <= 0 or len(h) < self.min_n + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_n, len(h) - 1), self.min_n - 1, -1):
            tail = h[-n:]
            for j in range(len(h) - n - 1, -1, -1):
                if np.array_equal(h[j:j + n], tail):
                    return h[j + n:j + n + k].astype(np.int32)
        return np.zeros((0,), np.int32)


@dataclasses.dataclass(frozen=True)
class LowBitSelfDraft:
    """Low-bit self-draft: ``max_draft`` greedy decode steps with the
    serving weights under ``core.policy.draft_policy(policy, bits)``.  The
    engine runs the steps; this carries the knobs."""

    max_draft: int = 3
    bits: int = 3

    needs_draft_pass = True

    def __post_init__(self):
        if self.max_draft < 1:
            raise ValueError(f"max_draft must be >= 1 (got {self.max_draft})")


def greedy_accept(drafts, verify_toks) -> int:
    """Longest accepted draft prefix: ``drafts[i]`` was proposed for
    position i, ``verify_toks[i]`` is the verifier's argmax at the
    position before it (the token plain decode emits there).  The caller
    emits the ``a`` accepted drafts and then ``verify_toks[a]``."""
    a = 0
    for d, g in zip(drafts, verify_toks):
        if int(d) != int(g):
            break
        a += 1
    return a
