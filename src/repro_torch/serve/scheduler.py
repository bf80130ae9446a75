"""FIFO continuous-batching scheduler: model-free slot assignment
(port of ``repro/serve/scheduler.py``).

    QUEUED --admit(now)--> ACTIVE(slot) --retire(slot)--> DONE

With chunked piggybacked prefill (``PoolEngine(prefill_chunk=C)``) a slot
first passes through a PREFILLING sub-state of ACTIVE: assigned, but still
consuming prompt chunks rather than emitting tokens:

    ACTIVE --mark_prefilling--> PREFILLING --finish_prefill--> DECODING

* FIFO fairness: requests are admitted in (arrival, submit-order) order;
  a refused head blocks the queue rather than being overtaken.
* A slot holds at most one request; never more than ``max_slots`` active.
* Every admitted request is retired exactly once (double retires raise).
* Conservation: queued + active + done == submitted, at every step
  (PREFILLING counts as active: the slot is occupied).

Arrival times are measured in engine steps (one step = one pooled decode
dispatch), which keeps traces deterministic and replayable.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Request:
    """One serving request: ``tokens`` is the (1, prompt_len) prompt; a
    family's extras (an encdec's ``frames`` (1, enc_seq, frame_dim), a
    vlm's ``patch_embeds`` (1, P, patch_dim)) ride in ``extras`` and go to
    prefill as they are; ``arrival`` is the engine step at which it
    becomes visible; ``eos_id`` optionally stops generation early."""

    uid: Any
    tokens: Any
    max_new_tokens: int
    arrival: int = 0
    eos_id: Optional[int] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


class SchedulerError(RuntimeError):
    """An invariant of the slot state machine was violated."""


class FIFOScheduler:
    """FIFO admission over a fixed pool of ``max_slots`` decode slots."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self._seq = itertools.count()
        self._queue: List[Tuple[int, int, Request]] = []  # (arrival, seq, r)
        self._free: List[int] = list(range(max_slots))  # min-heap of slots
        heapq.heapify(self._free)
        self._active: Dict[int, Request] = {}
        self._prefilling: set = set()  # slots of _active still in prefill
        self._done: List[Request] = []
        self._submitted = 0

    def submit(self, request: Request) -> None:
        """Queue a request (FIFO by (arrival, submission order))."""
        heapq.heappush(self._queue, (request.arrival, next(self._seq), request))
        self._submitted += 1

    def admit(self, now: int, can_admit=None) -> List[Tuple[int, Request]]:
        """Assign arrived requests to free slots (lowest first), FIFO,
        until one runs out.  Returns the new ``(slot, request)`` pairs.

        ``can_admit(request)``, when given, gates each admission on a
        resource the scheduler does not track (the engine's page
        allocator).  False head-blocks: the loop stops instead of skipping
        to a later request.  True means the pair IS admitted (the engine
        commits its page reservation inside the callback)."""
        out: List[Tuple[int, Request]] = []
        while self._free and self._queue and self._queue[0][0] <= now:
            if can_admit is not None and not can_admit(self._queue[0][2]):
                break  # head-block: FIFO order is never overtaken
            _, _, req = heapq.heappop(self._queue)
            slot = heapq.heappop(self._free)
            if slot in self._active:  # pragma: no cover - heap invariant
                raise SchedulerError(f"slot {slot} double-assigned")
            self._active[slot] = req
            out.append((slot, req))
        return out

    def retire(self, slot: int) -> Request:
        """Release ``slot``; its request is DONE (exactly once)."""
        if slot not in self._active:
            raise SchedulerError(f"retire of non-active slot {slot}")
        req = self._active.pop(slot)
        self._prefilling.discard(slot)
        self._done.append(req)
        heapq.heappush(self._free, slot)
        return req

    def mark_prefilling(self, slot: int) -> None:
        """Flag a just-admitted slot as consuming prompt chunks: it
        occupies the slot but emits no tokens until ``finish_prefill``."""
        if slot not in self._active:
            raise SchedulerError(f"mark_prefilling of non-active slot {slot}")
        self._prefilling.add(slot)

    def finish_prefill(self, slot: int) -> None:
        """PREFILLING -> DECODING (exactly once per admission)."""
        if slot not in self._prefilling:
            raise SchedulerError(f"finish_prefill of non-prefilling slot {slot}")
        self._prefilling.discard(slot)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_done(self) -> int:
        return len(self._done)

    @property
    def num_prefilling(self) -> int:
        return len(self._prefilling)

    def active_slots(self) -> List[int]:
        """Slots currently DECODING (prefilling slots are excluded: they
        occupy a slot but emit no tokens yet)."""
        return sorted(s for s in self._active if s not in self._prefilling)

    def prefilling_slots(self) -> List[int]:
        return sorted(self._prefilling)

    def active_request(self, slot: int) -> Request:
        return self._active[slot]

    def next_arrival(self) -> Optional[int]:
        """Arrival step of the queue head (None when the queue is empty)."""
        return self._queue[0][0] if self._queue else None

    def pending_arrivals(self) -> List[Tuple[int, Any]]:
        """(arrival, uid) of every still-queued request (unordered)."""
        return [(a, r.uid) for a, _, r in self._queue]

    def all_done(self) -> bool:
        return not self._queue and not self._active

    def check_conservation(self) -> None:
        if self.num_queued + self.num_active + self.num_done != self._submitted:
            raise SchedulerError(
                f"conservation violated: {self.num_queued} queued + "
                f"{self.num_active} active + {self.num_done} done != "
                f"{self._submitted} submitted"
            )
