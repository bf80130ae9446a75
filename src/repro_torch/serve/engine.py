"""Continuous-batching serving engine (port of ``repro/serve/engine.py``,
``PoolEngine`` and ``generate``).

:class:`PoolEngine` keeps one block-table paged KV cache (built once,
``registry.init_pool_cache``; ``serve/slots.py``) and admits queued
requests into free slots mid-flight, in one of two ways:

* solo prefill (default): a batch-1 prefill whose cache is copied into
  the slot's pages, one extra weight pass per admission;
* chunked piggybacked prefill (``prefill_chunk=C``): the prompt streams
  C tokens per engine step through the same fused ``registry.chunk_step``
  that advances the decoding slots.  When no slot is prefilling, the
  engine dispatches plain ``decode_step`` instead (the decode fast path):
  the two step bodies are bit-equal on decode rows.

A host-side :class:`~repro_torch.serve.slots.PageAllocator` hands every
admission its worst-case pages up front and defers admissions (FIFO,
head-blocking) when the pool runs short.  With ``prefix_cache=True``
finished prompts publish their full pages; a later prompt with the same
head maps them (shared), copies the page it will append into
(copy-on-write) and resumes streaming after the hit.  Idle prefix pages
are LRU-evicted to make room.

Guarantee: batching never changes a request's tokens.  Each request's
output equals its run alone through the same admission recipe (solo
prefill, or the same chunk size) bit for bit, for every page size and
with the prefix cache on or off.  K1 reduces each row on its own in a
fixed order, activation scales are per sample
(``policy.per_sample_act_scales``, forced on here), and each slot's norms
and attention run as programs of their own (``models/transformer.py``).

The loop is synchronous.  The reference overlaps host scheduling with
the in-flight step, which moves wall-clock time only; its counters are
kept here exactly, arrival stamps included.  PoT-quantized KV pages,
speculative decoding, lockstep serving and ``cache_dtype`` are later
slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve import quantized_weights as qw
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.scheduler import FIFOScheduler, Request


@dataclasses.dataclass
class ServeStats:
    """Host-side counters from one :meth:`PoolEngine.run`.

    ``weight_passes`` is the deterministic cost clock: every full
    weight-streaming dispatch (a pooled decode or chunk step, a solo
    admission prefill) counts one pass.  ``ttft_passes[uid]`` is a
    request's time-to-first-token on that clock, from the first engine
    step at which it was admissible (queue wait included).  The paging
    counters are as deterministic for a fixed trace."""

    decode_steps: int = 0  # pooled step dispatches (plain decode or chunk)
    prefills: int = 0  # completed admissions
    emitted_tokens: int = 0
    occupancy_sum: float = 0.0  # sum over steps of occupied/max_slots
    weight_passes: int = 0
    ttft_passes: Dict = dataclasses.field(default_factory=dict)
    prompt_tokens: int = 0  # total prompt tokens across admitted requests
    prefix_hit_tokens: int = 0  # prompt tokens served from the prefix cache
    cow_copies: int = 0
    evictions: int = 0
    admission_deferrals: int = 0  # head-blocked admissions (page pressure)
    pages_in_use_sum: int = 0  # sum over pooled steps of live pages
    page_size: int = 0
    kv_page_bytes: int = 0  # bytes of one K+V page across all layers
    # host wall-clock seconds from admissible to first token on the host;
    # a measurement of the port's own (the reference keeps none)
    ttft_s: Dict = dataclasses.field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.decode_steps if self.decode_steps else 0.0

    @property
    def mean_ttft_passes(self) -> float:
        if not self.ttft_passes:
            return 0.0
        return sum(self.ttft_passes.values()) / len(self.ttft_passes)

    @property
    def mean_ttft_s(self) -> float:
        return sum(self.ttft_s.values()) / len(self.ttft_s) if self.ttft_s else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from shared prefix pages."""
        return self.prefix_hit_tokens / self.prompt_tokens if self.prompt_tokens else 0.0

    @property
    def kv_hbm_bytes_per_token(self) -> float:
        """Mean live KV footprint per emitted token (pages, not whole
        rows, pin memory)."""
        if not self.emitted_tokens:
            return 0.0
        return self.pages_in_use_sum * self.kv_page_bytes / self.emitted_tokens


class PoolEngine:
    """Continuous-batching serving engine over a paged slot-pooled KV cache.

    Weights are PoT-prequantized at construction by default
    (``serve/quantized_weights.py``); pass ``prequantize=False`` to serve
    the weights as given.  ``params`` must already lie on ``device``
    (default ``cuda``).  The KV cache is bf16, as in the reference.

    ``prefill_chunk=C`` admits by chunked piggybacked prefill (C in
    [1, span]).  Chunking is part of a request's recipe (a chunk is one
    activation-scale group), so chunked tokens differ from solo-prefill
    tokens; pool and solo agree for the same C.  ``page_size`` (default
    the whole span) must divide the span; ``num_pages`` defaults to
    ``max_slots * span / page_size``.  ``prefix_cache`` needs
    ``prefill_chunk``."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy, params, *,
                 max_slots: int, max_len: int, prequantize: bool = True,
                 prefill_chunk: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False, device=None):
        if cfg.family not in registry.PAGED_FAMILIES or cfg.moe is not None:
            raise NotImplementedError(
                f"PoolEngine: family {cfg.family!r} is not ported yet")
        span = registry.pool_span(cfg, max_len)
        if prefill_chunk is not None:
            if cfg.family not in registry.CHUNKED_FAMILIES:
                raise NotImplementedError(
                    f"prefill_chunk: family {cfg.family!r} has no fused chunk "
                    f"step (supported: {registry.CHUNKED_FAMILIES})")
            if not 1 <= prefill_chunk <= span:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be in [1, {span}] "
                    "(the cache span) so a chunk's ring writes cannot collide")
        self.page_size = page_size or span
        if span % self.page_size != 0:
            raise ValueError(
                f"page_size={self.page_size} must divide the cache span {span}")
        self.pages_per_slot = span // self.page_size
        self.num_pages = (max_slots * self.pages_per_slot
                          if num_pages is None else num_pages)
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} < pages_per_slot="
                f"{self.pages_per_slot}: nothing could ever be admitted")
        if prefix_cache and prefill_chunk is None:
            raise ValueError(
                "prefix_cache needs prefill_chunk: solo prefill's "
                "activation-scale groups cover the whole prompt, so its "
                "pages are never content-shareable")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params lie on {params['embed'].device}, engine runs on "
                f"{self.device}")
        if prequantize and policy.enabled and not policy.weights_prequantized:
            params = qw.quantize_for_serving(cfg, policy, params)
            policy = dataclasses.replace(policy, weights_prequantized=True)
        # per-slot activation scale groups: batch-invariant decode (at
        # batch 1 identical to the per-tensor groups)
        policy = dataclasses.replace(policy, per_sample_act_scales=True)
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.span = span
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.last_stats: Optional[ServeStats] = None

    # -- request admission -------------------------------------------------
    def _validate(self, requests: Sequence[Request]) -> None:
        seen = set()
        for r in requests:
            if r.uid in seen:
                raise ValueError(f"duplicate request uid {r.uid!r}")
            seen.add(r.uid)
            plen = self._request_tokens(r)
            need = plen + r.max_new_tokens
            # a windowed arch decodes from a ring whose wrap is the model's
            # semantics; otherwise the request must fit its page budget
            if self.cfg.window is not None:
                continue
            need_pages = -(-need // self.page_size)
            if need_pages > self.pages_per_slot:
                raise ValueError(
                    f"request {r.uid!r}: prompt ({plen}) + max_new_tokens "
                    f"({r.max_new_tokens}) = {need} tokens need {need_pages} "
                    f"pages of {self.page_size}, exceeding the per-slot budget "
                    f"of {self.pages_per_slot} pages (max_len={self.max_len})")

    def _prefill_into(self, cache, slot: int, req: Request, pages):
        """Solo-prefill ``req`` (batch 1) and copy its cache into the
        slot's ``pages``.  Returns the first generated token."""
        mini = registry.init_cache(self.cfg, 1, self.max_len, device=self.device)
        tokens = torch.as_tensor(np.asarray(req.tokens), dtype=torch.int64,
                                 device=self.device).reshape(1, -1)
        logits, mini = registry.prefill(self.cfg, self.policy, self.params,
                                        {"tokens": tokens}, mini)
        slots_lib.write_slot(cache, mini, slot, pages=pages)
        return int(torch.argmax(logits, dim=-1)[0])

    @staticmethod
    def _request_tokens(req: Request) -> int:
        return int(np.asarray(req.tokens).shape[-1])

    def _admission_plan(self, alloc, req: Request):
        """Worst-case token need (capped at the span: a ring wrap revisits
        pages) and, when enabled, the prefix-cache lookup."""
        need = self._request_tokens(req) + req.max_new_tokens
        prompt = chunk = None
        if self.prefix_cache and self.cfg.window is None:
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            chunk = self.prefill_chunk
        return alloc.plan_admission(prompt, min(need, self.span), chunk)

    def _table_row(self, pages) -> List[int]:
        drop = slots_lib.drop_id(self.num_pages)
        return list(pages) + [drop] * (self.pages_per_slot - len(pages))

    def _sync_admission(self, cache, slot: int, hold, aplan):
        """Mirror one allocator admission into the device cache: the
        slot's table row, ``pos`` resets of its new pages, copy-on-write
        page copies (positions from ``resume`` on cleared back to -1, as a
        solo run would hold them there) and ``len`` = the prompt position
        streaming resumes from."""
        dev = self.device
        cache["table"][slot] = torch.tensor(self._table_row(hold["table"]), device=dev)
        if hold["new"]:
            cache["pos"][torch.tensor(hold["new"], device=dev)] = -1
        for src, dst in hold["copies"]:
            for key in ("k", "v"):
                cache[key][:, dst] = cache[key][:, src]
            sp = cache["pos"][src]
            cache["pos"][dst] = torch.where(sp < aplan.resume, sp, torch.full_like(sp, -1))
        cache["len"][slot] = aplan.resume

    def _void_table_rows(self, cache, dead_slots):
        """Retired slots keep riding the fixed-shape step: point their
        table rows at drop_id so their writes land nowhere."""
        cache["table"][sorted(dead_slots)] = slots_lib.drop_id(self.num_pages)

    def _stats(self) -> ServeStats:
        cfg = self.cfg
        return ServeStats(page_size=self.page_size,
                          kv_page_bytes=2 * cfg.n_layers * self.page_size
                          * cfg.kv_heads * cfg.head_dim * 2)  # bf16 K and V

    # -- main loop ---------------------------------------------------------
    def run(self, requests: Sequence[Request]) -> Dict:
        """Drive all ``requests`` to completion; returns {uid: np.ndarray
        of generated token ids (int32)}.  Counters land in ``last_stats``."""
        self._validate(requests)
        cfg = self.cfg
        sched = FIFOScheduler(self.max_slots)
        for r in requests:
            sched.submit(r)
        stats = self._stats()
        alloc = slots_lib.PageAllocator(self.num_pages, self.page_size,
                                        self.pages_per_slot, self.max_slots)
        out: Dict = {r.uid: [] for r in requests}
        remaining: Dict[int, int] = {}  # slot -> tokens still to emit
        pending: Dict[int, np.ndarray] = {}  # slot -> unconsumed prompt
        prompts: Dict[int, np.ndarray] = {}  # slot -> full prompt
        arrival_pass: Dict = {}  # uid -> weight_passes when first admissible
        arrival_time: Dict = {}  # uid -> host clock when first admissible
        holds: List = []  # reserve() results, FIFO with sched.admit's pairs
        last_tok = np.zeros((self.max_slots,), np.int64)
        chunk = self.prefill_chunk
        step = 0

        def stamp_arrivals(now):
            for arr, uid in sched.pending_arrivals():
                if arr <= now and uid not in arrival_pass:
                    arrival_pass[uid] = stats.weight_passes
                    arrival_time[uid] = time.perf_counter()

        def can_admit_cb(req):
            aplan = self._admission_plan(alloc, req)
            protect = set(aplan.shared) | {p for p, _ in aplan.cow}
            if not alloc.can_admit(alloc.fresh_needed(aplan), protect):
                stats.admission_deferrals += 1
                return False
            # commit now: the next head's check must see these pages gone
            holds.append((aplan, alloc.reserve(aplan)))
            return True

        def retire(slot):
            sched.retire(slot)
            alloc.release_slot(slot)
            dead_rows.append(slot)
            prompts.pop(slot, None)

        def first_token(slot, req, tok):
            out[req.uid].append(tok)
            last_tok[slot] = tok
            stats.emitted_tokens += 1
            stats.ttft_passes[req.uid] = (
                stats.weight_passes - arrival_pass.get(req.uid, stats.weight_passes))
            stats.ttft_s[req.uid] = time.perf_counter() - arrival_time[req.uid]
            remaining[slot] = req.max_new_tokens - 1
            if remaining[slot] <= 0 or tok == req.eos_id:
                retire(slot)

        with torch.inference_mode():
            cache = registry.init_pool_cache(
                cfg, self.max_slots, self.max_len, device=self.device,
                page_size=self.page_size, num_pages=self.num_pages)
            # the allocator owns every mapping: dead slots must write into
            # nothing, not into pages the allocator will hand out
            cache["table"].fill_(slots_lib.drop_id(self.num_pages))
            while not sched.all_done():
                stamp_arrivals(step)
                dead_rows: List[int] = []
                alloc.tick(step)
                for slot, req in sched.admit(step, can_admit_cb):
                    stats.prompt_tokens += self._request_tokens(req)
                    aplan, hold = holds.pop(0)
                    alloc.bind(slot, hold)
                    self._sync_admission(cache, slot, hold, aplan)
                    stats.prefix_hit_tokens += aplan.hit_tokens
                    if chunk is not None:
                        sched.mark_prefilling(slot)
                        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
                        prompts[slot] = prompt
                        pending[slot] = prompt[aplan.resume:]
                    else:
                        tok = self._prefill_into(cache, slot, req,
                                                 self._table_row(hold["table"]))
                        stats.prefills += 1
                        stats.weight_passes += 1
                        first_token(slot, req, tok)
                active = sched.active_slots()
                prefilling = sched.prefilling_slots()
                if not active and not prefilling:
                    # fast-forward the clock to the next arrival
                    if dead_rows:
                        self._void_table_rows(cache, dead_rows)
                    nxt = sched.next_arrival()
                    if nxt is None:
                        break
                    step = max(step + 1, nxt)
                    continue
                finishing = []
                if chunk is None or (not prefilling and cfg.window is None):
                    # decode fast path: with nobody prefilling the chunk step
                    # is plain decode, bit-equal on decode rows.  Windowed
                    # archs keep the chunk step (its layout differs).
                    logits, cache = registry.decode_step(
                        cfg, self.policy, self.params,
                        torch.as_tensor(last_tok, device=self.device), cache)
                else:
                    tokens = np.zeros((self.max_slots, chunk), np.int64)
                    n_new = np.zeros((self.max_slots,), np.int64)
                    for slot in active:
                        tokens[slot, 0] = last_tok[slot]
                        n_new[slot] = 1
                    for slot in prefilling:
                        buf = pending[slot]
                        take = min(chunk, len(buf))
                        tokens[slot, :take] = buf[:take]
                        n_new[slot] = take
                        pending[slot] = buf[take:]
                        if take == len(buf):
                            finishing.append(slot)
                    logits, cache = registry.chunk_step(
                        cfg, self.policy, self.params,
                        torch.as_tensor(tokens, device=self.device), n_new, cache)
                ntok = torch.argmax(logits, dim=-1)
                stats.decode_steps += 1
                stats.weight_passes += 1
                stats.occupancy_sum += (len(active) + len(prefilling)) / self.max_slots
                stats.pages_in_use_sum += alloc.pages_in_use()
                # where the reference stamps the next step's arrivals: after
                # the pass clock moved, before this step's retirements
                stamp_arrivals(step + 1)
                ntok = ntok.cpu().numpy()
                for slot in finishing:
                    sched.finish_prefill(slot)
                    stats.prefills += 1
                    if self.prefix_cache and cfg.window is None:
                        # publish the prompt's full pages BEFORE first_token
                        # may retire the slot
                        alloc.register_prefix(slot, prompts[slot], chunk)
                    first_token(slot, sched.active_request(slot), int(ntok[slot]))
                for slot in active:
                    req = sched.active_request(slot)
                    tok = int(ntok[slot])
                    out[req.uid].append(tok)
                    last_tok[slot] = tok
                    stats.emitted_tokens += 1
                    remaining[slot] -= 1
                    if remaining[slot] <= 0 or tok == req.eos_id:
                        retire(slot)
                if dead_rows:
                    self._void_table_rows(cache, dead_rows)
                sched.check_conservation()
                alloc.check_conservation()
                step += 1
        stats.cow_copies = alloc.cow_copies
        stats.evictions = alloc.evictions
        alloc.check_conservation()
        self.last_stats = stats
        return {uid: np.asarray(toks, np.int32) for uid, toks in out.items()}


def generate(cfg: ModelConfig, policy: QuantPolicy, params, batch, *,
             max_new_tokens: int, max_len: int, prequantize: bool = False,
             device=None) -> torch.Tensor:
    """Greedy generation: a :class:`PoolEngine` with one slot per request
    (all arrivals at step 0).  Returns (B, max_new_tokens) int32 on the
    CPU."""
    toks = np.asarray(batch["tokens"].cpu() if torch.is_tensor(batch["tokens"])
                      else batch["tokens"])
    b = toks.shape[0]
    reqs: List[Request] = [
        Request(uid=i, tokens=toks[i:i + 1], max_new_tokens=max_new_tokens)
        for i in range(b)
    ]
    eng = PoolEngine(cfg, policy, params, max_slots=b, max_len=max_len,
                     prequantize=prequantize, device=device)
    out = eng.run(reqs)
    return torch.as_tensor(np.stack([out[i] for i in range(b)]))
