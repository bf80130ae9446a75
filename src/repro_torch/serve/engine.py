"""Serving engines (port of ``repro/serve/engine.py``: ``PoolEngine``,
``generate`` and ``lockstep_generate``).

:class:`PoolEngine` keeps one pool cache (built once,
``registry.init_pool_cache``; ``serve/slots.py``), block-table paged for
the attention families, and admits queued requests into free slots
mid-flight, in one of two ways:

* solo prefill (default): a batch-1 prefill whose cache is copied into
  the slot's pages, one extra weight pass per admission;
* chunked piggybacked prefill (``prefill_chunk=C``): the prompt streams
  C tokens per engine step through the same fused ``registry.chunk_step``
  that advances the decoding slots.  When no slot is prefilling, the
  engine dispatches plain ``decode_step`` instead (the decode fast path):
  the two step bodies are bit-equal on decode rows.

The recurrent families (ssm: mamba2; hybrid: recurrentgemma, RG-LRU
plus local attention) pool in the lifted slot-row layout
(``slots.lift_cache``): their state is O(1) in length, so there are no
pages, no allocator, no page counters, and every admission is a solo
prefill written into the slot's rows (``slots.write_slot``); they have
no chunk or verify step, so ``prefill_chunk``, ``spec``, the paged knobs
and ``kv_quant`` are refused, as in the reference.

The vlm and encdec families serve through the same engine.  A vlm
request's ``patch_embeds`` (``Request.extras``) prefix its prompt: it
takes positions in the cache and solo-prefills even in a chunked engine.
A chunked encdec admission first runs the encoder over the request's
``frames`` and writes the slot's cross K/V (``registry.encode_cross_kv``,
one weight pass); its decoder prompt then streams in by chunk steps.

A host-side :class:`~repro_torch.serve.slots.PageAllocator` hands every
admission its worst-case pages up front and defers admissions (FIFO,
head-blocking) when the pool runs short.  With ``prefix_cache=True``
finished prompts publish their full pages; a later prompt with the same
head maps them (shared), copies the page it will append into
(copy-on-write) and resumes streaming after the hit.  An encdec page is
shared only between requests with the same frames too: its decoder K/V
see them through cross attention (the reference keys on the prompt
alone, and maps pages made under another request's frames).  Idle
prefix pages are LRU-evicted to make room.

``kv_quant=KV_PINNED`` stores the K/V pages in the PoT wire format
(``core/compress.py``: 4-bit nibble codes and one int32 beta per token).
``spec=NgramDrafter(...)`` or ``spec=LowBitSelfDraft(...)`` serves by
speculative decoding (``serve/spec.py``): while no slot is prefilling,
each engine step drafts up to ``max_draft`` tokens a slot, scores them in
one ``registry.verify_step`` weight pass and keeps the greedy-accepted
prefix plus the verifier's own next token.

Guarantee: batching never changes a request's tokens.  Each request's
output equals its run alone through the same admission recipe (solo
prefill, or the same chunk size) bit for bit, for every page size, with
the prefix cache on or off, and with speculation on or off.  K1 reduces
each row on its own in a fixed order, activation scales are per sample
(``policy.per_sample_act_scales``, forced on here), each slot's norms and
attention run as programs of their own (``models/transformer.py``), a
MoE layer dispatches per slot (each slot its own expert capacity and
expert scales, ``transformer._moe_apply(per_slot=True)``), and a KV
page's codes have one scale per token.

Admission is double-buffered, as in the reference.  Right after a
pooled step is enqueued, its token vector starts on its way to the host
(:class:`_InflightTokens`: a ``non_blocking`` copy into a pinned buffer
and a CUDA event behind it).  While the step and the copy are in flight
the host stamps the next step's arrivals and stages the next chunk row
of every slot that stays prefilling; neither depends on this step's
tokens (finishing slots are known at dispatch, prefilling slots are
never retired).  Then it waits on the event, the one host sync of a
plain step, and retires, emits and admits from the arrived tokens.  The
step bodies and the uploads of tokens, chunk widths and page tables
hold no other sync (``device.to_device``).  The overlap can move
wall-clock time only: every token and counter is the synchronous
loop's.  Spec rounds and solo-prefill admissions read the device as the
reference does.

``cache_dtype`` (default bf16) is the dtype of the K/V pages and of a
solo prefill's mini cache; under ``kv_quant`` the pages hold codes and
betas and the mini cache keeps ``cache_dtype``.

Sharded serving (``plan=``, a pool plan of ``parallel/planner.py`` on a
concrete mesh; the dense decoder only, other families on a plan are
refused with a pointer to ROADMAP).  Every rank runs the same host
scheduler, allocator and counters.

* Model axis: weights are prequantized whole, then each rank keeps its
  shard (``plan.shard_params``) and steps with the plan's local config;
  the step bodies' collectives (``models/transformer.py``) give every
  model rank the whole logits.
* Data axis: the slots split evenly over the data ranks, in order; each
  data rank steps only its slots' rows of the pool (the table, ``len``
  and page stores are whole on every rank; a page is written and read
  only by the rank that owns its slot).  The sampled tokens of each step
  are all-gathered in rank order, so every rank takes the same
  decisions, and a solo prefill runs on the owner's ranks and broadcasts
  its first token.  When a finished prompt publishes its full pages to
  the prefix cache, the owner broadcasts their contents to the other
  data ranks, so any slot may map them: every token and every counter
  equals one rank's.
* Host syncs the sharded path adds: the token all-gather of each step,
  the first-token broadcast of a solo prefill and the page broadcast of
  a prefix publication (through the host under gloo), and the
  collectives of a step body on a model axis.

:func:`lockstep_generate` is the pre-pool loop the reference keeps as
servebench's baseline: one batched prefill, then the whole batch decodes
in lockstep (one shared position, per-tensor activation scales) to
``max_new_tokens``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compress
from repro_torch.core.policy import QuantPolicy, draft_policy
from repro_torch.device import resolve_device, to_device
from repro_torch.models import registry
from repro_torch.parallel import actshard, collectives
from repro_torch.parallel import planner as planner_lib
from repro_torch.serve import quantized_weights as qw
from repro_torch.serve import slots as slots_lib
from repro_torch.serve import spec as spec_lib
from repro_torch.serve.scheduler import FIFOScheduler, Request


@dataclasses.dataclass
class ServeStats:
    """Host-side counters from one :meth:`PoolEngine.run`.

    ``weight_passes`` is the deterministic cost clock: every full
    weight-streaming dispatch (a pooled decode, chunk or verify step, a
    solo admission prefill) counts one pass; a low-bit self-draft step
    counts in ``draft_weight_passes`` instead.  ``ttft_passes[uid]`` is a
    request's time-to-first-token on that clock, from the first engine
    step at which it was admissible (queue wait included).  The paging
    and speculation counters are as deterministic for a fixed trace."""

    decode_steps: int = 0  # pooled step dispatches (plain decode or chunk)
    prefills: int = 0  # completed admissions
    emitted_tokens: int = 0
    occupancy_sum: float = 0.0  # sum over steps of occupied/max_slots
    weight_passes: int = 0
    ttft_passes: Dict = dataclasses.field(default_factory=dict)
    accepted_tokens: int = 0  # draft tokens accepted by verify rounds
    draft_weight_passes: int = 0  # low-bit self-draft steps
    prompt_tokens: int = 0  # total prompt tokens across admitted requests
    prefix_hit_tokens: int = 0  # prompt tokens served from the prefix cache
    cow_copies: int = 0
    evictions: int = 0
    admission_deferrals: int = 0  # head-blocked admissions (page pressure)
    pages_in_use_sum: int = 0  # sum over pooled steps of live pages
    page_size: int = 0
    kv_page_bytes: int = 0  # bytes of one K+V page across all layers (wire format)
    # the mesh-shape keys of a sharded engine's plan (slot and weight
    # shard divisors); a one-card engine has no plan, so both stay 1
    data_shards: int = 1
    model_shards: int = 1
    # host wall-clock seconds from admissible to first token on the host;
    # a measurement of the port's own (the reference keeps none)
    ttft_s: Dict = dataclasses.field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.decode_steps if self.decode_steps else 0.0

    @property
    def per_device_weight_passes(self) -> float:
        """Full-weight-equivalent streams per device: each pass streams
        1/model_shards of the weight bytes on a device."""
        return self.weight_passes / max(1, self.model_shards)

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
    def accepted_tokens_per_weight_pass(self) -> float:
        """Tokens served per full-policy weight pass: plain decode serves
        at most one per pass and slot, speculation more."""
        return self.emitted_tokens / self.weight_passes if self.weight_passes else 0.0

    @property
    def kv_hbm_bytes_per_token(self) -> float:
        """Mean live KV footprint per emitted token (pages, not whole
        rows, pin memory)."""
        if not self.emitted_tokens:
            return 0.0
        return self.pages_in_use_sum * self.kv_page_bytes / self.emitted_tokens


class _InflightTokens:
    """The token vector of a dispatched step (a pooled step's, or a solo
    prefill's one token) on its way to the host.  On a card :meth:`start`
    copies it ``non_blocking`` into a pinned host buffer and records a
    CUDA event behind the copy; :meth:`wait` synchronizes on that event.
    A copy into pageable memory would block at once, so a card engine
    without its pinned buffer fails instead.  On the CPU the step is done
    when it returns, and :meth:`wait` is a plain copy."""

    def __init__(self, max_slots: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self._tok = None
        if self._cuda:
            self._host = torch.empty((max_slots,), dtype=torch.int64, pin_memory=True)
            if not self._host.is_pinned():
                raise RuntimeError("the host token buffer is not pinned")
            self._event = torch.cuda.Event()

    def start(self, tok: torch.Tensor) -> None:
        if tok.is_cuda != self._cuda:
            raise ValueError(f"token vector on {tok.device}, engine on "
                             f"{'cuda' if self._cuda else 'cpu'}")
        self._n = tok.shape[0]
        if self._cuda:
            self._host[:self._n].copy_(tok, non_blocking=True)
            self._event.record()
        else:
            self._tok = tok

    def wait(self) -> np.ndarray:
        """Block until the copy lands; the host token vector."""
        if self._cuda:
            self._event.synchronize()
            return self._host[:self._n].numpy().copy()
        return self._tok.numpy().copy()


class PoolEngine:
    """Continuous-batching serving engine over a slot-pooled cache (paged
    for the attention families, slot rows for the recurrent ones).

    Weights are PoT-prequantized at construction by default
    (``serve/quantized_weights.py``); pass ``prequantize=False`` to serve
    the weights as given.  ``params`` must already lie on ``device``
    (default ``cuda``).  The KV cache holds ``cache_dtype`` values
    (default bf16, as in the reference) or the PoT wire format of
    ``kv_quant`` (default ``policy.kv_quant``).

    ``prefill_chunk=C`` admits by chunked piggybacked prefill (C in
    [1, span]).  Chunking is part of a request's recipe (a chunk is one
    activation-scale group), so chunked tokens differ from solo-prefill
    tokens; pool and solo agree for the same C.  ``page_size`` (default
    the whole span) must divide the span; ``num_pages`` defaults to
    ``max_slots * span / page_size``.  ``prefix_cache`` needs
    ``prefill_chunk``.  ``spec`` is a ``serve.spec.NgramDrafter`` or
    ``LowBitSelfDraft``; its verify row (``max_draft + 1`` positions) must
    fit the span.

    ``plan`` (``planner.plan_for(..., pool_slots=max_slots)``) keys the
    engine by page geometry and ``kv_bits`` as in the reference, and sets
    ``ServeStats.data_shards`` / ``model_shards``; on a concrete mesh of
    more than one rank it shards the engine (module docstring)."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy, params, *,
                 max_slots: int, max_len: int, prequantize: bool = True,
                 prefill_chunk: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False, spec=None, kv_quant=None,
                 cache_dtype=torch.bfloat16, device=None, plan=None):
        if cfg.family not in registry.POOLED_FAMILIES:
            raise NotImplementedError(
                f"PoolEngine: family {cfg.family!r} lacks per-slot decode")
        span = registry.pool_span(cfg, max_len)
        if spec is not None:
            if cfg.family not in registry.SPEC_FAMILIES:
                raise NotImplementedError(
                    f"spec: family {cfg.family!r} has no verify step "
                    f"(supported: {registry.SPEC_FAMILIES})")
            if not isinstance(spec, (spec_lib.NgramDrafter, spec_lib.LowBitSelfDraft)):
                raise TypeError(
                    "spec must be a serve.spec.NgramDrafter or "
                    f"serve.spec.LowBitSelfDraft (got {type(spec).__name__})")
            if spec.max_draft + 1 > span:
                raise ValueError(
                    f"spec.max_draft={spec.max_draft}: a verify row of "
                    f"{spec.max_draft + 1} positions exceeds the cache span {span}")
        if prefill_chunk is not None:
            if cfg.family not in registry.CHUNKED_FAMILIES:
                raise NotImplementedError(
                    f"prefill_chunk: family {cfg.family!r} has no fused chunk "
                    f"step (supported: {registry.CHUNKED_FAMILIES})")
            if not 1 <= prefill_chunk <= span:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be in [1, {span}] "
                    "(the cache span) so a chunk's ring writes cannot collide")
        self.paged = cfg.family in registry.PAGED_FAMILIES
        if not self.paged and (page_size is not None or num_pages is not None
                               or prefix_cache):
            raise ValueError(
                f"family {cfg.family!r} has no paged cache (paged: "
                f"{registry.PAGED_FAMILIES}); drop page_size/num_pages/prefix_cache")
        # the kwarg wins, else the policy's recipe; either way every step
        # body reads it from the policy
        kv_quant = kv_quant if kv_quant is not None else policy.kv_quant
        if kv_quant is not None:
            if not self.paged:
                raise ValueError(
                    f"kv_quant: family {cfg.family!r} has no paged KV cache to "
                    f"quantize (paged: {registry.PAGED_FAMILIES})")
            compress.kv_code_width(kv_quant, cfg.head_dim)  # even head_dim
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
        policy = dataclasses.replace(policy, kv_quant=kv_quant)
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
        self.plan = plan
        self.step_cfg = cfg
        self.sharded = False
        self.data_rank, self.data_size = 0, 1
        if plan is not None:
            self._check_plan(plan, cfg, policy, max_slots, kv_quant, spec)
            if self.sharded:
                params = plan.shard_params(params)
                self.step_cfg = plan.local_config()
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.span = span
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.kv_quant = kv_quant
        self.spec = spec
        # the self-draft: the same weights at spec.bits, re-quantized at use
        self.draft_policy = (draft_policy(policy, spec.bits)
                             if spec is not None and spec.needs_draft_pass else None)
        self.last_stats: Optional[ServeStats] = None

    def _check_plan(self, plan, cfg, policy, max_slots, kv_quant, spec):
        """The reference's refusals (slot count, page geometry, kv_bits),
        then, on a concrete mesh of more than one rank, what the sharded
        runtime takes."""
        if getattr(plan, "pool_slots", None) != max_slots:
            raise ValueError(
                "PoolEngine plans must be built with planner.plan_for(..., "
                "pool_slots=max_slots) so the cache specs cover the per-slot leaves; got "
                f"pool_slots={getattr(plan, 'pool_slots', None)!r}, max_slots={max_slots}")
        if self.paged and plan.page_size is not None and (
                plan.page_size != self.page_size or plan.num_pages != self.num_pages):
            raise ValueError(
                f"PoolEngine plan was built for page geometry (page_size={plan.page_size}, "
                f"num_pages={plan.num_pages}) but the engine uses (page_size="
                f"{self.page_size}, num_pages={self.num_pages}); rebuild the plan with "
                "planner.plan_for(..., page_size=..., num_pages=...)")
        eng_bits = kv_quant.bits if kv_quant is not None else None
        if self.paged and plan.kv_bits != eng_bits:
            raise ValueError(
                f"PoolEngine plan was built for kv_bits={plan.kv_bits} but the engine "
                f"quantizes at kv_bits={eng_bits}; rebuild the plan with "
                "planner.plan_for(..., kv_quant=...)")
        if not getattr(plan.mesh, "is_concrete", False) or plan.mesh.size == 1:
            return
        refuse = None
        if not planner_lib.is_dense_decoder(cfg):
            refuse = f"family {cfg.family!r}{' (MoE)' if cfg.moe else ''}"
        elif spec is not None:
            refuse = "speculative decoding"
        elif plan.model_shards > 1 and kv_quant is not None:
            refuse = "quantized K/V pages on a model axis (a token's scale spans its heads)"
        elif plan.model_shards > 1 and (not policy.enabled or policy.quantize_attention):
            refuse = "a model axis under an unquantized policy or quantize_attention"
        if refuse is not None:
            raise NotImplementedError(
                f"PoolEngine on a sharded plan runs the dense decoder only; {refuse} on a "
                "plan is not ported yet (ROADMAP Queue 1)")
        self.data_rank, self.data_size = actshard.data_rank_and_size(plan)
        if max_slots % self.data_size:
            raise ValueError(f"max_slots={max_slots} must split evenly over the "
                             f"{self.data_size} data ranks")
        self.sharded = True

    # -- the sharded pool's local rows -----------------------------------------
    def _local_rows(self):
        """The slots [lo, hi) this data rank steps."""
        n = self.max_slots // self.data_size
        return self.data_rank * n, (self.data_rank + 1) * n

    def _owner(self, slot: int) -> int:
        return slot // (self.max_slots // self.data_size)

    def _pool_step(self, cache, tokens, n_new=None):
        """One pooled step (``decode_step`` when ``n_new`` is None, else
        ``chunk_step``) over this data rank's slots; returns the sampled
        token of every slot (the data ranks' tokens all-gathered in rank
        order)."""
        dev = self.device
        if self.data_size == 1:
            if n_new is None:
                logits, _ = registry.decode_step(self.step_cfg, self.policy, self.params,
                                                 to_device(tokens, dev), cache)
            else:
                logits, _ = registry.chunk_step(self.step_cfg, self.policy, self.params,
                                                to_device(tokens, dev), n_new, cache)
            return torch.argmax(logits, dim=-1)
        lo, hi = self._local_rows()
        sub = dict(cache, table=cache["table"][lo:hi], len=cache["len"][lo:hi])
        if n_new is None:
            logits, sub = registry.decode_step(self.step_cfg, self.policy, self.params,
                                               to_device(tokens[lo:hi], dev), sub)
        else:
            logits, sub = registry.chunk_step(self.step_cfg, self.policy, self.params,
                                              to_device(tokens[lo:hi], dev), n_new[lo:hi], sub)
        cache["len"][lo:hi] = sub["len"]
        return torch.cat(collectives.all_gather(torch.argmax(logits, dim=-1),
                                                self.plan.mesh.group("data")))

    def _publish_pages(self, cache, slot: int, pages) -> None:
        """Over a data axis: the owner of ``slot`` broadcasts the contents
        of ``pages`` (their K/V, betas and ``pos``) to the other data
        ranks, which hold them stale, so a prefix hit on any rank reads
        what one rank would."""
        if self.data_size == 1 or not pages:
            return
        ids = to_device(list(pages), self.device, torch.int64)
        group, owner = self.plan.mesh.group("data"), self._owner(slot)
        for key in ("k", "v", "k_beta", "v_beta"):
            if key in cache:
                cache[key][:, ids] = collectives.broadcast(cache[key][:, ids].contiguous(),
                                                           owner, group)
        cache["pos"][ids] = collectives.broadcast(cache["pos"][ids].contiguous(), owner,
                                                  group)

    # -- request admission -------------------------------------------------
    def _validate(self, requests: Sequence[Request]) -> None:
        seen = set()
        for r in requests:
            if r.uid in seen:
                raise ValueError(f"duplicate request uid {r.uid!r}")
            seen.add(r.uid)
            plen = self._request_tokens(r)  # a vlm's patches take positions
            need = plen + r.max_new_tokens
            # a windowed arch decodes from a ring whose wrap is the model's
            # semantics, and an ssm's state is O(1) in length; otherwise the
            # request must fit its page budget (unpaged: the slot's row)
            if self.cfg.family == "ssm" or self.cfg.window is not None:
                continue
            if not self.paged:
                if need > self.max_len:
                    raise ValueError(
                        f"request {r.uid!r}: prompt ({plen}) + max_new_tokens "
                        f"({r.max_new_tokens}) = {need} exceeds the pool's "
                        f"max_len={self.max_len}")
                continue
            need_pages = -(-need // self.page_size)
            if need_pages > self.pages_per_slot:
                raise ValueError(
                    f"request {r.uid!r}: prompt ({plen}) + max_new_tokens "
                    f"({r.max_new_tokens}) = {need} tokens need {need_pages} "
                    f"pages of {self.page_size}, exceeding the per-slot budget "
                    f"of {self.pages_per_slot} pages (max_len={self.max_len})")

    def _prefill_into(self, cache, slot: int, req: Request, pages, flight):
        """Solo-prefill ``req`` (batch 1, its extras passed along) and copy
        its cache into the slot's ``pages`` (a slot-row pool: the slot's
        rows, ``pages`` None).  Returns the first generated token, read
        through ``flight`` (an explicit sync)."""
        dev = self.device
        owner = self._owner(slot) if self.data_size > 1 else 0
        if owner == self.data_rank:
            mini = registry.init_cache(self.step_cfg, 1, self.max_len, self.cache_dtype,
                                       device=dev)
            batch = {"tokens": to_device(np.asarray(req.tokens), dev,
                                         torch.int64).reshape(1, -1)}
            batch.update({k: to_device(np.asarray(v), dev) for k, v in req.extras.items()})
            logits, mini = registry.prefill(self.step_cfg, self.policy, self.params, batch,
                                            mini)
            slots_lib.write_slot(cache, mini, slot, pages=pages, kv_quant=self.kv_quant)
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = torch.zeros((1,), dtype=torch.int64, device=dev)
        if self.data_size > 1:  # the owner's first token to every data rank
            collectives.broadcast(tok, owner, self.plan.mesh.group("data"))
        flight.start(tok)
        return int(flight.wait()[0])

    def _chunkable(self, req: Request) -> bool:
        """Chunked admission for this request?  A vlm's patch prefix is
        activations, not tokens: such a request solo-prefills even in a
        chunked engine."""
        return self.prefill_chunk is not None and "patch_embeds" not in req.extras

    def _admit_encoder(self, cache, slot: int, req: Request) -> None:
        """Chunked encdec admission: the encoder pass over the request's
        frames and the decoder layers' cross K/V, written into the slot
        (one weight pass); the prompt then streams in by chunk steps."""
        frames = to_device(np.asarray(req.extras["frames"]), self.device, torch.float32)
        cks, cvs = registry.encode_cross_kv(self.cfg, self.policy, self.params, frames)
        slots_lib.write_cross(cache, cks, cvs, slot)

    @staticmethod
    def _prompt_len(req: Request) -> int:
        return int(np.asarray(req.tokens).shape[-1])

    def _request_tokens(self, req: Request) -> int:
        """Positions the prompt takes in the cache: its tokens, after a
        vlm's patches."""
        plen = self._prompt_len(req)
        if "patch_embeds" in req.extras:
            plen += int(np.asarray(req.extras["patch_embeds"]).shape[1])
        return plen

    def _admission_plan(self, alloc, req: Request):
        """Worst-case token need (capped at the span: a ring wrap revisits
        pages) and, when enabled, the prefix-cache lookup."""
        need = self._request_tokens(req) + req.max_new_tokens
        prompt = chunk = None
        if self.prefix_cache and self._chunkable(req) and self.cfg.window is None:
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            chunk = self.prefill_chunk
        return alloc.plan_admission(prompt, min(need, self.span), chunk,
                                    self._prefix_context(req))

    @staticmethod
    def _prefix_context(req: Request) -> bytes:
        """What a request's prefix pages depend on besides its prompt.  An
        encdec decoder's self-attention K/V from layer 1 up see the
        request's frames through cross attention, so its pages are shared
        only between requests with the same frames (a digest of them)."""
        if "frames" not in req.extras:
            return b""
        frames = np.ascontiguousarray(req.extras["frames"], np.float32)
        return hashlib.sha256(frames.tobytes()).digest()

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
        cache["table"][slot] = to_device(self._table_row(hold["table"]), dev,
                                         cache["table"].dtype)
        if hold["new"]:
            cache["pos"].index_fill_(0, to_device(hold["new"], dev, torch.int64), -1)
        for src, dst in hold["copies"]:
            for key in ("k", "v", "k_beta", "v_beta"):
                if key in cache:
                    cache[key][:, dst] = cache[key][:, src]
            sp = cache["pos"][src]
            cache["pos"][dst] = torch.where(sp < aplan.resume, sp, torch.full_like(sp, -1))
        cache["len"][slot].fill_(aplan.resume)  # a fill: no host copy, no sync

    def _void_table_rows(self, cache, dead_slots):
        """Retired slots keep riding the fixed-shape step: point their
        table rows at drop_id so their writes land nowhere."""
        for slot in dead_slots:
            cache["table"][slot].fill_(slots_lib.drop_id(self.num_pages))

    def _stats(self) -> ServeStats:
        """Fresh counters; a slot-row pool has no pages (page_size and
        kv_page_bytes 0, as in the reference)."""
        cfg = self.cfg
        if not self.paged:
            return ServeStats()
        if self.kv_quant is not None:
            leaf = compress.kv_page_wire_bytes(self.kv_quant, self.page_size,
                                               cfg.kv_heads, cfg.head_dim)
        else:
            itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
            leaf = self.page_size * cfg.kv_heads * cfg.head_dim * itemsize
        return ServeStats(page_size=self.page_size, kv_page_bytes=2 * cfg.n_layers * leaf)

    def _draft(self, last_tok, cache):
        """``max_draft`` greedy decode steps under the draft policy on the
        live cache; returns the draft tokens (B, max_draft) with ``len``
        rewound (the caller restores the cache entries written)."""
        token = torch.as_tensor(last_tok, device=self.device)
        toks = []
        for _ in range(self.spec.max_draft):
            logits, cache = registry.decode_step(self.cfg, self.draft_policy, self.params,
                                                 token, cache)
            token = torch.argmax(logits, dim=-1)
            toks.append(token)
        cache["len"] = cache["len"] - self.spec.max_draft
        return torch.stack(toks, dim=1)

    def _spec_round(self, cache, stats, reqs, alloc, remaining, last_tok,
                    histories):
        """Draft, then one verify pass when any slot has a draft.  Returns
        None when none has (the cache is as it was; the caller runs a
        plain step), else ``(emitted, lens, n_new)``: the tokens each slot
        of ``reqs`` ({slot: request}) emits (greedy acceptance, cut at EOS
        and at its budget), and the pre-round lengths and verify-row
        widths.  Rejected positions are rolled back here."""
        spec = self.spec
        active = sorted(reqs)
        c = spec.max_draft + 1
        lens = cache["len"].cpu().numpy()
        snap = slots_lib.spec_snapshot(cache, c)
        if spec.needs_draft_pass:
            dtoks = self._draft(last_tok, cache)
            stats.draft_weight_passes += spec.max_draft
            # the verify pass must see the pristine pre-round cache
            slots_lib.spec_restore(cache, snap, torch.zeros_like(snap["len"]))
            dhost = dtoks.cpu().numpy()
            drafts = {slot: dhost[slot] for slot in active}
        else:
            drafts = {slot: spec.propose(histories[slot], spec.max_draft)
                      for slot in active}
        tokens = np.zeros((self.max_slots, c), np.int64)
        n_new = np.zeros((self.max_slots,), np.int64)
        for slot in active:
            cap = remaining[slot]
            if self.cfg.window is None:
                # a verify row's valid positions may not wrap the span
                cap = min(cap, self.span - int(lens[slot]))
            nd = max(0, min(len(drafts[slot]), cap - 1, c - 1))
            tokens[slot, 0] = last_tok[slot]
            tokens[slot, 1:1 + nd] = drafts[slot][:nd]
            n_new[slot] = 1 + nd
        if int(n_new.max()) <= 1:
            return None
        logits, cache = registry.verify_step(
            self.cfg, self.policy, self.params,
            torch.as_tensor(tokens, device=self.device), n_new, cache)
        vhost = torch.argmax(logits, dim=-1).cpu().numpy()  # (B, C)
        stats.decode_steps += 1
        stats.weight_passes += 1
        stats.occupancy_sum += len(active) / self.max_slots
        stats.pages_in_use_sum += alloc.pages_in_use()
        keep = np.zeros((self.max_slots,), np.int64)
        emitted = {}
        for slot in active:
            eos, nd = reqs[slot].eos_id, int(n_new[slot]) - 1
            a = spec_lib.greedy_accept(tokens[slot, 1:1 + nd], vhost[slot, :nd])
            emit = [int(t) for t in tokens[slot, 1:1 + a]] + [int(vhost[slot, a])]
            # sequential decode's stop rules: the first EOS, the budget
            for j, t in enumerate(emit):
                if t == eos:
                    emit = emit[:j + 1]
                    break
            emit = emit[:remaining[slot]]
            keep[slot] = len(emit)
            stats.accepted_tokens += len(emit) - 1
            emitted[slot] = emit
        # keep[slot] positions cache exactly the consumed context (the
        # last emitted token is never cached, as in decode)
        slots_lib.spec_restore(cache, snap, torch.as_tensor(keep, device=self.device))
        return emitted, lens, n_new

    def _drop_rejected_pages(self, cache, alloc, rnd, spec_dropped):
        """Table entries of pages a spec round wrote only rejected
        positions into go to drop_id (their ``pos`` is back at -1); they
        are re-bound from ``alloc.tables`` before the slot's next step."""
        emitted, lens, n_new = rnd
        drop = slots_lib.drop_id(self.num_pages)
        rows, cols = [], []
        for slot, emit in emitted.items():
            p0 = int(lens[slot])
            lo = -(-(p0 + len(emit)) // self.page_size)
            hi = (p0 + int(n_new[slot]) - 1) // self.page_size
            nmap = len(alloc.tables[slot])  # 0 once the slot retired
            for lp in range(lo, min(hi, nmap - 1) + 1):
                spec_dropped.setdefault(slot, set()).add(lp)
                rows.append(slot)
                cols.append(lp)
        if rows:
            dev = self.device
            cache["table"][to_device(rows, dev), to_device(cols, dev)] = drop

    def _rebind_dropped_pages(self, cache, alloc, spec_dropped):
        rows, cols, pids = [], [], []
        for slot, lps in spec_dropped.items():
            row = alloc.tables[slot]
            for lp in sorted(lps):
                if lp < len(row):
                    rows.append(slot)
                    cols.append(lp)
                    pids.append(int(row[lp]))
        if rows:
            dev = self.device
            cache["table"][to_device(rows, dev), to_device(cols, dev)] = to_device(pids, dev)
        spec_dropped.clear()

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
        if self.plan is not None:
            stats.data_shards = self.plan.fsdp_size()
            stats.model_shards = self.plan.model_size()
        alloc = (slots_lib.PageAllocator(self.num_pages, self.page_size,
                                         self.pages_per_slot, self.max_slots)
                 if self.paged else None)
        out: Dict = {r.uid: [] for r in requests}
        remaining: Dict[int, int] = {}  # slot -> tokens still to emit
        pending: Dict[int, np.ndarray] = {}  # slot -> unconsumed prompt
        prompts: Dict[int, np.ndarray] = {}  # slot -> full prompt
        histories: Dict[int, List[int]] = {}  # slot -> prompt + emitted (n-gram)
        spec_dropped: Dict[int, set] = {}  # slot -> table columns at drop_id
        track_hist = isinstance(self.spec, spec_lib.NgramDrafter)
        arrival_pass: Dict = {}  # uid -> weight_passes when first admissible
        arrival_time: Dict = {}  # uid -> host clock when first admissible
        holds: List = []  # reserve() results, FIFO with sched.admit's pairs
        last_tok = np.zeros((self.max_slots,), np.int64)
        chunk = self.prefill_chunk
        # double-buffered admission: {slot: (row, finishes)}, the chunk
        # rows staged for the NEXT step while this one is in flight
        staged: Dict[int, tuple] = {}
        flight = _InflightTokens(self.max_slots, self.device)
        step = 0

        def next_chunk(slot):
            """The slot's next prompt chunk and whether it ends the prompt;
            the chunk leaves ``pending``."""
            buf = pending[slot]
            pending[slot] = buf[chunk:]
            return buf[:chunk], len(buf) <= chunk

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
            if alloc is not None:
                alloc.release_slot(slot)
                dead_rows.append(slot)
            prompts.pop(slot, None)
            histories.pop(slot, None)
            spec_dropped.pop(slot, None)

        def emit_tokens(slot, req, toks):
            out[req.uid].extend(toks)
            if track_hist:
                histories[slot].extend(toks)
            last_tok[slot] = toks[-1]
            stats.emitted_tokens += len(toks)
            remaining[slot] -= len(toks)
            if remaining[slot] <= 0 or toks[-1] == req.eos_id:
                retire(slot)

        def first_token(slot, req, tok):
            stats.ttft_passes[req.uid] = (
                stats.weight_passes - arrival_pass.get(req.uid, stats.weight_passes))
            stats.ttft_s[req.uid] = time.perf_counter() - arrival_time[req.uid]
            remaining[slot] = req.max_new_tokens
            emit_tokens(slot, req, [tok])

        with torch.inference_mode(), actshard.use_plan(self.plan if self.sharded else None):
            paged_kw = (dict(page_size=self.page_size, num_pages=self.num_pages,
                             kv_quant=self.kv_quant) if self.paged else {})
            cache = registry.init_pool_cache(
                self.step_cfg, self.max_slots, self.max_len, self.cache_dtype,
                device=self.device, **paged_kw)
            if alloc is not None:
                # the allocator owns every mapping: dead slots must write
                # into nothing, not into pages the allocator will hand out
                cache["table"].fill_(slots_lib.drop_id(self.num_pages))
            while not sched.all_done():
                stamp_arrivals(step)
                dead_rows: List[int] = []
                if alloc is not None:
                    alloc.tick(step)
                for slot, req in sched.admit(step, can_admit_cb if alloc is not None else None):
                    stats.prompt_tokens += self._prompt_len(req)
                    if track_hist:
                        histories[slot] = np.asarray(req.tokens, np.int64).reshape(-1).tolist()
                    pages = None
                    if alloc is not None:
                        aplan, hold = holds.pop(0)
                        alloc.bind(slot, hold)
                        self._sync_admission(cache, slot, hold, aplan)
                        stats.prefix_hit_tokens += aplan.hit_tokens
                        pages = self._table_row(hold["table"])
                    if self._chunkable(req):
                        if cfg.family == "encdec":
                            self._admit_encoder(cache, slot, req)
                            stats.weight_passes += 1  # the encoder-side pass
                        sched.mark_prefilling(slot)
                        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
                        prompts[slot] = prompt
                        pending[slot] = prompt[aplan.resume:]
                    else:
                        tok = self._prefill_into(cache, slot, req, pages, flight)
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
                if spec_dropped:
                    # re-bind pages a spec round dropped before anything
                    # writes through them again (their pos is -1 either way)
                    self._rebind_dropped_pages(cache, alloc, spec_dropped)
                if self.spec is not None and active and not prefilling:
                    reqs = {slot: sched.active_request(slot) for slot in active}
                    rnd = self._spec_round(cache, stats, reqs, alloc, remaining,
                                           last_tok, histories)
                    if rnd is not None:
                        for slot, emit in rnd[0].items():
                            emit_tokens(slot, reqs[slot], emit)
                        if cfg.window is None:
                            self._drop_rejected_pages(cache, alloc, rnd, spec_dropped)
                        if dead_rows:
                            self._void_table_rows(cache, dead_rows)
                        sched.check_conservation()
                        alloc.check_conservation()
                        step += 1
                        continue
                    # no slot had a draft: the cache is as before the
                    # round, so the plain step runs
                finishing = []
                if chunk is None or (not prefilling and cfg.window is None):
                    # decode fast path: with nobody prefilling the chunk step
                    # is plain decode, bit-equal on decode rows.  Windowed
                    # archs keep the chunk step (its layout differs).
                    tok = self._pool_step(cache, last_tok)
                else:
                    tokens = np.zeros((self.max_slots, chunk), np.int64)
                    n_new = np.zeros((self.max_slots,), np.int64)
                    for slot in active:
                        tokens[slot, 0] = last_tok[slot]
                        n_new[slot] = 1
                    for slot in prefilling:
                        # staged while the previous step was in flight, or
                        # (first chunk of a fresh admission) taken now
                        row, fin = staged.pop(slot) if slot in staged else next_chunk(slot)
                        tokens[slot, :len(row)] = row
                        n_new[slot] = len(row)
                        if fin:
                            finishing.append(slot)
                    tok = self._pool_step(cache, tokens, n_new)
                flight.start(tok)
                # -- overlap window: the step and its token copy are in
                # flight; nothing here may depend on this step's tokens
                stats.decode_steps += 1
                stats.weight_passes += 1
                stats.occupancy_sum += (len(active) + len(prefilling)) / self.max_slots
                if alloc is not None:
                    stats.pages_in_use_sum += alloc.pages_in_use()
                # the next step's arrivals stamp against the moved pass
                # clock, and every slot that stays prefilling gets its next
                # chunk row (finishing slots need this step's token first)
                stamp_arrivals(step + 1)
                for slot in prefilling:
                    if slot not in finishing:
                        staged[slot] = next_chunk(slot)
                # -- the one host sync of the step: its tokens arrive
                ntok = flight.wait()
                for slot in finishing:
                    sched.finish_prefill(slot)
                    stats.prefills += 1
                    if self.prefix_cache and cfg.window is None:
                        # publish the prompt's full pages BEFORE first_token
                        # may retire the slot
                        alloc.register_prefix(slot, prompts[slot], chunk,
                                              self._prefix_context(sched.active_request(slot)))
                        self._publish_pages(
                            cache, slot, alloc.tables[slot][:len(prompts[slot]) // self.page_size])
                    first_token(slot, sched.active_request(slot), int(ntok[slot]))
                for slot in active:
                    emit_tokens(slot, sched.active_request(slot), [int(ntok[slot])])
                if dead_rows:
                    self._void_table_rows(cache, dead_rows)
                sched.check_conservation()
                if alloc is not None:
                    alloc.check_conservation()
                step += 1
        if alloc is not None:
            stats.cow_copies = alloc.cow_copies
            stats.evictions = alloc.evictions
            alloc.check_conservation()
        self.last_stats = stats
        return {uid: np.asarray(toks, np.int32) for uid, toks in out.items()}


def generate(cfg: ModelConfig, policy: QuantPolicy, params, batch, *,
             max_new_tokens: int, max_len: int, cache_dtype=torch.bfloat16,
             prequantize: bool = False, device=None) -> torch.Tensor:
    """Greedy generation: a :class:`PoolEngine` with one slot per request
    (all arrivals at step 0), so a row's tokens do not depend on the
    other rows.  ``batch`` holds ``tokens`` (B, S) and a family's
    ``frames`` or ``patch_embeds``, split per request.  Returns (B,
    max_new_tokens) int32 on the CPU."""
    host = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in batch.items()
            if k in ("tokens", "frames", "patch_embeds")}
    b = host["tokens"].shape[0]
    reqs: List[Request] = [
        Request(uid=i, tokens=host["tokens"][i:i + 1], max_new_tokens=max_new_tokens,
                extras={k: v[i:i + 1] for k, v in host.items() if k != "tokens"})
        for i in range(b)
    ]
    eng = PoolEngine(cfg, policy, params, max_slots=b, max_len=max_len,
                     prequantize=prequantize, cache_dtype=cache_dtype, device=device)
    out = eng.run(reqs)
    return torch.as_tensor(np.stack([out[i] for i in range(b)]))


def lockstep_generate(cfg: ModelConfig, policy: QuantPolicy, params, batch, *,
                      max_new_tokens: int, max_len: int, cache_dtype=torch.bfloat16,
                      device=None) -> torch.Tensor:
    """The pre-pool serving loop, kept as servebench's baseline: one
    batched prefill of ``batch["tokens"]`` (B, S), then ``max_new_tokens
    - 1`` lockstep decode steps of the whole batch, every row at the same
    position (dead rows stream every weight for nothing).  The policy is
    taken as given: activation scales are per tensor over the batch
    unless ``policy.per_sample_act_scales``, and the weights are
    quantized at use unless ``policy.weights_prequantized``.  At batch 1
    it gives a :class:`PoolEngine` request's tokens, bit for bit.  A
    family's ``frames`` or ``patch_embeds`` in ``batch`` go to the
    prefill.  Returns (B, max_new_tokens) int32 on the CPU."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, generation runs on {dev}")
    tokens = torch.as_tensor(batch["tokens"]).to(dev, torch.int64)
    inputs = {"tokens": tokens}
    inputs.update({k: torch.as_tensor(batch[k]).to(dev, torch.float32)
                   for k in ("frames", "patch_embeds") if k in batch})
    with torch.inference_mode():
        cache = registry.init_cache(cfg, tokens.shape[0], max_len, cache_dtype, device=dev)
        logits, cache = registry.prefill(cfg, policy, params, inputs, cache)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = registry.decode_step(cfg, policy, params, tok, cache)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32).cpu()
