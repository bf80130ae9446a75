"""Continuous-batching serving engine (port of ``repro/serve/engine.py``,
solo-prefill admission).

:class:`PoolEngine` keeps one fixed ``max_slots x max_len`` slot-pooled KV
cache, admits queued requests into free slots mid-flight through a solo
batch-1 prefill whose cache is copied into the slot, advances the whole
pool with one fixed-shape decode step per engine step (each slot at its
own position), and retires slots on EOS / ``max_new_tokens``.

Guarantee: batching never changes a request's tokens.  Each request's
output equals its solo run bit for bit, because every per-row computation
of the decode step is batch-invariant: K1 reduces each row on its own in
a fixed order, activation scales are per sample
(``policy.per_sample_act_scales``, forced on here), and the step's row
reductions run row by row (``models/transformer.py``).

The loop is synchronous; the reference's double-buffered admission,
chunked prefill, paging, prefix cache and speculative decoding are later
slices of the port.
"""
from __future__ import annotations

import dataclasses
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
    weight-streaming dispatch — a pooled decode step or a solo admission
    prefill — counts one pass.  ``ttft_passes[uid]`` is a request's
    time-to-first-token on that clock, from the first engine step at which
    it was admissible (queue wait included)."""

    decode_steps: int = 0
    prefills: int = 0
    emitted_tokens: int = 0
    prompt_tokens: int = 0
    weight_passes: int = 0
    occupancy_sum: float = 0.0  # sum over steps of occupied/max_slots
    ttft_passes: Dict = dataclasses.field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.decode_steps if self.decode_steps else 0.0

    @property
    def mean_ttft_passes(self) -> float:
        if not self.ttft_passes:
            return 0.0
        return sum(self.ttft_passes.values()) / len(self.ttft_passes)


class PoolEngine:
    """Continuous-batching serving engine over a slot-pooled KV cache.

    Weights are PoT-prequantized at construction by default
    (``serve/quantized_weights.py``); pass ``prequantize=False`` to serve
    the weights as given.  ``params`` must already lie on ``device``
    (default ``cuda``).  The KV cache is bf16, as in the reference."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy, params, *,
                 max_slots: int, max_len: int, prequantize: bool = True,
                 device=None):
        if cfg.family not in registry.PORTED_FAMILIES or cfg.moe is not None:
            raise NotImplementedError(
                f"PoolEngine: family {cfg.family!r} is not ported yet")
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
        self.last_stats: Optional[ServeStats] = None

    def _validate(self, requests: Sequence[Request]) -> None:
        seen = set()
        for r in requests:
            if r.uid in seen:
                raise ValueError(f"duplicate request uid {r.uid!r}")
            seen.add(r.uid)
            plen = int(np.asarray(r.tokens).shape[-1])
            need = plen + r.max_new_tokens
            if self.cfg.window is None and need > self.max_len:
                raise ValueError(
                    f"request {r.uid!r}: prompt ({plen}) + max_new_tokens "
                    f"({r.max_new_tokens}) = {need} exceeds the pool's "
                    f"max_len={self.max_len}"
                )

    def _prefill_into(self, cache, slot: int, req: Request):
        """Solo-prefill ``req`` (batch 1) and copy its cache into ``slot``.
        Returns (pool cache, first generated token)."""
        mini = registry.init_cache(self.cfg, 1, self.max_len, device=self.device)
        tokens = torch.as_tensor(np.asarray(req.tokens), dtype=torch.int64,
                                 device=self.device).reshape(1, -1)
        logits, mini = registry.prefill(self.cfg, self.policy, self.params,
                                        {"tokens": tokens}, mini)
        tok = int(torch.argmax(logits, dim=-1)[0])
        return slots_lib.write_slot(cache, mini, slot), tok

    def run(self, requests: Sequence[Request]) -> Dict:
        """Drive all ``requests`` to completion; returns {uid: np.ndarray
        of generated token ids (int32)}.  Counters land in ``last_stats``."""
        self._validate(requests)
        sched = FIFOScheduler(self.max_slots)
        for r in requests:
            sched.submit(r)
        stats = ServeStats()
        out: Dict = {r.uid: [] for r in requests}
        remaining: Dict[int, int] = {}
        arrival_pass: Dict = {}
        last_tok = np.zeros((self.max_slots,), np.int64)
        step = 0

        def retire_if_done(slot, req, tok):
            if remaining[slot] <= 0 or tok == req.eos_id:
                sched.retire(slot)

        with torch.inference_mode():
            cache = registry.init_pool_cache(
                self.cfg, self.max_slots, self.max_len, device=self.device)
            while not sched.all_done():
                for arr, uid in sched.pending_arrivals():
                    if arr <= step and uid not in arrival_pass:
                        arrival_pass[uid] = stats.weight_passes
                for slot, req in sched.admit(step):
                    stats.prompt_tokens += int(np.asarray(req.tokens).shape[-1])
                    cache, tok = self._prefill_into(cache, slot, req)
                    stats.prefills += 1
                    stats.weight_passes += 1
                    out[req.uid].append(tok)
                    stats.emitted_tokens += 1
                    stats.ttft_passes[req.uid] = (
                        stats.weight_passes
                        - arrival_pass.get(req.uid, stats.weight_passes))
                    last_tok[slot] = tok
                    remaining[slot] = req.max_new_tokens - 1
                    retire_if_done(slot, req, tok)
                active = sched.active_slots()
                if not active:
                    # fast-forward the clock to the next arrival
                    nxt = sched.next_arrival()
                    if nxt is None:
                        break
                    step = max(step + 1, nxt)
                    continue
                # dead slots keep riding the fixed-shape step: their rows
                # are independent of the live ones and are overwritten
                # whole on the next admission into the slot
                logits, cache = registry.decode_step(
                    self.cfg, self.policy, self.params,
                    torch.as_tensor(last_tok, device=self.device), cache)
                ntok = torch.argmax(logits, dim=-1).cpu().numpy()
                stats.decode_steps += 1
                stats.weight_passes += 1
                stats.occupancy_sum += len(active) / self.max_slots
                for slot in active:
                    req = sched.active_request(slot)
                    tok = int(ntok[slot])
                    out[req.uid].append(tok)
                    stats.emitted_tokens += 1
                    last_tok[slot] = tok
                    remaining[slot] -= 1
                    retire_if_done(slot, req, tok)
                sched.check_conservation()
                step += 1
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
