"""KV memory of the serving pool (port of ``repro/serve/slots.py``): the
block-table paged layout, the page allocator with its shared-prefix cache,
and the contiguous slot-row helpers kept for direct callers.

Paged layout (``registry.init_pool_cache``, the engine's default):

    k/v   (L, num_pages+1, page, KV, hd)   physical page store
    pos   (num_pages+1, page)              global position per physical slot
    len   (max_slots,)                     per-slot sequence length
    table (max_slots, pages_per_slot)      logical page -> physical page

With a ``KVQuantSpec`` the page stores hold the PoT wire format
(``core/compress.py``): ``k``/``v`` become uint8 code pages
(L, num_pages+1, page, KV, hd/2) beside int32 per-token scales
``k_beta``/``v_beta`` (L, num_pages+1, page), page-shaped so a page's
scales travel with it.

A slot's logical row is reassembled in the step bodies by gathering
``k[table[slot]]``: it holds the same (position, value) pairs in the same
logical order whatever the physical layout, so attention reduces over the
same values for every page size (pool-vs-solo identity survives paging).

Two sentinel page ids make dead state self-masking:

* page ``num_pages`` is the **null page**: never written, its ``pos``
  stays -1, so a gather that lands there is masked out by attention;
* table entries of unallocated and retired slots hold ``num_pages + 1``
  (:func:`drop_id`).  The reference relies on jit's out-of-bounds
  semantics for it (scatters drop, gathers clamp).  Torch has neither, so
  the port clamps every gather onto the null page (:func:`gather_view`) and
  writes only through entries below ``num_pages``
  (``models.transformer.paged_write``): nothing indexes out of bounds.

An encdec pool also carries each slot's cross-attention K/V, ``ck``/``cv``
(L, max_slots, enc_seq, KV, hd): slot-rowed, never paged, never
quantized and never shared.  They are written once per admission
(:func:`write_slot`, or the engine's encoder-side pass) and a
speculative rollback never touches them.  On a sharded plan the pool is
built from the plan's local config, so on a model axis KV is this rank's
K/V heads; over a data axis only the data rank that owns a slot writes
its rows (``serve/engine.py``), and a pooled step reads them through the
rank's slice of the slot axis.

Slot-row layout (``lift_cache``): every leaf of ``init_cache(cfg,
max_slots, max_len)`` keeps its batch axis as the slot axis, ``len``
becomes (max_slots,) and each ``pos`` leaf (max_slots, span).  It is the
pool of the recurrent families (ssm: per-layer conv windows and SSM
states; hybrid: a tuple of per-layer dicts, RG-LRU states and attention
rings), whose state is O(1) in length and has nothing to page; an
attention family's ``decode_step`` still accepts it (``k``/``v``
(L, max_slots, span, KV, hd)).  On a sharded plan it is built from the
plan's local config, so its widths are this model rank's (an ssm's
``conv`` channels of its heads and B and C, its heads' ``ssm`` states; a
hybrid's RG-LRU channels in ``conv`` and ``lru``); over a data axis a
rank steps its slots' rows through :func:`slot_rows`.

:class:`PageAllocator` is host-side bookkeeping in numpy (free list,
refcounts, per-slot tables, a prompt-keyed prefix cache with LRU eviction
and copy-on-write); the engine mirrors its tables and page resets into
the device cache once per admission.  The helpers here update the pool in
place and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compress
from repro_torch.core.policy import KVQuantSpec
from repro_torch.device import to_device
from repro_torch.models import transformer


# ---------------------------------------------------------------------------
# Contiguous slot-row layout
# ---------------------------------------------------------------------------

def _map_keyed(fn, tree, key=""):
    """``fn(key, leaf)`` over a cache tree of dicts and tuples, ``key`` the
    leaf's own dict key; a new tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_keyed(fn, v, key) for v in tree)
    return fn(key, tree)


def lift_cache(cache, max_slots: int):
    """Lift a fresh ``init_cache(cfg, max_slots, ...)`` tree to the
    slot-pooled layout: every ``len`` leaf (max_slots,) zeros, every
    ``pos`` leaf one row a slot; the other leaves as they are."""
    def one(key, x):
        if key == "len":
            return x.new_zeros((max_slots,))
        if key == "pos":
            return x[None].repeat((max_slots,) + (1,) * x.dim())
        return x

    return _map_keyed(one, cache)


def _slot_axis(key: str, in_layers: bool) -> int:
    """The slot axis of a slot-row pool's leaf: an ssm's stacked
    ``conv``/``ssm`` (L, slots, ...) on 1; a hybrid's per-layer leaves,
    every ``len`` and ``pos``, on 0."""
    return 1 if key in ("conv", "ssm") and not in_layers else 0


def slot_rows(pool, lo: int, hi: int):
    """The slots [lo, hi) of a pool (a data rank's share of a sharded
    pool), as views a step body writes in place.  A paged pool: its
    table rows, ``len`` and an encdec's cross K/V rows, the page stores
    whole (a page is written only by its slot's rank).  A slot-row pool:
    every leaf's rows; a step replaces ``len`` and ``pos`` (see
    :func:`put_slot_rows`)."""
    if is_paged(pool):
        sub = dict(pool, table=pool["table"][lo:hi], len=pool["len"][lo:hi])
        sub.update({key: pool[key][:, lo:hi] for key in CROSS_KEYS if key in pool})
        return sub

    def cut(tree, key, in_layers):
        if isinstance(tree, dict):
            return {k: cut(v, k, in_layers) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(cut(v, key, True) for v in tree)
        return tree.narrow(_slot_axis(key, in_layers), lo, hi - lo)

    return cut(pool, "", False)


def put_slot_rows(pool, sub, lo: int, hi: int) -> None:
    """Write the leaves a step replaced in :func:`slot_rows`' ``sub`` back
    into slots [lo, hi) of the pool: ``len``, and a slot-row pool's
    ``pos``."""
    def put(p, s):
        if isinstance(p, dict):
            for k, v in p.items():
                if k in ("len", "pos"):
                    v[lo:hi] = s[k]
                elif isinstance(v, (dict, tuple, list)):
                    put(v, s[k])
        elif isinstance(p, (tuple, list)):
            for a, b in zip(p, s):
                put(a, b)

    if is_paged(pool):
        pool["len"][lo:hi] = sub["len"]
    else:
        put(pool, sub)


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------

#: encdec's slot-rowed cross-attention K/V leaves
CROSS_KEYS = ("ck", "cv")


def write_cross(pool, ck, cv, slot: int):
    """Write one request's cross-attention K/V (L, 1, frames, kv, hd), as
    ``encode_cross_kv`` or a batch-1 prefill gives them, into ``slot``'s
    rows of an encdec pool (contiguous or paged: they stay slot-rowed)."""
    pool["ck"][:, slot] = ck[:, 0].to(pool["ck"].dtype)
    pool["cv"][:, slot] = cv[:, 0].to(pool["cv"].dtype)


def is_paged(pool) -> bool:
    return isinstance(pool, dict) and "table" in pool


def num_pages_of(pool) -> int:
    """Usable page count (the +1 null page excluded)."""
    return pool["pos"].shape[0] - 1


def drop_id(pool_or_num_pages) -> int:
    """Sentinel table entry of a slot with no page there: writes through
    it are skipped and gathers read the null page."""
    n = (pool_or_num_pages if isinstance(pool_or_num_pages, int)
         else num_pages_of(pool_or_num_pages))
    return n + 1


def page_pool_cache(cache, max_slots: int, page_size: int,
                    num_pages: Optional[int] = None,
                    kv_quant: Optional[KVQuantSpec] = None):
    """Turn a fresh ``init_cache(cfg, max_slots, max_len)`` into the paged
    pool layout (with ``kv_quant``: code pages and per-token beta leaves).
    With the default ``num_pages = max_slots * pages_per_slot`` the table
    is the identity mapping (slot i owns pages [i*n, (i+1)*n)), so direct
    callers that never retire slots see the contiguous behaviour;
    otherwise every entry starts at :func:`drop_id`.  Engine-managed
    pools overwrite the table at admission either way."""
    L, _, span, kv, hd = cache["k"].shape
    if page_size < 1 or span % page_size != 0:
        raise ValueError(f"page_size={page_size} must divide the cache span {span}")
    n = span // page_size
    if num_pages is None:
        num_pages = max_slots * n
    if num_pages < n:
        raise ValueError(
            f"num_pages={num_pages} < pages_per_slot={n}: no single "
            "request could ever be admitted")
    dev, dt = cache["k"].device, cache["k"].dtype
    if num_pages == max_slots * n:
        table = torch.arange(max_slots * n, device=dev).reshape(max_slots, n)
    else:
        table = torch.full((max_slots, n), drop_id(num_pages), dtype=torch.int64,
                           device=dev)
    if kv_quant is not None:
        hd, dt = compress.kv_code_width(kv_quant, hd), compress.kv_code_dtype(kv_quant)
    out = {
        "k": torch.zeros((L, num_pages + 1, page_size, kv, hd), dtype=dt, device=dev),
        "v": torch.zeros((L, num_pages + 1, page_size, kv, hd), dtype=dt, device=dev),
        "pos": torch.full((num_pages + 1, page_size), -1, dtype=torch.int64, device=dev),
        "len": torch.zeros((max_slots,), dtype=torch.int64, device=dev),
        "table": table,
    }
    if kv_quant is not None:
        for key in ("k_beta", "v_beta"):
            out[key] = torch.zeros((L, num_pages + 1, page_size), dtype=torch.int32,
                                   device=dev)
    out.update({key: cache[key] for key in CROSS_KEYS if key in cache})
    return out


def gather_view(pool, leaf):
    """Logical (B, span, ...) view (a copy) of one physical page store:
    gather the slot tables (drop_id entries clamped onto the null page),
    flatten the page axis back into a span axis.  ``leaf`` is indexed on
    its first axis (``pos``, or ``k[layer]``)."""
    return transformer.page_view(leaf, transformer.page_ids(pool))


def reset_slot(pool, slot: int):
    """Rewind one slot: ``len`` -> 0 and its positions to -1 (the
    not-yet-written sentinel the attention mask keys on).  On a paged pool
    this resets the ``pos`` rows of the pages the slot's table maps;
    engine-managed slots get their resets from the allocator instead."""
    if is_paged(pool):
        pool["len"][slot] = 0
        pids = [p for p in pool["table"][slot].tolist() if p < num_pages_of(pool)]
        pool["pos"][pids] = -1
        return pool

    def one(key, x):
        if key == "len":
            x[slot] = 0
        elif key == "pos":
            x[slot] = -1
        return x

    _map_keyed(one, pool)
    return pool


def write_slot(pool, mini, slot: int, *, pages: Optional[Sequence[int]] = None,
               kv_quant: Optional[KVQuantSpec] = None):
    """Copy a batch-1 cache (``init_cache(cfg, 1, max_len)`` after a solo
    prefill) into ``slot``: the slot's whole row (k, v, pos, len) is
    overwritten, so nothing of a previous occupant survives.

    Paged pools scatter the mini cache's span into the slot's pages:
    ``pages`` (``pages_per_slot`` ids, drop_id-padded) replaces the slot's
    table row (the engine passes freshly allocated pages); without it the
    current row is used.  Logical pages mapped to drop_id are skipped.  A
    quantized pool (``kv_quant``, which must match the pool) encodes the
    bf16 mini K/V per written token on the way in.  An encdec slot's
    cross ``ck``/``cv`` rows are copied as they are.

    A slot-row pool (``lift_cache``) takes every leaf of the mini cache,
    cast to the pool leaf's dtype, as the reference's tree map does: a
    lifted ``len``/``pos`` leaf at row ``slot``, any other along its one
    axis where the mini cache has size 1 and the pool not (its batch
    axis), or whole where the two shapes agree (a one-slot pool)."""
    if is_paged(pool):
        if "ck" in pool:
            write_cross(pool, mini["ck"], mini["cv"], slot)
        return _write_slot_paged(pool, mini, slot, pages, kv_quant)
    _write_rows(pool, mini, slot)
    return pool


def _write_rows(pool, mini, slot: int) -> None:
    if isinstance(pool, dict):
        for k, p in pool.items():
            if isinstance(p, (dict, tuple, list)):
                _write_rows(p, mini[k], slot)
            else:
                _write_leaf(p, mini[k], slot)
        return
    for p, m in zip(pool, mini):
        _write_rows(p, m, slot)


def _write_leaf(p: torch.Tensor, m: torch.Tensor, slot: int) -> None:
    if m.dim() == p.dim() - 1:  # a lifted per-slot leaf (pos / len)
        p[slot] = m
        return
    if p.shape == m.shape:  # max_slots == 1: the row is the pool
        p.copy_(m)
        return
    diffs = [d for d, (ps, ms) in enumerate(zip(p.shape, m.shape)) if ps != ms]
    if len(diffs) != 1 or m.shape[diffs[0]] != 1:
        raise ValueError(f"write_slot: pool leaf {tuple(p.shape)} vs mini {tuple(m.shape)}")
    p.narrow(diffs[0], slot, 1).copy_(m)


def _write_slot_paged(pool, mini, slot, pages, kv_quant=None):
    page = pool["pos"].shape[1]
    n = pool["table"].shape[1]
    if ("k_beta" in pool) != (kv_quant is not None):
        raise ValueError("write_slot kv_quant must be given exactly when the pool "
                         "holds quantized K/V pages")
    if pages is None:
        pages = pool["table"][slot].tolist()
    if len(pages) != n:
        raise ValueError(f"write_slot: {len(pages)} pages for a {n}-page slot")
    # every index goes up through pinned memory: no implicit host sync
    dev = pool["pos"].device
    pool["table"][slot] = to_device(list(pages), dev, pool["table"].dtype)
    live = [(lp, p) for lp, p in enumerate(pages) if p < num_pages_of(pool)]
    logical = to_device([lp for lp, _ in live], dev, torch.int64)
    phys = to_device([p for _, p in live], dev, torch.int64)
    for key in ("k", "v"):
        m = mini[key]  # (L, 1, span, KV, hd)
        L, _, _, kv, hd = m.shape
        if kv_quant is not None:
            codes, beta = compress.kv_page_encode(m, kv_quant, transformer.head_group())
            mp = codes.reshape((L, n, page, kv) + codes.shape[4:])
            pool[f"{key}_beta"][:, phys] = beta.reshape(L, n, page)[:, logical]
        else:
            mp = m.to(pool[key].dtype).reshape(L, n, page, kv, hd)
        pool[key][:, phys] = mp[:, logical]
    pool["pos"][phys] = mini["pos"].reshape(n, page)[logical].to(pool["pos"].dtype)
    pool["len"][slot] = mini["len"]
    return pool


# ---------------------------------------------------------------------------
# Speculative-decoding rollback (serve/spec.py)
# ---------------------------------------------------------------------------
# A spec round writes K/V and pos at positions len .. len+C-1 of every
# slot.  ``spec_snapshot`` gathers those C entries (and ``len``) before
# the round; ``spec_restore`` writes them back at positions >= keep[b]:
# keep = 0 erases the self-draft's writes before the verify pass, keep =
# accepted + 1 rolls back the rejected tail after acceptance.  Without a
# window the restored entries held pos -1, so this is the reference's "pos
# back to -1" rollback.  Kept positions, and dead slots (drop_id tables),
# are written as the null page's own contents (``transformer.paged_write``).


def _spec_addr(cache, c: int, pos0):
    """``(dest, loff)`` (B, C): physical page and offset of each slot's C
    spec-round entries (drop_id where the slot maps no page)."""
    offs = torch.arange(c, dtype=pos0.dtype, device=pos0.device)
    gpos = pos0[:, None] + offs[None, :]
    table = cache["table"]
    page = cache["pos"].shape[1]
    lo = gpos % (table.shape[1] * page)
    return torch.gather(table, 1, lo // page), lo % page


def _spec_leaves(cache):
    return [k for k in ("k", "v", "k_beta", "v_beta") if k in cache]


def spec_snapshot(cache, c: int):
    """The pre-round state of the C entries a spec round can touch:
    ``{"k": (L, B, C, ...), "v", ["k_beta", "v_beta"], "pos": (B, C),
    "len": (B,)}`` (copies; dead slots read the null page)."""
    if not is_paged(cache):
        raise NotImplementedError("repro_torch's spec rounds run the paged pool cache")
    pos0 = cache["len"].clone()
    dest, off = _spec_addr(cache, c, pos0)
    d = dest.clamp(max=num_pages_of(cache))
    snap = {key: cache[key][:, d, off] for key in _spec_leaves(cache)}
    snap["pos"] = cache["pos"][d, off]
    snap["len"] = pos0
    return snap


def spec_restore(cache, snap, keep):
    """Write the snapshot back at positions >= ``keep[b]`` and set ``len =
    snap["len"] + keep``; ``keep`` (B,) in [0, C].  In place."""
    c = snap["pos"].shape[1]
    pos0 = snap["len"]
    keep = torch.as_tensor(keep, dtype=pos0.dtype, device=pos0.device)
    dest, off = _spec_addr(cache, c, pos0)
    offs = torch.arange(c, dtype=pos0.dtype, device=pos0.device)
    rej = offs[None, :] >= keep[:, None]  # (B, C): restore these
    npages = num_pages_of(cache)
    dest = torch.where(rej, dest, torch.full_like(dest, npages + 1))
    for key in _spec_leaves(cache):
        for layer, sv in zip(cache[key], snap[key]):
            transformer.paged_write(layer, dest, off, sv, npages)
    transformer.paged_write(cache["pos"], dest, off, snap["pos"], npages)
    cache["len"] = pos0 + keep
    return cache


# ---------------------------------------------------------------------------
# Host-side page allocator with shared-prefix cache
# ---------------------------------------------------------------------------


class PageAllocatorError(RuntimeError):
    """An allocator invariant was violated (double free, bad refcount)."""


@dataclasses.dataclass
class AdmissionPlan:
    """What :meth:`PageAllocator.plan_admission` decided for one request.

    ``shared`` pages are mapped straight from the prefix cache (ref
    bumped); ``cow`` pages are prefix hits the slot will append into, so
    they get a fresh copy (src physical page and logical index recorded);
    ``fresh`` counts brand-new pages.  ``resume`` is the prompt position
    streaming restarts from (a multiple of the chunk; everything before it
    is served from the cache)."""

    shared: List[int]
    cow: List[Tuple[int, int]]  # (src physical page, logical index)
    fresh: int
    resume: int
    hit_tokens: int


class PageAllocator:
    """Free-list page allocator with refcounts, per-slot tables, a
    shared-prefix cache and copy-on-write: the host half of the paged pool.

    Pages are admitted worst case up front: a request gets every page it
    could ever touch (``ceil((plen + max_new) / page)``, capped at the
    span), so a step can never run out mid-flight; "preemption" is
    admission deferral, counted by the engine.  The prefix cache keeps a
    page alive after its last slot retires (one cache ref) until LRU
    eviction makes room for a new admission.

    Determinism: the free list is kept sorted and eviction is strictly LRU
    on an engine-step clock, so for a fixed trace the physical page
    assignment and every counter are exactly reproducible.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int,
                 max_slots: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.max_slots = max_slots
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # stack
        self.refcount = np.zeros((num_pages,), np.int64)
        self.tables: List[List[int]] = [[] for _ in range(max_slots)]
        # prefix cache: key (logical index, prompt bytes through the page's
        # covering chunk, request context) -> physical page, so a hit is
        # exact token equality under the same context
        self._prefix: Dict[Tuple, int] = {}
        self._prefix_of: Dict[int, Tuple] = {}  # physical page -> key
        self._lru: Dict[int, int] = {}  # physical page -> last-hit clock
        self._clock = 0
        self.cow_copies = 0
        self.evictions = 0

    # -- invariant-checked primitives ---------------------------------------
    def free_pages(self) -> int:
        return len(self._free)

    def _evictable(self, protect) -> List[int]:
        return [pid for pid in self._prefix_of
                if self.refcount[pid] == 1 and pid not in protect]

    def evictable_pages(self, protect=()) -> int:
        """Prefix-cached pages whose only ref is the cache itself."""
        return len(self._evictable(set(protect)))

    def can_admit(self, fresh_needed: int, protect=()) -> bool:
        return self.free_pages() + self.evictable_pages(protect) >= fresh_needed

    def alloc(self, count: int, protect=()) -> List[int]:
        """Pop ``count`` pages, LRU-evicting idle prefix pages if the free
        list runs short.  Raises if the pool cannot supply them (the
        engine checks ``can_admit`` first)."""
        while len(self._free) < count:
            self._evict_one(protect)
        out = [self._free.pop() for _ in range(count)]
        for pid in out:
            if self.refcount[pid] != 0:  # pragma: no cover - internal
                raise PageAllocatorError(f"page {pid} allocated while live")
            self.refcount[pid] = 1
        return out

    def _evict_one(self, protect=()):
        victims = self._evictable(set(protect))
        if not victims:
            raise PageAllocatorError("out of pages: nothing evictable")
        victim = min(victims, key=lambda pid: (self._lru.get(pid, -1), pid))
        self._unregister(victim)
        self.evictions += 1

    def _unregister(self, pid: int):
        key = self._prefix_of.pop(pid)
        del self._prefix[key]
        self._lru.pop(pid, None)
        self._unref(pid)

    def _unref(self, pid: int):
        if self.refcount[pid] <= 0:
            raise PageAllocatorError(f"double free of page {pid}")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)
            self._free.sort(reverse=True)  # deterministic: lowest pid first

    # -- prefix cache --------------------------------------------------------
    @staticmethod
    def chunk_dep(logical_page: int, page_size: int, chunk: int) -> int:
        """Prompt length page ``logical_page``'s content depends on: the
        end of the chunk that wrote the page's last position (a chunk is
        one activation-scale group)."""
        end = (logical_page + 1) * page_size
        return -(-end // chunk) * chunk

    def _key(self, prompt: np.ndarray, k: int, chunk: int, context: bytes) -> Tuple:
        dep = self.chunk_dep(k, self.page_size, chunk)
        return (k, prompt[:dep].tobytes(), context)

    def prefix_lookup(self, prompt: np.ndarray, chunk: int,
                      context: bytes = b"") -> List[int]:
        """Longest chain of registered pages matching ``prompt``'s head
        (pages whose chunk dependency the prompt fully covers) under the
        same ``context``: what a page's K/V depend on besides the prompt
        (an encdec request's frames, through cross attention)."""
        plen = len(prompt)
        hits: List[int] = []
        k = 0
        while (k + 1) * self.page_size <= plen:
            if self.chunk_dep(k, self.page_size, chunk) > plen:
                break
            pid = self._prefix.get(self._key(prompt, k, chunk, context))
            if pid is None:
                break
            hits.append(pid)
            k += 1
        return hits

    def register_prefix(self, slot: int, prompt: np.ndarray, chunk: int,
                        context: bytes = b""):
        """After a slot finishes prefill, publish its full, chunk-complete
        prompt pages under ``context`` (one cache ref each;
        already-registered keys get an LRU touch)."""
        plen = len(prompt)
        table = self.tables[slot]
        for k in range(plen // self.page_size):
            if self.chunk_dep(k, self.page_size, chunk) > plen:
                break
            key = self._key(prompt, k, chunk, context)
            pid = self._prefix.get(key)
            if pid is not None:
                self._lru[pid] = self._clock
                continue
            pid = table[k]
            self._prefix[key] = pid
            self._prefix_of[pid] = key
            self.refcount[pid] += 1
            self._lru[pid] = self._clock

    def tick(self, clock: int):
        self._clock = clock

    # -- admission / retirement ---------------------------------------------
    def plan_admission(self, prompt: Optional[np.ndarray], need_tokens: int,
                       chunk: Optional[int], context: bytes = b"") -> AdmissionPlan:
        """Pages for one request: prefix hits (shared / copy-on-write) and
        a fresh count.  ``prompt=None`` or no chunk disables prefix reuse
        (solo prefill's scale groups cover the whole prompt)."""
        npages = min(-(-need_tokens // self.page_size), self.pages_per_slot)
        if prompt is None or chunk is None:
            return AdmissionPlan([], [], npages, 0, 0)
        hits = self.prefix_lookup(prompt, chunk, context)
        plen = len(prompt)
        share_tok = len(hits) * self.page_size
        # streaming resumes on a chunk boundary with >= 1 prompt token
        # left (the resumed chunk emits the first token)
        resume = (min(share_tok, plen - 1) // chunk) * chunk
        if resume == 0:
            return AdmissionPlan([], [], npages, 0, 0)
        first_stream_page = resume // self.page_size
        shared = hits[:first_stream_page]
        cow = [(pid, k) for k, pid in enumerate(hits) if k >= first_stream_page]
        return AdmissionPlan(shared=shared, cow=cow, fresh=npages - len(hits),
                             resume=resume, hit_tokens=resume)

    def fresh_needed(self, plan: AdmissionPlan) -> int:
        return plan.fresh + len(plan.cow)

    def reserve(self, plan: AdmissionPlan) -> Dict:
        """Commit a plan's pages before its slot is known, so back-to-back
        ``can_admit`` checks cannot hand the same pages to two requests.
        Returns {'table': the table row, 'new': cow-dst + fresh pids,
        'copies': [(src, dst)]}; pass it to :meth:`bind` right away."""
        protect = set(plan.shared) | {pid for pid, _ in plan.cow}
        new = self.alloc(self.fresh_needed(plan), protect)
        copies = []
        table: List[int] = []
        for pid in plan.shared:
            self.refcount[pid] += 1
            self._lru[pid] = self._clock
            table.append(pid)
        for src, _ in plan.cow:
            dst = new.pop(0)
            self._lru[src] = self._clock
            copies.append((src, dst))
            table.append(dst)
            self.cow_copies += 1
        table.extend(new)
        return {"table": table, "new": [d for _, d in copies] + new,
                "copies": copies}

    def bind(self, slot: int, hold: Dict) -> None:
        """Attach a :meth:`reserve` result to its assigned slot."""
        if self.tables[slot]:
            raise PageAllocatorError(f"slot {slot} already holds pages")
        self.tables[slot] = list(hold["table"])

    def release_slot(self, slot: int):
        """Unref every page the slot maps; prefix-registered pages stay
        alive on their cache ref."""
        for pid in self.tables[slot]:
            self._unref(pid)
        self.tables[slot] = []

    # -- accounting ----------------------------------------------------------
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def check_conservation(self):
        """free + live == num_pages, refcounts consistent, no aliasing
        between the free list and any table or the prefix cache."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageAllocatorError("duplicate page on the free list")
        refs = np.zeros_like(self.refcount)
        for t in self.tables:
            for pid in t:
                refs[pid] += 1
        for pid in self._prefix_of:
            refs[pid] += 1
        if not np.array_equal(refs, self.refcount):
            bad = np.nonzero(refs != self.refcount)[0]
            raise PageAllocatorError(
                f"refcount drift on pages {bad.tolist()}: "
                f"counted {refs[bad].tolist()}, "
                f"stored {self.refcount[bad].tolist()}")
        for pid in range(self.num_pages):
            if (self.refcount[pid] == 0) != (pid in free):
                raise PageAllocatorError(
                    f"page {pid}: refcount {self.refcount[pid]} vs "
                    f"free-list membership {pid in free}")
        if np.any(self.refcount < 0):
            raise PageAllocatorError("negative refcount")
