"""Shared-prefix KV reuse and page-resident serving: a paged KV pool, a
radix prefix cache and the continuous batcher's page bookkeeping.

Port of ``deepspeed_tpu/inference/kvreuse.py``, logic for logic, for the
page-resident mode of :class:`~.serving.ContinuousBatcher`:

- :class:`PagedKVPool` — a fixed arena of KV *pages* on the engine's
  device (``page_tokens`` tokens of every layer's K/V), laid out from the
  model's own cache (``models/common.append_kv_cache``), and a host LRU
  free list.
- :class:`RadixPrefixCache` — a host radix tree over token blocks whose
  nodes own page refs. Admission looks up the longest cached prefix (exact
  block match only) and references its pages; a retiring request's full
  prompt pages attach to the tree by reference (:meth:`absorb`). Eviction
  peels refcount-0 leaves in LRU order under the page budget; a live
  request pins its matched chain.
- :class:`PagedServingState` — the slots' page table, lengths and page
  ownership; decode attention reads the arena in place through the table.

The arena is written in place (PyTorch tensors are mutable), so the JAX
package's buffer donation and ``adopt`` rebinding have no counterpart. Not
ported in this slice: the gather path (a prefix cache with paged decode
off, where admission copies pages into a contiguous cache): asking for it,
or a head geometry the paged kernel does not take, raises
``NotImplementedError`` naming the ROADMAP entry, and an undersized
pool raises ``ValueError`` naming the page count it needs. Nothing falls
back. Off by default, enabled per call (``ContinuousBatcher(...,
prefix_cache=...)``), per engine (``init_inference(prefix_cache=True |
{...})``) or with ``DSTPU_PREFIX_CACHE=1`` (``0`` disables over any
config), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import common as model_common
from ..ops.paged_attention import paged_decode_supported
from ..utils.logging import logger

__all__ = ["PagedKVPool", "RadixPrefixCache", "PagedServingState",
           "resolve_prefix_cache", "resolve_paged_decode", "PREFIX_CACHE_ENV"]

PREFIX_CACHE_ENV = "DSTPU_PREFIX_CACHE"

_DEFAULT_PAGE_TOKENS = 16
_DEFAULT_BUDGET_BYTES = 64 << 20
# host bookkeeping (one tree node + free-list slot per page) stays trivial
# up to here; a larger budget should raise page_tokens instead
_MAX_PAGES = 16384
_GATHER_TODO = ("is the gather path (admission copies pages into a contiguous cache), "
                "not ported yet (ROADMAP.md, queue A: gather path)")


@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    """Static geometry of one KV leaf of the PER-ROW cache."""

    bdim: int            # batch axis
    tokdim: int          # token axis — always bdim + 1 in append_kv_cache's layout
    page_shape: tuple    # ONE page's slice shape (batch axis = 1)
    dtype: torch.dtype


def _leaf_key(layer: int, name: str) -> str:
    return f"{layer}.{name}"


def _derive_meta(engine, page_tokens: int) -> Dict[str, _LeafMeta]:
    """Per-KV-leaf page geometry from ``engine``'s model config: every
    layer's K and V leaf is ``(B, cache_len, kv_heads, head_dim)``
    (``init_layer_cache``), so a page is ``(1, page_tokens, kv_heads,
    head_dim)`` with the batch on axis 0 and the tokens on axis 1."""
    cfg = engine.model_cfg
    if engine.cache_len < page_tokens:
        raise ValueError(f"page_tokens={page_tokens} exceeds the cache length "
                         f"{engine.cache_len}")
    page = (1, page_tokens, cfg.kv_heads, cfg.head_dim)
    return {_leaf_key(i, name): _LeafMeta(0, 1, page, cfg.dtype)
            for i in range(cfg.n_layer) for name in model_common.KV_CACHE_LEAVES}


def _page_bytes(meta: Dict[str, _LeafMeta]) -> int:
    return sum(math.prod(m.page_shape) * torch.empty((), dtype=m.dtype).element_size()
               for m in meta.values())


class PagedKVPool:
    """Fixed arena of ``n_pages`` KV pages derived from ``engine``'s cache,
    on the engine's device; a host LRU free list.

    Pages hold every layer's K/V for ``page_tokens`` consecutive positions:
    one page buffer per ``cached_key``/``cached_value`` leaf, shaped like
    the per-row cache leaf with the batch axis widened to ``n_pages`` and
    the token axis narrowed to ``page_tokens``."""

    def __init__(self, engine, n_pages: int, page_tokens: int,
                 meta: Optional[Dict[str, _LeafMeta]] = None):
        if n_pages < 1 or page_tokens < 1:
            raise ValueError(f"need n_pages >= 1 and page_tokens >= 1, got "
                             f"{n_pages}/{page_tokens}")
        self.engine = engine
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self._meta = meta if meta is not None else _derive_meta(engine, page_tokens)

        def arena_shape(m):
            return m.page_shape[:m.bdim] + (self.n_pages,) + m.page_shape[m.bdim + 1:]

        self.pages: Dict[str, torch.Tensor] = {
            k: torch.zeros(arena_shape(m), dtype=m.dtype, device=engine.device)
            for k, m in sorted(self._meta.items())}
        self.page_bytes = _page_bytes(self._meta)
        # LRU free list: free() appends, alloc() pops the oldest-freed
        self._free: List[int] = list(range(self.n_pages))

    # -- host-side page accounting -------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` page ids off the free list (None if short — the radix
        cache evicts and retries; the pool itself never blocks)."""
        if n > len(self._free):
            return None
        got, self._free = self._free[:n], self._free[n:]
        return got

    def free(self, pids) -> None:
        for pid in pids:
            if not 0 <= pid < self.n_pages:
                raise ValueError(f"bad page id {pid}")
        self._free.extend(pids)


class _Node:
    __slots__ = ("key", "page", "parent", "children", "refs", "last_used")

    def __init__(self, key, page, parent):
        self.key = key          # the page's token block (tuple of ints)
        self.page = page        # pool page id
        self.parent = parent
        self.children: dict = {}
        self.refs = 0           # pins from live admissions
        self.last_used = 0


class RadixPrefixCache:
    """Host radix tree over ``page_tokens``-sized token blocks; nodes own
    pool pages. Single-threaded: driven from the batcher's admission and
    retirement. Per-instance counters (``hit_tokens``, ``miss_tokens``,
    ``evictions``) take the place of the JAX package's telemetry registry."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self.page_tokens = pool.page_tokens
        self._root = _Node(None, None, None)
        self._nodes: set = set()
        self._clock = 0
        # lazy LRU heap of (last_used, seq, node) eviction candidates:
        # pushed whenever a node BECOMES evictable, validated at pop time
        self._lru_heap: List[tuple] = []
        self._heap_seq = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def _blocks(self, prompt, n: int) -> List[tuple]:
        pt = self.page_tokens
        return [tuple(int(t) for t in prompt[i * pt:(i + 1) * pt]) for i in range(n)]

    def match(self, prompt) -> Tuple[int, tuple, tuple]:
        """Longest cached prefix of ``prompt`` at page granularity:
        ``(matched_tokens, page_ids, nodes)``. Capped one token short of
        the prompt — the suffix prefill must still produce the real last
        token's logits to sample from. Blocks are built lazily: a cold tree
        costs O(one block), not O(prompt)."""
        pt = self.page_tokens
        limit = (len(prompt) - 1) // pt
        self._clock += 1
        node, pages, nodes = self._root, [], []
        for i in range(limit):
            key = tuple(int(t) for t in prompt[i * pt:(i + 1) * pt])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            node.last_used = self._clock
            pages.append(node.page)
            nodes.append(node)
        if nodes:
            # the touch staled any heap entry for the deepest node (the only
            # possible leaf on the chain); re-offer it
            self._push_candidate(nodes[-1])
        return len(pages) * pt, tuple(pages), tuple(nodes)

    def pin(self, nodes) -> None:
        """Hold ``nodes``' pages against eviction while a request reads them."""
        for nd in nodes:
            nd.refs += 1

    def unpin(self, nodes) -> None:
        for nd in nodes:
            nd.refs -= 1
            if nd.refs == 0:
                self._push_candidate(nd)   # may have become evictable

    def note_tokens(self, hit: int, miss: int) -> None:
        self.hit_tokens += int(hit)
        self.miss_tokens += int(miss)

    # ------------------------------------------------------------------
    def _push_candidate(self, node) -> None:
        """Offer ``node`` to the eviction heap if it is evictable NOW (a
        non-root refcount-0 leaf); entries are validated again at pop time,
        so over-offering is harmless and under-offering is caught by the
        scan backstop in :meth:`_evict_one`."""
        if node is not self._root and node in self._nodes \
                and not node.children and node.refs == 0:
            self._heap_seq += 1
            heapq.heappush(self._lru_heap, (node.last_used, self._heap_seq, node))

    def _evict_one(self) -> bool:
        """Free the LRU refcount-0 leaf's page. Interior nodes become leaves
        as their children go, so repeated calls peel a cold branch back to
        the root. O(log n) via the lazy heap; a linear scan backstops it."""
        victim = None
        while self._lru_heap:
            lu, _, nd = heapq.heappop(self._lru_heap)
            if nd in self._nodes and nd.last_used == lu \
                    and not nd.children and nd.refs == 0:
                victim = nd
                break
        if victim is None:
            for nd in self._nodes:
                if nd.children or nd.refs > 0:
                    continue
                if victim is None or nd.last_used < victim.last_used:
                    victim = nd
        if victim is None:
            return False
        victim.parent.children.pop(victim.key, None)
        self._nodes.discard(victim)
        self.pool.free([victim.page])
        self.evictions += 1
        if victim.parent is not self._root:
            self._push_candidate(victim.parent)   # may have turned leaf
        return True

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n > self.pool.n_pages:
            return None   # can never fit: don't flush the tree for nothing
        while self.pool.free_pages < n:
            if not self._evict_one():
                return None   # everything left is pinned or interior
        return self.pool.alloc(n)

    def absorb(self, prompt, own_pages, first_own: int) -> set:
        """Zero-copy donation — the page-resident retirement path: a
        retiring slot's full-prompt pages attach to the tree BY REFERENCE.
        The slot's blocks ``[0, first_own)`` are the tree's own matched
        chain (still pinned by the caller here), so attachment starts at
        the deepest existing match and block ``d`` takes
        ``own_pages[d - first_own]``. Returns the page ids the tree took;
        the caller frees the rest. Sound because a slot's prompt-prefix
        pages are written once by its suffix prefill and never again
        (decode appends at positions >= prompt_len, overshoot resolves to
        trash entries)."""
        pt = self.page_tokens
        n_target = len(prompt) // pt
        if n_target <= first_own:
            return set()     # prompt region fully covered by hit pages
        keys = self._blocks(prompt, n_target)
        self._clock += 1
        node, depth, walked = self._root, 0, []
        while depth < n_target and keys[depth] in node.children:
            node = node.children[keys[depth]]
            node.last_used = self._clock
            walked.append(node)
            depth += 1
        if depth == n_target or depth < first_own:
            # fully cached already (a sibling retired the same prefix first),
            # or the walk ended inside the pinned hit chain (impossible while
            # pinned: attaching there would alias tree-owned pages)
            if walked:
                self._push_candidate(walked[-1])
            return set()
        absorbed = set()
        for d in range(depth, n_target):
            pid = own_pages[d - first_own]
            child = _Node(keys[d], pid, node)
            child.last_used = self._clock
            node.children[keys[d]] = child
            self._nodes.add(child)
            node = child
            absorbed.add(pid)
        self._push_candidate(node)   # the new chain's tip is a leaf
        return absorbed


def resolve_prefix_cache(engine, override=None) -> Optional[RadixPrefixCache]:
    """Resolve the batcher's prefix-cache setting (the JAX precedence).

    ``DSTPU_PREFIX_CACHE=0`` disables over ANY config. An explicit ``False``
    (argument or engine config) stays off even under
    ``DSTPU_PREFIX_CACHE=1``; the env ``1`` only enables where nothing
    disabled. Otherwise the argument wins over the engine config. Values:
    ``None`` (defer), ``False`` (off), ``True`` (on, default sizing), a dict
    with ``page_tokens`` / ``n_pages`` / ``budget_bytes``, or a ready
    :class:`RadixPrefixCache`. Returns None when disabled; a layout the pool
    cannot page raises (the JAX package warns and serves without reuse)."""
    env = os.environ.get(PREFIX_CACHE_ENV, "").strip().lower()
    if env in ("0", "false", "off"):
        return None   # kill switch FIRST: a ready instance must not bypass it
    if isinstance(override, RadixPrefixCache):
        return override
    cfg = override if override is not None else getattr(engine.config, "prefix_cache", None)
    if cfg is False:
        return None
    # ANY dict is an explicit enable — {} means "defaults"
    if not (isinstance(cfg, dict) or bool(cfg) or env in ("1", "true", "on")):
        return None
    opts = dict(cfg) if isinstance(cfg, dict) else {}
    unknown = set(opts) - {"page_tokens", "n_pages", "budget_bytes"}
    if unknown:
        logger.warning(f"prefix_cache: ignoring unknown keys {sorted(unknown)}")
    page_tokens = int(opts.get("page_tokens", _DEFAULT_PAGE_TOKENS))
    meta = _derive_meta(engine, page_tokens)
    n_pages = opts.get("n_pages")
    if n_pages is None:
        budget = int(opts.get("budget_bytes", _DEFAULT_BUDGET_BYTES))
        n_pages = max(1, min(_MAX_PAGES, budget // max(1, _page_bytes(meta))))
    pool = PagedKVPool(engine, int(n_pages), page_tokens, meta=meta)
    return RadixPrefixCache(pool)


# ---------------------------------------------------------------------------
# Page-resident serving (paged decode attention)
# ---------------------------------------------------------------------------
#
# The slot's K/V lives in the POOL ARENA for its whole life: admission is
# page-ref bookkeeping (hit pages are referenced, not copied; the suffix
# prefill writes straight into freshly allocated pages), decode attention
# reads the arena through a per-slot page table, and retirement donates
# the prompt's pages to the radix tree BY REFERENCE.


@dataclasses.dataclass
class _SlotPages:
    """Page ownership of one page-resident request (parked or slotted)."""

    own: list                # pages allocated for the suffix + generation span
    nodes: tuple             # pinned radix nodes backing the hit prefix
    m0: int                  # matched prefix tokens (page-aligned)
    prompt_len: int
    table_row: np.ndarray    # (T,) int32, trash-padded past the span


class PagedServingState:
    """Host page bookkeeping and paged-cache plumbing for a
    :class:`~.serving.ContinuousBatcher` running page-resident slots.

    Owns the reserved trash page (a free or bucket-padded row's writes past
    its allocation resolve there — never another slot's pages), the live
    ``(n_slots, T)`` page table and per-slot lengths the decode windows are
    built from, and the per-slot :class:`_SlotPages`."""

    def __init__(self, cache: RadixPrefixCache, engine, n_slots: int):
        self.cache = cache
        self.pool = cache.pool
        self.pt = self.pool.page_tokens
        self.gen_limit = int(engine._gen_limit)
        self.device = engine.device
        self.T = -(-self.gen_limit // self.pt)
        self.n_slots = int(n_slots)
        self.n_layers = engine.model_cfg.n_layer
        need = self.n_slots * self.T + 1
        if self.pool.n_pages < need:
            raise ValueError(
                f"pool holds {self.pool.n_pages} pages but page-resident slots need "
                f"n_slots*ceil(gen_limit/page_tokens)+1 = {self.n_slots}*{self.T}+1 = "
                f"{need} pages worst-case; raise n_pages/budget_bytes or lower max_tokens")
        trash = cache._alloc(1)
        if trash is None:
            raise ValueError("could not reserve the overshoot trash page")
        self.trash = int(trash[0])
        self.table = np.full((self.n_slots, self.T), self.trash, np.int32)
        self.lengths = np.zeros((self.n_slots,), np.int32)
        self.slot_meta: List[Optional[_SlotPages]] = [None] * self.n_slots
        self._slot_pages_n = 0     # pages owned by parked/active requests
        # the static device copies a captured decode tick reads (decode_cache)
        self._lengths_dev = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        self._table_dev = torch.full((self.n_slots, self.T), self.trash, dtype=torch.int32,
                                     device=self.device)
        self._decode_cache = None

    # -- admission / placement / retirement ----------------------------
    def try_admit(self, prompt, max_new: int, m0: int, nodes, pids,
                  span_tokens: int) -> Optional[_SlotPages]:
        """Allocate the request's own pages covering ``[m0, span_tokens)``
        and build its table row; None when the budget (after eviction)
        cannot supply them — the caller applies backpressure.
        ``span_tokens`` covers the prefill writes and the generation span,
        so the table never changes mid-flight."""
        first_own = m0 // self.pt
        n_own = -(-span_tokens // self.pt) - first_own
        # pin BEFORE _alloc, for the request's LIFETIME: _alloc's eviction
        # sweep could otherwise recycle the chain this admission reads
        self.cache.pin(nodes)
        own = self.cache._alloc(n_own) if n_own > 0 else []
        if own is None:
            self.cache.unpin(nodes)
            return None
        row = np.full((self.T,), self.trash, np.int32)
        row[:first_own] = pids
        row[first_own:first_own + len(own)] = own
        meta = _SlotPages(own=list(own), nodes=tuple(nodes), m0=int(m0),
                          prompt_len=int(len(prompt)), table_row=row)
        self._slot_pages_n += len(own)
        return meta

    def place(self, i: int, meta: _SlotPages) -> None:
        self.slot_meta[i] = meta
        self.table[i, :] = meta.table_row
        self.lengths[i] = meta.prompt_len

    def retire_slot(self, i: int, prompt) -> None:
        meta = self.slot_meta[i]
        self.slot_meta[i] = None
        self.table[i, :] = self.trash
        self.lengths[i] = 0
        if meta is not None:
            self._release(meta, prompt)

    def finish_unslotted(self, meta: _SlotPages, prompt) -> None:
        """A request retired by its first token releases its pages without
        ever holding a slot (prompt pages still donate)."""
        self._release(meta, prompt)

    def abort_admit(self, meta: _SlotPages) -> None:
        """Roll back a ``try_admit`` whose prefill never completed: free the
        own pages and unpin the hit chain WITHOUT absorbing — the pages hold
        no (or partial) K/V."""
        self.cache.unpin(meta.nodes)
        if meta.own:
            self.pool.free(meta.own)
        self._slot_pages_n -= len(meta.own)

    def _release(self, meta: _SlotPages, prompt) -> None:
        absorbed = self.cache.absorb(prompt, meta.own, meta.m0 // self.pt)
        self.cache.unpin(meta.nodes)
        leftover = [p for p in meta.own if p not in absorbed]
        if leftover:
            self.pool.free(leftover)
        self._slot_pages_n -= len(meta.own)

    def note_window(self, ticks: int) -> None:
        """Mirror the decode window's head advance: EVERY row (free slots
        included — their writes resolve to trash) appends one token per
        tick."""
        self.lengths += int(ticks)

    # -- paged caches ----------------------------------------------------
    def build_cache(self, lengths_np, table_np) -> list:
        """The paged cache a decode window or suffix prefill runs over, one
        dict per layer: the K/V leaves ARE the pool arena (by reference),
        ``cache_index`` holds per-row lengths and ``page_table`` the rows'
        tables (one device copy of each, shared by every layer)."""
        lengths = torch.as_tensor(lengths_np, dtype=torch.int32, device=self.device)
        table = torch.as_tensor(table_np, dtype=torch.int32, device=self.device)
        pages = self.pool.pages
        return [{"cached_key": pages[_leaf_key(i, "cached_key")],
                 "cached_value": pages[_leaf_key(i, "cached_value")],
                 model_common.CACHE_INDEX_LEAF: lengths,
                 model_common.PAGE_TABLE_LEAF: table}
                for i in range(self.n_layers)]

    def decode_cache(self) -> list:
        """The paged cache a decode window's ticks run over: the host
        mirrors of the slots' lengths and table rows copied into static
        device buffers, which every layer shares (``static_head``: the tick
        advances the lengths in place, ``models/common.advance_heads``). The
        same list, over the same buffers, at every window, so a captured
        tick reads each window's values."""
        self._lengths_dev.copy_(torch.from_numpy(self.lengths))
        self._table_dev.copy_(torch.from_numpy(self.table))
        if self._decode_cache is None:
            self._decode_cache = self.build_cache(self._lengths_dev, self._table_dev)
            for layer in self._decode_cache:
                layer[model_common.STATIC_HEAD] = True
        return self._decode_cache


def resolve_paged_decode(engine, prefix_cache, n_slots: int, specdec=None,
                         override=None) -> Optional[PagedServingState]:
    """Resolve the batcher's page-resident mode: on whenever a prefix cache
    is resolved (None without one: contiguous slots). Where the JAX package
    falls back to the gather path — an explicit ``paged_decode=False``,
    speculative decoding, a head geometry the paged kernel does not take,
    an undersized pool — this port raises: the gather path is not ported,
    and an undersized pool's ``ValueError`` names the page count it needs."""
    if prefix_cache is None:
        return None
    cfg = override if override is not None else getattr(engine.config, "paged_decode", None)
    if cfg is False:
        raise NotImplementedError(f"a prefix cache with paged decode off {_GATHER_TODO}")
    if specdec is not None:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP.md, queue A: specdec)")
    m = engine.model_cfg
    if not paged_decode_supported(prefix_cache.page_tokens, m.n_head, m.kv_heads, m.head_dim):
        raise NotImplementedError(
            f"the paged decode kernel has no build for page_tokens={prefix_cache.page_tokens} "
            f"n_head={m.n_head} kv_heads={m.kv_heads} head_dim={m.head_dim}; a prefix cache "
            f"on this geometry {_GATHER_TODO}")
    return PagedServingState(prefix_cache, engine, n_slots)
