"""Continuous batching: a slot pool over the inference engine.

Port of ``deepspeed_tpu/inference/serving.py`` (``ContinuousBatcher``).
Requests are admitted into a fixed pool of ``n_slots`` decode slots as
others retire; one batched forward over all ``n_slots`` rows advances every
slot by a token per tick (the JAX package vmaps a one-row step over the
slots in contiguous mode and runs this batched step in paged mode; eager
PyTorch runs the batched step in both). Two cache modes, as in the JAX
batcher:

- **contiguous slots** (no prefix cache, the default): each slot owns a row
  of a ``(n_slots, cache_len, H, D)`` cache with its own write head; decode
  attention is the contiguous kernel with per-row lengths. A group of
  queued prompts shares one batched prefill into its own cache, whose rows
  are copied into slots as they free (prefill-ahead parking).
- **page-resident** (a prefix cache resolved, ``inference/kvreuse.py``):
  K/V live in the shared page arena for a request's whole life. Admission
  references the cached prefix's pages and prefills only the suffix,
  straight into freshly allocated pages; decode attention is the paged
  kernel, reading the arena through each slot's page table; retirement
  hands the prompt's pages to the radix tree by reference.

Scheduling is the JAX batcher's: prompts at the queue head that share a
power-of-two bucket (and, paged, the same cached prefix) form one prefill,
fed as descending power-of-two chunks; the first token is sampled at
prefill and parks until a slot frees; with waiters, a decode window ends at
the next certain retirement, rounded up to a power of two within the step's
ticks (the JAX batcher's rule, which bounds its executables; here it keeps
each request retiring on the same ``step()`` call). One change: every
window also ends before any live row's head would reach ``cache_len``, so
no row ever writes past its cache (the JAX batcher lets those writes clamp
at the cache edge). Free slots rewind their head to 0 at each window.

Each decode window runs ``sub`` ticks over all ``n_slots`` rows as replays
of ONE captured tick (``compiled_loop=True``, the default; the JAX batcher
runs the window as one compiled ``lax.scan`` over its tick): the tick reads
and writes static device buffers (token, position, done, the per-row heads
or the paged lengths and page table, temperature, top-p, penalty, the
window's uniforms and output rows, a tick counter), which the host refreshes
once per window before the first replay; there is one graph per greedy
pool flag (``inference/graphs.py``). On the CPU the same tick function runs
without capture. ``compiled_loop=False`` keeps the eager window, which
enqueues every op of every tick from Python, to hold the two against each
other.

Sampling is per row (``sample_row`` of the JAX batcher): temperature,
top-p and repetition penalty per request, ``top_k`` and EOS pool-wide, the
greedy shortcut when every live row is greedy, done → pad and the EOS
latch. JAX's threefry keys cannot be matched; here each draw is a function
of ``(seed, tick, slot)`` at decode and ``(seed, uid)`` for the first token
(Philox uniforms made on the host, picked by inverse CDF), so sampled
streams repeat under a seed and agree between the two cache modes.

Not ported (arguments asking for them raise ``NotImplementedError``):
speculative decoding, admission control and SLO tagging; the chaos sites,
the telemetry registry, ``/statusz``, request tracing and the SIGTERM drain
hook are left out. Per-instance counters (``stats``, ``latency_stats``,
the prefix cache's hit/miss tokens) remain.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.common import advance_heads
from . import kvreuse
from .engine import _filtered_logits, _penalized_logits
from .graphs import DecodeGraph

_TODO = "is not ported to the PyTorch/CUDA batcher yet (ROADMAP.md, queue A)"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_p: float = 1.0
    repetition_penalty: float = 1.0


@dataclasses.dataclass
class _Active:
    req: Request
    emitted: List[int]


def _pct(sorted_xs, q: float) -> float:
    """Nearest-rank percentile over an ascending sequence, NaN on empty (the
    JAX package's ``telemetry.registry.pct``)."""
    if not sorted_xs:
        return float("nan")
    return sorted_xs[min(len(sorted_xs) - 1, int(q * len(sorted_xs)))]


def _uniforms(seed: int, stream: int, n: int) -> np.ndarray:
    """``n`` float32 uniforms in [0, 1) from Philox keyed by ``(seed,
    stream)``: the same numbers on every device and in every cache mode."""
    key = ((int(seed) % 2 ** 64) << 64) | int(stream)
    return np.random.Generator(np.random.Philox(key=key)).random(n, dtype=np.float32)


def sample_rows(logits: torch.Tensor, greedy_pool: bool, temp: torch.Tensor,
                top_p: torch.Tensor, rep: torch.Tensor, seen: torch.Tensor,
                uniforms: Optional[torch.Tensor], top_k: int) -> torch.Tensor:
    """THE per-row sampling step over fp32 logits ``(B, V)``: repetition
    penalty on ``seen`` tokens, then greedy rows take the first maximum and
    sampled rows the inverse-CDF pick of ``uniforms`` ``(B,)`` under their
    temperature / pool-wide top-k / top-p. ``greedy_pool`` (every live row
    greedy) skips the sampling work."""
    logits = _penalized_logits(logits, rep[:, None], seen)
    greedy = torch.argmax(logits, dim=-1)
    if greedy_pool:
        return greedy
    probs = torch.softmax(_filtered_logits(logits, temp, top_k, top_p), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    x = uniforms.to(cdf.device)[:, None] * cdf[:, -1:]
    # the first token whose CDF exceeds x: it has positive mass, since x <
    # cdf[-1] for u < 1 (the left side would give u = 0 to token 0, kept or not)
    sampled = torch.searchsorted(cdf, x, right=True).clamp_(max=logits.shape[-1] - 1)[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled)


class _TickState:
    """The static buffers of the batcher's compiled tick over ``n`` slots:
    token and position (one int64 block), done, temperature / top-p /
    penalty (one fp32 block), the window's uniforms and output rows
    (``cap`` ticks: a window never outruns the cache) and the tick counter."""

    def __init__(self, n: int, cap: int, device):
        self.ints = torch.zeros((2, n), dtype=torch.long, device=device)
        self.token, self.pos = self.ints[0], self.ints[1]
        self.done = torch.ones((n,), dtype=torch.bool, device=device)
        self.floats = torch.zeros((3, n), dtype=torch.float32, device=device)
        self.temp, self.top_p, self.rep = self.floats[0], self.floats[1], self.floats[2]
        self.u = torch.zeros((cap, n), dtype=torch.float32, device=device)
        self.out = torch.zeros((cap, n), dtype=torch.long, device=device)
        self.idx = torch.zeros((1,), dtype=torch.long, device=device)


class ContinuousBatcher:
    """Slot-pool scheduler over an :class:`~.engine.InferenceEngine`.

    ``top_k`` and ``eos_token_id`` are pool-wide; temperature, top-p and
    repetition penalty are per request. ``prefix_cache`` (None defers to the
    engine config and ``DSTPU_PREFIX_CACHE``) turns on page-resident
    serving; ``paged_decode`` may only confirm it (False asks for the gather
    path, which is not ported and raises). ``compiled_loop``: decode windows
    as replays of a captured tick (True) or the eager window (False)."""

    def __init__(self, engine, n_slots: int = 4, *, top_k: int = 0,
                 eos_token_id: Optional[int] = None, pad_token_id: Optional[int] = None,
                 seed: int = 0, prefill_ahead: Optional[int] = None, prefix_cache=None, specdec=None,
                 paged_decode=None, slo=None, admission=None, compiled_loop: bool = True):
        for name, value in (("specdec", specdec), ("slo", slo), ("admission", admission)):
            if value is not None and value is not False:   # {} asks for the defaults
                raise NotImplementedError(f"{name} {_TODO}")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.prefix_cache = kvreuse.resolve_prefix_cache(engine, prefix_cache)
        self.paged = kvreuse.resolve_paged_decode(engine, self.prefix_cache, n_slots,
                                                  None, paged_decode)
        self.top_k = int(top_k)
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        self.pad = int(pad_token_id if pad_token_id is not None
                       else (eos_token_id if eos_token_id is not None else 0))
        self.seed = int(seed)
        self.prefill_ahead = n_slots if prefill_ahead is None else int(prefill_ahead)
        self._vocab = int(engine.model_cfg.padded_vocab_size)
        self._device = engine.device
        self.compiled_loop = bool(compiled_loop)
        # contiguous slots: one row per slot, per-row write heads (mirrored
        # in self._heads; one static head the tick advances under
        # compiled_loop); page-resident slots keep their K/V in the arena
        self._cache = None if self.paged is not None else engine.init_cache(
            n_slots, static_head=self.compiled_loop)
        # host mirrors of the per-slot decode state, uploaded once per window
        n = self.n_slots
        self._token = np.zeros((n,), np.int64)
        self._pos = np.zeros((n,), np.int64)
        self._heads = np.zeros((n,), np.int32)
        self._temp = np.zeros((n,), np.float32)
        self._top_p = np.ones((n,), np.float32)
        self._rep = np.ones((n,), np.float32)
        self._done = np.ones((n,), bool)              # free ⇒ done
        self._seen = torch.zeros((n, self._vocab), dtype=torch.bool, device=self._device)
        self._slots: List[Optional[_Active]] = [None] * n
        self._queue: deque = deque()
        # prefill-ahead: queued requests are prefilled and their first token
        # sampled while every slot is busy; (req, cacheB, row, firstB,
        # seen1B, first) parks here until a slot frees. Rows of one batched
        # prefill share its cacheB by reference (None when page-resident).
        self._parked: deque = deque()
        self._parked_meta: Dict[int, object] = {}
        self._tick_no = 0
        self._next_uid = 0
        self._finished: Dict[int, np.ndarray] = {}
        self._t_submit: Dict[int, float] = {}
        self._t_first: Dict[int, float] = {}
        self._lat: deque = deque(maxlen=4096)
        self._tpot_window: deque = deque(maxlen=512)
        # the static buffers of the compiled tick and its graphs by greedy flag
        self._tick_state = _TickState(n, engine.cache_len, self._device) \
            if self.compiled_loop else None
        self._graphs: Dict[bool, DecodeGraph] = {}
        self._graphs_version = engine.params_version
        # per-instance counters: decode ticks and windows, decode wall
        # seconds and tokens, prefill tokens (padding included), and prefill
        # forwards of one token (which, like a decode tick, run the
        # single-token kernels)
        self.stats = dict(ticks=0, windows=0, decode_s=0.0, decode_tokens=0,
                          prefill_tokens=0, one_token_prefills=0)
        # prefill forwards by (rows, chunk tokens): which kernels a chunk runs
        # depends on its shape (one-token chunks take the single-token kernels,
        # W8A16 chunks of 2..64 rows x tokens the w8 matmul)
        self.prefill_chunks: Counter = Counter()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
               top_p: float = 1.0, repetition_penalty: float = 1.0) -> int:
        """Queue a request; returns its uid."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            raise ValueError(f"prompt token ids must be in [0, {self._vocab}); got "
                             f"range [{prompt.min()}, {prompt.max()}]")
        if len(prompt) + max_new_tokens > self.engine._gen_limit:
            raise ValueError(f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) "
                             f"exceeds the generation limit {self.engine._gen_limit}")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid, prompt, int(max_new_tokens), float(temperature),
                                   float(top_p), float(repetition_penalty)))
        self._t_submit[uid] = time.perf_counter()
        return uid

    # ------------------------------------------------------------------
    def _prefill(self, ids: np.ndarray, cache: list, start: int = 0):
        """Prefill of ``ids`` (B, S) — B prompts of equal (or bucket-padded)
        length — into ``cache`` at positions ``[start, start + S)``, fed as
        DESCENDING power-of-two chunks (the binary decomposition of its
        length), each appended at its exact positions. Returns (last-chunk
        logits, cache)."""
        B, S = ids.shape
        self.stats["prefill_tokens"] += B * S
        pos, logits = 0, None
        for chunk in [1 << b for b in range(S.bit_length() - 1, -1, -1) if S & (1 << b)]:
            positions = np.arange(start + pos, start + pos + chunk)[None, :]
            logits, cache = self.engine.prefill(cache, ids[:, pos:pos + chunk], positions)
            self.stats["one_token_prefills"] += chunk == 1
            self.prefill_chunks[(B, chunk)] += 1
            pos += chunk
        return logits, cache

    def _pop_group(self, max_new: int, match):
        """Pop the run of queued requests at the head that share one prefill:
        the same cached prefix (``match(prompt)`` → ``(m, page_ids,
        nodes)``) and the same power-of-two suffix bucket (the same suffix
        length when the bucket would pass the generation limit), at most
        ``max_new``.
        Returns (requests, m0, page_ids, nodes, bucket, bucketed)."""
        m0, pids0, nodes0 = match(self._queue[0].prompt)
        sfx0 = len(self._queue[0].prompt) - m0
        bucket = 1 << (sfx0 - 1).bit_length()
        bucketed = m0 + bucket <= self.engine._gen_limit

        def same_group(r):
            m, pids, _ = match(r.prompt)
            if pids != pids0:
                return False
            s = len(r.prompt) - m
            return (1 << (s - 1).bit_length() == bucket) if bucketed else s == sfx0

        reqs = [self._queue.popleft()]
        while self._queue and len(reqs) < max_new and same_group(self._queue[0]):
            reqs.append(self._queue.popleft())
        return reqs, m0, pids0, nodes0, bucket, bucketed

    def _prefill_rows(self, reqs, m0: int, bucket: int, bucketed: bool, cache: list):
        """The group's (suffix) prefill; returns each row's real last-token
        logits ``(B, V)``. Mixed lengths right-pad to the bucket: the pads'
        K/V lands past each row's rewound head and is never attended."""
        lens = np.asarray([len(r.prompt) - m0 for r in reqs], np.int64)
        if bucketed and (lens != lens[0]).any():
            ids = np.full((len(reqs), bucket), self.pad, np.int64)
            for row, r in enumerate(reqs):
                ids[row, :lens[row]] = r.prompt[m0:]
            logits, _ = self._prefill(ids, cache, start=m0)
            rows = torch.arange(len(reqs), device=logits.device)
            return logits[rows, torch.as_tensor(lens - 1, device=logits.device)], lens
        ids = np.stack([r.prompt[m0:] for r in reqs]).astype(np.int64)
        logits, _ = self._prefill(ids, cache, start=m0)
        return logits[:, -1], lens

    def _first_tokens(self, reqs, last: torch.Tensor):
        """Sample each request's first token from its last-token logits;
        returns (first (B,) on the device, prompt+first seen mask (B, V),
        first tokens on the host)."""
        B, dev = len(reqs), last.device
        seen_np = np.zeros((B, self._vocab), bool)
        for row, r in enumerate(reqs):
            seen_np[row, r.prompt] = True
        seen = torch.as_tensor(seen_np, device=dev)
        f32 = np.float32
        temp = torch.as_tensor(np.asarray([r.temperature for r in reqs], f32), device=dev)
        top_p = torch.as_tensor(np.asarray([r.top_p for r in reqs], f32), device=dev)
        rep = torch.as_tensor(np.asarray([r.repetition_penalty for r in reqs], f32), device=dev)
        greedy = all(r.temperature <= 0.0 for r in reqs)
        u = None if greedy else torch.as_tensor(
            np.asarray([_uniforms(self.seed, 2 * r.uid + 1, 1)[0] for r in reqs]), device=dev)
        first = sample_rows(last.float(), greedy, temp, top_p, rep, seen, u, self.top_k)
        seen[torch.arange(B, device=dev), first] = True
        return first, seen, first.cpu().numpy()

    def _park_or_finish(self, reqs, first, seen, first_host, cacheB, metas=None):
        """Park each prefilled row until a slot frees, or finish it at once
        when its first token ends it (EOS or ``max_new_tokens <= 1``);
        ``metas`` carry page-resident rows' page ownership."""
        t_first = time.perf_counter()
        for row, req in enumerate(reqs):
            self._t_first[req.uid] = t_first
            tok = int(first_host[row])
            if tok == self.eos or req.max_new_tokens <= 1:
                if metas is not None:
                    self.paged.finish_unslotted(metas[row], req.prompt)
                self._finish_unslotted(req, [tok])
                continue
            if metas is not None:
                self._parked_meta[req.uid] = metas[row]
            self._parked.append((req, cacheB, row, first, seen, tok))

    def _prefill_batch(self, max_new: int):
        """Prefill up to ``max_new`` queued requests and PARK the results
        (contiguous slots): each group shares one batched prefill into a
        fresh cache with one write head, and its first tokens are sampled
        now, so TTFT lands even while every slot is busy. A request finished
        by its first token never occupies a slot. Page-resident mode takes
        :meth:`_prefill_batch_paged`."""
        if self.paged is not None:
            return self._prefill_batch_paged(max_new)
        while self._queue and max_new > 0:
            reqs, m0, _, _, bucket, bucketed = self._pop_group(max_new, lambda p: (0, (), ()))
            max_new -= len(reqs)
            cacheB = self.engine.init_cache(len(reqs), per_row=False)
            last, _ = self._prefill_rows(reqs, m0, bucket, bucketed, cacheB)
            self._park_or_finish(reqs, *self._first_tokens(reqs, last), cacheB)

    def _prefill_batch_paged(self, max_new: int):
        """Page-resident admission: per group (same matched pages and suffix
        bucket), each request allocates its own pages covering ``[m0,
        prompt + max_new)`` (``try_admit`` pins the hit chain for its
        lifetime), the batched suffix prefill writes straight into them
        through the rows' page tables, and the parked entry carries only
        the sampling state. Page exhaustion re-queues the un-admitted tail
        in order and stops (backpressure). Any failure before a row finds
        an owner rolls that row's admission back (``abort_admit``)."""
        pc, pg = self.prefix_cache, self.paged
        blocked = False
        while self._queue and max_new > 0 and not blocked:
            reqs, m0, pids0, nodes0, bucket, bucketed = self._pop_group(max_new, pc.match)
            max_new -= len(reqs)
            admitted, metas = [], []
            while reqs:
                r = reqs[0]
                meta = pg.try_admit(r.prompt, r.max_new_tokens, m0, nodes0, pids0,
                                    span_tokens=min(len(r.prompt) + r.max_new_tokens,
                                                    pg.gen_limit))
                if meta is None:
                    # out of pages even after eviction: the tail goes back to
                    # the queue head IN ORDER and admission stops
                    self._queue.extendleft(reversed(reqs))
                    blocked = True
                    break
                admitted.append(reqs.pop(0))
                metas.append(meta)
            if not admitted:
                break
            B = len(admitted)
            try:
                cacheB = pg.build_cache(np.full((B,), m0, np.int32),
                                        np.stack([m.table_row for m in metas]))
                last, lens = self._prefill_rows(admitted, m0, bucket, bucketed, cacheB)
                first = self._first_tokens(admitted, last)
            except BaseException:
                # the pages hold no (or partial) K/V: free them and unpin the
                # hit chains without absorbing, or a transient failure leaks
                # pinned nodes and pages until admission deadlocks
                for meta in metas:
                    pg.abort_admit(meta)
                raise
            pc.note_tokens(hit=m0 * B, miss=int(lens.sum()))
            self._park_or_finish(admitted, *first, None, metas)

    def _record_latency(self, uid: int) -> None:
        t_sub = self._t_submit.pop(uid, None)
        t_first = self._t_first.pop(uid, None)
        if t_sub is None:
            return
        ttft = t_first - t_sub if t_first is not None else float("nan")
        self._lat.append((ttft, time.perf_counter() - t_sub))

    def _finish_unslotted(self, req: Request, emitted: List[int]):
        self._finished[req.uid] = np.concatenate([req.prompt, np.asarray(emitted, np.int32)])
        self._record_latency(req.uid)

    def _admit(self):
        """Place parked (already-prefilled) requests into free slots;
        prefill directly for any remaining free capacity."""
        free = [i for i in range(self.n_slots) if self._slots[i] is None]
        if len(self._parked) < len(free):
            self._prefill_batch(len(free) - len(self._parked))
        while self._parked and free:
            req, cacheB, row, firstB, seen1B, first_host = self._parked.popleft()
            i = free.pop(0)
            n = len(req.prompt)
            if self.paged is not None:
                # K/V is already page-resident: bind the slot's table row
                self.paged.place(i, self._parked_meta.pop(req.uid))
            else:
                for dst, src in zip(self._cache, cacheB):
                    dst["cached_key"][i, :n].copy_(src["cached_key"][row, :n])
                    dst["cached_value"][i, :n].copy_(src["cached_value"][row, :n])
                # bucket-padded prefills leave pad K/V past the prompt: the
                # head rewinds to the real length and decode overwrites it
                self._heads[i] = n
            self._token[i] = first_host
            self._pos[i] = n
            self._temp[i] = req.temperature
            self._top_p[i] = req.top_p
            self._rep[i] = req.repetition_penalty
            self._done[i] = first_host == self.eos
            self._seen[i] = seen1B[row]
            self._slots[i] = _Active(req, [first_host])
        self._shrink_parked()

    def _shrink_parked(self):
        """Release B-row prefill caches that only one parked row still pins
        (contiguous slots): that row is copied into a 1-row cache and the
        batch's reference dropped, so a slow-to-place row holds one row of
        memory, not B."""
        if self.paged is not None:
            return   # paged parked entries hold no cache: their K/V is in the arena
        refs: Dict[int, int] = {}
        for entry in self._parked:
            refs[id(entry[1])] = refs.get(id(entry[1]), 0) + 1
        for idx, (req, cacheB, row, firstB, seen1B, first_host) in enumerate(self._parked):
            if refs[id(cacheB)] == 1 and int(firstB.shape[0]) > 1:
                cache1 = [{name: (leaf[row:row + 1].clone() if isinstance(leaf, torch.Tensor)
                                  else leaf) for name, leaf in layer.items()}
                          for layer in cacheB]
                self._parked[idx] = (req, cache1, 0, firstB[row:row + 1].clone(),
                                     seen1B[row:row + 1].clone(), first_host)

    def _retire(self, i: int):
        act = self._slots[i]
        self._finished[act.req.uid] = np.concatenate(
            [act.req.prompt, np.asarray(act.emitted, np.int32)])
        self._record_latency(act.req.uid)
        self._slots[i] = None
        if self.paged is not None:
            # zero-copy retirement: the prompt pages attach to the radix tree
            # by reference, the rest free; the next window's table and
            # lengths simply stop naming this slot
            self.paged.retire_slot(i, act.req.prompt)
        self._done[i] = True
        self._pos[i] = 0
        self._heads[i] = 0

    # ------------------------------------------------------------------
    def _headroom(self) -> int:
        """Ticks before a live row's write would reach ``cache_len``: each
        window stops there, so no row writes past its cache (>= every live
        row's remaining token count, since prompt + max_new <= gen_limit)."""
        cache_len = int(self.engine.cache_len)
        return min(cache_len - int(self._pos[i]) for i, s in enumerate(self._slots)
                   if s is not None)

    def _decode_tick(self, greedy: bool, cache: list):
        """ONE decode tick over all ``n_slots`` rows, in place on the static
        buffers and ``cache`` (a ``static_head`` cache): the batched forward
        of each row's last token at its position, the per-row sample (this
        tick's uniforms picked by the tick counter), done → pad and the EOS
        latch, the seen mask, the output row the counter names; then token,
        position, heads and counter advance."""
        # no reference to the batcher: its graphs (which hold this tick) go
        # with it when it is dropped, not at a later garbage collection
        st, module, seen = self._tick_state, self.engine.module, self._seen
        top_k, pad, eos = self.top_k, self.pad, self.eos

        def tick():
            logits = module(st.token[:, None], position_ids=st.pos[:, None],
                            cache=cache).logits[:, -1, :].float()
            u = None if greedy else st.u.index_select(0, st.idx)[0]
            nxt = sample_rows(logits, greedy, st.temp, st.top_p, st.rep, seen, u, top_k)
            nxt = torch.where(st.done, pad, nxt)
            st.done.logical_or_(nxt == eos)
            seen.scatter_(1, nxt[:, None], True)
            st.out.index_copy_(0, st.idx, nxt[None])
            st.token.copy_(nxt)
            st.pos.add_(1)
            advance_heads(cache)
            st.idx.add_(1)

        return tick

    def graph_stats(self) -> Dict[bool, dict]:
        """Each captured window graph (by greedy pool flag): its capture time
        (warm-up tick included, host seconds) and replays."""
        return {k: {"capture_s": g.capture_s, "replays": g.replays}
                for k, g in self._graphs.items()}

    @torch.no_grad()
    def _window_compiled(self, ticks: int, greedy: bool) -> np.ndarray:
        """The window of :meth:`_window` as ``ticks`` runs of the captured
        tick (:class:`~.graphs.DecodeGraph`): the host mirrors go to the
        static buffers once, then the replays, then one device fetch."""
        if self._graphs_version != self.engine.params_version:   # weights reloaded
            self._graphs, self._graphs_version = {}, self.engine.params_version
        st, n = self._tick_state, self.n_slots
        free = np.asarray([s is None for s in self._slots])
        self._pos[free] = 0      # free rows decode discarded pads from 0
        self._heads[free] = 0
        st.ints.copy_(torch.from_numpy(np.stack([self._token, self._pos])))
        st.done.copy_(torch.from_numpy(self._done))
        st.floats.copy_(torch.from_numpy(np.stack([self._temp, self._top_p, self._rep])))
        if not greedy:
            st.u[:ticks].copy_(torch.from_numpy(np.stack(
                [_uniforms(self.seed, 2 * (self._tick_no + t), n) for t in range(ticks)])))
        if self.paged is None:
            cache = self._cache
            cache[0]["cache_index"].copy_(torch.from_numpy(self._heads))
        else:
            cache = self.paged.decode_cache()    # the window's lengths and table
        st.idx.zero_()
        graph = self._graphs.get(greedy)
        if graph is None:
            graph = self._graphs[greedy] = DecodeGraph(
                self._decode_tick(greedy, cache), self._device, tickets=self.engine._tickets)
        graph.run(ticks)
        return st.out[:ticks].cpu().numpy()

    @torch.no_grad()
    def _window(self, ticks: int, greedy: bool) -> np.ndarray:
        """Run ``ticks`` decode ticks over all ``n_slots`` rows, eagerly: one
        batched forward and one per-row sample each. Returns the tokens
        ``(ticks, n_slots)`` on the host (one device fetch per window)."""
        dev, n = self._device, self.n_slots
        free = np.asarray([s is None for s in self._slots])
        self._pos[free] = 0      # free rows decode discarded pads from 0
        self._heads[free] = 0
        state = torch.as_tensor(np.stack([self._token, self._pos, self._done.astype(np.int64)]),
                                device=dev)
        token, pos, done = state[0], state[1], state[2].bool()
        temp, top_p, rep = torch.as_tensor(np.stack([self._temp, self._top_p, self._rep]),
                                           device=dev)
        u = None if greedy else torch.as_tensor(np.stack(
            [_uniforms(self.seed, 2 * (self._tick_no + t), n) for t in range(ticks)]), device=dev)
        if self.paged is not None:
            cache = self.paged.build_cache(self.paged.lengths, self.paged.table)
        else:
            cache = self._cache
            heads = torch.as_tensor(self._heads, device=dev)
            for layer in cache:
                layer["cache_index"] = heads
        rows = torch.arange(n, device=dev)
        outs = []
        for t in range(ticks):
            logits = self.engine.module(token[:, None], position_ids=pos[:, None],
                                        cache=cache).logits[:, -1, :].float()
            nxt = sample_rows(logits, greedy, temp, top_p, rep, self._seen,
                              None if u is None else u[t], self.top_k)
            nxt = torch.where(done, self.pad, nxt)
            done = done | (nxt == self.eos)
            self._seen[rows, nxt] = True
            outs.append(nxt)
            token, pos = nxt, pos + 1
        return torch.stack(outs).cpu().numpy()

    def step(self, ticks: int = 1) -> Dict[int, np.ndarray]:
        """Admit, decode up to ``ticks`` ticks, retire finished slots.
        Returns {uid: full token array} for requests completed in this call.

        With waiters (queued or parked requests) a window ends at the next
        CERTAIN retirement (a slot reaching its ``max_new_tokens``), rounded
        up to a power of two as in the JAX batcher (a slot past its budget
        decodes discarded pads to the window's end), so freed slots refill
        soon; queued requests are prefilled ahead so their
        first token is produced while slots are still busy. EOS retirements
        are seen at window boundaries (the done flag freezes the row, so
        its pads are discarded, not emitted)."""
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        before = set(self._finished)
        remaining = int(ticks)
        while remaining > 0:
            self._admit()
            if self.prefill_ahead and self._queue:
                self._prefill_batch(self.prefill_ahead - len(self._parked))
            active = [a for a in self._slots if a is not None]
            if not active:
                break
            greedy = all(a.req.temperature <= 0.0 for a in active)
            sub = remaining
            if self._queue or self._parked:
                t2r = min(a.req.max_new_tokens - len(a.emitted) for a in active)
                sub = max(1, min(remaining, t2r))
                if sub & (sub - 1):   # up to a power of two, at most remaining's largest
                    sub = min(1 << sub.bit_length(), 1 << (remaining.bit_length() - 1))
            sub = min(sub, self._headroom())
            t0 = time.perf_counter()
            toks = (self._window_compiled if self.compiled_loop else self._window)(sub, greedy)
            wall = time.perf_counter() - t0
            self._tick_no += sub
            self._token[:] = toks[-1]
            self._pos += sub
            self._heads += sub
            if self.eos >= 0:
                self._done |= (toks == self.eos).any(axis=0)
            if self.paged is not None:
                self.paged.note_window(sub)
            appended = 0
            for t in range(sub):
                for i, act in enumerate(self._slots):
                    if act is None:
                        continue
                    tokv = int(toks[t, i])
                    act.emitted.append(tokv)
                    appended += 1
                    if (self.eos >= 0 and tokv == self.eos) or \
                            len(act.emitted) >= act.req.max_new_tokens:
                        self._retire(i)
            self.stats["ticks"] += sub
            self.stats["windows"] += 1
            self.stats["decode_s"] += wall
            self.stats["decode_tokens"] += appended
            if appended:
                self._tpot_window.append(wall * 1e3 / appended)
            remaining -= sub
        return {u: self._finished[u] for u in self._finished if u not in before}

    def leak_counts(self) -> Dict[str, int]:
        """Resources still owned by in-flight requests: occupied slots,
        parked entries and (page-resident) arena pages owned by parked or
        active requests. All three are zero once everything has finished."""
        return {"slots": sum(s is not None for s in self._slots),
                "parked": len(self._parked),
                "pages": 0 if self.paged is None else int(self.paged._slot_pages_n)}

    def _live_uids(self) -> set:
        live = {r.uid for r in self._queue}
        live.update(e[0].uid for e in self._parked)
        live.update(a.req.uid for a in self._slots if a is not None)
        return live

    def wait(self, uids=None, *, ticks: int = 4,
             timeout_s: Optional[float] = None) -> Dict[int, np.ndarray]:
        """Step until every requested uid has finished; returns {uid:
        tokens}. ``uids=None`` waits for everything in flight. A uid that is
        neither finished nor live can never finish → ``RuntimeError``;
        ``timeout_s`` bounds the wait → ``TimeoutError``."""
        targets = list(self._live_uids()) if uids is None else list(uids)
        t0 = time.perf_counter()
        while True:
            outstanding = [u for u in targets if u not in self._finished]
            if not outstanding:
                break
            dead = [u for u in outstanding if u not in self._live_uids()]
            if dead:
                raise RuntimeError(f"uids {dead} are neither pending nor finished — they "
                                   f"can never complete")
            if timeout_s is not None and time.perf_counter() - t0 >= timeout_s:
                raise TimeoutError(f"wait expired with {len(outstanding)} unfinished uids "
                                   f"{outstanding[:8]}")
            self.step(ticks=ticks)
        return {u: self._finished[u] for u in targets}

    def run(self, prompts, ticks: int = 1, timeout_s: Optional[float] = None,
            **gen_kwargs) -> List[np.ndarray]:
        """Submit every prompt, step until drained, return the outputs in
        submission order."""
        uids = [self.submit(p, **gen_kwargs) for p in prompts]
        self.wait(uids, ticks=ticks, timeout_s=timeout_s)
        return [self._finished[u] for u in uids]

    def reset_latency_stats(self) -> None:
        """Drop the finished-request latency windows (e.g. after a warm-up)."""
        self._lat.clear()
        self._tpot_window.clear()

    def latency_stats(self) -> Dict[str, float]:
        """Latency percentiles over the retired-request window (last ≤ 4096):
        ``ttft`` (submit → first token on the host, queueing and prefill
        included) and ``e2e`` (submit → retirement), seconds; and TPOT, ms
        per output token of each decode window."""
        ttfts = sorted(t for t, _ in self._lat if t == t)
        e2es = sorted(e for _, e in self._lat)
        tpots = sorted(self._tpot_window)
        return {"n": len(self._lat),
                "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p90_s": _pct(ttfts, 0.90),
                "ttft_p99_s": _pct(ttfts, 0.99),
                "e2e_p50_s": _pct(e2es, 0.50), "e2e_p90_s": _pct(e2es, 0.90),
                "e2e_p99_s": _pct(e2es, 0.99),
                "tpot_p50_ms": _pct(tpots, 0.50), "tpot_p99_ms": _pct(tpots, 0.99)}
