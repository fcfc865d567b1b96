"""Shared model plumbing: LayerNorm math, model outputs, the KV-cache
contract and the fused decode-tick dispatch.

Port of the serving half of ``deepspeed_tpu/models/common.py``. The cache
is a list with one dict per layer holding the leaves the JAX package names
(``cached_key``, ``cached_value``, ``cache_index`` and, in a paged cache,
``page_table``). Every append writes IN PLACE (JAX returns a new cache tree
and leans on buffer donation; the port saves the copy, so the JAX
donation/``adopt`` dance has no counterpart here).

Three layouts share :func:`append_kv_cache`:

- contiguous, one write head: K/V ``(B, cache_len, H, D)``, ``cache_index``
  a host ``int`` (``engine.generate``, prefill caches), so slicing needs no
  device round trip;
- contiguous, per-row heads: the same buffers with ``cache_index`` a
  ``(B,)`` int32 tensor (the continuous batcher's slot pool, where JAX
  vmaps a one-row cache per slot);
- paged: K/V are the shared page arena ``(P, pt, KV, D)``, ``page_table``
  ``(B, T)`` int32 and ``cache_index`` ``(B,)`` lengths (page-resident
  serving, ``inference/kvreuse.py``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..ops.decode_layer import norm_proj_supported, post_attn_supported
from ..ops.paged_attention import PagedKV

KV_CACHE_LEAVES = ("cached_key", "cached_value")
CACHE_INDEX_LEAF = "cache_index"
# present only in PAGED caches (inference/kvreuse.py builds them): the
# per-row page table mapping token range [j*pt, (j+1)*pt) to an arena page.
# Its presence is how append_kv_cache detects paged mode.
PAGE_TABLE_LEAF = "page_table"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last dim, cast back to x's dtype — the one
    norm math of every model module (the JAX package's ``layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class ModelOutput(dict):
    """Attribute-accessible output dict (``logits`` and friends)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def cache_leaf_kind(name: str) -> Optional[str]:
    """``"kv"`` for a K/V buffer (contiguous or the paged arena),
    ``"index"`` for the write head, ``"table"`` for a paged cache's page
    table, None for anything outside the ``append_kv_cache`` contract."""
    if name in KV_CACHE_LEAVES:
        return "kv"
    if name == CACHE_INDEX_LEAF:
        return "index"
    if name == PAGE_TABLE_LEAF:
        return "table"
    return None


def set_cache_index(cache: list, value) -> list:
    """Set every layer's write head to ``value`` (in place; returns cache):
    an ``int`` head stays an ``int``, a per-row head takes ``value`` (an
    ``int`` or a ``(B,)`` tensor) in every row."""
    for layer in cache:
        for name in layer:
            if cache_leaf_kind(name) == "index":
                cur = layer[name]
                if isinstance(cur, torch.Tensor):
                    layer[name] = torch.as_tensor(value, dtype=torch.int32,
                                                  device=cur.device).expand(cur.shape).clone()
                else:
                    layer[name] = int(value)
    return cache


def init_layer_cache(batch: int, cache_len: int, heads: int, head_dim: int,
                     dtype, device, per_row: bool = False) -> dict:
    """One layer's contiguous cache; ``per_row`` gives each row its own
    ``(B,)`` int32 write head instead of one host ``int``."""
    shape = (batch, cache_len, heads, head_dim)
    head = torch.zeros((batch,), dtype=torch.int32, device=device) if per_row else 0
    return {"cached_key": torch.zeros(shape, dtype=dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=dtype, device=device),
            CACHE_INDEX_LEAF: head}


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once: the appends run per layer
    per tick and each ``arange`` would be a launch."""
    return torch.arange(n, device=device)


def append_kv_cache(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
                    cache_len: Optional[int] = None):
    """Write this step's K/V ``(B, S, H, D)`` at the layer's write head(s)
    and return ``(k_cache, v_cache, cur)`` with ``cur`` the head before the
    append: an ``int``, or ``(B,)`` for per-row heads. A paged cache takes
    :func:`_append_paged_kv_cache` and returns :class:`PagedKV` carriers
    that carry ``cache_len``, the contiguous cache length the model would
    have used (None: the table's span).

    A contiguous append past the cache's end raises on the CPU: the JAX
    package relies on ``dynamic_update_slice`` clamping its start there,
    which would overwrite live history. The continuous batcher sizes its
    decode windows so that no row's head reaches the end (a host check,
    ``serving.py``), so the per-row append on the card carries no check
    that would need a device→host sync. Each row writes only at its own
    ``(row, position)`` pairs, never into another row."""
    if PAGE_TABLE_LEAF in layer_cache:
        return _append_paged_kv_cache(layer_cache, k, v, cache_len)
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    cur = layer_cache[CACHE_INDEX_LEAF]
    B, S = k.shape[:2]
    S_max = ck.shape[1]
    if not isinstance(cur, torch.Tensor):
        if cur + S > S_max:
            raise ValueError(f"KV cache append of {S} at position {cur} overruns "
                             f"cache_len {S_max}")
        ck[:, cur:cur + S] = k
        cv[:, cur:cur + S] = v
        layer_cache[CACHE_INDEX_LEAF] = cur + S
        return ck, cv, cur
    pos = cur.long()[:, None] + _arange(S, ck.device)[None, :]          # (B, S)
    if not ck.is_cuda and int(pos.max()) >= S_max:
        raise ValueError(f"KV cache append of {S} at per-row heads {cur.tolist()} "
                         f"overruns cache_len {S_max}")
    rows = _arange(B, ck.device)[:, None]
    ck[rows, pos] = k
    cv[rows, pos] = v
    layer_cache[CACHE_INDEX_LEAF] = cur + S
    return ck, cv, cur


def _append_paged_kv_cache(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
                           cache_len: Optional[int]):
    """Paged append (``_append_paged_kv_cache`` of the JAX package): the
    ``cached_key``/``cached_value`` leaves are the SHARED page arena
    ``(P, pt, KV, D)``, ``page_table`` is ``(B, T)`` and ``cache_index`` is
    per-row lengths ``(B,)``. The new K/V lands at each row's write head
    through the table — a scatter of O(new tokens), not O(history), in
    place. Rows whose head has run past their allocation (free slots ticking
    on, bucket-pad overshoot) resolve to the table's trailing trash entries
    (``blk = min(pos // pt, T - 1)``) — never another slot's pages."""
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    table = layer_cache[PAGE_TABLE_LEAF]
    lengths = layer_cache[CACHE_INDEX_LEAF]                             # (B,)
    S = k.shape[1]
    pt, T = ck.shape[1], table.shape[1]
    pos = lengths.long()[:, None] + _arange(S, ck.device)[None, :]      # (B, S)
    blk = torch.clamp(pos // pt, max=T - 1)                             # overshoot →
    pids = torch.gather(table, 1, blk).long()                           # trash entry
    offs = pos % pt
    ck[pids, offs] = k
    cv[pids, offs] = v
    layer_cache[CACHE_INDEX_LEAF] = lengths + S
    cache_len = T * pt if cache_len is None else int(cache_len)
    return (PagedKV(ck, table, cache_len), PagedKV(cv, table, cache_len), lengths)


def decode_fused_enabled(cfg, device: torch.device) -> bool:
    """The fused decode-tick kernels: an explicit ``cfg.decode_fused`` wins;
    None means on for the card and off on the CPU (where the unfused chain
    is the stock path, as off the TPU in the JAX package)."""
    flag = getattr(cfg, "decode_fused", None)
    return device.type == "cuda" if flag is None else bool(flag)


def decode_fused_plan(cfg, rows: int, e: int, proj_outs: tuple, f: int,
                      device: torch.device) -> bool:
    """Whether THIS tick takes the fused kernels: enabled, and the shape
    predicates of both kernels hold (``decode_fused_plan`` of the JAX
    package, without its mesh and W8A16 cases)."""
    return (decode_fused_enabled(cfg, device)
            and all(norm_proj_supported(rows, e, n) for n in proj_outs)
            and post_attn_supported(rows, e, f))
