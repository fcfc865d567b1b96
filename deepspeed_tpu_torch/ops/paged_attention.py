"""Paged decode attention: one decode tick read straight off the KV page arena.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The TPU kernel
``_paged_kernel`` (a flash-decode whose grid walks the page table in order,
the table and lengths riding as scalar prefetch) becomes one C entry,
``csrc/paged_attention.cu``: the contiguous decode kernel's split design
(``csrc/decode_split.cuh``) with a paged address map. The ``T * pt``
positions a row's table covers are cut into chunks of ``CHUNK``; one block
per (chunk, KV head, batch row) reads the table entries its chunk spans,
copies the live rows through them (rows past the length zero-filled, never
read) and forms the chunk's fp32 softmax state for the group's query heads;
a second kernel merges a row's live chunks by their lse, in chunk order.
See the sources' headers for the bound and what limits the kernel.

Layouts are the JAX package's: ``q`` ``(B, 1, H, D)``; the arena
``k_pages``/``v_pages`` ``(P, pt, KV, D)`` with ``KV`` dividing ``H``
(GQA reads KV head ``h // (H/KV)``); ``page_table`` ``(B, T)`` int32 page
ids, entry ``j`` covering tokens ``[j*pt, (j+1)*pt)`` and rows padded with
a trash page past a slot's allocation; ``lengths`` ``(B,)`` valid tokens
INCLUDING the just-appended one. A row attends ``min(L, T*pt)`` positions:
a free slot's length keeps growing across windows while its table row is
all trash, and the table is never indexed past ``T - 1``.

:func:`paged_decode_attention` launches the kernel for CUDA tensors and
runs :func:`paged_decode_attention_plain` (gather the table's pages, then
the contiguous plain version's one pass) for CPU tensors;
:func:`paged_decode_attention_split_plain` repeats the kernel's chunks and
merge for the tests. The launch plan comes from shapes alone: the wrapper
never reads ``lengths`` back from the card.
:func:`paged_reference_attention` is the multi-token path (suffix prefill)
over the gathered view, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel, capturing, check_operands, dtype_code, stream_of
from .decode_attention import (CHUNK, decode_attention_plain, decode_attention_split_plain,
                               decode_supported, split_workspace)

KERNEL = Kernel("paged_attention", "paged_attention_fwd",
                [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT,
                 INT, PTR])


class PagedKV(NamedTuple):
    """A paged K or V cache as ``append_kv_cache`` returns it in paged mode:
    the arena leaf plus the page table that maps this batch's rows onto it.
    ``cache_len`` is the contiguous cache length the model would have used —
    the multi-token path slices its gathered view to exactly this many
    tokens, so paged and contiguous streams see the same shapes. Consumed
    at once by ``cached_decode_attention``."""

    pages: torch.Tensor     # (P, pt, KV, D) arena leaf
    table: torch.Tensor     # (B, T) int32 page ids
    cache_len: int


def paged_decode_supported(page_tokens: int, n_heads: int, kv_heads: int, d: int) -> bool:
    """True when the CUDA kernel takes this geometry: any page size, and the
    head layouts of the contiguous decode kernel (it keeps that design; the
    TPU predicate's sublane floor and VMEM budget have no counterpart)."""
    return page_tokens >= 1 and decode_supported(n_heads, kv_heads, d)


def gather_kv_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``(P, pt, ...)`` arena + ``(B, T)`` table → ``(B, T*pt, ...)``
    contiguous view (a read inside the attention computation, not a copy
    into a persistent cache). Page ids clip into ``[0, P)``, JAX's
    ``mode="clip"``."""
    idx = table.long().clamp(0, pages.shape[0] - 1)
    g = pages[idx]                                            # (B, T, pt, ...)
    return g.reshape((table.shape[0], -1) + tuple(pages.shape[2:]))


def paged_decode_attention_plain(q, k_pages, v_pages, table, lengths, scale):
    """The kernel's arithmetic in plain PyTorch: gather the table's pages
    into ``(B, T*pt, KV, D)``, then the contiguous kernel's masked fp32
    softmax over ``min(L, T*pt)`` positions (dead V rows zeroed, so
    garbage in unallocated or trash pages never reaches the output)."""
    k = gather_kv_pages(k_pages, table)
    v = gather_kv_pages(v_pages, table)
    live = lengths.to(q.device).clamp(0, k.shape[1])
    return decode_attention_plain(q, k, v, live, scale)


def paged_decode_attention_split_plain(q, k_pages, v_pages, table, lengths, scale,
                                       chunk=CHUNK):
    """The kernel's split arithmetic in plain PyTorch, for the tests: gather
    the table's pages, then :func:`decode_attention_split_plain` (chunks of
    the ``T*pt`` gathered positions, merged by lse) over ``min(L, T*pt)``."""
    k = gather_kv_pages(k_pages, table)
    v = gather_kv_pages(v_pages, table)
    return decode_attention_split_plain(q, k, v, lengths, scale, chunk)


def _check_geometry(q, k_pages, v_pages, table, lengths):
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError("paged decode attention is single-token decode only; the "
                         "multi-token path rides paged_reference_attention")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 or k_pages.shape[3] != D:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} and arenas "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not match")
    KV = k_pages.shape[2]
    if H % KV:
        raise ValueError(f"q heads {H} must be a multiple of KV heads {KV}")
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"page table must be ({B}, T), got {tuple(table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One decode tick off the page arena; returns ``(B, 1, H, D)`` in
    ``q``'s dtype (fp32 scores, softmax and accumulation; a row with no
    live position gives zeros). Under graph capture ``lengths`` must already
    be ``(B,)`` int32 on q's device (the static lengths the tick advances),
    so that converting them is no copy."""
    B, _, H, D = q.shape
    if q.is_cuda and capturing() and not (
            isinstance(lengths, torch.Tensor) and lengths.dtype == torch.int32
            and lengths.device == q.device and lengths.shape == (B,)):
        raise ValueError("paged_decode_attention under graph capture takes (B,) int32 lengths "
                         "on q's device: a conversion would be a host copy baked into the graph")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device).reshape(-1)
    if lengths.numel() == 1 and B != 1:
        lengths = lengths.expand(B)
    _check_geometry(q, k_pages, v_pages, page_table, lengths)
    scale = D ** -0.5 if scale is None else float(scale)
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, scale)

    P, pt, KV = k_pages.shape[:3]
    T = page_table.shape[1]
    if not paged_decode_supported(pt, H, KV, D):
        raise ValueError(f"paged_attention kernel: unsupported geometry pt={pt} H={H} "
                         f"KV={KV} D={D}")
    q = q.contiguous()   # q is often a view into the fused QKV output
    check_operands(q, k_pages, v_pages)
    table = page_table.to(dtype=torch.int32).contiguous()
    lengths = lengths.contiguous()
    if table.device != q.device:
        raise ValueError(f"page table on {table.device}, q on {q.device}")
    out = torch.empty_like(q)
    ws = split_workspace(B, H, D, T * pt, q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), B, P, pt, T, H, KV, D,
                      scale, dtype_code(q), stream_of(q))
    return out


def paged_reference_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                              table: torch.Tensor, lengths, *, scale: Optional[float] = None,
                              attn_mask: Optional[torch.Tensor] = None,
                              s_kv: Optional[int] = None) -> torch.Tensor:
    """Paged decode/prefill attention over the gathered view.

    ``q``: ``(B, S, H, D)`` — the S newest tokens, at positions
    ``[lengths - S, lengths)`` per row; ``lengths``: ``(B,)`` or scalar,
    valid tokens AFTER the append. ``s_kv`` slices the gathered view to the
    model's contiguous cache length, so the shapes (and the streams) match
    the contiguous path's. ``attn_mask`` broadcasts to ``(B, 1, S, s_kv)``."""
    from .attention import dense_attention

    B, S, H, D = q.shape
    KV = k_pages.shape[2]
    k = gather_kv_pages(k_pages, table)
    v = gather_kv_pages(v_pages, table)
    if s_kv is not None and s_kv < k.shape[1]:
        k, v = k[:, :s_kv], v[:, :s_kv]
    if KV != H:      # GQA on the dense path: repeat the KV heads
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
    q_pos = lengths[:, None] - S + torch.arange(S, device=q.device)[None, :]      # (B, S)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]
    if attn_mask is not None:
        mask = mask & attn_mask
    return dense_attention(q, k, v, causal=False, mask=mask, scale=scale)
