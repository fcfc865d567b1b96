"""Attention dispatch: one API over the flash kernel and dense attention.

Port of ``deepspeed_tpu/ops/attention.py``. The same shape predicates
choose the path on every device: the flash kernels when S ≥ 128 and
D ∈ {64, 128, 256}, else dense attention; on the CPU the flash wrapper runs
its plain versions. Both paths are differentiable: flash through its
``autograd.Function`` (the backward kernels on the card), dense attention
through torch's autograd. The port has no attention dropout (the JAX
package takes flash only at ``dropout_rate == 0``; a ``*_pdrop`` above 0
raises in the model config). Shapes are ``(batch, seq, heads, head_dim)``.

``cached_decode_attention`` covers the KV caches: over a contiguous cache,
single-token ticks go to the decode kernel and multi-token queries
(prefill) to masked dense attention over the whole cache, as the JAX
package computes it; over the paged arena, single-token ticks go to the
paged kernel and multi-token queries to the gathered reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention, decode_supported
from .flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from .flash_attention import flash_attention
from .paged_attention import PagedKV, paged_decode_attention, paged_reference_attention

IMPLS = ("auto", "jnp", "flash")   # the JAX config vocabulary ("jnp": dense)


def _pick_impl(impl: str, q: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise NotImplementedError(f"attention impl {impl!r} is not ported (have {IMPLS})")
    if impl != "auto":
        return impl
    if q.shape[1] >= 128 and q.shape[3] in FLASH_HEAD_DIMS:
        return "flash"
    return "jnp"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Multi-head scaled dot-product attention; returns ``(B, S, H, D)``.

    ``mask``: bool, broadcastable to ``(B, H, S, T)``, True = attend."""
    if _pick_impl(impl, q) == "flash" and mask is None:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return dense_attention(q, k, v, causal=causal, mask=mask, scale=scale)


def dense_attention(q, k, v, *, causal: bool, mask=None, scale=None):
    """The JAX package's XLA path (``_jnp_attention``) in plain PyTorch:
    fp32 scores and softmax, masked entries at ``finfo(fp32).min``,
    probabilities cast to v's dtype before ``p @ v``."""
    s_q, d = q.shape[1], q.shape[3]
    s_k = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        keep = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~keep, neg)
    if mask is not None:
        scores = scores.masked_fill(~mask, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def cached_decode_attention(q: torch.Tensor, k_cache, v_cache, cur,
                            attn_mask: Optional[torch.Tensor] = None, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q (B, S, H, D)`` over the cache AFTER the append;
    ``cur`` is the write head before it: an ``int``, or ``(B,)`` per row.

    Contiguous caches ``(B, S_max, KV, D)``: single-token ticks take the
    decode kernel (per-row lengths ``cur + 1``), multi-token queries
    (prefill) masked dense attention over the whole cache. A PAGED cache
    (:class:`PagedKV` carriers from the paged append) takes the paged
    kernel at S == 1 with no mask, and otherwise (suffix prefill) the
    gathered reference over ``cache_len`` positions."""
    B, S, H, D = q.shape
    if isinstance(k_cache, PagedKV):
        pages_k, pages_v, table = k_cache.pages, v_cache.pages, k_cache.table
        lengths = cur + S          # (B,) valid tokens after the append
        if S == 1 and attn_mask is None:   # the kernel, or its raise for a bad geometry
            return paged_decode_attention(q, pages_k, pages_v, table, lengths, scale=scale)
        return paged_reference_attention(q, pages_k, pages_v, table, lengths, scale=scale,
                                         attn_mask=attn_mask, s_kv=k_cache.cache_len)
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    if S == 1 and attn_mask is None and decode_supported(H, KV, D):
        return decode_attention(q, k_cache, v_cache, cur + 1, scale=scale)
    if KV != H:   # GQA on the dense path: repeat the KV heads
        k_cache = k_cache.repeat_interleave(H // KV, dim=2)
        v_cache = v_cache.repeat_interleave(H // KV, dim=2)
    k_pos = torch.arange(S_max, device=q.device)
    if isinstance(cur, torch.Tensor):   # per-row heads: (B, 1, S, S_max)
        q_pos = cur.to(q.device).long()[:, None] + torch.arange(S, device=q.device)[None, :]
        mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    else:
        q_pos = cur + torch.arange(S, device=q.device)[:, None]
        mask = (k_pos[None, :] <= q_pos)[None, None, :, :]
    if attn_mask is not None:
        mask = mask & attn_mask
    return dense_attention(q, k_cache, v_cache, causal=False, mask=mask, scale=scale)
