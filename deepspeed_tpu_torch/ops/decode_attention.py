"""One-token decode attention over a contiguous KV cache.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py``. The TPU kernels
(``_decode_kernel`` and the streamed ``_decode_kernel_blocked``) become one
C entry, ``csrc/decode_attention.cu``, over the split design of
``csrc/decode_split.cuh``: the cache is cut into chunks of :data:`CHUNK`
positions, one block per (chunk, KV head, batch row) forms that chunk's
softmax state (acc, m, l) in fp32 for all the group's query heads, and a
second kernel merges a row's live chunks by their lse, in chunk order.
Rows past a row's length are zero-filled, never read. See the sources'
headers for the bound and what limits the kernel.

Layouts are the JAX package's: ``q`` ``(B, 1, H, D)``, caches
``(B, S_max, KV, D)`` with ``KV`` dividing ``H`` (GQA), ``length`` a scalar
or ``(B,)`` count of live positions per row. :func:`decode_attention`
launches the kernel for CUDA tensors and runs :func:`decode_attention_plain`,
the same function in plain PyTorch in one pass, for CPU tensors.
:func:`decode_attention_split_plain` repeats the kernel's chunks and merge
in plain PyTorch for the tests. The launch plan (:func:`split_chunks`, the
workspace) comes from shapes alone: the wrapper never reads ``length``
back from the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ._build import FLOAT, INT, PTR, Kernel, capturing, check_operands, dtype_code, stream_of

KERNEL = Kernel("decode_attention", "decode_attention_fwd",
                [PTR, PTR, PTR, PTR, INT, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, PTR])

HEAD_DIMS = (32, 64, 96, 128, 256)   # instantiated in the CUDA source
MAX_GROUP = 8                        # query heads per KV head a block serves
CHUNK = 64                           # positions per block: csrc/decode_split.cuh kChunk


def split_chunks(positions: int) -> int:
    """Chunks the kernels cut a cache of ``positions`` positions into (the
    grid's first dimension); from the shape alone."""
    return -(-positions // CHUNK)


def split_workspace(B: int, H: int, D: int, positions: int, device) -> torch.Tensor:
    """The fp32 ``(B, H, chunks, D + 2)`` partial states (acc, m, l) the
    kernel writes and its merge reads."""
    return torch.empty((B, H, split_chunks(positions), D + 2), dtype=torch.float32,
                       device=device)


def decode_supported(n_heads: int, kv_heads: int, d: int) -> bool:
    """True when the CUDA kernel takes this head layout. Unlike the TPU
    predicate there is no cache-length limit: the kernel streams the cache."""
    return (d in HEAD_DIMS and kv_heads > 0 and n_heads % kv_heads == 0
            and n_heads // kv_heads <= MAX_GROUP)


def decode_attention_plain(q, k_cache, v_cache, lengths, scale):
    """The kernel's arithmetic in plain PyTorch: fp32 scores over positions
    ``< lengths[b]``, softmax, fp32 ``p @ v``; a row with no live position
    gives 0 (the blocked TPU kernel's ``l == 0`` guard)."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    live = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]  # (B, S)
    qf = q.float().reshape(B, KV, G, D) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    # dead rows are zeroed, not only masked: 0 * inf would poison p @ v
    v = v_cache.float().masked_fill(~live[:, :, None, None], 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v) / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_split_plain(q, k_cache, v_cache, lengths, scale, chunk=CHUNK):
    """The kernels' split arithmetic in plain PyTorch (the tests hold it
    against the one-pass plain version and the TPU kernels): per chunk of
    ``chunk`` positions, the fp32 scores of the live positions, the chunk's
    max m, p = exp(s - m), l = sum p and acc = p @ v over the chunk's rows
    (dead rows zeroed, p = 0 there); then, per row and head, the
    ``ceil(L / chunk)`` live chunks merged in order: M = max m_i,
    out = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M), zeros where no
    position is live."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    lengths = lengths.to(q.device).clamp(0, S)
    qf = q.float().reshape(B, KV, G, D) * scale
    pos = torch.arange(S, device=q.device)
    live = pos[None, :] < lengths[:, None]                                 # (B, S)
    acc, m, l = [], [], []
    for c0 in range(0, S, chunk):
        lv = live[:, c0:c0 + chunk]                                        # (B, c)
        k = k_cache[:, c0:c0 + chunk].float()
        v = v_cache[:, c0:c0 + chunk].float().masked_fill(~lv[:, :, None, None], 0.0)
        s = torch.einsum("bkgd,bskd->bkgs", qf, k).masked_fill(~lv[:, None, None, :],
                                                                float("-inf"))
        mc = s.amax(-1)                                                    # (B, KV, G)
        p = torch.exp(s - torch.where(mc == float("-inf"), torch.zeros_like(mc), mc)[..., None])
        acc.append(torch.einsum("bkgs,bskd->bkgd", p, v))
        m.append(mc)
        l.append(p.sum(-1))
    acc, m, l = torch.stack(acc), torch.stack(m), torch.stack(l)           # chunk first
    n_live = -(-lengths // chunk)                                          # (B,)
    is_live = (torch.arange(len(m), device=q.device)[:, None] < n_live[None, :])
    is_live = is_live[:, :, None, None]                                    # (C, B, 1, 1)
    M = m.masked_fill(~is_live, float("-inf")).amax(0)
    w = torch.where(is_live & (m != float("-inf")),
                    torch.exp(m - torch.where(M == float("-inf"), torch.zeros_like(M), M)),
                    torch.zeros_like(m))
    num = (acc * w[..., None]).sum(0)
    den = (l * w).sum(0)
    o = torch.where(den[..., None] > 0, num / torch.where(den > 0, den, 1.0)[..., None],
                    torch.zeros_like(num))
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode tick; returns ``(B, 1, H, D)`` in ``q``'s dtype.

    ``k_cache``/``v_cache`` are the caches AFTER the new token's K/V was
    appended; ``length`` counts the live positions (``cur + 1``). A captured
    tick passes ``(B,)`` lengths on the card, which the kernel reads there
    at every replay; a host ``int`` would be baked into the graph, so under
    capture it raises."""
    B, one, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not match")
    if H % KV:
        raise ValueError(f"q heads {H} must be a multiple of KV heads {KV}")
    scale = D ** -0.5 if scale is None else float(scale)
    scalar = not isinstance(length, torch.Tensor) or length.dim() == 0
    if scalar:
        n = int(length)
        if not 0 <= n <= S:
            raise ValueError(f"decode length {n} outside the cache [0, {S}]")
    elif length.shape != (B,):
        raise ValueError(f"per-row lengths must be ({B},), got {tuple(length.shape)}")
    elif not length.is_cuda and (length.min() < 0 or length.max() > S):
        raise ValueError(f"decode lengths outside the cache [0, {S}]")

    if not q.is_cuda:
        lengths = torch.full((B,), n) if scalar else length
        return decode_attention_plain(q, k_cache, v_cache, lengths, scale)

    if not decode_supported(H, KV, D):
        raise ValueError(f"decode_attention kernel: unsupported heads H={H} KV={KV} D={D}")
    q = q.contiguous()   # q is often a view into the fused QKV output
    check_operands(q, k_cache, v_cache)
    if scalar:
        if capturing():
            raise ValueError("decode_attention under graph capture takes per-row lengths on "
                             "the card: a host length would be baked into the graph")
        len_ptr = None
    else:
        length = length.to(device=q.device, dtype=torch.int32).contiguous()
        len_ptr, n = length.data_ptr(), 0
    out = torch.empty_like(q)
    ws = split_workspace(B, H, D, S, q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), len_ptr, n,
                      out.data_ptr(), ws.data_ptr(), B, S, H, KV, D, scale, dtype_code(q),
                      stream_of(q))
    return out
