"""Block-sparse attention execution.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.
Two paths, under the JAX package's names, so that user code ports by
renaming the import:

- ``impl="mask"`` (the default): expand the block layout to an element mask
  and run dense attention (``ops/attention.py`` :func:`dense_attention`, the
  port of the JAX ``_jnp_attention``). The same flops as dense attention; a
  query block with no enabled key block gets the mean of v over all keys
  (every score at ``finfo.min``, a uniform softmax).
- ``impl="pallas"``: the block-sparse kernel, which visits only the enabled
  key blocks of each query block through a per-(head, query block) LUT
  built on the host (:func:`_build_lut`). The TPU kernel ``_pallas_kernel``
  (:59) becomes ``csrc/sparse_attention.cu`` (see its header for the design
  and bound); CUDA tensors launch it, CPU tensors run its plain version
  (:func:`sparse_attention_plain`), and a CUDA tensor never falls back. Its
  arithmetic is the TPU kernel's: q cast to fp32 and scaled there, scores,
  the online softmax and ``p @ v`` in fp32 (p is not cast to v's dtype, as
  the mask path casts it), one cast at the end; a query block with no
  enabled key block writes zeros. The kernel takes D in :data:`HEAD_DIMS`
  and block in :data:`BLOCKS`; other shapes raise on the card.

The JAX package defines no backward for the kernel: here it is an
``autograd.Function`` whose backward raises ``NotImplementedError`` (ROADMAP
B10), so a caller that needs gradients learns it instead of getting a
tensor with no gradient. The mask path is differentiable through torch's
autograd. Shapes are ``(B, S, H, D)``; layouts ``(H, S/block, S/block)``.
:class:`SparseSelfAttention` caches each sequence length's layout, and its
LUT and counts on the device per (sequence length, device).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._build import FLOAT, INT, PTR, Kernel, check_operands, dtype_code, stream_of
from ..attention import dense_attention
from .sparsity_config import SparsityConfig

# q k v out lut counts, B S H D block max_nnz scale causal dtype stream
KERNEL = Kernel("sparse_attention", "sparse_attention_fwd",
                [PTR] * 6 + [INT] * 6 + [FLOAT, INT, INT, PTR])
HEAD_DIMS = (64, 128)          # instantiated in CUDA
BLOCKS = (16, 32, 64, 128)
IMPLS = ("mask", "pallas")


def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """(H, nb, nb) block layout → (H, S, S) bool element mask."""
    return np.kron(layout, np.ones((block, block), dtype=bool))


def _build_lut(layout: np.ndarray):
    """Per (head, q-block): padded list of enabled k-block indices + count.

    As the JAX package builds it: padding repeats the first enabled block
    (the kernel visits only the first ``count`` entries)."""
    H, nq, nk = layout.shape
    max_nnz = int(layout.sum(axis=2).max())
    lut = np.zeros((H, nq, max_nnz), dtype=np.int32)
    counts = np.zeros((H, nq), dtype=np.int32)
    for h in range(H):
        for qi in range(nq):
            idx = np.nonzero(layout[h, qi])[0]
            counts[h, qi] = len(idx)
            if len(idx):
                lut[h, qi, :len(idx)] = idx
                lut[h, qi, len(idx):] = idx[0]
    return lut, counts, max_nnz


def lut_on(layout: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_build_lut` as int32 tensors on ``device``: ``lut (H, nq,
    max(max_nnz, 1))`` and ``counts (H, nq)`` (an all-empty layout keeps one
    LUT column, which no count reaches)."""
    lut, counts, _ = _build_lut(np.asarray(layout))
    if lut.shape[2] == 0:
        lut = np.zeros(lut.shape[:2] + (1,), dtype=np.int32)
    return torch.from_numpy(lut).to(device), torch.from_numpy(counts).to(device)


def _block_mask(lut: torch.Tensor, counts: torch.Tensor, nk: int) -> torch.Tensor:
    """The (H, nq, nk) bool block mask the first ``count`` LUT entries enable."""
    valid = torch.arange(lut.shape[2], device=lut.device) < counts[..., None]
    hits = torch.zeros(lut.shape[:2] + (nk,), dtype=torch.int32, device=lut.device)
    return hits.scatter_add_(2, lut.long(), valid.int()) > 0


def sparse_attention_plain(q, k, v, lut, counts, block: int, causal: bool, scale: float):
    """The kernel's function in plain PyTorch, over the LUT's blocks: scores
    of ``q·scale`` (fp32) and k in fp32, masked outside the enabled blocks
    (and, with ``causal``, where k_pos > q_pos), softmax with the TPU
    kernel's guards (max −inf → 0, sum 0 → 1: an empty row is 0), ``p @ v``
    in fp32, one cast to q's dtype. Returns ``(B, S, H, D)``."""
    B, S, H, D = q.shape
    nb = S // block
    keep = _block_mask(lut, counts, nb)
    keep = keep.repeat_interleave(block, 1).repeat_interleave(block, 2)   # (H, S, S)
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = keep & (pos[:, None] >= pos[None, :])
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) / l.permute(0, 2, 1, 3)
    return out.to(q.dtype)


def sparse_attention_kernel(q, k, v, lut, counts, block: int, causal: bool, scale: float):
    """The block-sparse forward: the kernel on CUDA tensors,
    :func:`sparse_attention_plain` on CPU tensors. ``lut``/``counts`` from
    :func:`lut_on` on q's device."""
    if not q.is_cuda:
        return sparse_attention_plain(q, k, v, lut, counts, block, causal, scale)
    B, S, H, D = q.shape
    if D not in HEAD_DIMS or block not in BLOCKS:
        raise ValueError(f"sparse attention kernel: head dim {D} (takes {HEAD_DIMS}) and block "
                         f"{block} (takes {BLOCKS})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lut, counts = lut.contiguous(), counts.contiguous()
    check_operands(q, k, v, lut, counts, dtypes=[q.dtype] * 3 + [torch.int32] * 2)
    if lut.shape[:2] != (H, S // block) or counts.shape != lut.shape[:2]:
        raise ValueError(f"sparse attention kernel: lut {tuple(lut.shape)} / counts "
                         f"{tuple(counts.shape)} for q {tuple(q.shape)}, block {block}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lut.data_ptr(),
                      counts.data_ptr(), B, S, H, D, block, lut.shape[2], scale, int(causal),
                      dtype_code(q), stream_of(q))
    return out


class _SparseAttention(torch.autograd.Function):
    """The kernel's forward; no backward (the JAX package defines none)."""

    @staticmethod
    def forward(ctx, q, k, v, lut, counts, block, causal, scale):
        return sparse_attention_kernel(q, k, v, lut, counts, block, causal, scale)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "block-sparse attention (impl='pallas') has no backward: ROADMAP B10 "
            "(the JAX package defines none either); use impl='mask' for gradients")


def _check(q, k, v, layout, block):
    B, S, H, D = q.shape
    nb = S // block
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout shape {layout.shape} != {(H, nb, nb)}")
    if S % block:
        raise ValueError(f"seq_len {S} not divisible by block {block}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"sparse attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout: np.ndarray, block: int, *,
                     causal: bool = False, scale: Optional[float] = None,
                     impl: str = "mask") -> torch.Tensor:
    """Block-sparse attention; shapes ``(B, S, H, D)``; layout ``(H, nb, nb)``."""
    layout = np.asarray(layout)
    _check(q, k, v, layout, block)
    D = q.shape[3]
    if scale is None:
        scale = D ** -0.5
    if impl == "mask":
        mask = torch.from_numpy(layout_to_dense_mask(layout, block) != 0).to(q.device)[None]
        return dense_attention(q, k, v, causal=causal, mask=mask, scale=scale)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    lut, counts = lut_on(layout, q.device)
    return _SparseAttention.apply(q, k, v, lut, counts, block, causal, float(scale))


class SparseSelfAttention:
    """Module-shaped wrapper (the JAX package's): holds a
    :class:`SparsityConfig`, builds each sequence length's layout once, and
    under ``impl="pallas"`` its LUT and counts once per device."""

    def __init__(self, sparsity_config: SparsityConfig, causal: bool = False,
                 impl: str = "mask"):
        self.sparsity_config = sparsity_config
        self.causal = causal
        self.impl = impl
        self._layouts: dict[int, np.ndarray] = {}
        self._luts: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def get_lut(self, seq_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = (seq_len, torch.device(device))
        if key not in self._luts:
            self._luts[key] = lut_on(self.get_layout(seq_len), device)
        return self._luts[key]

    def __call__(self, q, k, v):
        S = q.shape[1]
        block = self.sparsity_config.block
        if self.impl != "pallas":
            return sparse_attention(q, k, v, self.get_layout(S), block,
                                    causal=self.causal, impl=self.impl)
        layout = self.get_layout(S)
        _check(q, k, v, layout, block)
        lut, counts = self.get_lut(S, q.device)
        return _SparseAttention.apply(q, k, v, lut, counts, block, self.causal,
                                      q.shape[3] ** -0.5)
