"""Flash-attention forward, with the per-row log-sum-exp.

Port of the forward half of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
the TPU kernel ``_fwd_kernel`` becomes ``csrc/flash_attention.cu`` (see its
header for the design and bound). There is no backward yet: the
``autograd.Function`` comes with the training slice (ROADMAP.md, queue B).

Public shapes are the JAX package's, ``(B, S, H, D)``. The kernel writes
``out`` and ``lse`` in the TPU kernel's ``(B·H, 1, S)`` fp32 layout;
:func:`flash_attention_with_lse` returns it as ``(B, S, H)`` like JAX.
CUDA tensors launch the kernel; CPU tensors run :func:`flash_attention_plain`,
the same function in plain PyTorch. S need not divide any tile: ragged
lengths are masked.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel, check_operands, dtype_code, stream_of

KERNEL = Kernel("flash_attention", "flash_attention_fwd",
                [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, INT, PTR])

HEAD_DIMS = (64, 128, 256)   # the flash predicate's head dims, instantiated in CUDA


def flash_attention_plain(q, k, v, causal: bool, scale: float):
    """softmax(q kᵀ·scale) v in fp32 with the TPU kernel's guards; returns
    ``out (B, S, H, D)`` in q's dtype and ``lse (B·H, 1, S)`` fp32."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    if causal:
        keep = torch.arange(S, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(B * H, 1, S)
    return out.to(q.dtype), lse


def _flash_fwd(q, k, v, causal: bool, scale: Optional[float]):
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    scale = D ** -0.5 if scale is None else float(scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, scale)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      B, S, Sk, H, D, scale, int(causal), dtype_code(q), stream_of(q))
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(B, S, H, D)`` inputs; returns ``(B, S, H, D)``."""
    return _flash_fwd(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, scale: Optional[float] = None):
    """Like :func:`flash_attention`, plus the per-row log-sum-exp ``(B, S, H)``."""
    B, S, H, _ = q.shape
    out, lse = _flash_fwd(q, k, v, causal, scale)
    return out, lse.reshape(B, H, S).transpose(1, 2)
