"""Flash attention, forward and backward, with the per-row log-sum-exp.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``: the TPU kernel
``_fwd_kernel`` becomes ``csrc/flash_attention.cu``, and the backward
kernels ``_dqkv_kernel`` (merged, the default) and ``_dq_kernel`` /
``_dkv_kernel`` (split) become ``csrc/flash_attention_bwd.cu`` (see each
header for the design and bound).

Public shapes are the JAX package's, ``(B, S, H, D)``. The kernels keep
``lse`` and ``delta`` in the TPU kernels' ``(B·H, 1, S)`` fp32 layout;
:func:`flash_attention_with_lse` returns ``lse`` as ``(B, S, H)`` like JAX.
One ``autograd.Function`` serves both public functions on every device:
its forward saves ``q, k, v, out, lse``; its backward forms
``delta = rowsum(do·o)`` in fp32 (minus the lse cotangent, when the caller
used ``lse``) and then runs :func:`flash_attention_bwd`, which dispatches
on the backward mode as the JAX package does (``BWD_MODE``, overridden by
the ``DS_TPU_FLASH_BWD`` environment variable; an unknown mode raises).
CUDA tensors launch the kernels; CPU tensors run the plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`), the
same functions in plain PyTorch. S need not divide any tile: ragged
lengths are masked. Gradients come back in the inputs' dtype; ``dk``
carries ``scale`` through the pre-scaled q, and ``dq`` is scaled after its
fp32 accumulation.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel, check_operands, dtype_code, stream_of

KERNEL = Kernel("flash_attention", "flash_attention_fwd",
                [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, INT, PTR])
_BWD_ARGS = [INT, INT, INT, INT, INT, FLOAT, INT, INT, PTR]   # B S Sk H D scale causal dtype stream
BWD_MERGED = Kernel("flash_attention_bwd", "flash_attention_bwd_merged", [PTR] * 9 + _BWD_ARGS)
BWD_DKV = Kernel("flash_attention_bwd", "flash_attention_bwd_dkv", [PTR] * 8 + _BWD_ARGS)
BWD_DQ = Kernel("flash_attention_bwd", "flash_attention_bwd_dq", [PTR] * 7 + _BWD_ARGS)

HEAD_DIMS = (64, 128, 256)   # the flash predicate's head dims, instantiated in CUDA
BWD_MODE = "merged"          # "merged" | "split"; env DS_TPU_FLASH_BWD overrides
BWD_MODES = ("merged", "split")


def bwd_mode(mode: Optional[str] = None) -> str:
    """The backward mode: ``mode`` if given, else ``DS_TPU_FLASH_BWD``, else
    :data:`BWD_MODE`. Raises on anything but ``merged`` or ``split``."""
    mode = mode or os.environ.get("DS_TPU_FLASH_BWD", BWD_MODE)
    if mode not in BWD_MODES:
        raise ValueError(f"flash attention backward mode {mode!r}: valid modes are {BWD_MODES}")
    return mode


def _causal_keep(S: int, Sk: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[:, None] >= torch.arange(Sk, device=device)[None, :]


def flash_attention_plain(q, k, v, causal: bool, scale: float):
    """softmax(q kᵀ·scale) v in fp32 with the TPU kernel's guards; returns
    ``out (B, S, H, D)`` in q's dtype and ``lse (B·H, 1, S)`` fp32."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    if causal:
        s = s.masked_fill(~_causal_keep(S, Sk, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(B * H, 1, S)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, do, delta, causal: bool, scale: float):
    """The backward kernels' arithmetic in plain PyTorch, fp32: ``p =
    exp((q·scale) kᵀ − lse)`` (masked entries 0), ``dv = pᵀ do``, ``ds =
    p (do vᵀ − delta)``, ``dk = dsᵀ (q·scale)``, ``dq = scale · ds k``;
    returns ``(dq, dk, dv)`` in the inputs' dtype. ``lse`` and ``delta``
    are ``(B·H, 1, S)`` fp32; ``out`` is unused (delta carries it), kept so
    the signature is the kernels'."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    qs = q.float() * scale
    s = torch.einsum("bshd,bthd->bhst", qs, k.float())
    if causal:
        s = s.masked_fill(~_causal_keep(S, Sk, q.device), float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dof = do.float()
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dp = torch.einsum("bshd,bthd->bhst", dof, v.float())
    ds = p * (dp - delta.reshape(B, H, S, 1))
    dk = torch.einsum("bhst,bshd->bthd", ds, qs)
    dq = torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(q, k, v) -> None:
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.is_cuda and D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")


def _flash_fwd(q, k, v, causal: bool, scale: float):
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      B, S, Sk, H, D, scale, int(causal), dtype_code(q), stream_of(q))
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool, scale: float,
                        dlse: Optional[torch.Tensor] = None, mode: Optional[str] = None):
    """``(dq, dk, dv)`` of flash attention from the saved forward: ``delta =
    rowsum(do·o) − dlse`` in fp32 (``lse``/``dlse`` ``(B·H, 1, S)``), then
    the merged kernel or the split pair (:func:`bwd_mode`) on CUDA tensors,
    :func:`flash_attention_bwd_plain` on CPU tensors."""
    mode = bwd_mode(mode)
    B, S, H, D = q.shape
    Sk = k.shape[1]
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B * H, 1, S)
    if dlse is not None:
        # the lse cotangent folds in exactly: dlse_i/ds_ij = p_ij, so
        # ds = p (dp − delta + dlse)
        delta = delta - dlse.float()
    delta = delta.contiguous()
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, do, delta, causal, scale)
    _check_shapes(q, k, v)
    q, k, v, lse = q.contiguous(), k.contiguous(), v.contiguous(), lse.contiguous()
    check_operands(q, k, v, do)
    check_operands(lse, delta)
    if lse.shape != (B * H, 1, S):
        raise ValueError(f"flash backward: lse {tuple(lse.shape)}, expected {(B * H, 1, S)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    tail = (B, S, Sk, H, D, scale, int(causal), dtype_code(q), stream_of(q))
    with torch.cuda.device(q.device):
        if mode == "merged":
            dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            BWD_MERGED.launch(*ins, dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail)
            return (dq_acc * scale).to(q.dtype), dk, dv
        dq = torch.empty_like(q)
        BWD_DQ.launch(*ins, dq.data_ptr(), *tail)
        BWD_DKV.launch(*ins, dk.data_ptr(), dv.data_ptr(), *tail)
        return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Outputs ``out (B, S, H, D)`` and ``lse (B·H, 1, S)``; differentiable
    in both (an unused ``lse`` contributes no fold)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale, dlse)
        return dq, dk, dv, None, None


def _flash(q, k, v, causal: bool, scale: Optional[float]):
    _check_shapes(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over ``(B, S, H, D)`` inputs; returns ``(B, S, H, D)``."""
    return _flash(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, scale: Optional[float] = None):
    """Like :func:`flash_attention`, plus the per-row log-sum-exp ``(B, S, H)``,
    differentiable in both outputs."""
    B, S, H, _ = q.shape
    out, lse = _flash(q, k, v, causal, scale)
    return out, lse.reshape(B, H, S).transpose(1, 2)
