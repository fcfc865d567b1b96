"""Rotary position embeddings.

Port of ``deepspeed_tpu/ops/rotary.py``: rotate the leading ``rotary_dim``
channels of q/k by position-dependent angles, GPT-NeoX/LLaMA style
(half-split) or GPT-J style (interleaved pairs); channels past
``rotary_dim`` pass through. The JAX package computes this outside any
Pallas kernel, so plain PyTorch is the port. The cast points are the JAX
package's: the angles in fp32, cos and sin cast to x's dtype before the
products. Shapes are ``(batch, seq, heads, head_dim)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotary_angles(positions: torch.Tensor, rotary_dim: int, theta: float = 10000.0):
    """cos/sin tables for integer positions; shapes ``(..., rotary_dim/2)``, fp32."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / rotary_dim))
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _rotate(x1, x2, cos, sin, dtype):
    cos = cos[:, :, None, :].to(dtype)   # (B, S, 1, rd/2)
    sin = sin[:, :, None, :].to(dtype)
    return x1 * cos - x2 * sin, x2 * cos + x1 * sin


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Half-split rotation of ``x`` ``(B, S, H, D)``: ``x1' = x1·cos − x2·sin``,
    ``x2' = x2·cos + x1·sin`` over the first ``rotary_dim`` channels."""
    rd = x.shape[-1] if rotary_dim is None else rotary_dim
    half = rd // 2
    out1, out2 = _rotate(x[..., :half], x[..., half:rd], cos, sin, x.dtype)
    return torch.cat([out1, out2, x[..., rd:]], dim=-1)


def apply_rotary_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                             rotary_dim: Optional[int] = None) -> torch.Tensor:
    """GPT-J style ("rotate every two"): channel pairs ``(2i, 2i+1)`` rotate
    by angle ``i``."""
    rd = x.shape[-1] if rotary_dim is None else rotary_dim
    pairs = x[..., :rd].reshape(*x.shape[:-1], rd // 2, 2)
    out1, out2 = _rotate(pairs[..., 0], pairs[..., 1], cos, sin, x.dtype)
    out = torch.stack([out1, out2], dim=-1).reshape(*x.shape[:-1], rd)
    return torch.cat([out, x[..., rd:]], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                         rotary_dim: Optional[int] = None, theta: float = 10000.0,
                         interleaved: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k ``(B, S, H, D)``; positions ``(B, S)`` or ``(1, S)`` int."""
    rd = q.shape[-1] if rotary_dim is None else rotary_dim
    cos, sin = rotary_angles(positions, rd, theta)
    rot = apply_rotary_interleaved if interleaved else apply_rotary
    return rot(q, cos, sin, rd), rot(k, cos, sin, rd)
