"""Weight-only int8 (W8A16) serving: int8 codes + grouped fp32 scales.

Port of ``deepspeed_tpu/ops/w8.py``. A dense ``(K, N)`` kernel is stored as
int8 codes ``(K, N)`` and fp32 scales ``(K/g, N)``, one per (group of ``g``
contraction rows, output column): half the bytes of bf16. Quantization is
symmetric absmax (``scale = amax / 127``, 1 where the group is all zero;
``codes = clip(round(w / scale), -127, 127)``) in fp32, with IEEE division
and round-half-to-even on every device, so the codes equal the JAX
package's bit for bit.

:func:`w8a16_matmul` computes ``x @ dequant(codes, scale)`` and takes the
JAX package's route for each shape, reading "on the TPU" as "on the card":

- a CUDA tensor whose shape passes :func:`~.w8_matmul.supported` (decode
  rows, M ≤ 64, 128-aligned widths and groups) launches the hand-written
  kernel (``csrc/w8_matmul.cu``) with x cast to bf16; its fp32 result is
  cast back to x's dtype;
- more than 64 rows (prefill): one dequantized ``(K, N)`` panel in the
  compute dtype, then a plain matrix product;
- otherwise: the grouped contraction in x's dtype, the per-group partials
  combined with the scales in fp32 (the JAX package's route off the TPU).
"""
from __future__ import annotations

import math

import torch

from . import w8_matmul

MAX_ROWS = 64   # the decode regime; past it the dequantized panel wins (JAX, round 5)


def w8_group_size(k: int, group: int) -> int:
    """Contraction-group size for a K-row panel: ``group`` when it divides
    K, else one whole-K group (the one rule the stored scale shapes, the
    model and the fused decode dispatch share)."""
    return group if k % group == 0 else k


@torch.no_grad()
def quantize_weight(w: torch.Tensor, group: int = 128):
    """``(K, N)`` float → (int8 codes ``(K, N)``, fp32 scales ``(K/g, N)``)
    on w's device; a 3-D (layer stack) or 4-D input quantizes per leading
    index."""
    if w.ndim in (3, 4):
        pairs = [quantize_weight(layer, group) for layer in w]
        return torch.stack([c for c, _ in pairs]), torch.stack([s for _, s in pairs])
    if w.ndim != 2:
        raise ValueError(f"quantize_weight takes a (K, N) kernel, got shape {tuple(w.shape)}")
    K, N = w.shape
    g = w8_group_size(K, group)
    wf = w.float().reshape(K // g, g, N)
    amax = wf.abs().amax(dim=1, keepdim=True)                       # (G, 1, N)
    # divide by a tensor on w's device: torch divides by a Python scalar
    # through its reciprocal on the card, one bit off IEEE division
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), amax.new_tensor(1.0))
    codes = torch.clamp(torch.round(wf / scale), -127, 127)
    return codes.reshape(K, N).to(torch.int8), scale[:, 0, :].contiguous()


def dequantize_weight(codes: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """The ``(K, N)`` panel ``codes × scale`` in fp32, cast to ``dtype``."""
    K, N = codes.shape
    G = scale.shape[0]
    return (codes.reshape(G, K // G, N).float() * scale[:, None, :]).reshape(K, N).to(dtype)


def w8a16_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(codes (K, N), scale (G, N))`` in x's dtype."""
    K, N = codes.shape
    G = scale.shape[0]
    g = K // G
    M = math.prod(x.shape[:-1])
    if x.is_cuda and w8_matmul.supported(x.shape, codes.shape, G):
        y = w8_matmul.w8a16_matmul_kernel(x.reshape(M, K).to(torch.bfloat16), codes, scale)
        return y.reshape(*x.shape[:-1], N).to(x.dtype)
    cdt = x.dtype if x.is_floating_point() else torch.bfloat16
    if M > MAX_ROWS:
        return (x.to(cdt) @ dequantize_weight(codes, scale, cdt)).to(x.dtype)
    xg = x.reshape(*x.shape[:-1], G, g).to(cdt)
    part = torch.einsum("...ug,ugn->...un", xg, codes.reshape(G, g, N).to(cdt))
    y = torch.einsum("...un,un->...n", part.float(), scale)
    return y.to(x.dtype)


def quantize_state_dict(params, group: int = 128, device=None) -> dict:
    """Every dense ``*_kernel`` entry (2-D, or a 3-D stack) of a flat state
    dict → ``*_kernel_q`` int8 codes + ``*_kernel_s`` fp32 scales, computed
    in fp32 from the given values (on ``device`` when given). Embeddings,
    norms and biases pass through unchanged (``quantize_dense_tree`` of the
    JAX package)."""
    out = {}
    for name, v in params.items():
        t = torch.as_tensor(v)
        if name.endswith("_kernel") and t.ndim in (2, 3):
            codes, scale = quantize_weight(t.to(device=device, dtype=torch.float32), group)
            out[name + "_q"], out[name + "_s"] = codes, scale
        else:
            out[name] = v
    return out
