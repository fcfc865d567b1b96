"""Grouped quantization: symmetric and asymmetric, deterministic and
stochastic rounding, and the fake-quantize round trip.

Port of ``deepspeed_tpu/ops/quantizer.py``, the ops the inference engine's
``quant`` option uses to fake-quantize weights at load when it does not
take the int8 (W8A16) path (``bits`` other than 8, or ``fake: true``).
Groups are a reshape of the flattened tensor into ``(groups, n / groups)``.
Stochastic rounding draws its uniforms from an explicit
``torch.Generator`` in place of a JAX key, so it repeats under a seed but
does not give JAX's numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    n = x.numel()
    if n % groups:
        raise ValueError(f"size {n} not divisible by groups {groups}")
    return x.reshape(groups, n // groups)


def _round(y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        return torch.round(y)          # half to even, as jnp.round
    u = torch.rand(y.shape, generator=generator, device=generator.device).to(y.device)
    return torch.floor(y + u)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # IEEE division on every device (torch divides by a Python scalar
    # through its reciprocal on the card)
    return a / a.new_tensor(b)


def quantize_symmetric(x: torch.Tensor, bits: int, groups: int = 1,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (codes in ``[-(2^(b-1) - 1), 2^(b-1) - 1]``, per-group fp32 scale)."""
    g = _grouped(x.float(), groups)
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.clamp(_div(g.abs().amax(dim=1, keepdim=True), qmax), min=1e-12)
    y = torch.clamp(_round(g / scale, generator), -qmax, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int32
    return y.reshape(x.shape).to(dtype), scale[:, 0]


def dequantize_symmetric(codes: torch.Tensor, scale: torch.Tensor, groups: int,
                         dtype=torch.float32) -> torch.Tensor:
    g = _grouped(codes.float(), groups)
    return (g * scale[:, None]).reshape(codes.shape).to(dtype)


def quantize_asymmetric(x: torch.Tensor, bits: int, groups: int = 1,
                        generator: Optional[torch.Generator] = None):
    """→ (codes in ``[0, 2^b - 1]``, scale, zero point)."""
    g = _grouped(x.float(), groups)
    qmax = 2.0 ** bits - 1.0
    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    scale = torch.clamp(_div(hi - lo, qmax), min=1e-12)
    y = torch.clamp(_round((g - lo) / scale, generator), 0.0, qmax)
    return y.reshape(x.shape).to(torch.int32), scale[:, 0], lo[:, 0]


def dequantize_asymmetric(codes, scale, zero_point, groups, dtype=torch.float32):
    g = _grouped(codes.float(), groups)
    return (g * scale[:, None] + zero_point[:, None]).reshape(codes.shape).to(dtype)


def fake_quantize(x: torch.Tensor, bits: int, groups: int = 1, symmetric: bool = True,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantize → dequantize, returned in x's dtype."""
    if symmetric:
        codes, scale = quantize_symmetric(x, bits, groups, generator)
        return dequantize_symmetric(codes, scale, groups, x.dtype)
    codes, scale, zp = quantize_asymmetric(x, bits, groups, generator)
    return dequantize_asymmetric(codes, scale, zp, groups, x.dtype)
