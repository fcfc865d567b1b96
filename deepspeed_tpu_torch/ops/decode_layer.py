"""Fused decode-row kernels: norm → projection, and o-proj → norm → MLP.

Port of ``deepspeed_tpu/ops/pallas/decode_layer.py`` for the branch the
GPT-2 decode tick runs: LayerNorm, weights in the activation dtype, the
GELU-tanh MLP pair and a sequential residual. The TPU kernels
``_norm_proj_kernel`` and ``_post_attn_kernel`` become
``csrc/decode_layer.cu`` (one launch, and three launches, respectively;
see its header for the design and bound).

:func:`fused_norm_proj` and :func:`fused_post_attn` launch the kernels for
CUDA tensors and run :func:`norm_proj_plain` / :func:`post_attn_plain`,
the kernels' arithmetic in plain PyTorch with the same cast points, for CPU
tensors. :func:`reference_norm_proj` and :func:`reference_post_attn` are
the unfused op chains the stock module path computes; in a low-precision
dtype they round at other points than the fused kernels, so each path is
held against its own JAX counterpart.

Branches of the TPU kernels not ported yet raise ``NotImplementedError``
naming their ROADMAP entry.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel, check_operands, dtype_code, stream_of

NORM_PROJ = Kernel("decode_layer", "norm_proj_fwd",
                   [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT, INT, PTR])
POST_ATTN = Kernel("decode_layer", "post_attn_fwd",
                   [PTR] * 13 + [INT, INT, INT, FLOAT, INT, PTR])

MAX_ROWS = 64      # the decode regime; prefill rows take the unfused chain
_SQRT_2_OVER_PI = 0.7978845608028654
_DEFERRED = "not ported yet (ROADMAP.md, queue B, deferred branches of the decode-layer kernels)"


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """``_gelu_tanh`` of ``ops/pallas/fused_ops.py``, term for term."""
    inner = _SQRT_2_OVER_PI * (u + 0.044715 * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(inner))


def _norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last dim (``_norm_rows`` of the TPU module)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def norm_proj_supported(m: int, e: int, n: int) -> bool:
    """The JAX dispatch predicate: decode rows, 128-aligned widths."""
    return m <= MAX_ROWS and e % 128 == 0 and n % 128 == 0


def post_attn_supported(m: int, e: int, f: int) -> bool:
    return m <= MAX_ROWS and e % 128 == 0 and f % 128 == 0


def _reject_deferred(rms=False, swiglu=False, exact_gelu=False,
                     parallel_residual=False, weights=()):
    for flag, what in ((rms, "RMSNorm"), (swiglu, "SwiGLU MLP"),
                       (exact_gelu, "exact GELU"),
                       (parallel_residual, "parallel residual")):
        if flag:
            raise NotImplementedError(f"fused decode kernels: {what} {_DEFERRED}")
    if any(isinstance(w, tuple) for w in weights):
        raise NotImplementedError(f"fused decode kernels: W8A16 weights {_DEFERRED}")


# ---------------------------------------------------------------------------
# The kernels' arithmetic in plain PyTorch
# ---------------------------------------------------------------------------

def norm_proj_plain(x, ns, nb, w, b, eps):
    """``cast(cast(LN(x)) @ W + b)``: LN in fp32, cast to x's dtype before
    the product (``decode_layer.py:195``), fp32 product and bias."""
    cdt = x.dtype
    xn = _norm_rows(x.float(), ns.float(), nb.float(), eps).to(cdt)
    y = xn.float() @ w.float()
    return (y + b.to(cdt).float()).to(cdt)


def post_attn_plain(y, x, wo, bo, ns, nb, w1, b1, w2, b2, eps):
    """o-proj + residual → LN → GELU-tanh MLP → residual, with r1 kept in
    fp32 and casts where ``_post_attn_kernel`` casts (:382, :396)."""
    cdt = x.dtype
    r1 = (x.float() + y.float() @ wo.float()) + bo.to(cdt).float()
    hin = _norm_rows(r1, ns.float(), nb.float(), eps).to(cdt)
    h = gelu_tanh(hin.float() @ w1.float() + b1.to(cdt).float()).to(cdt)
    return ((r1 + h.float() @ w2.float()) + b2.to(cdt).float()).to(cdt)


# ---------------------------------------------------------------------------
# The unfused chains (the stock module path)
# ---------------------------------------------------------------------------

def _dense(a, w, b):
    out = a @ w
    return out if b is None else out + b.to(out.dtype)


def reference_norm_proj(x, norm_scale, norm_bias, weight, bias, *, eps=1e-5):
    """Unfused ``norm(x) @ W + b`` in x's dtype."""
    xn = _norm_rows(x.float(), norm_scale.float(), norm_bias.float(), eps).to(x.dtype)
    return _dense(xn, weight, bias)


def reference_post_attn(y, x, wo, bo, norm_scale, norm_bias, mlp_weights, *, eps=1e-5):
    """Unfused o-proj + residual → norm → GELU-tanh MLP → residual."""
    w1, b1, w2, b2 = mlp_weights
    r1 = x + _dense(y, wo, bo)
    h = _norm_rows(r1.float(), norm_scale.float(), norm_bias.float(), eps).to(x.dtype)
    h1 = torch.nn.functional.gelu(_dense(h, w1, b1), approximate="tanh")
    return r1 + _dense(h1, w2, b2)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _vec(t: Optional[torch.Tensor], n: int, like: torch.Tensor, dtype) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, dtype=dtype, device=like.device)
    return t.to(dtype).reshape(n).contiguous()


def fused_norm_proj(x: torch.Tensor, norm_scale: torch.Tensor,
                    norm_bias: Optional[torch.Tensor], weight, bias: Optional[torch.Tensor],
                    *, rms: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """``norm(x) @ W + b`` in one kernel; returns ``(..., N)`` in x's dtype.

    ``x``: ``(..., E)`` decode rows; ``weight``: ``(E, N)``."""
    _reject_deferred(rms=rms, weights=(weight,))
    lead, E = x.shape[:-1], x.shape[-1]
    N = weight.shape[1]
    M = math.prod(lead)
    if weight.shape[0] != E:
        raise ValueError(f"fused_norm_proj: x width {E} vs weight {tuple(weight.shape)}")
    x2 = x.reshape(M, E)
    ns = _vec(norm_scale, E, x, torch.float32)
    nb = _vec(norm_bias, E, x, torch.float32)
    b = _vec(bias, N, x, x.dtype)
    if not x.is_cuda:
        return norm_proj_plain(x2, ns, nb, weight, b, eps).reshape(*lead, N)
    if not norm_proj_supported(M, E, N):
        raise ValueError(f"fused_norm_proj kernel: unsupported shape M={M} E={E} N={N}")
    x2 = x2.contiguous()
    check_operands(x2, weight, b)
    check_operands(ns, nb)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        NORM_PROJ.launch(x2.data_ptr(), ns.data_ptr(), nb.data_ptr(), weight.data_ptr(),
                         b.data_ptr(), out.data_ptr(), M, E, N, float(eps),
                         dtype_code(x2), stream_of(x2))
    return out.reshape(*lead, N)


def fused_post_attn(y: torch.Tensor, x: torch.Tensor, wo, bo: Optional[torch.Tensor],
                    norm_scale: torch.Tensor, norm_bias: Optional[torch.Tensor],
                    mlp_weights: tuple, *, swiglu: bool = False, rms: bool = False,
                    eps: float = 1e-5, exact_gelu: bool = False,
                    parallel_residual: bool = False) -> torch.Tensor:
    """``x + y@Wo + bo`` → LN → GELU-tanh MLP → residual; returns the new
    residual stream, shaped and typed like ``x``.

    ``y``: pre-o-proj attention output ``(..., E)``; ``mlp_weights``:
    ``(w1 (E, F), b1, w2 (F, E), b2)``, biases may be None."""
    _reject_deferred(rms=rms, swiglu=swiglu, exact_gelu=exact_gelu,
                     parallel_residual=parallel_residual, weights=(wo, *mlp_weights))
    w1, b1, w2, b2 = mlp_weights
    lead, E = x.shape[:-1], x.shape[-1]
    F = w1.shape[1]
    M = math.prod(lead)
    if y.shape != x.shape or wo.shape != (E, E) or w1.shape != (E, F) or w2.shape != (F, E):
        raise ValueError("fused_post_attn: operand shapes do not match")
    y2, x2 = y.reshape(M, E), x.reshape(M, E)
    ns = _vec(norm_scale, E, x, torch.float32)
    nb = _vec(norm_bias, E, x, torch.float32)
    bo, b1, b2 = (_vec(bo, E, x, x.dtype), _vec(b1, F, x, x.dtype), _vec(b2, E, x, x.dtype))
    if not x.is_cuda:
        out = post_attn_plain(y2, x2, wo, bo, ns, nb, w1, b1, w2, b2, eps)
        return out.reshape(*lead, E)
    if not post_attn_supported(M, E, F):
        raise ValueError(f"fused_post_attn kernel: unsupported shape M={M} E={E} F={F}")
    y2, x2 = y2.contiguous(), x2.contiguous()
    check_operands(y2, x2, wo, bo, w1, b1, w2, b2)
    check_operands(ns, nb)
    r1 = torch.empty((M, E), dtype=torch.float32, device=x.device)   # scratch
    h = torch.empty((M, F), dtype=x.dtype, device=x.device)          # scratch
    out = torch.empty((M, E), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        POST_ATTN.launch(y2.data_ptr(), x2.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                         ns.data_ptr(), nb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), r1.data_ptr(), h.data_ptr(),
                         out.data_ptr(), M, E, F, float(eps), dtype_code(x2), stream_of(x2))
    return out.reshape(*lead, E)
