"""Fused LayerNorm, bias + tanh-GELU and attention softmax, forward and backward.

Port of ``deepspeed_tpu/ops/pallas/fused_ops.py``: the six TPU kernels
``_ln_fwd_kernel`` (:46), ``_ln_bwd_kernel`` (:60),
``_bias_gelu_fwd_kernel`` (:179), ``_bias_gelu_bwd_kernel`` (:184),
``_softmax_fwd_kernel`` (:259) and ``_softmax_bwd_kernel`` (:275) become the
six entries of ``csrc/fused_ops.cu`` (see its header for the design and
bounds), and each ``jax.custom_vjp`` pair an ``autograd.Function`` whose
forward and backward are kernels. CUDA tensors launch the kernels; CPU
tensors run the plain versions (``*_plain`` below, the kernels' arithmetic
in plain PyTorch with the same cast points); a CUDA tensor never falls back
(a build or launch failure raises).

The arithmetic is the TPU kernels', fp32 inside:

- :func:`layer_norm`: the ONE-pass variance ``E[x²] − mean²`` (not the
  two-pass variance of ``BertLayerNorm``: far from zero mean they part),
  ``rstd = rsqrt(var + eps)``; ``y`` in x's dtype; ``mean`` and ``rstd``
  saved as fp32 ``(R, 1)``. The backward: ``dx = rstd·(dŷ − mean(dŷ) −
  x̂·mean(dŷ·x̂))`` with ``dŷ = dy·γ``, in x's dtype; ``dgamma = Σ dy·x̂`` and
  ``dbeta = Σ dy`` over rows in fp32, both cast to GAMMA's dtype (the JAX
  wrapper casts beta's gradient so too).
- :func:`bias_gelu`: ``gelu_tanh(x + b)`` in x's dtype; the backward ``dx =
  dy·gelu_tanh'(x + b)`` in x's dtype and ``dbias = Σ dx`` (of the fp32 dx)
  in bias's dtype.
- :func:`attention_softmax`: ``softmax(scores·scale)`` over the last dim,
  with ``causal`` keeping key j for query i where ``Sk − Sq + i ≥ j`` (the
  bottom-aligned triangle); a row's max at −inf reads 0, so a row whose every
  key is masked (``Sq > Sk``, rows ``i < Sq − Sk``) is 0/0 = NaN, as the TPU
  kernel gives (ROADMAP.md, "Not port faults"). ``p`` in the scores' dtype;
  the backward ``ds = p·(dy − Σ p·dy)·scale`` in p's dtype.

The backward kernels of LayerNorm and bias-GELU write per-row-block fp32
partials of the parameter gradients, as the TPU kernels do, added in a fixed
order (no atomics: a repeated call gives the same bits): bias-GELU's by
``torch.sum``, LayerNorm's by the library's own sum kernel, in the order
:func:`layer_norm_bwd_tiled_plain` models (:func:`ln_bwd_plan`: one block of
rows an SM, one sweep of x and dy, for rows of up to :data:`LN_HELD_COLS`).
The softmax forward holds a row of up to :data:`SOFTMAX_HELD_COLS` keys in a
warp's registers and reads each kept key once (:func:`softmax_fwd_plan`:
one wave of blocks, each warp a run of rows), with the bits of the
three-sweep kernel that wider rows keep.
The JAX wrappers' ``block_rows`` / ``block_q`` (TPU tiles, which
change no result beyond the order of partial sums) and ``interpret`` (the
Pallas interpreter) have no counterpart here, nor has their row padding: the
kernels take any row count. ``gelu_tanh`` and ``gelu_tanh_grad`` are the
JAX module's ``_gelu_tanh`` and ``_gelu_tanh_grad``, term for term, and
``ops/decode_layer.py`` and ``ops/fused_mlp.py`` take them from here, as
the JAX modules do.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import FLOAT, INT, PTR, Kernel, check_operands, dtype_code, stream_of

_TAIL = [INT, PTR]   # dtype, stream
LN_FWD = Kernel("fused_ops", "layer_norm_fwd", [PTR] * 6 + [INT, INT, FLOAT] + _TAIL)
LN_BWD = Kernel("fused_ops", "layer_norm_bwd", [PTR] * 10 + [INT, INT, INT] + _TAIL)
GELU_FWD = Kernel("fused_ops", "bias_gelu_fwd", [PTR] * 3 + [INT, INT] + _TAIL)
GELU_BWD = Kernel("fused_ops", "bias_gelu_bwd", [PTR] * 5 + [INT, INT, INT] + _TAIL)
SOFTMAX_FWD = Kernel("fused_ops", "softmax_fwd", [PTR] * 2 + [INT] * 4 + [FLOAT, INT, INT] + _TAIL)
SOFTMAX_BWD = Kernel("fused_ops", "softmax_bwd", [PTR] * 3 + [INT, INT, FLOAT] + _TAIL)

_F32 = torch.float32
LN_HELD_COLS = 1024   # the widest row the one-sweep LayerNorm backward holds
LN_ROWS = 32          # rows per block of the LayerNorm backward past LN_HELD_COLS
LN_WARPS = 8          # warps of a LayerNorm backward block
LN_SUM_SEGS = 16      # segments of the partial rows in the LayerNorm backward's sum
GELU_ROWS = 32        # rows per block of the bias-GELU backward: one partial row each
SOFTMAX_HELD_COLS = 1024   # the widest row the softmax forward holds in registers
SOFTMAX_WARPS = 8          # warps of a softmax forward block
_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """``_gelu_tanh`` of ``ops/pallas/fused_ops.py`` (:165), term for term."""
    inner = _SQRT_2_OVER_PI * (u + 0.044715 * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(inner))


def gelu_tanh_grad(u: torch.Tensor) -> torch.Tensor:
    """``_gelu_tanh_grad`` of ``ops/pallas/fused_ops.py`` (:170), term for term."""
    u3 = 0.044715 * u * u * u
    inner = _SQRT_2_OVER_PI * (u + u3)
    t = torch.tanh(inner)
    sech2 = 1.0 - t * t
    return 0.5 * (1.0 + t) + 0.5 * u * sech2 * _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * u * u)


# ----------------------------------------------------------------------
# plain versions: the six kernels' functions in plain PyTorch
# ----------------------------------------------------------------------
def layer_norm_fwd_plain(x, gamma, beta, eps: float):
    """``(y, mean, rstd)`` of rows ``x (R, D)``: the one-pass variance."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def layer_norm_bwd_plain(x, gamma, mean, rstd, dy):
    """``(dx, dgamma, dbeta)``: dx in x's dtype, the sums fp32."""
    xhat = (x.float() - mean) * rstd
    dyf = dy.float()
    dxhat = dyf * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0)


class LnBwdPlan(NamedTuple):
    """The LayerNorm backward's blocks: each takes ``rows_per_block`` rows and
    writes one fp32 partial row of dgamma and of dbeta; ``parts`` of them."""
    rows_per_block: int
    parts: int


def ln_bwd_plan(R: int, D: int, n_sm: int) -> LnBwdPlan:
    """Rows of up to :data:`LN_HELD_COLS` columns: one block of rows an SM
    (at least one row a warp), one partial row each; wider rows:
    :data:`LN_ROWS` rows a block. From shapes and the card's SM count."""
    rpb = LN_ROWS if D > LN_HELD_COLS else max(LN_WARPS, -(-R // n_sm))
    return LnBwdPlan(rpb, -(-R // rpb))


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts (P, D)`` summed as ``ln_bwd_sum_kernel`` sums them: segment k
    takes rows [k·per, (k+1)·per) in order (per = ⌈P / 16⌉), then the
    segments in order; each sum rounded on its own."""
    P, D = parts.shape
    per = -(-P // LN_SUM_SEGS)
    segs = F.pad(parts, (0, 0, 0, LN_SUM_SEGS * per - P)).view(LN_SUM_SEGS, per, D)
    acc = torch.zeros_like(segs[:, 0])
    for j in range(per):
        acc = acc + segs[:, j]
    tot = acc[0]
    for k in range(1, LN_SUM_SEGS):
        tot = tot + acc[k]
    return tot


def layer_norm_bwd_tiled_plain(x, gamma, mean, rstd, dy, plan: LnBwdPlan):
    """:func:`layer_norm_bwd_plain` with dgamma and dbeta summed in the
    kernels' order under ``plan`` (the kernels' bits, each product and sum
    rounded on its own): per block of ``rows_per_block`` rows, rows past
    :data:`LN_HELD_COLS` columns in order; narrower ones per warp (local
    rows w, w + 8, ... in order), the warps then ((w0 + w1) + (w2 + w3)) +
    ((w4 + w5) + (w6 + w7)); the partial rows as :func:`_ordered_sum`."""
    dx = layer_norm_bwd_plain(x, gamma, mean, rstd, dy)[0]
    R, D = x.shape
    rpb, P = plan
    dyf = dy.float()
    terms = torch.stack([dyf * ((x.float() - mean) * rstd), dyf])   # (2, R, D)
    terms = F.pad(terms, (0, 0, 0, P * rpb - R)).view(2, P, rpb, D)
    if D > LN_HELD_COLS:
        acc = torch.zeros_like(terms[:, :, 0])
        for r in range(rpb):
            acc = acc + terms[:, :, r]
    else:
        steps = -(-rpb // LN_WARPS)
        terms = F.pad(terms, (0, 0, 0, steps * LN_WARPS - rpb)).view(2, P, steps, LN_WARPS, D)
        acc = torch.zeros_like(terms[:, :, 0])
        for i in range(steps):
            acc = acc + terms[:, :, i]
        while acc.shape[2] > 1:
            acc = acc[:, :, 0::2] + acc[:, :, 1::2]
        acc = acc[:, :, 0]
    return dx, _ordered_sum(acc[0]), _ordered_sum(acc[1])


def bias_gelu_fwd_plain(x, bias):
    return gelu_tanh(x.float() + bias.float()).to(x.dtype)


def bias_gelu_bwd_plain(x, bias, dy):
    """``(dx, dbias)``: dx in x's dtype, dbias the fp32 sum of the fp32 dx."""
    dx = dy.float() * gelu_tanh_grad(x.float() + bias.float())
    return dx.to(x.dtype), dx.sum(0)


def _causal_keep(Sq: int, Sk: int, device) -> torch.Tensor:
    q_pos = (Sk - Sq) + torch.arange(Sq, device=device)
    return q_pos[:, None] >= torch.arange(Sk, device=device)[None, :]


def softmax_fwd_plain(s, causal: bool, scale: float):
    """``p`` of scores ``(BH, Sq, Sk)`` in their dtype (NaN rows where every
    key is masked, as the TPU kernel)."""
    sf = s.float() * scale
    if causal:
        sf = sf.masked_fill(~_causal_keep(s.shape[1], s.shape[2], s.device), float("-inf"))
    m = sf.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    e = torch.exp(sf - m)
    return (e / e.sum(-1, keepdim=True)).to(s.dtype)


class SoftmaxFwdPlan(NamedTuple):
    """The softmax forward's grid: ``route`` "held" (rows of up to
    :data:`SOFTMAX_HELD_COLS` keys in registers) or "wide" (three sweeps);
    each warp takes ``rows_per_warp`` rows, ``blocks`` blocks of
    :data:`SOFTMAX_WARPS` warps."""
    route: str
    rows_per_warp: int
    blocks: int


def softmax_fwd_plan(rows: int, Sk: int, n_sm: int, item: int = 2) -> SoftmaxFwdPlan:
    """Held rows: one wave, as many blocks as the card holds at once (four an
    SM up to 1024 bytes a row, 512 bf16 or 256 fp32 keys, two past that: the
    kernel's ``__launch_bounds__``), each warp a run of rows, an even one
    where a warp takes more than one (the kernel pairs causal queries t and
    Sq − 1 − t); wide rows: one a warp. From shapes, the element size
    ``item`` and the card's SM count."""
    if Sk > SOFTMAX_HELD_COLS:
        return SoftmaxFwdPlan("wide", 1, -(-rows // SOFTMAX_WARPS))
    warps = n_sm * (4 if -(-Sk // 256) * item <= 4 else 2) * SOFTMAX_WARPS
    rpw = -(-rows // warps)
    if rpw > 1:
        rpw += rpw % 2
    return SoftmaxFwdPlan("held", rpw, -(-rows // (SOFTMAX_WARPS * rpw)))


def softmax_bwd_plain(p, dy, scale: float):
    pf, dyf = p.float(), dy.float()
    dot = (pf * dyf).sum(-1, keepdim=True)
    return (pf * (dyf - dot) * scale).to(p.dtype)


# ----------------------------------------------------------------------
# the kernels' wrappers: CUDA tensors launch, CPU tensors run the plain versions
# ----------------------------------------------------------------------
def _check_vec(D: int, **params) -> None:
    for name, t in params.items():
        if t.shape != (D,):
            raise ValueError(f"{name} of shape {tuple(t.shape)} for rows of width {D}")


def _launch_args(x):
    return dtype_code(x), stream_of(x)


def layer_norm_fwd(x, gamma, beta, eps: float):
    if not x.is_cuda:
        return layer_norm_fwd_plain(x, gamma, beta, eps)
    R, D = x.shape
    _check_vec(D, gamma=gamma, beta=beta)
    g, b = gamma.float().contiguous(), beta.float().contiguous()
    check_operands(x, g, b, dtypes=[x.dtype, _F32, _F32])
    y = torch.empty_like(x)
    mean = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        LN_FWD.launch(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), mean.data_ptr(),
                      rstd.data_ptr(), R, D, eps, *_launch_args(x))
    return y, mean, rstd


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_bwd(x, gamma, mean, rstd, dy):
    if not x.is_cuda:
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    R, D = x.shape
    dy = dy.contiguous()
    _check_vec(D, gamma=gamma)
    if mean.shape != (R, 1) or rstd.shape != (R, 1) or dy.shape != x.shape:
        raise ValueError(f"layer_norm backward: mean {tuple(mean.shape)}, rstd "
                         f"{tuple(rstd.shape)}, dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    g = gamma.float().contiguous()
    check_operands(x, dy, g, mean, rstd, dtypes=[x.dtype, x.dtype, _F32, _F32, _F32])
    plan = ln_bwd_plan(R, D, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    parts = torch.empty((2, plan.parts, D), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        LN_BWD.launch(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                      dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                      sums[0].data_ptr(), sums[1].data_ptr(), R, D, plan.rows_per_block,
                      *_launch_args(x))
    return dx, sums[0], sums[1]


def bias_gelu_fwd(x, bias):
    if not x.is_cuda:
        return bias_gelu_fwd_plain(x, bias)
    R, D = x.shape
    _check_vec(D, bias=bias)
    b = bias.float().contiguous()
    check_operands(x, b, dtypes=[x.dtype, _F32])
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        GELU_FWD.launch(x.data_ptr(), b.data_ptr(), y.data_ptr(), R, D, *_launch_args(x))
    return y


def bias_gelu_bwd(x, bias, dy):
    if not x.is_cuda:
        return bias_gelu_bwd_plain(x, bias, dy)
    R, D = x.shape
    dy = dy.contiguous()
    _check_vec(D, bias=bias)
    if dy.shape != x.shape:
        raise ValueError(f"bias_gelu backward: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    b = bias.float().contiguous()
    check_operands(x, dy, b, dtypes=[x.dtype, x.dtype, _F32])
    dx = torch.empty_like(x)
    db_part = torch.empty((-(-R // GELU_ROWS), D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        GELU_BWD.launch(x.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                        db_part.data_ptr(), R, D, GELU_ROWS, *_launch_args(x))
    return dx, db_part.sum(0)


def softmax_fwd(s, causal: bool, scale: float):
    if not s.is_cuda:
        return softmax_fwd_plain(s, causal, scale)
    BH, Sq, Sk = s.shape
    check_operands(s)
    plan = softmax_fwd_plan(BH * Sq, Sk, _sm_count(s.device.index or 0), s.element_size())
    p = torch.empty_like(s)
    with torch.cuda.device(s.device):
        SOFTMAX_FWD.launch(s.data_ptr(), p.data_ptr(), BH, Sq, Sk, Sk - Sq, scale, int(causal),
                           plan.rows_per_warp, *_launch_args(s))
    return p


def softmax_bwd(p, dy, scale: float):
    if not p.is_cuda:
        return softmax_bwd_plain(p, dy, scale)
    BH, Sq, Sk = p.shape
    dy = dy.contiguous()
    if dy.shape != p.shape:
        raise ValueError(f"softmax backward: dy {tuple(dy.shape)} for p {tuple(p.shape)}")
    check_operands(p, dy)
    ds = torch.empty_like(p)
    with torch.cuda.device(p.device):
        SOFTMAX_BWD.launch(p.data_ptr(), dy.data_ptr(), ds.data_ptr(), BH * Sq, Sk, scale,
                           *_launch_args(p))
    return ds


# ----------------------------------------------------------------------
# the public ops
# ----------------------------------------------------------------------
def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2, gamma, mean, rstd, dy)
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, bias):
        ctx.save_for_backward(x2, bias)
        return bias_gelu_fwd(x2, bias)

    @staticmethod
    def backward(ctx, dy):
        x2, bias = ctx.saved_tensors
        dx, db = bias_gelu_bwd(x2, bias, dy)
        return dx, db.to(bias.dtype)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, causal, scale):
        p = softmax_fwd(s, causal, scale)
        ctx.save_for_backward(p)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, dy):
        (p,) = ctx.saved_tensors
        return softmax_bwd(p, dy, ctx.scale), None, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layernorm over the last dim; any leading shape."""
    return _LayerNorm.apply(_rows(x), gamma, beta, float(eps)).reshape(x.shape)


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused ``gelu(x + bias)`` (the tanh approximation)."""
    return _BiasGelu.apply(_rows(x), bias).reshape(x.shape)


def attention_softmax(scores: torch.Tensor, *, causal: bool = True,
                      scale: float = 1.0) -> torch.Tensor:
    """Fused (scaled, causally masked) attention softmax over the last dim.

    ``scores``: ``(..., Sq, Sk)``; the causal triangle is bottom-aligned
    (query i sits at absolute position ``Sk − Sq + i``)."""
    Sq, Sk = scores.shape[-2:]
    s = scores.reshape(-1, Sq, Sk).contiguous()
    return _Softmax.apply(s, bool(causal), float(scale)).reshape(scores.shape)
