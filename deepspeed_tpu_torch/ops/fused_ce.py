"""Fused cross-entropy head: the tied LM-head product with an online
log-sum-exp, the logits never in device memory in either pass.

Port of ``deepspeed_tpu/ops/pallas/fused_ce.py``: the TPU kernels
``_fwd_kernel`` (:37), ``_dh_kernel`` (:72) and ``_dw_kernel`` (:101)
become the three entries of ``csrc/fused_ce.cu`` (see its header for the
design and bounds), and the custom VJP (``fused_ce_sum``, ``_ce_bwd``
:222-233) an ``autograd.Function``.

Shapes are the JAX package's: ``h (N, E)``, ``wteT (E, Vp)`` (the tied
embedding transposed, as the model passes ``wte.to(dtype).T``), ``labels
(N,)`` int. The kernels read ``wteT`` as the ``(Vp, E)`` rows it is a view
of. Per token ``n``: ``lse = logsumexp_v(logits)`` over the padded vocab
with columns ``≥ vocab_size`` at ``NEG = -1e30``; ``nll = lse −
logits[label]`` for a valid label, 0 for ``ignore_index``. The backward
rebuilds the logits from ``h``, ``W`` and ``lse``: ``dlog = (p − onehot) ·
valid``, cast to the weight dtype before ``dh = dlog · W`` and to ``h``'s
dtype before ``dw = hᵀ · dlog`` (fp32 accumulation throughout, the TPU
kernels' cast points :88-90 and :115-117); the autograd backward scales
both by the incoming gradient and casts them to the inputs' dtypes. Any
``N`` is taken: ragged token tiles are masked in the kernels, where the
JAX wrapper pads with ``ignore_index`` rows (the same result). CUDA tensors
launch the kernels (:func:`fused_ce_bwd` launches dh and dw together);
CPU tensors run :func:`fused_ce_plain` and :func:`fused_ce_bwd_plain`, the
same functions in plain PyTorch.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, Kernel, dtype_code, stream_of

NEG = -1e30
_CE_ARGS = [INT, INT, INT, INT, INT, INT, PTR]   # N E Vp vocab ignore dtype stream
FWD = Kernel("fused_ce", "fused_ce_fwd", [PTR] * 6 + [INT] + _CE_ARGS)
DH = Kernel("fused_ce", "fused_ce_dh", [PTR] * 5 + [INT] + _CE_ARGS)
DW = Kernel("fused_ce", "fused_ce_dw", [PTR] * 5 + _CE_ARGS)

ROWS = 16          # the kernels' rows per block (tokens for fwd/dh, vocab for dw)
COLS = 256         # columns per tile of the other side
MAX_E = 2560       # the (ROWS, E) fp32 shared-memory accumulator of dh/dw fits
_SM_COUNT = 132    # blocks are split for at least a few waves on an H100


def _logits_plain(h, wteT, vocab_size: int):
    logits = h.float() @ wteT.float()
    vpos = torch.arange(wteT.shape[1], device=h.device)
    return torch.where(vpos < vocab_size, logits, NEG)


def fused_ce_plain(h, wteT, labels, vocab_size: int, ignore_index: int):
    """The forward kernel's function in plain PyTorch: ``(nll (N,), lse
    (N,))`` fp32, ``nll`` 0 on ``ignore_index`` rows."""
    logits = _logits_plain(h, wteT, vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    vpos = torch.arange(wteT.shape[1], device=h.device)
    label_logit = torch.where(vpos[None, :] == labels[:, None].long(), logits, 0.0).sum(-1)
    return torch.where(valid, lse - label_logit, 0.0), lse


def _dlog_plain(h, wteT, labels, lse, vocab_size: int, ignore_index: int):
    logits = _logits_plain(h, wteT, vocab_size)
    p = torch.exp(logits - lse[:, None])
    vpos = torch.arange(wteT.shape[1], device=h.device)
    onehot = (vpos[None, :] == labels[:, None].long()).float()
    return (p - onehot) * (labels != ignore_index).float()[:, None]


def fused_ce_bwd_plain(h, wteT, labels, lse, vocab_size: int, ignore_index: int):
    """The dh and dw kernels' functions in plain PyTorch: ``(dh (N, E),
    dw (E, Vp))`` fp32, unscaled; ``dlog`` cast to the weight dtype for dh
    and to ``h``'s dtype for dw, each product accumulated in fp32."""
    dlog = _dlog_plain(h, wteT, labels, lse, vocab_size, ignore_index)
    dh = dlog.to(wteT.dtype).float() @ wteT.float().T
    dw = h.float().T @ dlog.to(h.dtype).float()
    return dh, dw


# ----------------------------------------------------------------------
# the kernels' wrappers
# ----------------------------------------------------------------------
def _operands(h, wteT, labels):
    """``(h, W (Vp, E), labels int32)`` contiguous, checked for the kernels."""
    N, E = h.shape
    if wteT.dim() != 2 or wteT.shape[0] != E or labels.shape != (N,):
        raise ValueError(f"fused_ce: h {tuple(h.shape)}, wteT {tuple(wteT.shape)}, labels "
                         f"{tuple(labels.shape)} do not match")
    if wteT.dtype != h.dtype:
        raise TypeError(f"fused_ce: h is {h.dtype}, wteT {wteT.dtype}")
    if E > MAX_E:
        raise ValueError(f"fused_ce kernel: E = {E} > {MAX_E}, its shared-memory accumulator's "
                         "limit")
    w = wteT.T.contiguous()                      # (Vp, E): a view's base, no copy
    h = h.contiguous()
    lab = labels.to(torch.int32).contiguous()
    if len({h.device, w.device, lab.device}) != 1:
        raise ValueError("fused_ce: operands on different devices")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_ce: operands must be 16-byte aligned")
    return h, w, lab


def _splits(tiles: int, segments_of: int, waves: int) -> int:
    """Segments of the other side per row tile, so that ``tiles ×
    segments`` blocks make about ``waves`` blocks per SM."""
    return max(1, min(segments_of, -(-waves * _SM_COUNT // max(tiles, 1))))


def fused_ce_fwd(h, wteT, labels, vocab_size: int, ignore_index: int):
    """``(nll (N,), lse (N,))`` fp32: the forward kernel on CUDA tensors,
    :func:`fused_ce_plain` on CPU tensors."""
    if not h.is_cuda:
        return fused_ce_plain(h, wteT, labels, vocab_size, ignore_index)
    h, w, lab = _operands(h, wteT, labels)
    N, E = h.shape
    Vp = w.shape[0]
    nseg = _splits(-(-N // ROWS), -(-Vp // COLS), 8)   # small blocks: several per SM
    part = torch.empty((3, nseg, N), dtype=torch.float32, device=h.device)
    nll = torch.empty((N,), dtype=torch.float32, device=h.device)
    lse = torch.empty((N,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        FWD.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                   part.data_ptr(), nseg, N, E, Vp, vocab_size, ignore_index, dtype_code(h),
                   stream_of(h))
    return nll, lse


def fused_ce_bwd(h, wteT, labels, lse, vocab_size: int, ignore_index: int):
    """``(dh (N, E), dw (E, Vp))`` fp32, unscaled: the dh and dw kernels on
    CUDA tensors (``dw`` the transpose view of a ``(Vp, E)`` buffer),
    :func:`fused_ce_bwd_plain` on CPU tensors."""
    if not h.is_cuda:
        return fused_ce_bwd_plain(h, wteT, labels, lse, vocab_size, ignore_index)
    h, w, lab = _operands(h, wteT, labels)
    N, E = h.shape
    Vp = w.shape[0]
    nseg = _splits(-(-N // ROWS), -(-Vp // COLS), 4)   # one block per SM (its accumulator)
    dh = torch.zeros((N, E), dtype=torch.float32, device=h.device)   # atomics add into it
    dw = torch.empty((Vp, E), dtype=torch.float32, device=h.device)
    lse = lse.float().contiguous()
    common = (N, E, Vp, vocab_size, ignore_index, dtype_code(h), stream_of(h))
    with torch.cuda.device(h.device):
        DH.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(), dh.data_ptr(),
                  nseg, *common)
        DW.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(), dw.data_ptr(),
                  *common)
    return dh, dw.T


class _FusedCESum(torch.autograd.Function):
    """Σ-over-tokens masked NLL (the JAX custom VJP ``fused_ce_sum``)."""

    @staticmethod
    def forward(ctx, h, wteT, labels, vocab_size: int, ignore_index: int):
        nll, lse = fused_ce_fwd(h, wteT, labels, vocab_size, ignore_index)
        ctx.save_for_backward(h, wteT, labels, lse)
        ctx.vocab_size, ctx.ignore_index = vocab_size, ignore_index
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        h, wteT, labels, lse = ctx.saved_tensors
        args = (h, wteT, labels, lse, ctx.vocab_size, ctx.ignore_index)
        gf = g.float()
        dh, dw = fused_ce_bwd(*args)
        return (dh * gf).to(h.dtype), (dw * gf).to(wteT.dtype), None, None, None


def fused_ce_sum(h: torch.Tensor, wteT: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int, ignore_index: int = -100) -> torch.Tensor:
    """Σ-over-tokens masked NLL of a tied LM head, logits never in device
    memory; differentiable in ``h`` and ``wteT``. The caller divides by the
    valid count."""
    return _FusedCESum.apply(h, wteT, labels, vocab_size, ignore_index)
