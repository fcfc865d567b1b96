"""Fused cross-entropy head: the tied LM-head product with an online
log-sum-exp, the logits never whole in device memory in either pass.

Port of ``deepspeed_tpu/ops/pallas/fused_ce.py``: the TPU kernels
``_fwd_kernel`` (:37), ``_dh_kernel`` (:72) and ``_dw_kernel`` (:101)
become the entries of ``csrc/fused_ce.cu`` (see its header for the design
and bounds), and the custom VJP (``fused_ce_sum``, ``_ce_bwd`` :222-233) an
``autograd.Function``.

Shapes are the JAX package's: ``h (N, E)``, ``wteT (E, Vp)`` (the tied
embedding transposed, as the model passes ``wte.to(dtype).T``), ``labels
(N,)`` int. The kernels read ``wteT`` as the ``(Vp, E)`` rows it is a view
of. Per token ``n``: ``lse = logsumexp_v(logits)`` over the padded vocab
with columns ``≥ vocab_size`` at ``NEG = -1e30``; ``nll = lse −
logits[label]`` for a valid label, 0 for ``ignore_index``. The backward
rebuilds the logits from ``h``, ``W`` and ``lse``: ``dlog = (p − onehot) ·
valid``, cast to the weight dtype before ``dh = dlog · W`` and to ``h``'s
dtype before ``dw = hᵀ · dlog`` (fp32 accumulation throughout, the TPU
kernels' cast points :88-90 and :115-117), both scaled by the incoming
gradient ``g`` and cast to the inputs' dtype. Any ``N`` is taken: ragged
token tiles are masked in the kernels, where the JAX wrapper pads with
``ignore_index`` rows (the same result).

Two routes on CUDA tensors, chosen by dtype and shape alone
(:func:`sm90_route`), each counted by launch counters of its own:

- bf16 with ``E % 8 == 0`` (every GPT-2 preset): the tensor-core kernels,
  :data:`FWD_SM90` (one call: the forward GEMM with its online-lse epilogue
  over :func:`segment_plan`'s vocab segments, then the merge of the
  segments) and :data:`BWD_SM90` (one call: per vocab chunk of
  :func:`chunk_plan`, the dlog GEMM into a bf16 scratch of at most
  :data:`SCRATCH_BYTES`, ``dh += dlog_c W_c`` and ``dW_c = dlog_cᵀ h``:
  three device kernels a chunk, ``g`` folded into the last epilogues and
  read from device memory). :func:`fused_ce_bwd_chunked_plain` follows the
  backward's order: dlog per chunk as bf16, dh summed over chunks in fp32.
- fp32, and bf16 with other ``E``: the CUDA-core kernels :data:`FWD`,
  :data:`DH`, :data:`DW` (E ≤ :data:`MAX_E`, their shared-memory
  accumulator), one call each; ``g`` and the cast applied after them.

A ``Kernel``'s count is its C entry's calls; :func:`kernel_launches` gives
the library's own counts by device kernel. A CUDA tensor launches its route
or raises (no fallback to the plain version); CPU tensors run
:func:`fused_ce_plain` and :func:`fused_ce_bwd_plain`, the same functions
in plain PyTorch. The launch plans come from the shapes alone, with no
value read back from the card.
"""
from __future__ import annotations

import torch

from ._build import INT, PTR, Kernel, LibraryCounts, dtype_code, stream_of

NEG = -1e30
_CE_ARGS = [INT, INT, INT, INT, INT, INT, PTR]   # N E Vp vocab ignore dtype stream
FWD = Kernel("fused_ce", "fused_ce_fwd", [PTR] * 6 + [INT] + _CE_ARGS)
DH = Kernel("fused_ce", "fused_ce_dh", [PTR] * 5 + [INT] + _CE_ARGS)
DW = Kernel("fused_ce", "fused_ce_dw", [PTR] * 5 + _CE_ARGS)
# h w labels nll lse part | nseg tps N E Vp vocab ignore | stream
FWD_SM90 = Kernel("fused_ce", "fused_ce_fwd_sm90", [PTR] * 6 + [INT] * 7 + [PTR])
# h w labels lse g dh dw dh_acc scratch | chunk dlog_tps N E Vp vocab ignore | stream
BWD_SM90 = Kernel("fused_ce", "fused_ce_bwd_sm90", [PTR] * 9 + [INT] * 7 + [PTR])

# the device kernels, in the order the library counts them (fused_ce_launched)
KERNELS = ("ce_fwd_sm90_kernel", "ce_dlog_sm90_kernel", "ce_dh_sm90_kernel",
           "ce_dw_sm90_kernel", "ce_fwd_combine", "ce_fwd_kernel", "ce_dh_kernel",
           "ce_dw_kernel")
COUNTS = LibraryCounts("fused_ce", "fused_ce_launched", KERNELS)

ROWS = 16          # the CUDA-core kernels' rows per block (tokens for fwd/dh, vocab for dw)
COLS = 256         # their columns per tile of the other side
MAX_E = 2560       # the CUDA-core dh/dw's (ROWS, E) fp32 shared-memory accumulator fits
TILE_M = 128       # the tensor-core kernels' output rows a CTA
TILE_N = 256       # their output columns a tile
SCRATCH_BYTES = 256 << 20   # the bf16 dlog chunk of the tensor-core backward, at most
SEGMENT_COST = 0.5          # a segment's start and partials, in tiles of time
_SM_COUNT = 132    # blocks are split for at least a few waves on an H100


def kernel_launches() -> dict:
    """Launches so far of each device kernel of :data:`KERNELS`, as the C
    library counts them where it launches them (graph replays included).
    Loads (and builds) it."""
    return COUNTS.read()


def sm90_route(dtype: torch.dtype, E: int) -> bool:
    """Whether the tensor-core kernels take these operands: bf16, rows of a
    multiple of 16 bytes (TMA's strides)."""
    return dtype == torch.bfloat16 and E % 8 == 0


def segment_plan(row_tiles: int, col_tiles: int, sms: int = _SM_COUNT) -> tuple[int, int]:
    """``(segments, tiles_per_segment)``: the column tiles of each row tile
    split into segments, none empty, the count that takes the fewest
    tile-times: waves of ``sms`` CTAs times (a segment's tiles +
    :data:`SEGMENT_COST`); the fewest segments among equals."""
    best = None
    for want in range(1, col_tiles + 1):
        per = -(-col_tiles // want)
        nseg = -(-col_tiles // per)
        cost = -(-row_tiles * nseg // sms) * (per + SEGMENT_COST)
        if best is None or cost < best[0]:
            best = (cost, nseg, per)
    return best[1], best[2]


def chunk_plan(N: int, Vp: int) -> tuple[int, int]:
    """``(chunk, chunks)`` of the tensor-core backward: the vocab in
    ``chunks`` chunks of ``chunk`` columns (a multiple of :data:`TILE_N`,
    the last one ragged), the fewest whose bf16 dlog ``N × chunk`` fits
    :data:`SCRATCH_BYTES` (one chunk of :data:`TILE_N` at the least, past
    2^19 tokens), balanced."""
    widest = max(TILE_N, SCRATCH_BYTES // (2 * N) // TILE_N * TILE_N)
    chunks = -(-Vp // widest)
    chunk = -(-(-(-Vp // chunks)) // TILE_N) * TILE_N
    return chunk, -(-Vp // chunk)


def _logits_plain(h, wteT, vocab_size: int, v0: int = 0):
    logits = h.float() @ wteT.float()
    vpos = v0 + torch.arange(wteT.shape[1], device=h.device)
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


def _dlog_plain(h, wteT, labels, lse, vocab_size: int, ignore_index: int, v0: int = 0):
    """``(p − onehot) · valid`` fp32 over the columns ``[v0, v0 + cols)`` that
    ``wteT`` holds."""
    logits = _logits_plain(h, wteT, vocab_size, v0)
    p = torch.exp(logits - lse[:, None])
    vpos = v0 + torch.arange(wteT.shape[1], device=h.device)
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


def fused_ce_bwd_chunked_plain(h, wteT, labels, lse, vocab_size: int, ignore_index: int, g=None):
    """The tensor-core backward's order in plain PyTorch: per vocab chunk of
    :func:`chunk_plan`, dlog cast to the inputs' dtype, ``dh`` summed over
    the chunks in fp32, each chunk's ``dw`` rows from one product; both
    scaled by ``g`` (a tensor, or 1) and cast at the end. ``(dh (N, E), dw
    (E, Vp))`` in the inputs' dtype."""
    N, E = h.shape
    Vp = wteT.shape[1]
    gf = torch.ones((), device=h.device) if g is None else g.float().reshape(())
    chunk, _ = chunk_plan(N, Vp)
    dh = None
    dw = torch.empty((Vp, E), dtype=h.dtype, device=h.device)
    for c0 in range(0, Vp, chunk):
        w_c = wteT[:, c0:c0 + chunk]
        dlog = _dlog_plain(h, w_c, labels, lse, vocab_size, ignore_index, c0).to(h.dtype).float()
        part = dlog @ w_c.float().T
        dh = part if dh is None else dh + part
        dw[c0:c0 + chunk] = ((dlog.T @ h.float()) * gf).to(h.dtype)
    return (dh * gf).to(h.dtype), dw.T


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
    if not sm90_route(h.dtype, E) and E > MAX_E:
        raise ValueError(f"fused_ce CUDA-core kernel ({h.dtype}, E = {E}): E > {MAX_E}, its "
                         "shared-memory accumulator's limit")
    w = wteT.T.contiguous()                      # (Vp, E): a view's base, no copy
    h = h.contiguous()
    lab = labels.to(torch.int32).contiguous()
    if len({h.device, w.device, lab.device}) != 1:
        raise ValueError("fused_ce: operands on different devices")
    if h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_ce: operands must be 16-byte aligned")
    return h, w, lab


def _splits(tiles: int, segments_of: int, waves: int) -> int:
    """Segments of the other side per row tile of the CUDA-core kernels, so
    that ``tiles × segments`` blocks make about ``waves`` blocks per SM."""
    return max(1, min(segments_of, -(-waves * _SM_COUNT // max(tiles, 1))))


def fused_ce_fwd(h, wteT, labels, vocab_size: int, ignore_index: int):
    """``(nll (N,), lse (N,))`` fp32: the forward kernel of the operands'
    route on CUDA tensors, :func:`fused_ce_plain` on CPU tensors."""
    if not h.is_cuda:
        return fused_ce_plain(h, wteT, labels, vocab_size, ignore_index)
    h, w, lab = _operands(h, wteT, labels)
    N, E = h.shape
    Vp = w.shape[0]
    if sm90_route(h.dtype, E):
        nseg, tps = segment_plan(-(-N // TILE_M), -(-Vp // TILE_N))
    else:
        nseg = _splits(-(-N // ROWS), -(-Vp // COLS), 8)   # small blocks: several per SM
    part = torch.empty((3, nseg, N), dtype=torch.float32, device=h.device)
    nll = torch.empty((N,), dtype=torch.float32, device=h.device)
    lse = torch.empty((N,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        if sm90_route(h.dtype, E):
            FWD_SM90.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), nll.data_ptr(),
                            lse.data_ptr(), part.data_ptr(), nseg, tps, N, E, Vp, vocab_size,
                            ignore_index, stream_of(h))
        else:
            FWD.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), nll.data_ptr(),
                       lse.data_ptr(), part.data_ptr(), nseg, N, E, Vp, vocab_size,
                       ignore_index, dtype_code(h), stream_of(h))
    return nll, lse


def fused_ce_bwd(h, wteT, labels, lse, vocab_size: int, ignore_index: int, g=None):
    """``(dh (N, E), dw (E, Vp))`` in the inputs' dtype, scaled by ``g`` (a
    tensor on the operands' device, or 1): the backward of the operands'
    route on CUDA tensors (``dw`` the transpose view of a ``(Vp, E)``
    buffer; the tensor-core route folds ``g`` and the cast into its
    epilogues), :func:`fused_ce_bwd_plain` scaled and cast on CPU tensors."""
    gf = (torch.ones((1,), dtype=torch.float32, device=h.device) if g is None
          else g.float().reshape(1).contiguous())
    if not h.is_cuda:
        dh, dw = fused_ce_bwd_plain(h, wteT, labels, lse, vocab_size, ignore_index)
        return (dh * gf).to(h.dtype), (dw * gf).to(wteT.dtype)
    h, w, lab = _operands(h, wteT, labels)
    N, E = h.shape
    Vp = w.shape[0]
    lse = lse.float().contiguous()
    if sm90_route(h.dtype, E):
        chunk, chunks = chunk_plan(N, Vp)
        _, tps = segment_plan(-(-N // TILE_M), chunk // TILE_N)
        dh = torch.empty((N, E), dtype=h.dtype, device=h.device)
        dw = torch.empty((Vp, E), dtype=h.dtype, device=h.device)
        scratch = torch.empty((N, chunk), dtype=h.dtype, device=h.device)
        dh_acc = (torch.empty((N, E), dtype=torch.float32, device=h.device) if chunks > 1
                  else None)
        with torch.cuda.device(h.device):
            BWD_SM90.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                            gf.data_ptr(), dh.data_ptr(), dw.data_ptr(),
                            None if dh_acc is None else dh_acc.data_ptr(), scratch.data_ptr(),
                            chunk, tps, N, E, Vp, vocab_size, ignore_index, stream_of(h))
        return dh, dw.T
    nseg = _splits(-(-N // ROWS), -(-Vp // COLS), 4)   # one block per SM (its accumulator)
    dh = torch.zeros((N, E), dtype=torch.float32, device=h.device)   # atomics add into it
    dw = torch.empty((Vp, E), dtype=torch.float32, device=h.device)
    common = (N, E, Vp, vocab_size, ignore_index, dtype_code(h), stream_of(h))
    with torch.cuda.device(h.device):
        DH.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(), dh.data_ptr(),
                  nseg, *common)
        DW.launch(h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(), dw.data_ptr(),
                  *common)
    return (dh * gf).to(h.dtype), (dw.T * gf).to(h.dtype)


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
        dh, dw = fused_ce_bwd(h, wteT, labels, lse, ctx.vocab_size, ctx.ignore_index, g)
        return dh, dw, None, None, None


def fused_ce_sum(h: torch.Tensor, wteT: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int, ignore_index: int = -100) -> torch.Tensor:
    """Σ-over-tokens masked NLL of a tied LM head, logits never whole in
    device memory; differentiable in ``h`` and ``wteT``. The caller divides
    by the valid count."""
    return _FusedCESum.apply(h, wteT, labels, vocab_size, ignore_index)
