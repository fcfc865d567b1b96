"""Fused transformer MLP: ``gelu_tanh(x @ w1 + b1) @ w2 + b2``, forward and
backward, the hidden never saved for the backward (which recomputes it).

Port of ``deepspeed_tpu/ops/pallas/fused_mlp.py``: the TPU kernels
``_fwd_kernel`` (:31), ``_bwd_dx_kernel`` (:45) and ``_bwd_dw_kernel`` (:72)
become the three entries of ``csrc/fused_mlp.cu`` (see its header for the
design and bounds), and the custom VJP (``_fused_mlp``, :116-216) an
``autograd.Function``. The forward is one dispatcher op,
``ds_tpu_torch::fused_mlp_fwd`` (:func:`fused_mlp_fwd_op`), so that
activation checkpointing's policies see it as one op, as they see the flash
forward. The function saves ``x, w1, b1, w2`` (never the hidden) and its
backward runs the dx and dw kernels, which recompute the hidden. Under
activation checkpointing every policy but ``everything_saveable`` recomputes
the forward op (no policy saves its output): two forward launches per layer
and micro-batch, one of dx and dw.

Shapes are the JAX package's: ``x (R, E)`` (the public :func:`fused_mlp`
takes ``(..., E)``), ``w1 (E, F)``, ``w2 (F, E)``, ``b1 (F,)`` in x's dtype,
``b2`` fp32 (the public function casts it, as the JAX wrapper does).
Arithmetic, as the TPU kernels' (:func:`fused_mlp_plain`,
:func:`fused_mlp_bwd_dx_plain`, :func:`fused_mlp_bwd_dw_plain`): products
of the inputs' values summed in fp32; ``h = gelu_tanh(u)`` cast to x's dtype
before the second forward product; in dx, ``du = dh · gelu_tanh'(u)`` cast to
x's dtype before ``du @ w1ᵀ``; in dw, ``du`` and ``h`` in fp32. One
difference from the TPU dx kernel, which adds its per-F-tile partials into a
bf16 output: the port sums all of F in fp32 and casts once (identical in
fp32). Gradients come back as the JAX backward returns them: dx, dw1, db1,
dw2 in their inputs' dtypes, db2 fp32. The bf16 dw kernel runs on Hopper's
tensor cores (``wgmma``, TMA, a thread-block cluster over E: :func:`dw_plan`);
:func:`fused_mlp_bwd_dw_tiled_plain` follows its order of summation, with du
and h entering its products as bf16 hi + lo pairs. The bf16 forward and dx
run as two tensor-core GEMMs each (``wgmma`` + TMA, ``csrc/gemm_sm90.cuh``)
through a bf16 scratch of the hidden at the TPU kernels' cast point (h in
the forward, du in dx), row chunk by row chunk so that the scratch stays
within :data:`SCRATCH_BYTES`: the hidden lies in device memory, a chunk at a
time, between the two products of a call (:func:`mlp_plan`;
:func:`fused_mlp_tiled_plain` and :func:`fused_mlp_bwd_dx_tiled_plain`
follow their order). :func:`kernel_launches` gives the C library's own
counts by kernel.

CUDA tensors launch the kernels (:func:`sm90_route`: bf16 dx, and the bf16
forward from :data:`SM90_MIN_ROWS` rows, on the tensor-core entries; the
``mma.sync`` ones for the bf16 forward below it and in fp32); CPU tensors
run the plain versions; a CUDA tensor never falls back (a build or launch
failure raises). The kernels take E a multiple of 64 up to :data:`MAX_E`
(768 in bf16, 384 in fp32, their shared-memory tiles), F a multiple of 32
and any R ≥ 1 (ragged row tiles are masked, where the JAX wrapper pads);
other shapes raise on the card. The JAX wrapper's tiling error
(``_pick_block_f``) and its mesh plan (``fused_mlp_spmd``) are TPU and
multi-device matters with no counterpart here.
:func:`fits_vmem` is the JAX package's dispatch rule, kept as it is.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import (INT, PTR, Kernel, LibraryCounts, check_operands, dtype_code, load,
                     stream_of)
from .fused_ops import gelu_tanh, gelu_tanh_grad

_ARGS = [INT, INT, INT, INT, INT, INT, PTR]   # R E F splits per_split dtype stream
FWD = Kernel("fused_mlp", "fused_mlp_fwd", [PTR] * 7 + _ARGS)
DX = Kernel("fused_mlp", "fused_mlp_bwd_dx", [PTR] * 7 + _ARGS)
# R E F segments tiles_per_segment chunk dtype stream
DW = Kernel("fused_mlp", "fused_mlp_bwd_dw", [PTR] * 8 + [INT] * 7 + [PTR])

# R E F chunk_rows f_tiles splits k_blocks stream
_SM90_ARGS = [INT] * 7 + [PTR]
FWD_SM90 = Kernel("fused_mlp", "fused_mlp_fwd_sm90", [PTR] * 8 + _SM90_ARGS)
DX_SM90 = Kernel("fused_mlp", "fused_mlp_bwd_dx_sm90", [PTR] * 8 + _SM90_ARGS)

# the kernels behind the C entries, in the order the library counts them
# (``fused_mlp_launched``): the forward, dx (fp32), the bf16 dw on Hopper, the
# fp32 dw, the pass that sums split partials in order and casts, then the bf16
# forward's two GEMMs (h, y) and dx's (du, dx) on the tensor cores
KERNELS = ("fwd_kernel", "dx_kernel", "dw_sm90_kernel", "dw_kernel", "reduce_kernel",
           "h_sm90_kernel", "y_sm90_kernel", "du_sm90_kernel", "dx_sm90_kernel")
COUNTS = LibraryCounts("fused_mlp", "fused_mlp_launched", KERNELS)

MAX_E = {torch.bfloat16: 768, torch.float32: 384}
ROWS = 32          # the kernels' row tile
CHUNK = 32         # hidden columns per chunk of the forward and dx kernels
DW_COLS = 16       # hidden columns per block of the fp32 dw kernel
DW_ROWS = 16       # its row tile
DW_TILE_ROWS = 64          # the bf16 dw kernel's row tile (wgmma's 64 rows)
DW_HIDDEN = 64             # hidden columns a cluster of it owns
DW_CHUNKS = (192, 128, 64)   # E-chunk widths a CTA of it may own
DW_MAX_CLUSTER = 8         # the portable cluster size
_SM_COUNT = 132    # splits and segments aim at a few blocks per SM of an H100

# the bf16 forward and dx on the tensor cores (``mlp_plan``)
SCRATCH_BYTES = 256 * 1024 * 1024   # the hidden's bf16 scratch at most (as fused_ce.py's)
TILE_ROWS = 128    # rows a CTA: two warpgroups of 64
H_TILE = 256       # hidden columns a tile of h_sm90_kernel (du_sm90_kernel: 128, twice as many)
# output columns a CTA of the E-wide products (y, dx): on an H100 as fast as
# 256 at 24576 rows and 4-7% faster at 2048 (scripts/fused_mlp_ab.py)
E_TILE = 192
K_BLOCK = 64       # contraction a pipeline stage
# rows from which the bf16 forward takes the tensor-core entry: below, its
# latency loses to fwd_kernel (an H100 at 8 rows: 0.025 ms against 0.013; at
# 64 it wins: scripts/fused_mlp_ab.py). bf16 dx takes its tensor-core entry
# at every row count: every path calls it with thousands of rows.
SM90_MIN_ROWS = 64
# the plan's cost model, in k-block times (one 64-deep k-block of a 128 x 256
# tile at the card's bf16 rate: 0.56 us on an H100)
CTA_START = 2.0          # a CTA's start: barriers, the first TMA round trip
REDUCE_START = 3.0       # reduce_kernel's launch
BYTES_PER_KBLOCK = 1.88e6   # device-memory bytes in a k-block time (3.35 TB/s)


def kernel_launches() -> dict:
    """Launches so far of each kernel of :data:`KERNELS`, as the C library
    counts them where it launches them (graph replays included). Loads (and
    builds) the library."""
    return COUNTS.read()


DW_SEGMENT_COST = 3   # a segment's fp32 partials, in tiles of time (~11 us against ~3.5 us)
_RESIDENT = {}         # (device, chunk, E) -> clusters the card holds at once


DW_MAX_SMEM = 232448   # a block's shared memory on the H100


def dw_smem(chunk: int, cluster: int) -> int:
    """Shared memory of one CTA of the bf16 dw kernel (``DwSm90::smem``): two
    stages of x and dy over the chunk, two du/h buffers, two receive buffers
    of the cluster's partials of its rows, seven mbarriers, 1024 of
    alignment."""
    rows = -(-DW_TILE_ROWS // cluster)
    return 1024 + 2 * 2 * chunk * 64 * 2 + 2 * 4 * 64 * 64 * 2 + 2 * cluster * 4 * rows * 128 + 56


def dw_chunk(E: int) -> tuple[int, int]:
    """``(chunk, cluster)``: of :data:`DW_CHUNKS`, the E-chunk that pads E the
    least in a cluster of at most :data:`DW_MAX_CLUSTER` CTAs whose shared
    memory fits (:func:`dw_smem`), then the widest (192 and 4 CTAs at E =
    768; a chunk past E reads zeros)."""
    chunk = min((c for c in DW_CHUNKS if -(-E // c) <= DW_MAX_CLUSTER
                 and dw_smem(c, -(-E // c)) <= DW_MAX_SMEM),
                key=lambda c: (-(-E // c) * c, -c))
    return chunk, -(-E // chunk)


def dw_plan(R: int, E: int, F: int, resident: int | None = None) -> tuple[int, int, int, int]:
    """``(chunk, cluster, segments, tiles_per_segment)`` of the bf16 dw kernel.

    A cluster of ``ceil(E / chunk)`` CTAs shares each 64-column hidden tile,
    one E-chunk a CTA (:func:`dw_chunk`). The 64-row tiles split into row
    segments, none empty, the count that takes the fewest tile-times: the
    waves of ``resident`` clusters (the card's count at once; one cluster an
    SM's worth of CTAs, ``132 // cluster``, when not given) times a
    segment's tiles, plus :data:`DW_SEGMENT_COST` a segment for its
    partials."""
    chunk, cluster = dw_chunk(E)
    resident = max(1, resident or _SM_COUNT // cluster)
    clusters, tiles = -(-F // DW_HIDDEN), -(-R // DW_TILE_ROWS)
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        nseg = -(-tiles // per)
        cost = -(-clusters * nseg // resident) * per + DW_SEGMENT_COST * nseg
        if best is None or cost < best[0]:
            best = (cost, nseg, per)
    return chunk, cluster, best[1], best[2]


def dw_resident(device, E: int) -> int:
    """Clusters of the bf16 dw kernel at this E that ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``, asked of the library once per
    device and width); the plan's ``resident``."""
    chunk = dw_chunk(E)[0]
    key = (device, chunk, E)
    if key not in _RESIDENT:
        fn = load("fused_mlp").fused_mlp_dw_active_clusters
        fn.argtypes, fn.restype = [INT, INT], ctypes.c_int
        with torch.cuda.device(device):
            n = fn(chunk, E)
        if n < 1:
            raise RuntimeError(f"fused_mlp dw: no cluster of {chunk}-column chunks at E={E} fits")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def fits_vmem(e: int, f: int, block_rows: int, itemsize: int) -> bool:
    """The JAX package's dispatch rule (``ops/pallas/fused_mlp.py:241``),
    kept as it is so that both packages fuse the same configs: both weight
    panels plus the row tiles within 15 MiB of TPU VMEM. Whether the card
    should fuse wider models is an open, measured question (ROADMAP.md)."""
    weights = 2 * e * f * itemsize
    tiles = block_rows * (f * (4 + itemsize) + 2 * 2 * e * itemsize)
    return weights + tiles <= 15 * 1024 * 1024


class MlpPlan(NamedTuple):
    """The bf16 forward and dx on the tensor cores (``fused_mlp.cu``,
    ``mlp_sm90``): a call walks the rows in chunks of ``chunk_rows``, its
    hidden a ``(chunk_rows, F)`` bf16 scratch; a CTA of the F-wide kernel (h
    or du) computes ``f_tiles`` tiles of 256 hidden columns of 128 rows (h's
    two warpgroups take them as 128-column halves in turns); the
    E-wide product (y or dx) takes :data:`E_TILE` columns of 128 rows a CTA
    and splits F into ``splits`` ranges of ``k_blocks`` blocks of 64, summed
    in order by ``reduce_kernel`` when more than one."""
    chunk_rows: int
    f_tiles: int
    splits: int
    k_blocks: int


def mlp_plan(R: int, E: int, F: int) -> MlpPlan:
    """The plan of a bf16 forward or dx call of ``R`` rows, from the shapes
    alone. Row chunks: the most whole 128-row tiles whose bf16 hidden fits
    :data:`SCRATCH_BYTES` (one chunk at R = 24576, F = 3072). Then, of a
    chunk's CTAs (one an SM: their shared memory), the counts that take the
    fewest k-block times in waves of :data:`_SM_COUNT`, plus
    :data:`CTA_START` a CTA: the F-wide kernel's tiles a CTA (each E / 64
    k-blocks), and the E-wide product's splits of F (each split's fp32
    partials cost their bytes and :data:`REDUCE_START`). Ties go to fewer
    tiles a CTA and fewer splits."""
    cap = max(TILE_ROWS, SCRATCH_BYTES // (2 * F) // TILE_ROWS * TILE_ROWS)
    chunk = R if R <= cap else cap
    m = -(-chunk // TILE_ROWS)

    def waves(ctas):
        return -(-ctas // _SM_COUNT)

    nt = -(-F // H_TILE)
    f_tiles = min(range(1, nt + 1),
                  key=lambda p: (waves(m * -(-nt // p)) * (p * E // K_BLOCK + CTA_START), p))
    kb = -(-F // K_BLOCK)
    best = None
    for per in range(kb, 0, -1):
        s = -(-kb // per)
        cost = waves(m * -(-E // E_TILE) * s) * (per * E_TILE / H_TILE + CTA_START)
        if s > 1:
            cost += REDUCE_START + (s * R * E * 4 + R * E * 2) / BYTES_PER_KBLOCK
        if best is None or (cost, s) < best[0]:
            best = ((cost, s), s, per)
    return MlpPlan(chunk, f_tiles, best[1], best[2])


def sm90_route(R: int, fwd: bool, dtype=torch.bfloat16) -> bool:
    """Whether a call of ``R`` rows takes the tensor-core entry: bf16 dx
    always, the bf16 forward from :data:`SM90_MIN_ROWS` rows, fp32 never
    (the ``mma.sync`` ``fwd_kernel`` / ``dx_kernel`` otherwise)."""
    return dtype == torch.bfloat16 and (not fwd or R >= SM90_MIN_ROWS)


def _u(x, w1, b1):
    return x.float() @ w1.float() + b1.float()


def fused_mlp_plain(x, w1, b1, w2, b2):
    """The forward kernel's function: ``(R, E)`` in x's dtype."""
    h = gelu_tanh(_u(x, w1, b1)).to(x.dtype)
    return (h.float() @ w2.float() + b2.float()).to(x.dtype)


def fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy):
    """The dx kernel's function: ``du = (dy @ w2ᵀ) · gelu_tanh'(u)`` cast to
    x's dtype, ``dx = du @ w1ᵀ`` summed in fp32 over all of F, in x's dtype."""
    du = (dy.float() @ w2.float().T) * gelu_tanh_grad(_u(x, w1, b1))
    return (du.to(x.dtype).float() @ w1.float().T).to(x.dtype)


def fused_mlp_bwd_dw_plain(x, w1, b1, w2, dy):
    """The dw kernel's function: ``(dw1, db1, dw2, db2)`` from ``du`` and
    ``h`` in fp32; dw1, db1, dw2 in the weights' dtype, db2 fp32."""
    u = _u(x, w1, b1)
    dyf = dy.float()
    du = (dyf @ w2.float().T) * gelu_tanh_grad(u)
    dw1 = x.float().T @ du
    dw2 = gelu_tanh(u).T @ dyf
    return dw1.to(w1.dtype), du.sum(0).to(b1.dtype), dw2.to(w2.dtype), dyf.sum(0)


def _mlp_tiled(x, w1, b1, w2, last, fwd: bool, plan=None):
    """The forward (``last`` = b2) or dx (``last`` = dy) in the tensor-core
    entries' order under ``plan`` (:func:`mlp_plan`'s from the shapes when
    not given): per row chunk the hidden in fp32 from fp32 products, cast to
    x's dtype (h = gelu_tanh(u); du = dh · gelu_tanh'(u)); then per split of
    F, in order, the fp32 product of its hidden columns, the splits summed
    in that order, b2 added (forward), cast once."""
    R, E = x.shape
    F = w1.shape[1]
    plan = plan or mlp_plan(R, E, F)
    dt = x.dtype
    w1f, w2f, b1f = w1.float(), w2.float(), b1.float()
    b = w2f if fwd else w1f.T
    width = plan.k_blocks * K_BLOCK
    outs = []
    for r0 in range(0, R, plan.chunk_rows):
        rows = slice(r0, r0 + plan.chunk_rows)
        u = x[rows].float() @ w1f + b1f
        if fwd:
            hid = gelu_tanh(u).to(dt).float()
        else:
            hid = ((last[rows].float() @ w2f.T) * gelu_tanh_grad(u)).to(dt).float()
        acc = None
        for c0 in range(0, F, width):
            p = hid[:, c0:c0 + width] @ b[c0:c0 + width]
            acc = p if acc is None else acc + p
        if fwd:
            acc = acc + last.float()
        outs.append(acc.to(dt))
    return torch.cat(outs)


def fused_mlp_tiled_plain(x, w1, b1, w2, b2, plan=None):
    """:func:`fused_mlp_plain` in ``fused_mlp_fwd_sm90``'s order (row chunks,
    the splits of F summed in order, then b2)."""
    return _mlp_tiled(x, w1, b1, w2, b2, True, plan)


def fused_mlp_bwd_dx_tiled_plain(x, w1, b1, w2, dy, plan=None):
    """:func:`fused_mlp_bwd_dx_plain` in ``fused_mlp_bwd_dx_sm90``'s order."""
    return _mlp_tiled(x, w1, b1, w2, dy, False, plan)


def _hi_lo(v):
    """v's bf16 hi + lo pair as fp32 values: hi = bf16(v), lo = bf16(v − hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def fused_mlp_bwd_dw_tiled_plain(x, w1, b1, w2, dy, resident=None):
    """:func:`fused_mlp_bwd_dw_plain` in the bf16 dw kernel's order under
    :func:`dw_plan` (``resident`` as the card holds; the wrapper's
    :func:`dw_resident`). Per row segment, per 64-row tile: u and dh as the
    cluster's E-chunk partials (each an fp32 product over its chunk) summed
    in rank order, then b1; du and h in fp32; with bf16 inputs each enters
    the products as its bf16 hi + lo pair (``dw1 += xᵀ hi + xᵀ lo``, and so
    for ``hᵀ dy``), fp32 inputs as it is; db1 and db2 column sums of the
    tile. The segments' fp32 partials are summed in segment order and cast.
    Hidden tiles are independent (each output element lies in one), so all
    of F is taken at once."""
    R, E = x.shape
    F = w1.shape[1]
    chunk, n, nseg, per = dw_plan(R, E, F, resident)
    split = x.dtype == torch.bfloat16
    xf, dyf, w1f, w2f, b1f = x.float(), dy.float(), w1.float(), w2.float(), b1.float()
    cols = [slice(c * chunk, min(E, (c + 1) * chunk)) for c in range(n)]
    rows = DW_TILE_ROWS * per
    total = None
    for seg in range(nseg):
        dw1, dw2 = torch.zeros_like(w1f), torch.zeros_like(w2f)
        db1, db2 = torch.zeros_like(b1f), torch.zeros(E, dtype=torch.float32, device=x.device)
        for r0 in range(seg * rows, min(R, (seg + 1) * rows), DW_TILE_ROWS):
            xt, dyt = xf[r0:r0 + DW_TILE_ROWS], dyf[r0:r0 + DW_TILE_ROWS]
            u = dh = None
            for c in cols:
                pu, pdh = xt[:, c] @ w1f[c], dyt[:, c] @ w2f[:, c].T
                u, dh = (pu, pdh) if u is None else (u + pu, dh + pdh)
            u = u + b1f
            du, h = dh * gelu_tanh_grad(u), gelu_tanh(u)
            for p in _hi_lo(du) if split else (du,):
                dw1 = dw1 + xt.T @ p
            for p in _hi_lo(h) if split else (h,):
                dw2 = dw2 + p.T @ dyt
            db1, db2 = db1 + du.sum(0), db2 + dyt.sum(0)
        seg_parts = (dw1, db1, dw2, db2)
        total = seg_parts if total is None else tuple(t + p for t, p in zip(total, seg_parts))
    dw1, db1, dw2, db2 = total
    return dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2


# ----------------------------------------------------------------------
# the kernels' wrappers
# ----------------------------------------------------------------------
def _check(x, w1, b1, w2, dy=None):
    R, E = x.shape
    F = w1.shape[1]
    if w1.shape != (E, F) or b1.shape != (F,) or w2.shape != (F, E) or (
            dy is not None and dy.shape != x.shape):
        raise ValueError(f"fused_mlp: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
                         f"{tuple(b1.shape)}, w2 {tuple(w2.shape)} do not match")
    if x.is_cuda and (E % 64 or E > MAX_E.get(x.dtype, 0) or F % CHUNK or R < 1):
        raise ValueError(f"fused_mlp kernels: E={E} F={F} R={R} {x.dtype}: the kernels take E a "
                         f"multiple of 64 up to {MAX_E} and F a multiple of {CHUNK}")


def _splits(row_tiles: int, units: int, waves: int) -> tuple[int, int]:
    """``(splits, units per split)`` of ``units`` work units so that
    ``row_tiles × splits`` blocks make about ``waves`` blocks per SM, with
    no empty split."""
    want = max(1, min(units, -(-waves * _SM_COUNT // row_tiles)))
    per = -(-units // want)
    return -(-units // per), per


def _launch_rows(kernel, x, w1, b1, w2, last, out):
    """The forward or dx kernel: ``last`` is b2 (fp32) or dy."""
    R, E = x.shape
    F = w1.shape[1]
    nsplit, per = _splits(-(-R // ROWS), F // CHUNK, 2)
    part = torch.empty((nsplit, R, E) if nsplit > 1 else (1,), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        kernel.launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), last.data_ptr(),
                      out.data_ptr(), part.data_ptr(), R, E, F, nsplit, per, dtype_code(x),
                      stream_of(x))
    return out


def _sm90_plan(x, w1, fwd: bool):
    """:func:`mlp_plan` of a call the tensor-core entries take
    (:func:`sm90_route`), else None."""
    if not sm90_route(x.shape[0], fwd, x.dtype):
        return None
    return mlp_plan(x.shape[0], x.shape[1], w1.shape[1])


def _launch_sm90(kernel, x, w1, b1, w2, last, out, plan):
    """The tensor-core forward or dx: ``last`` is b2 (fp32) or dy; the
    hidden's bf16 scratch and the splits' fp32 partials from the plan."""
    R, E = x.shape
    F = w1.shape[1]
    scratch = torch.empty((plan.chunk_rows, F), dtype=x.dtype, device=x.device)
    part = torch.empty((plan.splits, R, E) if plan.splits > 1 else (1,), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        kernel.launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), last.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), part.data_ptr(), R, E, F,
                      plan.chunk_rows, plan.f_tiles, plan.splits, plan.k_blocks, stream_of(x))
    return out


def fused_mlp_bwd_dx(x, w1, b1, w2, dy):
    """dx ``(R, E)`` in x's dtype: on CUDA tensors the tensor-core entry
    (bf16, :func:`mlp_plan`) or the dx kernel (fp32),
    :func:`fused_mlp_bwd_dx_plain` on CPU tensors."""
    _check(x, w1, b1, w2, dy)
    if not x.is_cuda:
        return fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy)
    x, w1, b1, w2, dy = (t.contiguous() for t in (x, w1, b1, w2, dy))
    check_operands(x, w1, b1, w2, dy)
    plan = _sm90_plan(x, w1, False)
    if plan is not None:
        return _launch_sm90(DX_SM90, x, w1, b1, w2, dy, torch.empty_like(x), plan)
    return _launch_rows(DX, x, w1, b1, w2, dy, torch.empty_like(x))


def fused_mlp_bwd_dw(x, w1, b1, w2, dy):
    """``(dw1, db1, dw2, db2)``: the dw kernel on CUDA tensors (bf16: the
    Hopper kernel under :func:`dw_plan`; fp32: the CUDA-core one; dw1, dw2
    and db1 views of one buffer in the weights' dtype, db2 fp32),
    :func:`fused_mlp_bwd_dw_plain` on CPU tensors."""
    _check(x, w1, b1, w2, dy)
    if not x.is_cuda:
        return fused_mlp_bwd_dw_plain(x, w1, b1, w2, dy)
    x, w1, b1, w2, dy = (t.contiguous() for t in (x, w1, b1, w2, dy))
    check_operands(x, w1, b1, w2, dy)
    R, E = x.shape
    F = w1.shape[1]
    if x.dtype == torch.bfloat16:   # dw_sm90_kernel: 64-row tiles, clusters over E
        chunk, _, nseg, per = dw_plan(R, E, F, dw_resident(x.device, E))
    else:                            # dw_kernel: 16 hidden columns by 16-row tiles
        chunk = 0
        nseg, per = _splits(F // DW_COLS, -(-R // DW_ROWS), 8)
    out = torch.empty((2 * E * F + F,), dtype=x.dtype, device=x.device)
    db2 = torch.empty((E,), dtype=torch.float32, device=x.device)
    part = torch.empty((nseg, 2 * E * F + F + E), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        DW.launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
                  out.data_ptr(), db2.data_ptr(), part.data_ptr(), R, E, F, nseg, per, chunk,
                  dtype_code(x), stream_of(x))
    EF = E * F
    return out[:EF].view(E, F), out[2 * EF:], out[EF:2 * EF].view(F, E), db2


@torch.library.custom_op("ds_tpu_torch::fused_mlp_fwd", mutates_args=())
def fused_mlp_fwd_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """The forward as one dispatcher op, ``(R, E)`` in x's dtype: on CUDA
    tensors the tensor-core entry (bf16 from :data:`SM90_MIN_ROWS` rows,
    :func:`mlp_plan`) or the forward kernel, :func:`fused_mlp_plain` on CPU tensors (its products stay inside
    the op, so a checkpoint policy sees one op on both devices)."""
    _check(x, w1, b1, w2)
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, b1, w2, b2)
    x, w1, b1, w2 = (t.contiguous() for t in (x, w1, b1, w2))
    b2 = b2.float().contiguous()
    check_operands(x, w1, b1, w2)
    check_operands(b2)
    plan = _sm90_plan(x, w1, True)
    if plan is not None:
        return _launch_sm90(FWD_SM90, x, w1, b1, w2, b2, torch.empty_like(x), plan)
    return _launch_rows(FWD, x, w1, b1, w2, b2, torch.empty_like(x))


@fused_mlp_fwd_op.register_fake
def _(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


class _FusedMLP(torch.autograd.Function):
    """``(R, E)`` inputs; saves ``x, w1, b1, w2``, never the hidden."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return fused_mlp_fwd_op(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx = fused_mlp_bwd_dx(x, w1, b1, w2, dy)
        dw1, db1, dw2, db2 = fused_mlp_bwd_dw(x, w1, b1, w2, dy)
        return dx, dw1, db1, dw2, db2


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(x @ w1 + b1) @ w2 + b2`` over ``(..., E)`` inputs, in x's
    dtype, the hidden never saved for the backward; differentiable in all
    five (b2's gradient is taken in fp32 and cast back by autograd)."""
    lead, E = x.shape[:-1], x.shape[-1]
    y = _FusedMLP.apply(x.reshape(-1, E), w1, b1, w2, b2.float())
    return y.reshape(*lead, E)
