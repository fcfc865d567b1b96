"""Fused transformer MLP: ``gelu_tanh(x @ w1 + b1) @ w2 + b2`` with the hidden
never in device memory, forward and backward.

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
and h entering its products as bf16 hi + lo pairs. :func:`kernel_launches`
gives the C library's own counts by kernel.

CUDA tensors launch the kernels; CPU tensors run the plain versions; a CUDA
tensor never falls back (a build or launch failure raises). The kernels take
E a multiple of 64 up to :data:`MAX_E` (768 in bf16, 384 in fp32, their
shared-memory tiles), F a multiple of 32 and any R ≥ 1 (ragged row tiles are
masked, where the JAX wrapper pads); other shapes raise on the card. The JAX
wrapper's tiling error (``_pick_block_f``) and its mesh plan
(``fused_mlp_spmd``) are TPU and multi-device matters with no counterpart
here. :func:`fits_vmem` is the JAX package's dispatch rule, kept as it is.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import INT, PTR, Kernel, check_operands, dtype_code, load, stream_of
from .fused_ops import gelu_tanh, gelu_tanh_grad

_ARGS = [INT, INT, INT, INT, INT, INT, PTR]   # R E F splits per_split dtype stream
FWD = Kernel("fused_mlp", "fused_mlp_fwd", [PTR] * 7 + _ARGS)
DX = Kernel("fused_mlp", "fused_mlp_bwd_dx", [PTR] * 7 + _ARGS)
# R E F segments tiles_per_segment chunk dtype stream
DW = Kernel("fused_mlp", "fused_mlp_bwd_dw", [PTR] * 8 + [INT] * 7 + [PTR])

# the kernels behind the C entries, in the order the library counts them
# (``fused_mlp_launched``): the forward, dx, the bf16 dw on Hopper, the fp32
# dw, and the pass that sums split partials in order and casts
KERNELS = ("fwd_kernel", "dx_kernel", "dw_sm90_kernel", "dw_kernel", "reduce_kernel")

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


def kernel_launches() -> dict:
    """Launches so far of each kernel of :data:`KERNELS`, as the C library
    counts them where it launches them. Loads (and builds) the library."""
    fn = load("fused_mlp").fused_mlp_launched
    fn.argtypes, fn.restype = [INT], ctypes.c_ulonglong
    return {name: int(fn(i)) for i, name in enumerate(KERNELS)}


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


def fused_mlp_bwd_dx(x, w1, b1, w2, dy):
    """dx ``(R, E)`` in x's dtype: the dx kernel on CUDA tensors,
    :func:`fused_mlp_bwd_dx_plain` on CPU tensors."""
    _check(x, w1, b1, w2, dy)
    if not x.is_cuda:
        return fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy)
    x, w1, b1, w2, dy = (t.contiguous() for t in (x, w1, b1, w2, dy))
    check_operands(x, w1, b1, w2, dy)
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
    """The forward as one dispatcher op, ``(R, E)`` in x's dtype: the kernel
    on CUDA tensors, :func:`fused_mlp_plain` on CPU tensors (its products stay
    inside the op, so a checkpoint policy sees one op on both devices)."""
    _check(x, w1, b1, w2)
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, b1, w2, b2)
    x, w1, b1, w2 = (t.contiguous() for t in (x, w1, b1, w2))
    b2 = b2.float().contiguous()
    check_operands(x, w1, b1, w2)
    check_operands(b2)
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
    dtype, the hidden never in device memory; differentiable in all five
    (b2's gradient is taken in fp32 and cast back by autograd)."""
    lead, E = x.shape[:-1], x.shape[-1]
    y = _FusedMLP.apply(x.reshape(-1, E), w1, b1, w2, b2.float())
    return y.reshape(*lead, E)
