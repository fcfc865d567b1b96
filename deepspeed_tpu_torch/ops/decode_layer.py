"""Fused decode-row kernels: norm → projection, and o-proj → norm → MLP.

Port of ``deepspeed_tpu/ops/pallas/decode_layer.py``, every branch of it:
LayerNorm or RMSNorm (``rms``); the GELU MLP pair, tanh (GPT-2) or exact
erf (``exact_gelu``, GPT-NeoX), or the three-panel SwiGLU MLP (``swiglu``,
LLaMA); a sequential residual or the parallel one (``parallel_residual``,
GPT-NeoX: the MLP's norm reads the block input ``x``); weights in the
activation dtype or as W8A16 pairs (int8 codes ``(K, N)`` + fp32 scales
``(K/g, N)``, the ``ops/w8.py`` layout). The TPU kernels
``_norm_proj_kernel`` and ``_post_attn_kernel`` become
``csrc/decode_layer.cu``, one C entry per MLP and weight kind, the norm,
the GELU form and the residual flags. bf16 runs the tensor-core GEMV of
``csrc/decode_gemv_sm90.cuh`` split over K (:func:`gemv_plan` picks each
launch's column tile and K-slice): norm_proj is the norm's launch and one
GEMV, post_attn the norm's and three GEMVs; fp32 runs the CUDA-core GEMV
of ``csrc/rows_gemv.cuh`` (one launch, and three). :func:`kernel_launches`
gives the C library's own counts by kernel. Each branch has its own launch
count (one a call): ``NORM_PROJ_RMS`` beside
``NORM_PROJ``, and one handle per MLP kind (tanh, exact GELU, SwiGLU) ×
residual × weight kind (:func:`post_attn_handle`; GPT-2's, LLaMA's and
GPT-NeoX's named ``POST_ATTN``, ``POST_ATTN_SWIGLU``, ``POST_ATTN_ERF``,
``POST_ATTN_ERF_PAR`` and their ``_W8`` twins).

:func:`fused_norm_proj` and :func:`fused_post_attn` launch the kernels for
CUDA tensors and run :func:`norm_proj_plain` / :func:`post_attn_plain`,
the kernels' arithmetic in plain PyTorch with the same cast points, for CPU
tensors; :func:`norm_proj_tiled_plain` and :func:`post_attn_tiled_plain`
add the bf16 kernels' order of summation (:func:`gemv_tiled_plain`).
:func:`reference_norm_proj` and :func:`reference_post_attn` are
the unfused op chains the stock module path computes; in a low-precision
dtype they round at other points than the fused kernels, so each path is
held against its own JAX counterpart.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._build import (FLOAT, INT, PTR, Kernel, LibraryCounts, capturing, check_operands,
                     dtype_code, load, stream_of)
from .fused_ops import gelu_tanh
from .w8 import w8a16_matmul

# the bf16 scratch: the normalised rows, the split partials, the tickets
_SCRATCH = [PTR, PTR, PTR]
# M, K/E, N/F, eps, rms, n_tile, k_slice, dtype, stream
_TAIL = [INT, INT, INT, FLOAT, INT, INT, INT, INT, PTR]
# post_attn: M, E, F, eps, rms, [exact_gelu,] parallel, three plans, dtype, stream
_GELU_TAIL = [INT, INT, INT, FLOAT, INT, INT, INT] + [INT] * 6 + [INT, PTR]
_SWIGLU_TAIL = [INT, INT, INT, FLOAT, INT, INT] + [INT] * 6 + [INT, PTR]
_NORM_PROJ_ARGS = [PTR] * 6 + _SCRATCH + _TAIL
_NORM_PROJ_W8_ARGS = [PTR, PTR, PTR, PTR, PTR, INT, PTR, PTR] + _SCRATCH + _TAIL
# the LayerNorm (GPT-2, GPT-NeoX) and RMSNorm (LLaMA) branches share a C
# entry and keep separate launch counts
NORM_PROJ = Kernel("decode_layer", "norm_proj_fwd", _NORM_PROJ_ARGS)
NORM_PROJ_RMS = Kernel("decode_layer", "norm_proj_fwd", _NORM_PROJ_ARGS)
NORM_PROJ_W8 = Kernel("decode_layer", "norm_proj_w8_fwd", _NORM_PROJ_W8_ARGS)
NORM_PROJ_RMS_W8 = Kernel("decode_layer", "norm_proj_w8_fwd", _NORM_PROJ_W8_ARGS)

# the four post_attn C entries, by (swiglu, W8A16)
_POST_ATTN_ENTRIES = {
    (False, False): ("post_attn_fwd", [PTR] * 13 + _SCRATCH + _GELU_TAIL),
    (False, True): ("post_attn_w8_fwd", [PTR, PTR, PTR, PTR, INT] + [PTR] * 5
                    + [INT, PTR, PTR, PTR, INT] + [PTR] * 4 + _SCRATCH + _GELU_TAIL),
    (True, False): ("post_attn_swiglu_fwd", [PTR] * 12 + _SCRATCH + _SWIGLU_TAIL),
    (True, True): ("post_attn_swiglu_w8_fwd", [PTR, PTR, PTR, PTR, INT, PTR, PTR, PTR]
                   + [PTR, PTR, INT] * 3 + [PTR] * 3 + _SCRATCH + _SWIGLU_TAIL),
}

# one launch count per branch of _post_attn_kernel: MLP kind (tanh GELU,
# exact-erf GELU, SwiGLU) x residual (sequential, parallel) x weights
# (activation dtype, W8A16); the norm flag shares them
_POST_ATTN_HANDLES = {(mlp, par, quant): Kernel("decode_layer",
                                                 *_POST_ATTN_ENTRIES[(mlp == "swiglu", quant)])
                      for mlp in ("tanh", "erf", "swiglu") for par in (False, True)
                      for quant in (False, True)}


def post_attn_handle(swiglu: bool = False, exact_gelu: bool = False,
                     parallel_residual: bool = False, quant: bool = False) -> Kernel:
    """The launch-count handle of one branch of :func:`fused_post_attn`
    (``exact_gelu`` is unread under ``swiglu``, as in the JAX kernel)."""
    mlp = "swiglu" if swiglu else ("erf" if exact_gelu else "tanh")
    return _POST_ATTN_HANDLES[(mlp, bool(parallel_residual), bool(quant))]


POST_ATTN, POST_ATTN_W8 = post_attn_handle(), post_attn_handle(quant=True)
POST_ATTN_SWIGLU = post_attn_handle(swiglu=True)
POST_ATTN_SWIGLU_W8 = post_attn_handle(swiglu=True, quant=True)
POST_ATTN_ERF = post_attn_handle(exact_gelu=True)                 # GPT-NeoX, sequential
POST_ATTN_ERF_W8 = post_attn_handle(exact_gelu=True, quant=True)
POST_ATTN_ERF_PAR = post_attn_handle(exact_gelu=True, parallel_residual=True)   # GPT-NeoX
POST_ATTN_ERF_PAR_W8 = post_attn_handle(exact_gelu=True, parallel_residual=True, quant=True)

MAX_ROWS = 64      # the decode regime; prefill rows take the unfused chain
_SQRT_HALF = 2.0 ** -0.5

# the kernels behind the C entries, in the order the library counts them
# (``decode_layer_launched``): the tensor-core GEMV with bf16 weights and
# with W8A16 codes, the norm's launch (bf16), the CUDA-core GEMV (fp32)
KERNELS = ("gemv_sm90_kernel", "gemv_sm90_kernel_w8", "norm_rows_kernel", "rows_gemv_kernel")

# the split plan of the bf16 GEMV (csrc/decode_gemv_sm90.cuh)
SM_COUNT = 132                 # the H100's streaming multiprocessors
MIN_BLOCKS = 2 * SM_COUNT      # two blocks an SM where the shape allows
STAGE_ROWS = 128               # k-rows a ring stage holds; K-slices are multiples
N_TILES = (64, 32, 16)         # output columns a block owns (two panels of them under SwiGLU)
MAX_BLOCK_COLS = 64            # columns of weight a block streams: 4 warps x 16
MIN_ROW_BYTES = 32             # a tile's weight row is at least one 32-byte sector
_TICKETS = {}                  # (device, stream) -> zeroed int32 counters, one per column tile
_MIN_TICKETS = 4096


COUNTS = LibraryCounts("decode_layer", "decode_layer_launched", KERNELS)


def kernel_launches() -> dict:
    """Launches so far of each kernel of :data:`KERNELS`, as the C library
    counts them where it launches them (graph replays included): which
    kernels a call took (the bf16 tensor-core GEMV or the fp32 CUDA-core
    one). Loads (and builds) the library."""
    return COUNTS.read()


@functools.lru_cache(maxsize=None)
def gemv_plan(k: int, n: int, weight_bytes: int, group: Optional[int] = None,
              pair: bool = False) -> tuple:
    """``(n_tile, k_slice)`` of one bf16 GEMV launch over a ``(k, n)`` panel:
    a grid of ``n / n_tile`` column tiles by ``k / k_slice`` K-slices, each
    block streaming ``n_tile`` columns (of both panels with ``pair``, SwiGLU's
    gate and up) down its slice.

    The tile's weight row is at least 32 bytes (whole sectors: 16 bf16 or 32
    int8 columns) and at most 64 columns; slices are whole multiples of the
    128-row stage and of the scale group ``group`` (``None``, or ``k`` for
    one group: any multiple of 128, the scale distributing over partial
    sums). Of the plans with at least :data:`MIN_BLOCKS` blocks, the one with
    the most work a block (fewest blocks, fewest partials), then the widest
    tile; where none reaches it, the most blocks. The plan reads no row
    count: rows only lengthen the products, the operand's stage and the
    partials."""
    width = 2 if pair else 1
    tiles = [nt for nt in N_TILES if nt * width <= MAX_BLOCK_COLS
             and nt * weight_bytes >= MIN_ROW_BYTES and n % nt == 0]
    step = STAGE_ROWS if group is None or group >= k else math.lcm(STAGE_ROWS, group)
    slices = [ks for ks in range(step, k + 1, step) if k % ks == 0]
    if not tiles or not slices:
        raise ValueError(f"gemv_plan: no tile for K={k} N={n} ({weight_bytes}-byte weights, "
                         f"group {group}, pair {pair})")
    plans = [(nt, ks) for nt in tiles for ks in slices]

    def blocks(p):
        return (n // p[0]) * (k // p[1])
    full = [p for p in plans if blocks(p) >= MIN_BLOCKS]
    if full:
        return max(full, key=lambda p: (p[0] * p[1], p[0]))
    return max(plans, key=lambda p: (blocks(p), p[0]))


def gemv_partials(m: int, k: int, n: int, plan: tuple, pair: bool = False) -> int:
    """fp32 elements of one launch's split partials (0 when K is not split)."""
    splits = k // plan[1]
    return 0 if splits == 1 else splits * m * n * (2 if pair else 1)


def gemv_tickets(device, stream: int, n_tiles: int) -> torch.Tensor:
    """The zeroed column-tile counters of ``stream`` on ``device``, made once
    and reused: every launch's last blocks reset theirs, and launches on one
    stream run in order, so the next launch finds them zero.

    A graph bakes the counters' address in, so a stream under capture must
    hold enough of them already: replacing them there would leave the
    graph a freed buffer, so it raises instead. Called on the capture
    stream before capture with the most the capture needs
    (:func:`tickets_needed`), it reserves them."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n_tiles:
        if capturing():
            raise RuntimeError(
                f"gemv_tickets: a launch under graph capture needs {n_tiles} column-tile "
                f"counters and its stream holds {0 if t is None else t.numel()}; reserve "
                "them on the capture stream before capture")
        t = torch.zeros(max(_MIN_TICKETS, n_tiles), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def tickets_needed(module: torch.nn.Module) -> int:
    """The most column-tile counters one GEMV launch of ``module``'s dense
    panels can take: the widest panel over the narrowest tile."""
    widths = [p.shape[1] for name, p in module.named_parameters()
              if name.endswith(("_kernel", "_kernel_q")) and p.dim() == 2]
    return max(widths, default=0) // N_TILES[-1]


def graph_edges(graph) -> dict:
    """The edges of a captured graph kept as a ``cudaGraph_t``
    (``torch.cuda.CUDAGraph(keep_graph=True)`` before its instantiation) and
    how many are programmatic: the dependent launches of the bf16 GEMVs
    (``csrc/decode_gemv_sm90.cuh``) as stream capture records them."""
    lib = load("decode_layer")
    fn = lib.decode_graph_edges
    fn.argtypes = [PTR, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int
    total, prog = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    err = fn(graph.raw_cuda_graph(), ctypes.byref(total), ctypes.byref(prog))
    if err:
        raise RuntimeError(f"decode_graph_edges: CUDA error {err} "
                           f"({lib.ds_error_string(err).decode()})")
    return {"edges": int(total.value), "programmatic": int(prog.value)}


def gelu_exact(u: torch.Tensor) -> torch.Tensor:
    """``_gelu_exact`` of the TPU module (``decode_layer.py:98-100``), term
    for term: ``0.5·u·(1 + erf(u·2^-0.5))``."""
    return 0.5 * u * (1.0 + torch.erf(u * _SQRT_HALF))


def _norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float, rms: bool = False) -> torch.Tensor:
    """fp32 LayerNorm, or RMSNorm (no mean, no bias), over the last dim
    (``_norm_rows`` of the TPU module)."""
    if rms:
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _w8_groups_ok(k: int, groups: int) -> bool:
    """JAX's W8 group rule: one group, or 128-aligned groups that divide K."""
    g = k // max(groups, 1)
    return groups <= 1 or (g % 128 == 0 and k % g == 0)


def norm_proj_supported(m: int, e: int, n: int, quant: bool = False, groups: int = 1) -> bool:
    """The JAX dispatch predicate: decode rows, 128-aligned widths and,
    under W8 (``quant``), aligned scale groups. JAX's TPU tile rules
    (``_pick_bn``, ``_pick_bf``, the o-proj panel budget) are left out: the
    CUDA kernels have none. They never bite at a GPT-2 preset with 128-row
    groups; a down panel of 768-row groups (gpt2-125m, ``group_size``
    768) takes the kernels here where ``_pick_bf``'s scale tile refuses it
    on the TPU."""
    if m > MAX_ROWS or e % 128 or n % 128:
        return False
    return not quant or _w8_groups_ok(e, groups)


def post_attn_supported(m: int, e: int, f: int, quant: bool = False, groups_e: int = 1,
                        groups_f: int = 1) -> bool:
    """As :func:`norm_proj_supported`, for the o-proj/up (K = E) and down
    (K = F) panels."""
    if m > MAX_ROWS or e % 128 or f % 128:
        return False
    return not quant or (_w8_groups_ok(e, groups_e) and _w8_groups_ok(f, groups_f))


def _w8_kind(weights) -> bool:
    """True when every weight is a W8A16 ``(codes, scales)`` pair, False when
    none is; a mix raises."""
    quant = [isinstance(w, tuple) for w in weights]
    if any(quant) and not all(quant):
        raise ValueError("fused decode kernels: weights must be all W8A16 pairs or none")
    return all(quant)


def _out_features(w) -> int:
    return (w[0] if isinstance(w, tuple) else w).shape[1]


# ---------------------------------------------------------------------------
# The kernels' arithmetic in plain PyTorch
# ---------------------------------------------------------------------------

def _dot(a, w, pair=False):
    """``a @ W`` in fp32 for ``a`` in the activation dtype; a W8A16 pair
    computes ``_qdot_any`` (``decode_layer.py:160``): codes upcast to a's
    dtype, each group's fp32 partial times its scale, summed in group order.
    ``pair`` (SwiGLU's gate and up) is unread: it names the panel for
    :func:`gemv_tiled_plain`."""
    if not isinstance(w, tuple):
        return a.float() @ w.float()
    codes, scale = w
    K, G = codes.shape[0], scale.shape[0]
    g = K // G
    af = a.float()
    out = torch.zeros((a.shape[0], codes.shape[1]), dtype=torch.float32, device=a.device)
    for u in range(G):
        part = af[:, u * g:(u + 1) * g] @ codes[u * g:(u + 1) * g].to(a.dtype).float()
        out = out + part * scale[u]
    return out


def gemv_tiled_plain(a, w, pair=False):
    """``a @ W`` in fp32 summed in the bf16 kernel's order under
    :func:`gemv_plan`. Per K-slice, in 128-row stages of 8 k16 steps (a
    16-row product each): the warps sharing a column group take a stage's
    steps in turn (warp q steps q, q + n, ...), and each warp deals its
    steps to :data:`gemv_banks` accumulators in turn, each summing its steps
    in order (W8: a fresh partial a group, folded times the scale at the
    group's end, or the slice's); a warp's banks, then the warps, then the
    slices are summed in order. ``w``: ``(K, N)`` in a's dtype, or a W8A16
    pair (codes upcast to a's dtype)."""
    quant = isinstance(w, tuple)
    codes, scale = w if quant else (w, None)
    K, N = codes.shape
    group = K // scale.shape[0] if quant else None
    n_tile, k_slice = gemv_plan(K, N, 1 if quant else 2, group, pair)
    n_phase = 4 // ((2 if pair else 1) * n_tile // 16)
    banks = gemv_banks(a.shape[0])
    steps = 8 // n_phase                    # a warp's steps in a stage
    af = a.float()
    wf = codes.to(a.dtype).float()
    total = torch.zeros((a.shape[0], N), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, k_slice):
        prods = torch.einsum("mjk,jkn->jmn", af[:, k0:k0 + k_slice].reshape(-1, k_slice // 16, 16),
                             wf[k0:k0 + k_slice].reshape(k_slice // 16, 16, N))
        block = None
        for q in range(n_phase):
            warp = None
            for bank in range(banks):
                acc = torch.zeros_like(total)
                part = torch.zeros_like(total)
                for st in range(k_slice // STAGE_ROWS):
                    for i in range(bank, steps, banks):
                        part = part + prods[st * 8 + q + n_phase * i]
                    end = k0 + (st + 1) * STAGE_ROWS
                    if quant and (end % group == 0 or end == k0 + k_slice):
                        acc = acc + part * scale[(end - 1) // group]
                        part = torch.zeros_like(total)
                acc = acc if quant else part
                warp = acc if warp is None else warp + acc
            block = warp if block is None else block + warp
        total = total + block
    return total


def gemv_banks(m: int) -> int:
    """Accumulators a warp of the bf16 GEMV deals its k16 steps to: 2 for up
    to 16 rows, else 1 (its 8-row tiles are independent chains already)."""
    return 2 if m <= 16 else 1


def norm_proj_plain(x, ns, nb, w, b, eps, rms=False, dot=_dot):
    """``cast(cast(norm(x)) @ W + b)``: the norm (LayerNorm, or RMSNorm with
    ``rms``, which reads no ``nb``) in fp32, cast to x's dtype before the
    product (``decode_layer.py:195``), fp32 product and bias. ``w``:
    ``(E, N)`` or a W8A16 pair. ``dot``: the product's order of summation."""
    cdt = x.dtype
    xn = _norm_rows(x.float(), ns.float(), nb.float(), eps, rms).to(cdt)
    return (dot(xn, w) + b.to(cdt).float()).to(cdt)


def norm_proj_tiled_plain(x, ns, nb, w, b, eps, rms=False):
    """:func:`norm_proj_plain` summed in the bf16 kernel's order
    (:func:`gemv_tiled_plain`)."""
    return norm_proj_plain(x, ns, nb, w, b, eps, rms, dot=gemv_tiled_plain)


def post_attn_tiled_plain(y, x, wo, bo, ns, nb, mlp_weights, eps, swiglu=False, rms=False,
                          exact_gelu=False, parallel_residual=False):
    """:func:`post_attn_plain` summed in the bf16 kernels' order
    (:func:`gemv_tiled_plain` for each panel; gate and up as one pair)."""
    return post_attn_plain(y, x, wo, bo, ns, nb, mlp_weights, eps, swiglu, rms, exact_gelu,
                           parallel_residual, dot=gemv_tiled_plain)


def post_attn_plain(y, x, wo, bo, ns, nb, mlp_weights, eps, swiglu=False, rms=False,
                    exact_gelu=False, parallel_residual=False, dot=_dot):
    """o-proj + residual → norm → MLP → residual, with r1 kept in fp32 and
    casts where ``_post_attn_kernel`` casts (:382, :396). ``mlp_weights``:
    ``(w1, b1, w2, b2)`` for the GELU pair (tanh, or the erf form with
    ``exact_gelu``, in fp32), ``(wg, wu, wd)`` with ``swiglu`` (gate and up
    fp32 products, ``silu(gate)·up`` in fp32 and cast before the down
    product, no MLP biases). ``parallel_residual``: the norm reads ``x``
    upcast to fp32 instead of r1 (:376); the output still adds r1. ``dot``:
    the products' order of summation."""
    cdt = x.dtype
    r1 = (x.float() + dot(y, wo)) + bo.to(cdt).float()
    src = x.float() if parallel_residual else r1
    hin = _norm_rows(src, ns.float(), nb.float(), eps, rms).to(cdt)
    if swiglu:
        wg, wu, wd = mlp_weights
        gate, up = dot(hin, wg, True), dot(hin, wu, True)
        h = ((gate * torch.sigmoid(gate)) * up).to(cdt)
        return (r1 + dot(h, wd)).to(cdt)
    w1, b1, w2, b2 = mlp_weights
    gelu = gelu_exact if exact_gelu else gelu_tanh
    h = gelu(dot(hin, w1) + b1.to(cdt).float()).to(cdt)
    return ((r1 + dot(h, w2)) + b2.to(cdt).float()).to(cdt)


# ---------------------------------------------------------------------------
# The unfused chains (the stock module path)
# ---------------------------------------------------------------------------

def _dense(a, w, b):
    if isinstance(w, tuple):
        out = w8a16_matmul(a, *w)
    else:
        out = a @ w
    return out if b is None else out + b.to(out.dtype)


def _norm_apply(x, scale, bias, rms, eps):
    return _norm_rows(x.float(), scale.float(), 0.0 if bias is None else bias.float(), eps,
                      rms).to(x.dtype)


def reference_norm_proj(x, norm_scale, norm_bias, weight, bias, *, rms=False, eps=1e-5):
    """Unfused ``norm(x) @ W + b`` in x's dtype."""
    return _dense(_norm_apply(x, norm_scale, norm_bias, rms, eps), weight, bias)


def reference_post_attn(y, x, wo, bo, norm_scale, norm_bias, mlp_weights, *, swiglu=False,
                        rms=False, eps=1e-5, exact_gelu=False, parallel_residual=False):
    """Unfused o-proj + residual → norm (of ``x`` under ``parallel_residual``)
    → MLP (GELU pair, tanh or exact, or SwiGLU) → residual."""
    r1 = x + _dense(y, wo, bo)
    h = _norm_apply(x if parallel_residual else r1, norm_scale, norm_bias, rms, eps)
    if swiglu:
        wg, wu, wd = mlp_weights
        gate = _dense(h, wg, None)
        return r1 + _dense(torch.nn.functional.silu(gate) * _dense(h, wu, None), wd, None)
    w1, b1, w2, b2 = mlp_weights
    h1 = torch.nn.functional.gelu(_dense(h, w1, b1), approximate="none" if exact_gelu else "tanh")
    return r1 + _dense(h1, w2, b2)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _vec(t: Optional[torch.Tensor], n: int, like: torch.Tensor, dtype) -> torch.Tensor:
    if t is None:
        return torch.zeros(n, dtype=dtype, device=like.device)
    return t.to(dtype).reshape(n).contiguous()


def _w8_args(w, dtypes: list) -> list:
    """A W8A16 pair's C arguments (codes, scales, group size); their dtypes
    go to ``dtypes`` for the operand check."""
    codes, scale = w
    dtypes += [torch.int8, torch.float32]
    return [codes, scale, codes.shape[0] // scale.shape[0]]


def _ptrs(items) -> list:
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in items]


def _panel_group(w) -> Optional[int]:
    """A W8A16 pair's rows per scale group; None for a full-width panel."""
    return w[0].shape[0] // w[1].shape[0] if isinstance(w, tuple) else None


def _scratch(x2: torch.Tensor, stream: int, gemvs: tuple, sizes: tuple) -> tuple:
    """One call's scratch in one allocation (each of ``sizes`` bytes, then,
    for bf16, the normalised rows ``(M, E)`` bf16 and the split partials'
    workspace: the largest launch's), the C entries' scratch pointers (the
    normalised rows, the workspace, the column-tile tickets: null for fp32,
    whose CUDA-core kernels take none) and plan arguments (each GEMV's
    :func:`gemv_plan`, ``gemvs``: ``(K, N, weight_bytes, group, pair)`` per
    launch; zeros for fp32). Returns the buffer (keep it until the launch),
    the pointers of ``sizes``' regions, the scratch pointers and the plans."""
    M, E = x2.shape
    bf16 = x2.dtype == torch.bfloat16
    if bf16:
        plans, parts, tiles = _split_layout(M, gemvs)
        sizes = sizes + (M * E * 2, parts * 4)
    else:
        plans = (0,) * (2 * len(gemvs))
    offsets, total = _scratch_layout(sizes)
    buf = torch.empty(total, dtype=torch.uint8, device=x2.device)
    ptrs = [buf.data_ptr() + o for o in offsets]
    if not bf16:
        return buf, ptrs, [None] * 3, plans
    tickets = gemv_tickets(x2.device, stream, tiles)
    return buf, ptrs[:-2], [*ptrs[-2:], tickets.data_ptr()], plans


@functools.lru_cache(maxsize=None)
def _scratch_layout(sizes: tuple) -> tuple:
    """Byte offsets of regions of ``sizes`` bytes in one buffer, each
    256-byte aligned, and the buffer's bytes."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    return tuple(offsets), max(total, 256)


@functools.lru_cache(maxsize=None)
def _split_layout(m: int, gemvs: tuple) -> tuple:
    """The flat plan arguments, the workspace's fp32 elements (at least 4)
    and the most column tiles of a call's GEMVs (``_scratch``)."""
    plans = [gemv_plan(k, n, wb, g, pair) for k, n, wb, g, pair in gemvs]
    parts = max(gemv_partials(m, k, n, p, pair) for (k, n, _, _, pair), p in zip(gemvs, plans))
    tiles = max(n // p[0] for (_, n, *_), p in zip(gemvs, plans))
    return tuple(v for p in plans for v in p), max(parts, 4), tiles


def fused_norm_proj(x: torch.Tensor, norm_scale: torch.Tensor,
                    norm_bias: Optional[torch.Tensor], weight, bias: Optional[torch.Tensor],
                    *, rms: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """``norm(x) @ W + b`` in one kernel; returns ``(..., N)`` in x's dtype.

    ``x``: ``(..., E)`` decode rows; ``weight``: ``(E, N)`` in x's dtype, or
    a W8A16 pair (codes int8 ``(E, N)``, scales fp32 ``(E/g, N)``). The norm
    is LayerNorm, or RMSNorm with ``rms`` (``norm_bias`` unread); biases may
    be None (zeros, as the JAX wrapper passes)."""
    quant = _w8_kind((weight,))
    lead, E = x.shape[:-1], x.shape[-1]
    N = _out_features(weight)
    M = math.prod(lead)
    K = (weight[0] if quant else weight).shape[0]
    if K != E:
        raise ValueError(f"fused_norm_proj: x width {E} vs weight rows {K}")
    x2 = x.reshape(M, E)
    ns = _vec(norm_scale, E, x, torch.float32)
    nb = _vec(norm_bias, E, x, torch.float32)
    b = _vec(bias, N, x, x.dtype)
    if not x.is_cuda:
        return norm_proj_plain(x2, ns, nb, weight, b, eps, rms).reshape(*lead, N)
    groups = weight[1].shape[0] if quant else 1
    if not norm_proj_supported(M, E, N, quant, groups):
        raise ValueError(f"fused_norm_proj kernel: unsupported shape M={M} E={E} N={N} "
                         f"groups={groups}")
    x2 = x2.contiguous()
    stream = stream_of(x2)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if quant:
        dtypes = [x.dtype]
        wargs = _w8_args(weight, dtypes)
        check_operands(x2, *wargs[:2], b, dtypes=dtypes + [x.dtype])
        kernel = NORM_PROJ_RMS_W8 if rms else NORM_PROJ_W8
    else:
        wargs = [weight]
        check_operands(x2, weight, b)
        kernel = NORM_PROJ_RMS if rms else NORM_PROJ
    check_operands(ns, nb)
    buf, _, scratch, plan = _scratch(
        x2, stream, ((E, N, 1 if quant else 2, _panel_group(weight), False),), ())
    args = _ptrs([x2, ns, nb, *wargs, b, out]) + scratch + [M, E, N, float(eps), int(rms), *plan,
                                                           dtype_code(x2), stream]
    with torch.cuda.device(x.device):
        kernel.launch(*args)
    del buf   # the scratch is freed once the launches are on the stream
    return out.reshape(*lead, N)


def fused_post_attn(y: torch.Tensor, x: torch.Tensor, wo, bo: Optional[torch.Tensor],
                    norm_scale: torch.Tensor, norm_bias: Optional[torch.Tensor],
                    mlp_weights: tuple, *, swiglu: bool = False, rms: bool = False,
                    eps: float = 1e-5, exact_gelu: bool = False,
                    parallel_residual: bool = False) -> torch.Tensor:
    """``x + y@Wo + bo`` → norm → MLP → residual; returns the new residual
    stream, shaped and typed like ``x``.

    ``y``: pre-o-proj attention output ``(..., E)``; ``mlp_weights``:
    ``(w1 (E, F), b1, w2 (F, E), b2)`` for the GELU pair (biases may be
    None), or ``(w_gate (E, F), w_up (E, F), w_down (F, E))`` with
    ``swiglu``. Each weight is a tensor in x's dtype, or each is a W8A16
    pair (gate and up grouped alike). The norm is LayerNorm, or RMSNorm with
    ``rms``. ``exact_gelu``: the erf GELU (the GELU pair only; unread under
    ``swiglu``, as in the JAX kernel); ``parallel_residual``: the MLP's norm
    reads ``x`` instead of ``x + y@Wo + bo`` (GPT-NeoX), the output is still
    ``x + attn + mlp``."""
    if swiglu:
        w1, wu, w2 = mlp_weights
        b1 = b2 = None
        panels = (wo, w1, wu, w2)
    else:
        w1, b1, w2, b2 = mlp_weights
        panels = (wo, w1, w2)
    quant = _w8_kind(panels)
    lead, E = x.shape[:-1], x.shape[-1]
    F = _out_features(w1)
    M = math.prod(lead)
    shape = (lambda w: tuple(w[0].shape)) if quant else (lambda w: tuple(w.shape))
    want = [(E, E), (E, F), (E, F), (F, E)] if swiglu else [(E, E), (E, F), (F, E)]
    if y.shape != x.shape or [shape(w) for w in panels] != want:
        raise ValueError("fused_post_attn: operand shapes do not match")
    y2, x2 = y.reshape(M, E), x.reshape(M, E)
    ns = _vec(norm_scale, E, x, torch.float32)
    nb = _vec(norm_bias, E, x, torch.float32)
    bo = _vec(bo, E, x, x.dtype)
    if not swiglu:
        b1, b2 = _vec(b1, F, x, x.dtype), _vec(b2, E, x, x.dtype)
    mlp = (w1, wu, w2) if swiglu else (w1, b1, w2, b2)
    if not x.is_cuda:
        out = post_attn_plain(y2, x2, wo, bo, ns, nb, mlp, eps, swiglu, rms,
                              exact_gelu and not swiglu, parallel_residual)
        return out.reshape(*lead, E)
    groups = (wo[1].shape[0], w2[1].shape[0]) if quant else (1, 1)
    if quant and any(w[1].shape[0] != groups[0] for w in panels[1:-1]):
        raise ValueError("fused_post_attn: o-proj and up-proj scale groups differ")
    if not post_attn_supported(M, E, F, quant, *groups):
        raise ValueError(f"fused_post_attn kernel: unsupported shape M={M} E={E} F={F} "
                         f"groups={groups}")
    y2, x2 = y2.contiguous(), x2.contiguous()
    stream = stream_of(x2)
    out = torch.empty((M, E), dtype=x.dtype, device=x.device)
    act = x.dtype
    if quant:
        dtypes = [act, act]
        pairs = [_w8_args(w, dtypes) for w in panels]
        tensors = [t for p in pairs for t in p[:2]]
        biases = [bo] if swiglu else [bo, b1, b2]
        check_operands(y2, x2, *tensors, *biases, dtypes=dtypes + [act] * len(biases))
        ao, *rest = pairs
        if swiglu:
            wargs = [*ao, bo, ns, nb, *rest[0], *rest[1], *rest[2]]
        else:
            wargs = [*ao, bo, ns, nb, *rest[0], b1, *rest[1], b2]
    else:
        if swiglu:
            check_operands(y2, x2, wo, bo, w1, wu, w2)
            wargs = [wo, bo, ns, nb, w1, wu, w2]
        else:
            check_operands(y2, x2, wo, bo, w1, b1, w2, b2)
            wargs = [wo, bo, ns, nb, w1, b1, w2, b2]
    check_operands(ns, nb)
    kernel = post_attn_handle(swiglu, exact_gelu, parallel_residual, quant)
    flags = [int(parallel_residual)] if swiglu else [int(exact_gelu), int(parallel_residual)]
    wb = 1 if quant else 2
    # scratch: r1 (M, E) fp32 and h (M, F) in x's dtype
    buf, (r1, h), scratch, plans = _scratch(
        x2, stream, ((E, E, wb, _panel_group(wo), False), (E, F, wb, _panel_group(w1), swiglu),
                     (F, E, wb, _panel_group(w2), False)), (M * E * 4, M * F * x.element_size()))
    args = _ptrs([y2, x2, *wargs]) + [r1, h, out.data_ptr()] + scratch + [
        M, E, F, float(eps), int(rms), *flags, *plans, dtype_code(x2), stream]
    with torch.cuda.device(x.device):
        kernel.launch(*args)
    del buf   # the scratch is freed once the launches are on the stream
    return out.reshape(*lead, E)
