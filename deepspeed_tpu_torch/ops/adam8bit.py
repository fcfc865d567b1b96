"""8-bit (quantized-state) Adam(W): the moments stored as int8/uint8 codes.

Port of ``deepspeed_tpu/ops/adam8bit.py`` (the unfused chain, :41-139) and
of its fused single-pass update (``ops/pallas/adam8bit_kernel.py:55
_kernel`` → ``csrc/adam8bit.cu``, with ``fused_apply_factory`` at :175 as
:meth:`Adam8bit.update` with ``fused=True``).

The state per parameter leaf: ``m`` as int8 codes with a symmetric absmax
scale per row (the last axis), ``r = √v`` as uint8 codes with an absmax
scale per row, and one fp32 ``(…, 1)`` scale of each per row: 2 bytes per
parameter plus 8 per row, where fp32 Adam keeps 8 per parameter. Storing
``√v`` halves v's dynamic range in log space, and it is what the
denominator consumes anyway.

Two formulas, each copied from its JAX source:

- :func:`_leaf_moments` (the optax chain, ``scale_by_adam8bit``):
  ``upd = (m / c1) / (sqrt(v / c2) + eps)``, codes from ``x / scale``;
- :func:`adam8bit_leaf_plain` (the fused kernel's arithmetic, which the
  CUDA kernel is held against): ``upd = (m·(1/c1)) / (r·(1/√c2) + eps)``,
  codes from ``m·(127/amax)`` and ``r·(255/amax)``. Both devices form
  ``1/√c2`` as one reciprocal of one square root.

The two agree to the last bits of fp32; a code can move by one where the
difference tips a round-half tie. The CUDA kernel updates the parameter,
the codes and the scales in place (the TPU kernel's
``input_output_aliases``) and reads its four step scalars ``[gscale, lr,
c1, c2]`` from a device tensor, so the clip scale taken from the on-device
gradient norm never travels to the host. It takes a table of leaves
(:class:`LeafTable`): the optimizer's parameters, codes and scales are
checked and planned once, and a step over every leaf is one launch per
:data:`MAX_LEAVES` leaves, with the gradients' pointers passed in the
launch itself.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ._build import FLOAT, INT, PTR, Kernel, stream_of

# one launch over a table of leaves (csrc/adam8bit.cu): the host table, its
# leaf count, its work items, the step scalars, b1, b2, 1 - b1, 1 - b2, eps,
# wd, l2, the stream
KERNEL = Kernel("adam8bit", "adam8bit_update", [PTR, INT, INT, PTR] + [FLOAT] * 7 + [PTR])

# rows longer than this take the unfused math, as the JAX package's fused
# path does (``adam8bit_kernel.py:_MAX_ROW``)
MAX_ROW = 100_000
# the kernel's blocks (csrc/adam8bit.cu): THREADS threads, each holding up
# to SLOTS chunks of CHUNK elements of its item's rows in registers
THREADS, SLOTS, CHUNK = 256, 4, 8
HELD = THREADS * SLOTS   # chunks an item holds: rows of up to 8192 elements
MAX_LEAVES = 500         # leaves one launch's table carries (a by-value kernel parameter)
_TABLE_COLS = 10         # int64s a leaf: g, p, mc, rc, scm, scr, R, C, first item, plan


# ----------------------------------------------------------------------
# quantizers and the optax-chain math
# ----------------------------------------------------------------------
def _quant_sym(x: torch.Tensor):
    """fp32 → (int8 codes, fp32 row scale), symmetric absmax per last axis."""
    amax = x.abs() if x.dim() == 0 else x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def _quant_pos(x: torch.Tensor):
    """non-negative fp32 → (uint8 codes, fp32 row scale)."""
    amax = x if x.dim() == 0 else x.amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 255.0, 1.0).float()
    codes = torch.clamp(torch.round(x / scale), 0, 255).to(torch.uint8)
    return codes, scale


def _leaf_moments(g, mc, rc, sc, *, b1, b2, c1, c2, eps):
    """The adam8bit per-leaf math of the optax chain: dequant → m/v update
    → bias-corrected Adam direction → requant. Returns ``(upd, mc', rc',
    {"m", "r"} scales)``."""
    m = b1 * (mc.float() * sc["m"]) + (1.0 - b1) * g
    r0 = rc.float() * sc["r"]
    v = b2 * (r0 * r0) + (1.0 - b2) * (g * g)
    upd = (m / c1) / (torch.sqrt(v / c2) + eps)
    mc2, ms = _quant_sym(m)
    rc2, rs = _quant_pos(torch.sqrt(v))
    return upd, mc2, rc2, {"m": ms, "r": rs}


# ----------------------------------------------------------------------
# the fused update: the kernel and its plain version
# ----------------------------------------------------------------------
def fused_leaf_supported(shape) -> bool:
    """A leaf the kernel takes: at least one axis and a last axis (a row) of
    1 … :data:`MAX_ROW` elements. 0-d leaves and longer rows take the
    unfused math (the JAX predicate's Mosaic block-tiling clause has no
    counterpart: the kernel takes any row count)."""
    return len(shape) >= 1 and 0 < shape[-1] <= MAX_ROW


def adam8bit_leaf_plain(g, p, mc, rc, scm, scr, scalars, *, b1, b2, eps, wd=0.0, l2=0.0):
    """The fused kernel's arithmetic in plain PyTorch, fp32, on ``(R, C)``
    rows with ``(R, 1)`` scales; ``scalars = [gscale, lr, c1, c2]`` (a
    4-float tensor). Returns ``(p', mc', rc', scm', scr')``, new tensors."""
    gscale, lr, c1, c2 = scalars.float().unbind()
    inv_c1 = 1.0 / c1
    rs_c2 = 1.0 / torch.sqrt(c2)
    g = g.float() * gscale
    if l2:
        g = g + l2 * p
    m = b1 * (mc.float() * scm) + (1.0 - b1) * g
    r0 = rc.float() * scr
    v = b2 * (r0 * r0) + (1.0 - b2) * (g * g)
    r = torch.sqrt(v)
    upd = (m * inv_c1) / (r * rs_c2 + eps)
    if wd:
        upd = upd + wd * p
    p_new = p - lr * upd
    # tensor / tensor: ``127.0 / t`` would be ``t.reciprocal() * 127``,
    # rounded twice, where the kernel divides once
    amax_m = m.abs().amax(-1, keepdim=True)
    inv_m = torch.where(amax_m > 0, amax_m.new_tensor(127.0) / amax_m, 1.0)
    mc_new = torch.clamp(torch.round(m * inv_m), -127, 127).to(torch.int8)
    scm_new = torch.where(amax_m > 0, amax_m * (1.0 / 127.0), 1.0)
    amax_r = r.amax(-1, keepdim=True)
    inv_r = torch.where(amax_r > 0, amax_r.new_tensor(255.0) / amax_r, 1.0)
    rc_new = torch.clamp(torch.round(r * inv_r), 0, 255).to(torch.uint8)
    scr_new = torch.where(amax_r > 0, amax_r * (1.0 / 255.0), 1.0)
    return p_new, mc_new, rc_new, scm_new, scr_new


def _check_state(p, mc, rc, scm, scr, device) -> None:
    """The tensors a leaf's update writes: ``(R, C)`` fp32 ``p``, int8
    ``mc``, uint8 ``rc`` and ``(R, 1)`` fp32 scales, contiguous, on
    ``device``, with 0 < C ≤ :data:`MAX_ROW`."""
    if p.dim() != 2:
        raise ValueError(f"adam8bit_update: p of shape {tuple(p.shape)}, expected (R, C) rows")
    R, C = p.shape
    want = {"p": (p, torch.float32, (R, C)), "mc": (mc, torch.int8, (R, C)),
            "rc": (rc, torch.uint8, (R, C)), "scm": (scm, torch.float32, (R, 1)),
            "scr": (scr, torch.float32, (R, 1))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"adam8bit_update: {name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"adam8bit_update: {name} must be a contiguous tensor on {device}")
    if not 0 < C <= MAX_ROW:
        raise ValueError(f"adam8bit_update: rows of {C} elements (the kernel takes 1..{MAX_ROW})")


def _check_scalars(scalars, device) -> None:
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (4,) or \
            scalars.device != device or not scalars.is_contiguous():
        raise ValueError(f"adam8bit_update: scalars are {scalars.dtype} {tuple(scalars.shape)} "
                         f"on {scalars.device}, expected a contiguous float32 (4,) on {device}")


def _check_leaf(g, p, mc, rc, scm, scr, scalars) -> None:
    _check_state(p, mc, rc, scm, scr, p.device)
    _check_scalars(scalars, p.device)
    if g.dtype != torch.float32 or g.shape != p.shape or g.device != p.device \
            or not g.is_contiguous():
        raise ValueError(f"adam8bit_update: g is {g.dtype} {tuple(g.shape)} on {g.device}, "
                         f"expected a contiguous float32 {tuple(p.shape)} on {p.device}")


class LeafPlan(NamedTuple):
    """How the kernel cuts a leaf into work items (one block each)."""
    rows: int      # whole rows an item (a row's codes need its whole absmax)
    threads: int   # threads of the block that take the item's chunks
    wide: bool     # rows of more than HELD chunks: one an item, in two passes

    def code(self, vec: bool) -> int:
        """The plan as the kernel reads it; ``vec``: 16- and 8-byte loads."""
        return self.rows | self.threads << 11 | int(self.wide) << 20 | int(vec) << 21


@functools.lru_cache(maxsize=None)
def leaf_plan(R: int, C: int) -> LeafPlan:
    """The work items of an ``(R, C)`` leaf: K whole rows an item, as many
    as the block's registers hold (K·⌈C/8⌉ ≤ :data:`HELD` chunks), taken by
    T threads in ⌈K·⌈C/8⌉ / THREADS⌉ sweeps. K and T make the largest share
    of the block's slots do work, then T·sweeps equal the chunk count where
    some K allows it (no thread idles in its last sweep), then K the
    largest. From shapes alone."""
    nc = -(-C // CHUNK)
    if nc > HELD:
        return LeafPlan(1, THREADS, True)
    best = None
    for k in range(1, min(R, HELD // nc) + 1):
        chunks = k * nc
        sweeps = -(-chunks // THREADS)
        threads = -(-chunks // sweeps)
        key = (chunks / (THREADS * sweeps), threads * sweeps == chunks, k)
        if best is None or key > best[0]:
            best = (key, LeafPlan(k, threads, False))
    return best[1]


class TableLaunch(NamedTuple):
    """One launch over a table: its leaves (by index), each leaf's first
    work item (items numbered from 0 within the launch), and its items."""
    leaves: range
    first: List[int]
    items: int


def plan_table(shapes) -> List[TableLaunch]:
    """The launches of a table over leaves of ``(R, C)`` ``shapes``, in
    order, :data:`MAX_LEAVES` a launch; each leaf's items follow the
    previous leaf's (:func:`leaf_plan`). From shapes alone."""
    out = []
    for start in range(0, len(shapes), MAX_LEAVES):
        leaves = range(start, min(len(shapes), start + MAX_LEAVES))
        first, n = [], 0
        for i in leaves:
            R, C = shapes[i]
            first.append(n)
            n += -(-R // leaf_plan(R, C).rows)
        out.append(TableLaunch(leaves, first, n))
    return out


class LeafTable:
    """The fused update over a fixed list of leaves, each ``(p, mc, rc, scm,
    scr)`` as ``(R, C)`` rows and ``(R, 1)`` scales: checked, planned and
    laid out once (the tensors never move: the optimizer copies state into
    them). :meth:`launch` updates every leaf in place with one kernel launch
    per :data:`MAX_LEAVES` leaves (:attr:`launches`), the launch carrying
    the table by value with the step's gradient pointers filled in: no copy
    to the card, no read back, nothing allocated. CPU tensors take
    :func:`adam8bit_leaf_plain` leaf by leaf."""

    def __init__(self, leaves):
        self.leaves = [tuple(t) for t in leaves]
        if not self.leaves:
            raise ValueError("adam8bit_update: a table of no leaves")
        self.device = self.leaves[0][0].device
        for leaf in self.leaves:
            _check_state(*leaf, self.device)
        self.shapes = [tuple(leaf[0].shape) for leaf in self.leaves]
        self.plans = [leaf_plan(R, C) for R, C in self.shapes]
        self.p_ptrs = [leaf[0].data_ptr() for leaf in self.leaves]
        self.launch_plan = plan_table(self.shapes)
        self.launches = len(self.launch_plan)
        self._tables = []   # a launch's host table: int64 rows of _TABLE_COLS
        for launch in self.launch_plan:
            tab = np.zeros((len(launch.leaves), _TABLE_COLS), np.int64)
            for row, (i, first) in enumerate(zip(launch.leaves, launch.first)):
                (p, mc, rc, scm, scr), (R, C), plan = self.leaves[i], self.shapes[i], self.plans[i]
                vec = (C % CHUNK == 0 and p.data_ptr() % 16 == 0 and mc.data_ptr() % 8 == 0
                       and rc.data_ptr() % 8 == 0)
                tab[row, 1:] = (p.data_ptr(), mc.data_ptr(), rc.data_ptr(), scm.data_ptr(),
                                scr.data_ptr(), R, C, first, plan.code(vec))
            self._tables.append(tab)

    def launch(self, grads, scalars, *, b1, b2, eps, wd=0.0, l2=0.0) -> None:
        """One step: ``grads[i]`` (fp32, leaf i's ``R·C`` elements in any
        leading shape; a non-contiguous one is copied) and ``scalars =
        [gscale, lr, c1, c2]`` (fp32, on the device)."""
        if len(grads) != len(self.leaves):
            raise ValueError(f"adam8bit_update: {len(grads)} gradients for a table of "
                             f"{len(self.leaves)} leaves")
        if not self.leaves[0][0].is_cuda:
            for g, (p, mc, rc, scm, scr) in zip(grads, self.leaves):
                outs = adam8bit_leaf_plain(g.reshape(p.shape), p, mc, rc, scm, scr, scalars,
                                           b1=b1, b2=b2, eps=eps, wd=wd, l2=l2)
                for dst, src in zip((p, mc, rc, scm, scr), outs):
                    dst.copy_(src)
            return
        _check_scalars(scalars, self.device)
        # a gradient may be a transposed view (the tied head's wte): its
        # contiguous copy stays referenced here until every launch is enqueued
        rows = [g if g.is_contiguous() else g.contiguous() for g in grads]
        for g, (R, C) in zip(rows, self.shapes):
            if g.dtype != torch.float32 or g.numel() != R * C or g.shape[-1] != C \
                    or g.device != self.device:
                raise ValueError(f"adam8bit_update: a gradient {g.dtype} {tuple(g.shape)} on "
                                 f"{g.device} for a leaf of {R} rows of {C} float32")
        ptrs = [g.data_ptr() for g in rows]
        with torch.cuda.device(self.device):
            stream = stream_of(rows[0])
            for launch, tab in zip(self.launch_plan, self._tables):
                tab[:, 0] = ptrs[launch.leaves.start:launch.leaves.stop]
                KERNEL.launch(tab.ctypes.data, len(launch.leaves), launch.items,
                              scalars.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2, eps, wd, l2, stream)


def adam8bit_update(g, p, mc, rc, scm, scr, scalars, *, b1, b2, eps, wd=0.0, l2=0.0) -> None:
    """One fused AdamW step on ``(R, C)`` rows, IN PLACE on ``p``, ``mc``,
    ``rc``, ``scm`` and ``scr`` (the TPU kernel aliases them to its
    outputs). ``g``, ``p`` fp32; ``mc`` int8; ``rc`` uint8; ``scm``/``scr``
    ``(R, 1)`` fp32; ``scalars = [gscale, lr, c1, c2]`` fp32 on the same
    device. A one-leaf :class:`LeafTable`: CUDA tensors launch the kernel
    once; CPU tensors take :func:`adam8bit_leaf_plain` and copy its results
    in."""
    _check_leaf(g, p, mc, rc, scm, scr, scalars)
    LeafTable([(p, mc, rc, scm, scr)]).launch([g], scalars, b1=b1, b2=b2, eps=eps, wd=wd, l2=l2)


# ----------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------
def _rows(t: torch.Tensor) -> torch.Tensor:
    """A leaf (or its ``(…, 1)`` scale) as a 2-D view of rows."""
    return t.reshape(-1, t.shape[-1])


def _bias_corrections(b1: float, b2: float, count: int):
    """``1 − b^t`` in fp32, as the JAX package forms them on the device."""
    return (float(torch.tensor(1.0) - torch.tensor(b1) ** float(count)),
            float(torch.tensor(1.0) - torch.tensor(b2) ** float(count)))


class Adam8bit:
    """Clip → [L2] → int8-moment Adam → [AdamW decay] → lr over a fixed
    list of fp32 parameters (the JAX ``build_tx`` chain for ``adam8bit`` /
    ``adamw8bit``), in place.

    ``fused=False`` runs the optax chain's math per leaf
    (:func:`_leaf_moments`); ``fused=True`` updates every leaf
    :func:`fused_leaf_supported` takes through one :class:`LeafTable` built
    here (:attr:`launches_per_step` launches a step), and the rest on the
    unfused math, as the JAX fused apply does. ``count``
    advances once per applied update; the engine does not call
    :meth:`update` on a skipped fp16 step, so the count, codes, scales and
    LR stay where they were."""

    def __init__(self, params: List[torch.Tensor], lr: Callable[[int], float], b1: float,
                 b2: float, eps: float, weight_decay: float = 0.0, l2: float = 0.0,
                 clip: float = 0.0, fused: bool = False, names: Optional[List[str]] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.l2, self.clip, self.fused = weight_decay, l2, clip, fused
        self.names = list(names) if names is not None else [str(i) for i in range(len(params))]
        self.count = 0
        self.m_codes = [torch.zeros_like(p, dtype=torch.int8) for p in params]
        self.r_codes = [torch.zeros_like(p, dtype=torch.uint8) for p in params]
        self.scales = []
        for p in params:
            shape = p.shape[:-1] + (1,) if p.dim() else ()
            self.scales.append({"m": torch.ones(shape, dtype=torch.float32, device=p.device),
                                "r": torch.ones(shape, dtype=torch.float32, device=p.device)})
        self._table_idx = [i for i, p in enumerate(params)
                           if fused and fused_leaf_supported(p.shape)]
        self._rest_idx = [i for i, p in enumerate(params)
                          if fused and not fused_leaf_supported(p.shape)]
        self._table = self._leaf_table(params) if self._table_idx else None
        self.launches_per_step = self._table.launches if self._table else 0

    def _leaf_table(self, params) -> LeafTable:
        return LeafTable([(_rows(params[i]), _rows(self.m_codes[i]), _rows(self.r_codes[i]),
                           _rows(self.scales[i]["m"]), _rows(self.scales[i]["r"]))
                          for i in self._table_idx])

    def state_bytes(self) -> int:
        """Bytes of the moment state: the codes and the per-row scales."""
        return sum(t.numel() * t.element_size() for t in
                   [*self.m_codes, *self.r_codes, *(s[k] for s in self.scales for k in "mr")])

    def state_dict(self) -> dict:
        """``{"count", "m_codes", "r_codes", "scales"}`` keyed by parameter
        name (the layout ``models/convert.adam8bit_state_from_jax`` makes)."""
        return {"count": self.count, "m_codes": dict(zip(self.names, self.m_codes)),
                "r_codes": dict(zip(self.names, self.r_codes)),
                "scales": dict(zip(self.names, self.scales))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in (shapes and dtypes must match)."""
        for i, name in enumerate(self.names):
            for dst, src in ((self.m_codes[i], state["m_codes"][name]),
                             (self.r_codes[i], state["r_codes"][name]),
                             (self.scales[i]["m"], state["scales"][name]["m"]),
                             (self.scales[i]["r"], state["scales"][name]["r"])):
                src = torch.as_tensor(src)
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(f"{name}: state {src.dtype} {tuple(src.shape)}, expected "
                                     f"{dst.dtype} {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])

    def _gscale(self, grad_norm: torch.Tensor) -> torch.Tensor:
        """The clip scale as a 0-d device tensor (1 without clipping)."""
        if self.clip > 0:
            return torch.where(grad_norm < self.clip, 1.0, self.clip / grad_norm).float()
        return torch.ones((), dtype=torch.float32, device=grad_norm.device)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               grad_norm: torch.Tensor) -> None:
        """Apply one step in place. ``grads`` are fp32 and owned by the
        caller, which hands them over (the unfused path scales them in
        place)."""
        lr = float(self.lr(self.count))
        c1, c2 = _bias_corrections(self.b1, self.b2, self.count + 1)
        if self.fused:
            self._fused_update(params, grads, grad_norm, lr, c1, c2)
        else:
            self._unfused_update(params, grads, grad_norm, lr, c1, c2)
        self.count += 1

    def _unfused_update(self, params, grads, grad_norm, lr, c1, c2) -> None:
        if self.clip > 0:
            torch._foreach_mul_(grads, torch.clamp(self.clip / grad_norm, max=1.0))
        if self.l2:
            torch._foreach_add_(grads, params, alpha=self.l2)
        for i, (p, g) in enumerate(zip(params, grads)):
            self._leaf_unfused(i, p, g, lr, c1, c2)

    def _leaf_unfused(self, i, p, g, lr, c1, c2) -> None:
        upd, mc, rc, sc = _leaf_moments(g, self.m_codes[i], self.r_codes[i], self.scales[i],
                                        b1=self.b1, b2=self.b2, c1=c1, c2=c2, eps=self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * p
        p.sub_(lr * upd)
        self.m_codes[i].copy_(mc)
        self.r_codes[i].copy_(rc)
        self.scales[i]["m"].copy_(sc["m"])
        self.scales[i]["r"].copy_(sc["r"])

    def _fused_update(self, params, grads, grad_norm, lr, c1, c2) -> None:
        gscale = self._gscale(grad_norm)
        # fills, not a host copy: a copy from host memory would wait for the
        # device to drain the step's queue
        scalars = torch.stack([gscale, gscale.new_full((), lr), gscale.new_full((), c1),
                               gscale.new_full((), c2)])
        if self._table is not None:
            if [params[i].data_ptr() for i in self._table_idx] != self._table.p_ptrs:
                self._table = self._leaf_table(params)   # other parameter tensors: a new table
            self._table.launch([grads[i] for i in self._table_idx], scalars, b1=self.b1,
                               b2=self.b2, eps=self.eps, wd=self.weight_decay, l2=self.l2)
        for i in self._rest_idx:
            # 0-d leaves and oversize rows: the unfused math (the JAX fused
            # apply's fallback), on this leaf alone
            p = params[i]
            g = grads[i] * gscale
            if self.l2:
                g = g + self.l2 * p
            self._leaf_unfused(i, p, g, lr, c1, c2)
