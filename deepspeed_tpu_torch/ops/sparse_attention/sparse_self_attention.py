"""Block-sparse attention execution.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.
Two paths, under the JAX package's names, so that user code ports by
renaming the import:

- ``impl="mask"`` (the default): expand the block layout to an element mask
  and run dense attention (``ops/attention.py`` :func:`dense_attention`, the
  port of the JAX ``_jnp_attention``). The same flops as dense attention; a
  query block with no enabled key block gets the mean of v over all keys
  (every score at ``finfo.min``, a uniform softmax).
- ``impl="pallas"``: the block-sparse kernels, which visit only the enabled
  key blocks of each query block. The TPU kernel ``_pallas_kernel`` (:59)
  becomes ``csrc/sparse_attention.cu`` (see its header for the designs and
  bounds); CUDA tensors launch a kernel, CPU tensors run the plain version
  (:func:`sparse_attention_plain`), and a CUDA tensor never falls back. The
  function is the TPU kernel's: softmax(q kᵀ·scale) v over the enabled
  blocks, with scores, the online softmax and ``p @ v`` in fp32 (p is not
  cast to v's dtype, as the mask path casts it) and one cast at the end; a
  query block with no enabled key block writes zeros. Two routes:

  - bf16 runs ``sparse_fwd_sm90_kernel`` on the tensor cores. It follows a
    plan built on the host once per layout (:func:`build_plan`): work items
    of 64 query rows that walk the union of their query blocks' LUT rows in
    key tiles of 64 keys, masking for each query block what its own row
    lacks; a wide union is split over several items whose fp32 states a
    second kernel (``sparse_merge_kernel``) merges by lse. p enters the
    tensor cores as a bf16 hi + lo pair, so ``p @ v`` keeps fp32 p's grade.
    :func:`sparse_attention_tiled_plain` follows the same plan in plain
    PyTorch, for the tests and the card's checks.
  - fp32 runs the CUDA-core ``sparse_fwd_kernel`` over the LUT
    (:func:`_build_lut`), the card's exact fp32 reference, with a launch
    counter of its own (:data:`KERNEL_FP32`).

  The kernels take D in :data:`HEAD_DIMS` and block in :data:`BLOCKS`;
  other shapes and dtypes raise on the card.

The JAX package defines no backward for the kernel: here it is an
``autograd.Function`` whose backward raises ``NotImplementedError`` (ROADMAP
B10), so a caller that needs gradients learns it instead of getting a
tensor with no gradient. The mask path is differentiable through torch's
autograd. Shapes are ``(B, S, H, D)``; layouts ``(H, S/block, S/block)``.
:class:`SparseSelfAttention` caches each sequence length's layout, and its
LUT, counts and plan on the device per (sequence length, device); the
functional :func:`sparse_attention` builds them per call, as the JAX
function builds its LUT per call.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._build import FLOAT, INT, PTR, Kernel, LibraryCounts, check_operands, stream_of
from ..attention import dense_attention
from .sparsity_config import SparsityConfig

# q k v out, items n_items units merges n_merges ws n_slots, B S H D block, scale causal stream
KERNEL = Kernel("sparse_attention", "sparse_attention_sm90_fwd",
                [PTR] * 4 + [PTR, INT, PTR, PTR, INT, PTR, INT] + [INT] * 5 + [FLOAT, INT, PTR])
# q k v out lut counts, B S H D block max_nnz, scale causal stream (fp32 only)
KERNEL_FP32 = Kernel("sparse_attention", "sparse_attention_fwd",
                     [PTR] * 6 + [INT] * 6 + [FLOAT, INT, PTR])
# the kernels behind the two C entries, in the order their library counts them
KERNELS = ("sparse_fwd_sm90_kernel", "sparse_merge_kernel", "sparse_fwd_kernel")
COUNTS = LibraryCounts("sparse_attention", "sparse_attention_launched", KERNELS)
HEAD_DIMS = (64, 128)          # instantiated in CUDA
BLOCKS = (16, 32, 64, 128)
IMPLS = ("mask", "pallas")

TILE = 64       # query rows of a work item, keys of a key tile (csrc kTile)
CAP = 8         # key tiles per work item at most (csrc kCap)
ROW_BITS = 24   # a unit word: its first key row | enable bits << ROW_BITS
LOG2E = 1.4426950408889634


def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """(H, nb, nb) block layout → (H, S, S) bool element mask."""
    return np.kron(layout, np.ones((block, block), dtype=bool))


def _build_lut(layout: np.ndarray):
    """Per (head, q-block): padded list of enabled k-block indices + count.

    As the JAX package builds it: padding repeats the first enabled block
    (the kernel visits only the first ``count`` entries)."""
    H, nq, nk = layout.shape
    max_nnz = int(layout.sum(axis=2).max())
    lut = np.zeros((H, nq, max_nnz), dtype=np.int32)
    counts = np.zeros((H, nq), dtype=np.int32)
    for h in range(H):
        for qi in range(nq):
            idx = np.nonzero(layout[h, qi])[0]
            counts[h, qi] = len(idx)
            if len(idx):
                lut[h, qi, :len(idx)] = idx
                lut[h, qi, len(idx):] = idx[0]
    return lut, counts, max_nnz


def lut_on(layout: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_build_lut` as int32 tensors on ``device``: ``lut (H, nq,
    max(max_nnz, 1))`` and ``counts (H, nq)`` (an all-empty layout keeps one
    LUT column, which no count reaches)."""
    lut, counts, _ = _build_lut(np.asarray(layout))
    if lut.shape[2] == 0:
        lut = np.zeros(lut.shape[:2] + (1,), dtype=np.int32)
    return torch.from_numpy(lut).to(device), torch.from_numpy(counts).to(device)


class SparsePlan(NamedTuple):
    """The tensor-core kernel's work, built on the host from a layout.

    A tile is 64 query rows of one head (``ht = h * n_tiles + tile``). Its
    units are the key pieces its query blocks enable, in key order: one
    per enabled key block at block <= 64, two of 64 keys at block 128. A
    unit word is its first key row | the bits of the tile's query blocks
    (slot i: rows [64 tile + i·block, + block)) that enable it, << 24.
    Key tiles take 64 / unit-rows units each; a tile's last key tile is
    filled with copies of its last unit whose bits are 0. With ``causal``,
    units wholly past the tile's last row are left out. A tile of more
    than ``cap`` key tiles becomes as many even pieces; each piece writes
    its fp32 state to a workspace slot, and a merge entry names the slots.

    ``items`` (n_items, 4) int32: ht, first unit, key tiles, slot (-1: the
    item writes the output), widest first. ``units`` (n_units,) int32.
    ``merges`` (n_merges, 4) int32: ht, first slot, pieces, 0."""
    block: int
    causal: bool
    seq_len: int
    items: np.ndarray
    units: np.ndarray
    merges: np.ndarray
    n_slots: int


def build_plan(layout: np.ndarray, block: int, causal: bool, cap: int = CAP) -> SparsePlan:
    """The :class:`SparsePlan` of a ``(H, nb, nb)`` layout (nonzero: enabled)."""
    layout = np.asarray(layout) != 0
    H, nq, _ = layout.shape
    S = nq * block
    ku = min(block, TILE)
    per_kt = TILE // ku                  # units per key tile
    n_tiles = -(-S // TILE)
    items, units, merges = [], [], []
    n_units = n_slots = 0
    for h in range(H):
        for ti in range(n_tiles):
            r0, r1 = ti * TILE, min(S, (ti + 1) * TILE)
            if block <= TILE:
                rows_of = layout[h, r0 // block:-(-r1 // block)]   # the tile's query blocks
                bits = (rows_of.astype(np.int64) << np.arange(len(rows_of))[:, None]).sum(0)
                kb = np.nonzero(bits)[0]
                rows, bits = kb * block, bits[kb]
            else:
                kb = np.nonzero(layout[h, r0 // block])[0]
                rows = (kb[:, None] * block + np.arange(0, block, TILE)[None]).ravel()
                bits = np.ones_like(rows)
            if causal:
                rows, bits = rows[rows <= r1 - 1], bits[rows <= r1 - 1]
            words = rows | (bits << ROW_BITS)
            if len(words) % per_kt:
                spare = np.full(per_kt - len(words) % per_kt, rows[-1])
                words = np.concatenate([words, spare])
            n_kt = len(words) // per_kt
            n_p = max(1, -(-n_kt // cap))
            ht, off = h * n_tiles + ti, n_units
            for i in range(n_p):
                size = n_kt // n_p + (i < n_kt % n_p)
                items.append((ht, off, size, n_slots + i if n_p > 1 else -1))
                off += size * per_kt
            if n_p > 1:
                merges.append((ht, n_slots, n_p, 0))
                n_slots += n_p
            units.append(words)
            n_units += len(words)
    items = np.asarray(items, dtype=np.int32).reshape(-1, 4)
    items = items[np.argsort(-items[:, 2], kind="stable")]
    units = np.concatenate(units).astype(np.int32) if n_units else np.zeros(1, np.int32)
    merges = np.asarray(merges, dtype=np.int32).reshape(-1, 4)
    return SparsePlan(block, causal, S, items, units, merges, n_slots)


class DevicePlan(NamedTuple):
    """A layout's LUT, counts (:func:`lut_on`) and :class:`SparsePlan`, the
    arrays on one device; the sizes stay host ints."""
    plan: SparsePlan
    lut: torch.Tensor
    counts: torch.Tensor
    items: torch.Tensor
    units: torch.Tensor
    merges: torch.Tensor     # at least one row; ``plan.merges`` says how many count

    @property
    def block(self) -> int:
        return self.plan.block

    @property
    def causal(self) -> bool:
        return self.plan.causal


def plan_on(layout: np.ndarray, block: int, causal: bool, device, lut=None) -> DevicePlan:
    """Everything a call needs for ``layout`` on ``device``, built once on
    the host (``lut``: the :func:`lut_on` pair, if already built)."""
    layout = np.asarray(layout)
    plan = build_plan(layout, block, causal)
    lut, counts = lut if lut is not None else lut_on(layout, device)
    merges = plan.merges if len(plan.merges) else np.zeros((1, 4), np.int32)
    return DevicePlan(plan, lut, counts, torch.from_numpy(plan.items).to(device),
                      torch.from_numpy(plan.units).to(device),
                      torch.from_numpy(merges).to(device))


def sparse_workspace(B: int, D: int, n_slots: int, device) -> Optional[torch.Tensor]:
    """The split items' fp32 states: per (batch, slot) 64 rows of acc (D),
    then the rows' m and l. None when no tile is split."""
    if not n_slots:
        return None
    return torch.empty((B, n_slots, TILE * (D + 2)), dtype=torch.float32, device=device)


def _block_mask(lut: torch.Tensor, counts: torch.Tensor, nk: int) -> torch.Tensor:
    """The (H, nq, nk) bool block mask the first ``count`` LUT entries enable."""
    valid = torch.arange(lut.shape[2], device=lut.device) < counts[..., None]
    hits = torch.zeros(lut.shape[:2] + (nk,), dtype=torch.int32, device=lut.device)
    return hits.scatter_add_(2, lut.long(), valid.int()) > 0


def sparse_attention_plain(q, k, v, lut, counts, block: int, causal: bool, scale: float):
    """The kernel's function in plain PyTorch, over the LUT's blocks: scores
    of ``q·scale`` (fp32) and k in fp32, masked outside the enabled blocks
    (and, with ``causal``, where k_pos > q_pos), softmax with the TPU
    kernel's guards (max −inf → 0, sum 0 → 1: an empty row is 0), ``p @ v``
    in fp32, one cast to q's dtype. Returns ``(B, S, H, D)``."""
    B, S, H, D = q.shape
    nb = S // block
    keep = _block_mask(lut, counts, nb)
    keep = keep.repeat_interleave(block, 1).repeat_interleave(block, 2)   # (H, S, S)
    if causal:
        pos = torch.arange(S, device=q.device)
        keep = keep & (pos[:, None] >= pos[None, :])
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) / l.permute(0, 2, 1, 3)
    return out.to(q.dtype)


def sparse_attention_tiled_plain(q, k, v, plan: SparsePlan, scale: float):
    """:func:`sparse_attention_plain`'s function computed the way the
    tensor-core kernel computes it, in plain PyTorch: item by item over the
    plan's key units, scores ``(q k) · scale · log2(e)`` in fp32 masked where
    a row's query block does not enable a unit (and past the diagonal),
    each item's fp32 state (m, l, acc) in the log2 domain, items that own
    their tile divided out, split tiles merged by lse in slot order:
    M = max m_i, out = sum acc_i 2^(m_i - M) / sum l_i 2^(m_i - M), zeros
    where nothing is enabled. p stays fp32 (the kernel's hi + lo pair is
    within 2^-18 of it). For the tests and the card's checks."""
    B, S, H, D = q.shape
    block = plan.block
    ku, n_tiles = min(block, TILE), -(-S // TILE)
    per_kt = TILE // ku
    pad = n_tiles * TILE - S
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, pad))
    out = torch.zeros((B, n_tiles * TILE, H, D), dtype=torch.float32, device=q.device)
    dev = q.device
    pos = torch.arange(TILE, device=dev)
    slot_of_row = pos // block if block < TILE else torch.zeros_like(pos)
    states = {}
    for ht, u0, n_kt, slot in plan.items.tolist():
        h, ti = divmod(ht, n_tiles)
        r0 = ti * TILE
        words = torch.from_numpy(plan.units[u0:u0 + n_kt * per_kt].astype(np.int64)).to(dev)
        keys = ((words & ((1 << ROW_BITS) - 1))[:, None] + torch.arange(ku, device=dev)).ravel()
        bits = (words >> ROW_BITS).repeat_interleave(ku)
        s = torch.einsum("brd,bcd->brc", qf[:, r0:r0 + TILE, h], k[:, keys, h].float())
        s = s * (scale * LOG2E)
        keep = ((bits[None, :] >> slot_of_row[:, None]) & 1) == 1
        if plan.causal:
            keep = keep & (keys[None, :] <= r0 + pos[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        if n_kt:
            m = s.amax(-1)
        else:
            m = torch.full((B, TILE), float("-inf"), device=dev)
        p = torch.exp2(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
        l, acc = p.sum(-1), p @ v[:, keys, h].float()
        if slot < 0:
            out[:, r0:r0 + TILE, h] = acc / torch.where(l == 0, 1.0, l)[..., None]
        else:
            states[slot] = (m, l, acc)
    for ht, slot0, n_p, _ in plan.merges.tolist():
        h, ti = divmod(ht, n_tiles)
        parts = [states[slot0 + i] for i in range(n_p)]
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        num = torch.zeros((B, TILE, D), device=dev)
        den = torch.zeros((B, TILE), device=dev)
        for m, l, acc in parts:
            w = torch.where(m == float("-inf"), 0.0, torch.exp2(m - M))
            num, den = num + acc * w[..., None], den + l * w
        out[:, ti * TILE:(ti + 1) * TILE, h] = torch.where(
            den[..., None] > 0, num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out[:, :S].to(q.dtype)


def kernel_launches() -> dict:
    """Launches so far of each kernel of :data:`KERNELS`, as the C library
    counts them where it launches them (graph replays included). Loads (and
    builds) the library."""
    return COUNTS.read()


def sparse_attention_kernel(q, k, v, dplan: DevicePlan, scale: float):
    """The block-sparse forward: on CUDA tensors the tensor-core kernel
    (bf16, :data:`KERNEL`, one launch a call) or the CUDA-core kernel (fp32,
    :data:`KERNEL_FP32`); :func:`sparse_attention_plain` on CPU tensors.
    ``dplan`` from :func:`plan_on` on q's device. The launch reads nothing
    back from the card: the plan's sizes are host ints."""
    block, causal = dplan.block, dplan.causal
    if not q.is_cuda:
        return sparse_attention_plain(q, k, v, dplan.lut, dplan.counts, block, causal, scale)
    B, S, H, D = q.shape
    if D not in HEAD_DIMS or block not in BLOCKS:
        raise ValueError(f"sparse attention kernel: head dim {D} (takes {HEAD_DIMS}) and block "
                         f"{block} (takes {BLOCKS})")
    if S != dplan.plan.seq_len or tuple(dplan.counts.shape) != (H, S // block):
        raise ValueError(f"sparse attention kernel: a plan for S={dplan.plan.seq_len}, "
                         f"counts {tuple(dplan.counts.shape)}, for q {tuple(q.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        plan = dplan.plan
        if plan.items[0, 2] > CAP:   # widest first: the kernel stages at most CAP key tiles
            raise ValueError(f"sparse attention kernel: a plan item of {plan.items[0, 2]} key "
                             f"tiles (the kernel takes {CAP})")
        check_operands(q, k, v, dplan.items, dplan.units, dplan.merges,
                       dtypes=[q.dtype] * 3 + [torch.int32] * 3)
        ws = sparse_workspace(B, D, plan.n_slots, q.device)
        with torch.cuda.device(q.device):
            KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          dplan.items.data_ptr(), len(plan.items), dplan.units.data_ptr(),
                          dplan.merges.data_ptr(), len(plan.merges),
                          None if ws is None else ws.data_ptr(), plan.n_slots, B, S, H, D,
                          block, scale, int(causal), stream_of(q))
    elif q.dtype == torch.float32:
        lut, counts = dplan.lut.contiguous(), dplan.counts.contiguous()
        check_operands(q, k, v, lut, counts, dtypes=[q.dtype] * 3 + [torch.int32] * 2)
        with torch.cuda.device(q.device):
            KERNEL_FP32.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lut.data_ptr(), counts.data_ptr(), B, S, H, D, block,
                               lut.shape[2], scale, int(causal), stream_of(q))
    else:
        raise TypeError(f"sparse attention kernel takes bfloat16 or float32, not {q.dtype}")
    return out


class _SparseAttention(torch.autograd.Function):
    """The kernel's forward; no backward (the JAX package defines none)."""

    @staticmethod
    def forward(ctx, q, k, v, dplan, scale):
        return sparse_attention_kernel(q, k, v, dplan, scale)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "block-sparse attention (impl='pallas') has no backward: ROADMAP B10 "
            "(the JAX package defines none either); use impl='mask' for gradients")


def _check(q, k, v, layout, block):
    B, S, H, D = q.shape
    nb = S // block
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout shape {layout.shape} != {(H, nb, nb)}")
    if S % block:
        raise ValueError(f"seq_len {S} not divisible by block {block}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"sparse attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout: np.ndarray, block: int, *,
                     causal: bool = False, scale: Optional[float] = None,
                     impl: str = "mask") -> torch.Tensor:
    """Block-sparse attention; shapes ``(B, S, H, D)``; layout ``(H, nb, nb)``."""
    layout = np.asarray(layout)
    _check(q, k, v, layout, block)
    D = q.shape[3]
    if scale is None:
        scale = D ** -0.5
    if impl == "mask":
        mask = torch.from_numpy(layout_to_dense_mask(layout, block) != 0).to(q.device)[None]
        return dense_attention(q, k, v, causal=causal, mask=mask, scale=scale)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    dplan = plan_on(layout, block, causal, q.device)
    return _SparseAttention.apply(q, k, v, dplan, float(scale))


class SparseSelfAttention:
    """Module-shaped wrapper (the JAX package's): holds a
    :class:`SparsityConfig`, builds each sequence length's layout once, and
    under ``impl="pallas"`` its LUT, counts and plan once per device."""

    def __init__(self, sparsity_config: SparsityConfig, causal: bool = False,
                 impl: str = "mask"):
        self.sparsity_config = sparsity_config
        self.causal = causal
        self.impl = impl
        self._layouts: dict[int, np.ndarray] = {}
        self._luts: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._plans: dict[tuple, DevicePlan] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def get_lut(self, seq_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = (seq_len, torch.device(device))
        if key not in self._luts:
            self._luts[key] = lut_on(self.get_layout(seq_len), device)
        return self._luts[key]

    def get_plan(self, seq_len: int, device) -> DevicePlan:
        key = (seq_len, torch.device(device))
        if key not in self._plans:
            self._plans[key] = plan_on(self.get_layout(seq_len), self.sparsity_config.block,
                                       self.causal, device, self.get_lut(seq_len, device))
        return self._plans[key]

    def __call__(self, q, k, v):
        S = q.shape[1]
        block = self.sparsity_config.block
        if self.impl != "pallas":
            return sparse_attention(q, k, v, self.get_layout(S), block,
                                    causal=self.causal, impl=self.impl)
        _check(q, k, v, self.get_layout(S), block)
        return _SparseAttention.apply(q, k, v, self.get_plan(S, q.device), q.shape[3] ** -0.5)
