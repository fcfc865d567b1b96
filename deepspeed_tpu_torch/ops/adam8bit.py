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
gradient norm never travels to the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ._build import FLOAT, INT, PTR, Kernel, stream_of

KERNEL = Kernel("adam8bit", "adam8bit_update",
                [PTR] * 7 + [INT, INT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT, FLOAT, PTR])

# rows longer than this take the unfused math, as the JAX package's fused
# path does (``adam8bit_kernel.py:_MAX_ROW``)
MAX_ROW = 100_000


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


def _check_leaf(g, p, mc, rc, scm, scr, scalars) -> None:
    R, C = p.shape
    want = {"g": (g, torch.float32, (R, C)), "p": (p, torch.float32, (R, C)),
            "mc": (mc, torch.int8, (R, C)), "rc": (rc, torch.uint8, (R, C)),
            "scm": (scm, torch.float32, (R, 1)), "scr": (scr, torch.float32, (R, 1)),
            "scalars": (scalars, torch.float32, (4,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"adam8bit_update: {name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"adam8bit_update: {name} must be a contiguous tensor on {p.device}")
    if not 0 < C <= MAX_ROW:
        raise ValueError(f"adam8bit_update: rows of {C} elements (the kernel takes 1..{MAX_ROW})")


def adam8bit_update(g, p, mc, rc, scm, scr, scalars, *, b1, b2, eps, wd=0.0, l2=0.0) -> None:
    """One fused AdamW step on ``(R, C)`` rows, IN PLACE on ``p``, ``mc``,
    ``rc``, ``scm`` and ``scr`` (the TPU kernel aliases them to its
    outputs). ``g``, ``p`` fp32; ``mc`` int8; ``rc`` uint8; ``scm``/``scr``
    ``(R, 1)`` fp32; ``scalars = [gscale, lr, c1, c2]`` fp32 on the same
    device. CUDA tensors launch the kernel; CPU tensors take
    :func:`adam8bit_leaf_plain` and copy its results in."""
    _check_leaf(g, p, mc, rc, scm, scr, scalars)
    if not p.is_cuda:
        outs = adam8bit_leaf_plain(g, p, mc, rc, scm, scr, scalars, b1=b1, b2=b2, eps=eps,
                                   wd=wd, l2=l2)
        for dst, src in zip((p, mc, rc, scm, scr), outs):
            dst.copy_(src)
        return
    R, C = p.shape
    with torch.cuda.device(p.device):
        KERNEL.launch(g.data_ptr(), p.data_ptr(), mc.data_ptr(), rc.data_ptr(), scm.data_ptr(),
                      scr.data_ptr(), scalars.data_ptr(), R, C, b1, b2, 1.0 - b1, 1.0 - b2, eps,
                      wd, l2, stream_of(p))


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
    (:func:`_leaf_moments`); ``fused=True`` runs one kernel launch per leaf
    (:func:`adam8bit_update`), with the leaves :func:`fused_leaf_supported`
    rejects on the unfused math, as the JAX fused apply does. ``count``
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
        self.launches_per_step = sum(fused and fused_leaf_supported(p.shape) for p in params)

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
        for i, (p, g) in enumerate(zip(params, grads)):
            if fused_leaf_supported(p.shape):
                sc = self.scales[i]
                # a gradient may be a transposed view (the tied head's wte)
                adam8bit_update(_rows(g.contiguous()), _rows(p), _rows(self.m_codes[i]),
                                _rows(self.r_codes[i]), _rows(sc["m"]), _rows(sc["r"]), scalars,
                                b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay,
                                l2=self.l2)
                continue
            # 0-d leaves and oversize rows: the unfused math (the JAX fused
            # apply's fallback), on this leaf alone
            g = g * gscale
            if self.l2:
                g = g + self.l2 * p
            self._leaf_unfused(i, p, g, lr, c1, c2)

