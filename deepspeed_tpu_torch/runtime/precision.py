"""fp16 dynamic loss scaling (reference ``runtime/fp16/loss_scaler.py``).

Port of ``deepspeed_tpu/runtime/precision.py``: the same state machine
(grow ×2 after ``loss_scale_window`` clean steps; on overflow spend one
unit of hysteresis, and shrink ×0.5, not below ``min_loss_scale``, when it
runs out). The JAX package steps it inside the compiled train step; the
port steps it on the host, where the engine already reads each step's
overflow flag to count skipped steps. bf16 and fp32 training need no
scaling: the state stays at scale 1.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from .config import Float16Config


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    scale: float          # the loss multiplier
    good_steps: int       # consecutive overflow-free steps
    hysteresis: int       # overflows still tolerated before a shrink


def init_loss_scale(cfg: Float16Config) -> LossScaleState:
    if not cfg.enabled:
        return LossScaleState(scale=1.0, good_steps=0, hysteresis=0)
    scale = cfg.loss_scale if cfg.loss_scale > 0 else float(2 ** cfg.initial_scale_power)
    return LossScaleState(scale=float(scale), good_steps=0, hysteresis=cfg.hysteresis)


def grads_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor on the grads' device: every element finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_loss_scale(state: LossScaleState, finite: bool, cfg: Float16Config) -> LossScaleState:
    """One transition of the dynamic scaler; a static scale never moves."""
    if not cfg.enabled or cfg.loss_scale > 0:
        return state
    if finite:
        grew = state.good_steps + 1 >= cfg.loss_scale_window
        return LossScaleState(scale=state.scale * 2.0 if grew else state.scale,
                              good_steps=0 if grew else state.good_steps + 1,
                              hysteresis=cfg.hysteresis)
    hysteresis = max(state.hysteresis - 1, 0)
    shrink = hysteresis == 0
    return LossScaleState(
        scale=max(state.scale * 0.5, cfg.min_loss_scale) if shrink else state.scale,
        good_steps=0, hysteresis=cfg.hysteresis if shrink else hysteresis)
