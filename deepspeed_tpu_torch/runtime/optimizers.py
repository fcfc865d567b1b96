"""The optimizer: clip by global norm, then Adam/AdamW or their int8-moment
family, with optax's semantics.

Port of ``deepspeed_tpu/runtime/optimizers.py`` for the names this port
trains with; ``build_tx`` there chains ``optax.clip_by_global_norm`` with
the optimizer. Here one object does the whole update over lists of
tensors, in fp32:

- ``adam`` / ``adamw`` (:class:`Adam`, ``torch._foreach`` ops): clipping
  is ``g · min(1, c / ‖g‖)`` over the global norm;
  ``m ← b1 m + (1 − b1) g``, ``v ← b2 v + (1 − b2) g²``, bias-corrected by
  ``1 − b^t`` with ``eps`` outside the square root; AdamW decays decoupled:
  ``p ← p − lr(t) · (m̂ / (√v̂ + eps) + wd · p)``; Adam in L2 mode
  (``adam_w_mode: false`` with weight decay) adds ``wd · p`` to the clipped
  gradient instead;
- ``adam8bit`` / ``adamw8bit`` (:class:`~deepspeed_tpu_torch.ops.adam8bit.Adam8bit`):
  the same chain over int8/uint8 moments (``ops/adam8bit.py``), decoupled
  for ``adamw8bit`` or ``adam_w_mode``, L2 otherwise. The optimizer
  params' ``fused: true`` selects the one-kernel-per-leaf update
  (``csrc/adam8bit.cu``), under the JAX engine's conditions (no client
  optimizer, no offload, one device: the port refuses the first two and
  has only the third);
- ``lr`` is the schedule at the step count before its increment.

Every other optimizer name raises ``NotImplementedError`` (ROADMAP A3).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..ops.adam8bit import Adam8bit
from . import constants as C
from .config import Config, OptimizerConfig

TODO_A3 = "is not ported to the PyTorch engine yet (ROADMAP.md A3)"


class Adam:
    """Clip → Adam/AdamW over a fixed list of fp32 parameters. ``count``
    is optax's step count: it advances once per applied update, and a
    skipped (overflowed) fp16 step leaves it, the moments and the LR where
    they were."""

    def __init__(self, params: List[torch.Tensor], lr: Callable[[int], float], b1: float,
                 b2: float, eps: float, weight_decay: float, decoupled: bool, clip: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.decoupled, self.clip = weight_decay, decoupled, clip
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               grad_norm: torch.Tensor) -> None:
        """Apply one step in place. ``grads`` are fp32 and owned by the
        caller, which hands them over: they are clipped in place."""
        lr = float(self.lr(self.count))
        if self.clip > 0:
            torch._foreach_mul_(grads, torch.clamp(self.clip / grad_norm, max=1.0))
        wd = self.weight_decay
        if wd and not self.decoupled:
            torch._foreach_add_(grads, params, alpha=wd)
        b1, b2, t = self.b1, self.b2, self.count + 1
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1 - b2)
        denom = torch._foreach_div(self.exp_avg_sq, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(self.exp_avg, 1 - b1 ** t)
        torch._foreach_div_(step, denom)
        del denom
        if wd and self.decoupled:
            torch._foreach_add_(step, params, alpha=wd)
        torch._foreach_add_(params, step, alpha=-lr)
        self.count += 1


def build_optimizer(cfg: OptimizerConfig, params: List[torch.Tensor],
                    learning_rate: Optional[Callable[[int], float]] = None,
                    clip: float = 0.0, names: Optional[List[str]] = None):
    lr = learning_rate if learning_rate is not None else (lambda step: cfg.lr)
    name = cfg.type
    b1, b2 = cfg.betas
    if name in (C.ADAM8BIT_OPTIMIZER, C.ADAMW8BIT_OPTIMIZER):
        decoupled = name == C.ADAMW8BIT_OPTIMIZER or bool(cfg.extra.get("adam_w_mode", False))
        wd = cfg.weight_decay
        return Adam8bit(params, lr, b1, b2, cfg.eps, weight_decay=wd if decoupled else 0.0,
                        l2=0.0 if decoupled else wd, clip=clip,
                        fused=bool(cfg.extra.get("fused", False)), names=names)
    if name not in (C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
        if name in C.DEEPSPEED_OPTIMIZERS:
            raise NotImplementedError(f"optimizer {name!r} {TODO_A3}")
        raise ValueError(f"unknown optimizer {name!r}; valid: {C.DEEPSPEED_OPTIMIZERS}")
    adam_w_mode = cfg.extra.get("adam_w_mode", name == C.ADAMW_OPTIMIZER)
    return Adam(params, lr, b1, b2, cfg.eps, cfg.weight_decay,
                decoupled=bool(adam_w_mode) or cfg.weight_decay == 0.0, clip=clip)


def build_tx(config: Config, params: List[torch.Tensor],
             learning_rate: Optional[Callable[[int], float]] = None,
             names: Optional[List[str]] = None):
    """The whole update: clip (``gradient_clipping`` > 0) → the optimizer."""
    clip = config.gradient_clipping if config.gradient_clipping > 0 else 0.0
    return build_optimizer(config.optimizer, params, learning_rate, clip, names)
