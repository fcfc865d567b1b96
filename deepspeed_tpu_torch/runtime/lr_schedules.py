"""LR schedules: the reference's four (``LRRangeTest``, ``OneCycle``,
``WarmupLR``, ``WarmupDecayLR``) as plain functions of the step count that
return Python floats.

Port of ``deepspeed_tpu/runtime/lr_schedules.py``, which builds the same
functions over ``jnp`` arrays; the arithmetic is the same, in float64 on
the host, so reading the LR costs the device nothing.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

Schedule = Callable[[int], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Schedule:
    """Warm from min to max (log-spaced or linear), then hold."""
    warmup_num_steps = max(warmup_num_steps, 2)

    def sched(step: int) -> float:
        if step >= warmup_num_steps:
            return float(warmup_max_lr)
        if warmup_type == "log":
            lo = max(warmup_min_lr, 1e-10 * warmup_max_lr)   # guards min = 0
            factor = math.log(max(step, 1)) / math.log(warmup_num_steps)
            return lo * (warmup_max_lr / lo) ** _clip(factor, 0.0, 1.0)
        frac = _clip(step / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + frac * (warmup_max_lr - warmup_min_lr)

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    """Warmup, then linear decay to 0 at ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    warmup_num_steps = max(warmup_num_steps, 2)

    def sched(step: int) -> float:
        if step < warmup_num_steps:
            return warm(step)
        frac = (total_num_steps - step) / max(total_num_steps - warmup_num_steps, 1)
        return warmup_max_lr * _clip(frac, 0.0, 1.0)

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_) -> Schedule:
    """A triangular cycle, then an optional decay."""
    second = cycle_second_step_size or cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def sched(step: int) -> float:
        if step <= cycle_first_step_size:
            up = _clip(step / cycle_first_step_size, 0.0, 1.0)
            lr = cycle_min_lr + up * (cycle_max_lr - cycle_min_lr)
        else:
            down = _clip((step - cycle_first_step_size) / second, 0.0, 1.0)
            lr = cycle_max_lr - down * (cycle_max_lr - cycle_min_lr)
        if decay_step_size > 0 and step > total_cycle:
            decay_steps = max(step - total_cycle, 0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
        return lr

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_) -> Schedule:
    """An LR sweep for tuning."""

    def sched(step: int) -> float:
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return sched


_BUILDERS = {WARMUP_LR: warmup_lr, WARMUP_DECAY_LR: warmup_decay_lr, ONE_CYCLE: one_cycle,
             LR_RANGE_TEST: lr_range_test}


def get_lr_schedule(name: Optional[str], params: dict, base_lr: float = 1e-3) -> Schedule:
    """A schedule from config; no name means the constant ``base_lr``."""
    if name is None:
        return lambda step: float(base_lr)
    if name not in _BUILDERS:
        raise ValueError(f"unknown scheduler {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _BUILDERS[name](**params)
