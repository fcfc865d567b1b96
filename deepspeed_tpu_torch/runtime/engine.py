"""The training engine on one device.

Port of ``deepspeed_tpu/runtime/engine.py`` (``Engine``) for one card, with
the same user surface: ``initialize(model=..., config=...)``, then
``init_params()``, then ``train_batch(batch)`` (one optimizer step over
``gradient_accumulation_steps`` micro-batches), ``train_batches``,
``eval_batch`` and the DeepSpeed three-call path ``forward`` → ``backward``
→ ``step``.

Where the JAX engine compiles one program per step, this one runs the step
eagerly: a forward and ``torch.autograd.grad`` per micro-batch, the
gradients accumulated in ``data_types.grad_accum_dtype`` buffers, then the
unscale, the global norm, clipping and the update (``runtime/optimizers.py``:
Adam/AdamW with ``torch._foreach`` ops, or the int8-moment ``adam8bit`` /
``adamw8bit`` family, unfused or one fused kernel launch per leaf) over
fp32 master weights. The model computes in its config's dtype (bf16 by default): it casts
the fp32 masters at use, as the JAX models do. ``train_batch`` returns the
mean loss as a 0-d tensor on the device and reads nothing back to the host,
except under fp16, where the overflow flag of each step decides on the host
whether the step is skipped (the JAX engine reads it back too, to count
skipped steps).

Rounding differs from the JAX engine in one place: with
``grad_accum_dtype="bf16"`` JAX differentiates with respect to bf16 casts
of the parameters, so its forward sees bf16-rounded LayerNorm parameters
and its cotangents are bf16 throughout; here the forward sees the fp32
masters (the model casts only what its matmuls take) and each micro-batch's
fp32 gradient is rounded to bf16 when it is added to the bf16 buffer.

The engine runs on the card unless ``device="cpu"`` is passed; without
CUDA it raises. Options this slice does not port raise
``NotImplementedError`` naming their ROADMAP entry; none falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..inference.engine import resolve_device
from ..models.common import resolve_remat_policy
from ..models.convert import gpt2_params_from_jax, is_flax_tree
from ..utils.logging import logger
from . import precision
from .config import Config
from .lr_schedules import get_lr_schedule
from .optimizers import build_tx

TODO = "is not ported to the PyTorch engine yet"


def _enabled(section: dict) -> bool:
    return bool(section.get("enabled"))


class Engine:
    def __init__(self, model=None, config=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mesh=None, loss_fn=None, rngs=None,
                 collate_fn=None, dist_init_required=None, device=None):
        self.config = Config.load(config)
        self._refuse_unported(optimizer, training_data, mesh, loss_fn)
        self.device = resolve_device(device, "initialize")
        todo = getattr(model, "training_todo", None)   # the ROADMAP item of unported training
        if todo:
            raise NotImplementedError(
                f"training {type(model).__name__} {TODO} (ROADMAP.md {todo})")
        cfg = model.cfg
        if self.config.model_overrides:
            cfg = dataclasses.replace(cfg, **self.config.model_overrides)
        ac = self.config.activation_checkpointing
        if ac.enabled:
            # config-driven remat: a model that has remat on keeps its policy
            policy = cfg.remat_policy if cfg.remat else ac.policy
            resolve_remat_policy(policy)   # fail at build, not in the first backward
            cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        self.model_cfg = cfg
        self.config.resolve_batch(1)   # a mesh over more than one device raises here

        if lr_scheduler is not None and callable(lr_scheduler):
            self.lr_scheduler = lr_scheduler
        else:
            self.lr_scheduler = get_lr_schedule(self.config.scheduler.type,
                                                self.config.scheduler.params,
                                                base_lr=self.config.optimizer.lr)
        # fp32 master weights on the device; values come from init_params,
        # or from the model when it carries them (init_weights or a loaded
        # state dict), so weights a user put there are trained, not replaced
        self.module = type(model)(cfg, device=self.device, dtype=torch.float32)
        if model_parameters is None and getattr(model, "has_values", False):
            model_parameters = model.state_dict()
        self._names, self._params = zip(*self.module.named_parameters())
        self._params = list(self._params)
        self.optimizer = build_tx(self.config, self._params, self.lr_scheduler, self._names)
        # the fused int8-moment update, one kernel launch per leaf (the JAX
        # engine's ``_fused_opt``): None when the step takes the unfused chain
        self._fused_opt = self.optimizer if getattr(self.optimizer, "fused", False) else None
        self.loss_scale = precision.init_loss_scale(self.config.fp16)

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.metrics: Optional[dict] = None   # of the last applied step
        self._initialized = False
        self._pending = None                  # the three-call path's scaled loss
        self._grad_buffer = None
        if model_parameters is not None:
            self.init_params(params=model_parameters)

    def _refuse_unported(self, optimizer, training_data, mesh, loss_fn) -> None:
        c = self.config
        refused = [
            (optimizer is not None, "a client optimizer", "A3"),
            (loss_fn is not None, "a custom loss_fn", "A3"),
            (c.activation_checkpointing.cpu_checkpointing,
             "activation_checkpointing.cpu_checkpointing", "A11"),
            (training_data is not None, "training_data (the engine's dataloader)", "A7"),
            (mesh is not None, "an explicit mesh", "A9"),
            (bool(c.pipeline), "pipeline parallelism", "A9"),
            (c.optimizer.extra.get("comm_backend") == "compressed",
             "the 1-bit compressed comm backend", "A9"),
            (c.monitor.enabled, "monitors (tensorboard, wandb, csv)", "A10"),
            (c.zero.offload_optimizer.device != "none", "zero_optimization.offload_optimizer",
             "A11"),
            (c.zero.offload_param.device != "none", "zero_optimization.offload_param", "A11"),
            (c.sparse_gradients, "sparse_gradients", "A12"),
        ]
        for name in ("curriculum_learning", "progressive_layer_drop", "quantize_training",
                     "eigenvalue", "flops_profiler", "elasticity", "autotuning"):
            refused.append((_enabled(getattr(c, name)), name, "A12"))
        for bad, what, entry in refused:
            if bad:
                raise NotImplementedError(f"{what} {TODO} (ROADMAP.md {entry})")

    # ------------------------------------------------------------------
    # config properties
    # ------------------------------------------------------------------
    @property
    def zero_stage(self) -> int:
        return self.config.zero.stage

    @property
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    @property
    def fp16_enabled(self) -> bool:
        return self.config.fp16.enabled

    @property
    def bfloat16_enabled(self) -> bool:
        return self.config.bf16.enabled

    @property
    def params(self) -> dict:
        """The fp32 master weights by name (the module's parameters)."""
        self._require_state()
        return dict(zip(self._names, self._params))

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps == 0

    def _require_state(self) -> None:
        if not self._initialized:
            raise RuntimeError("parameters not initialized; call engine.init_params(...) "
                               "or pass model_parameters first")

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, example_batch=None, params: Optional[Mapping] = None, rng=None):
        """Fill the fp32 master weights (the optimizer's moments start at 0).

        ``params``: a flax GPT-2 tree of numpy arrays (converted by
        ``models/convert.py``) or a state dict of the port. Without it the
        model's ``init_weights`` draws from ``torch.Generator`` seeded with
        ``config.seed``: the same initialisers as flax's, but not flax's
        values (another generator). A no-op once the weights are set: by an
        earlier call, by ``model_parameters``, or by a model given to
        ``initialize`` that carried values. ``example_batch`` and ``rng``
        are accepted for the JAX signature and unused: shapes come from the
        model config."""
        if self._initialized:
            return
        if params is None:
            self.module.init_weights(torch.Generator().manual_seed(self.config.seed))
        else:
            if is_flax_tree(params):
                params = gpt2_params_from_jax(params, self.model_cfg)
            self.module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 for k, v in params.items()})
        self._initialized = True
        n = sum(p.numel() for p in self._params)
        logger.info(f"initialized {n / 1e6:.1f}M params on {self.device} | zero stage "
                    f"{self.zero_stage} (one device) | micro {self.train_micro_batch_size_per_gpu}"
                    f" x gas {self.gradient_accumulation_steps}")

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @property
    def _accum_dtype(self) -> torch.dtype:
        if self.config.grad_accum_dtype in ("bf16", "bfloat16"):
            return torch.bfloat16
        return torch.float32

    def _to_device(self, batch: Mapping) -> dict:
        """The batch's arrays or tensors on the device, integers as int64;
        aliased leaves (``labels`` is ``input_ids``) move once."""
        seen = {}

        def put(x):
            if id(x) not in seen:
                t = torch.as_tensor(x)
                if not t.is_floating_point():
                    t = t.long()
                seen[id(x)] = t.to(self.device)
            return seen[id(x)]

        return {k: put(v) for k, v in batch.items()}

    def _loss(self, batch: dict) -> torch.Tensor:
        return self.module(**batch)["loss"]

    def _grads_of(self, batch: dict, scale: float = 1.0):
        """(scaled loss, fp32 gradients) of one micro-batch."""
        loss = self._loss(batch)
        if scale != 1.0:
            loss = loss * scale
        return loss.detach(), list(torch.autograd.grad(loss, self._params))

    def _accumulate(self, acc, grads):
        grads = [g.to(self._accum_dtype) for g in grads]
        if acc is None:
            return grads
        torch._foreach_add_(acc, grads)
        return acc

    def _split_microbatches(self, batch: dict, gas: int) -> list:
        """Row block i of the batch is micro-batch i (one device: the JAX
        engine's rank-major layout with one rank)."""
        rows = {v.shape[0] for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % gas:
            raise ValueError(f"batch leading dims {sorted(rows)} must agree and divide by "
                             f"gradient_accumulation_steps {gas}")
        micro = next(iter(rows)) // gas
        return [{k: v[i * micro:(i + 1) * micro] for k, v in batch.items()} for i in range(gas)]

    def _apply_grads(self, grad_sum: list, loss_sum: torch.Tensor, denom: int,
                     loss_is_scaled: bool = True) -> dict:
        """Unscale → global norm → (fp16: finiteness) → clip + update →
        loss-scale state machine. ``metrics``: ``loss``, ``grad_norm``
        (before clipping), ``lr``, ``overflow`` (and ``loss_scale`` under
        fp16)."""
        fp16 = self.config.fp16.enabled
        scale = self.loss_scale.scale if fp16 else 1.0
        inv = 1.0 / (denom * scale)
        grads = [g if g.dtype == torch.float32 else g.float() for g in grad_sum]
        torch._foreach_mul_(grads, inv)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        mean_loss = loss_sum / (denom * scale) if loss_is_scaled else loss_sum / denom
        metrics = {"loss": mean_loss, "grad_norm": grad_norm,
                   "lr": float(self.lr_scheduler(self.optimizer.count))}
        if fp16:
            finite = bool(precision.grads_finite(grads))
            if finite:   # a skipped step also freezes the moments and the LR
                self.optimizer.update(self._params, grads, grad_norm)
            metrics["loss_scale"] = self.loss_scale.scale
            metrics["overflow"] = not finite
            self.loss_scale = precision.update_loss_scale(self.loss_scale, finite,
                                                          self.config.fp16)
            self.skipped_steps += int(not finite)
        else:
            self.optimizer.update(self._params, grads, grad_norm)
            metrics["overflow"] = False
        self.metrics = metrics
        return metrics

    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """One optimizer step on a global batch (leading dim
        ``train_batch_size``, split into ``gradient_accumulation_steps``
        micro-batches); returns the mean loss, a 0-d tensor on the device."""
        if batch is None or data_iter is not None:
            raise NotImplementedError(f"train_batch from data_iter or the engine's dataloader "
                                      f"{TODO} (ROADMAP.md A7): pass the batch")
        self._require_state()
        gas = self.gradient_accumulation_steps
        scale = self.loss_scale.scale if self.config.fp16.enabled else 1.0
        acc, loss_sum = None, None
        for mb in self._split_microbatches(self._to_device(batch), gas):
            loss, grads = self._grads_of(mb, scale)
            acc = self._accumulate(acc, grads)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = self._apply_grads(acc, loss_sum, gas)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += self.train_batch_size
        self._maybe_print(metrics)
        return metrics["loss"]

    def train_batches(self, batch, steps: int, stacked: Optional[bool] = None) -> torch.Tensor:
        """``steps`` calls of :meth:`train_batch`; returns the ``(steps,)``
        losses on the device. ``batch`` leaves carry either leading dim
        ``train_batch_size`` (the same batch every step) or a leading
        ``steps`` axis (one batch per step); pass ``stacked=`` when
        ``steps == train_batch_size`` makes that ambiguous."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        B = self.train_batch_size
        shapes = [tuple(v.shape) if hasattr(v, "shape") else np.shape(v) for v in batch.values()]
        leads = {shape[0] if shape else 0 for shape in shapes}
        if stacked is None:
            if B == steps and leads == {B}:
                raise ValueError(f"steps == train_batch_size == {B}: cannot infer whether the "
                                 "leading dim is the batch or the steps axis — pass stacked=")
            stacked = leads == {steps}
        want = steps if stacked else B
        if leads != {want}:
            raise ValueError(f"batch leading dims {sorted(leads)} != {want}")
        if not stacked:
            batch = self._to_device(batch)   # moved once for every step
        return torch.stack([self.train_batch({k: v[i] for k, v in batch.items()} if stacked
                                             else batch) for i in range(steps)])

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        self._require_state()
        return self._loss(self._to_device(batch))

    # -- DeepSpeed three-call path ---------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """The micro-batch's loss (unscaled, detached); its graph waits for
        :meth:`backward`."""
        self._require_state()
        loss = self._loss(self._to_device(batch))
        scale = self.loss_scale.scale if self.config.fp16.enabled else 1.0
        self._pending = (loss * scale if scale != 1.0 else loss), scale
        return loss.detach()

    __call__ = forward

    def backward(self, loss=None) -> torch.Tensor:
        """Gradients of the last forward, accumulated until :meth:`step`."""
        if self._pending is None:
            raise RuntimeError("backward() without a preceding forward()")
        scaled, scale = self._pending
        self._pending = None
        grads = list(torch.autograd.grad(scaled, self._params))
        unscaled = scaled.detach() / scale
        if self._grad_buffer is None:
            self._grad_buffer = (self._accumulate(None, grads), unscaled)
        else:
            acc, loss_sum = self._grad_buffer
            self._grad_buffer = (self._accumulate(acc, grads), loss_sum + unscaled)
        self.micro_steps += 1
        return unscaled

    def step(self) -> Optional[dict]:
        """The update at the accumulation boundary; returns its metrics."""
        self._require_state()
        if not self.is_gradient_accumulation_boundary():
            return None
        if self._grad_buffer is None:
            raise RuntimeError("step() without accumulated gradients")
        grads, loss_sum = self._grad_buffer
        self._grad_buffer = None
        metrics = self._apply_grads(grads, loss_sum, self.gradient_accumulation_steps,
                                    loss_is_scaled=False)
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        self._maybe_print(metrics)
        return metrics

    def _maybe_print(self, metrics: dict) -> None:
        if self.global_steps % self.config.steps_per_print:
            return
        logger.info(f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                    f"lr={metrics['lr']:.3e} grad_norm={float(metrics['grad_norm']):.3f}")
