"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu, for one
NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
``torch`` and ``numpy`` and nothing of JAX or of ``deepspeed_tpu``. Every
TPU kernel on a ported path is a hand-written CUDA kernel for ``sm_90a``
(``ops/csrc/``), built with nvcc at first use and bound through ctypes.

Top-level API (the JAX package's ``initialize`` and ``init_inference``):

- ``initialize(model=..., config=..., device=None)`` →
  ``(engine, optimizer, None, lr_scheduler)``: the single-device training
  :class:`~deepspeed_tpu_torch.runtime.engine.Engine` (``init_params``,
  ``train_batch``, ``train_batches``, ``eval_batch``, ``forward`` /
  ``backward`` / ``step``)
- ``init_inference(model, params=..., dtype=..., max_tokens=..., device=None)``
  → :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
- ``ContinuousBatcher(engine, n_slots, prefix_cache=...)`` — the slot-pool
  server over an engine, contiguous or page-resident
  (:mod:`~deepspeed_tpu_torch.inference.serving`)
"""
from __future__ import annotations

from .inference.serving import ContinuousBatcher

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler=None, mesh=None, config=None, config_params=None, loss_fn=None,
               rngs=None, collate_fn=None, dist_init_required=None, device=None):
    """Build a training :class:`~deepspeed_tpu_torch.runtime.engine.Engine`
    (on the card unless ``device="cpu"``) and return ``(engine, optimizer,
    None, lr_scheduler)``, the JAX package's 4-tuple; the dataloader slot is
    None because ``training_data`` is not ported (it raises)."""
    from .runtime.engine import Engine

    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = Engine(model=model, config=config, optimizer=optimizer,
                    model_parameters=model_parameters, training_data=training_data,
                    lr_scheduler=lr_scheduler, mesh=mesh, loss_fn=loss_fn, rngs=rngs,
                    collate_fn=collate_fn, dist_init_required=dist_init_required, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (on the card unless ``device="cpu"``)."""
    from .inference.engine import InferenceEngine

    return InferenceEngine(model=model, config=config, **kwargs)
