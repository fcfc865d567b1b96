"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu, for one
NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
``torch`` and ``numpy`` and nothing of JAX or of ``deepspeed_tpu``. Every
TPU kernel on a ported path is a hand-written CUDA kernel for ``sm_90a``
(``ops/csrc/``), built with nvcc at first use and bound through ctypes.

Top-level API (the JAX package's ``init_inference``):

- ``init_inference(model, params=..., dtype=..., max_tokens=..., device=None)``
  → :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
"""
from __future__ import annotations

__version__ = "0.1.0"


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (on the card unless ``device="cpu"``)."""
    from .inference.engine import InferenceEngine

    return InferenceEngine(model=model, config=config, **kwargs)
