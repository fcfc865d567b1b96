"""Carry weights across: a flax GPT-2 param tree → the port's state dict.

The port keeps the flax names and ``(in, out)`` kernel layouts, so each
leaf maps to one state-dict key with no transpose. Both flax layouts are
taken: ``scan_layers=True`` stacks the blocks under ``h`` with a leading
layer axis, ``scan_layers=False`` names them ``h_0 … h_{L-1}``. Leaves
arrive as numpy arrays (``np.asarray`` works on JAX arrays too, without
this package importing JAX); partition boxes must be unwrapped first.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .gpt2 import GPT2Config, GPT2LMHeadModel


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, np.asarray(val)


def is_flax_tree(params: Mapping) -> bool:
    """A flax GPT-2 tree nests its leaves (``ln_f`` is a dict); a state dict
    is flat."""
    return isinstance(params.get("ln_f"), Mapping)


def gpt2_params_from_jax(np_tree: Mapping, cfg: GPT2Config) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors, the tree's dtypes) for a flax
    GPT-2 param tree. Raises ``KeyError`` on missing or unexpected leaves
    and ``ValueError`` on a shape mismatch."""
    L = cfg.n_layer
    out = {}
    for name, arr in _flatten(np_tree):
        head, _, rest = name.partition(".")
        if head == "h":                       # scanned stack: (L, ...) leaves
            if arr.shape[:1] != (L,):
                raise ValueError(f"scanned leaf h.{rest} has shape {arr.shape}, "
                                 f"expected a leading axis of {L} layers")
            for i in range(L):
                out[f"h.{i}.{rest}"] = arr[i]
        elif head.startswith("h_") and head[2:].isdigit():
            out[f"h.{int(head[2:])}.{rest}"] = arr
        else:
            out[name] = arr

    with torch.device("meta"):
        expected = {k: tuple(p.shape) for k, p in GPT2LMHeadModel(cfg).named_parameters()}
    missing = sorted(expected.keys() - out.keys())
    extra = sorted(out.keys() - expected.keys())
    if missing or extra:
        raise KeyError(f"flax tree does not match GPT-2 {cfg.n_layer}x{cfg.n_embd}: "
                       f"missing {missing[:5]}, unexpected {extra[:5]}")
    for k, shape in expected.items():
        if out[k].shape != shape:
            raise ValueError(f"{k}: flax shape {out[k].shape}, port expects {shape}")
    return {k: _tensor(out[k]) for k in expected}


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16, which torch cannot wrap
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)   # a copy: the tree's arrays may be read-only
