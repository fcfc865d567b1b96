"""Carry weights and optimizer state across: a flax GPT-2, LLaMA or GPT-NeoX
param tree → the port's state dict, and the JAX ``Adam8bitState`` → the port's
``Adam8bit`` state.

The port keeps the flax names and ``(in, out)`` kernel layouts, so each
leaf maps to one state-dict key with no transpose. Both flax layouts are
taken: ``scan_layers=True`` stacks the blocks under one name (``h`` for
GPT-2, ``layers`` for LLaMA and GPT-NeoX) with a leading layer axis,
``scan_layers=False`` names them ``h_0 … h_{L-1}`` (``layers_0 …``). Leaves
arrive as numpy arrays (``np.asarray`` works on JAX arrays too, without
this package importing JAX); partition boxes must be unwrapped first.

The int8-moment state (``deepspeed_tpu/ops/adam8bit.py:Adam8bitState``)
has param-shaped code trees and a scale tree whose leaves are ``{"m",
"r"}`` dicts of ``(…, 1)`` scales. Its rows are the last axis in both
layouts, so a scanned ``(L, …, 1)`` scale splits per block like the leaf
it scales, and each row keeps its scale.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .gpt2 import GPT2Config, GPT2LMHeadModel
from .gptneox import GPTNeoXConfig, GPTNeoXForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, np.asarray(val)


# each family's model class and the name of its block stack
_FAMILIES = {GPT2Config: (GPT2LMHeadModel, "h"), LlamaConfig: (LlamaForCausalLM, "layers"),
             GPTNeoXConfig: (GPTNeoXForCausalLM, "layers")}


def is_flax_tree(params: Mapping) -> bool:
    """A flax tree nests its leaves (GPT-2's ``ln_f``, LLaMA's ``norm``,
    GPT-NeoX's ``final_ln`` and the blocks are dicts); a state dict is flat."""
    return any(isinstance(v, Mapping) for v in params.values())


def _by_port_name(np_tree: Mapping, n_layer: int, stack: str = "h") -> dict[str, np.ndarray]:
    """The tree's leaves under the port's names, a scanned stack's leading
    layer axis split per block."""
    out = {}
    for name, arr in _flatten(np_tree):
        head, _, rest = name.partition(".")
        index = head[len(stack) + 1:]
        if head == stack:                     # scanned stack: (L, ...) leaves
            if arr.shape[:1] != (n_layer,):
                raise ValueError(f"scanned leaf {stack}.{rest} has shape {arr.shape}, "
                                 f"expected a leading axis of {n_layer} layers")
            for i in range(n_layer):
                out[f"{stack}.{i}.{rest}"] = arr[i]
        elif head.startswith(stack + "_") and index.isdigit():
            out[f"{stack}.{int(index)}.{rest}"] = arr
        else:
            out[name] = arr
    return out


def _param_shapes(cfg) -> dict[str, tuple]:
    model_cls, _ = _FAMILIES[type(cfg)]
    with torch.device("meta"):
        return {k: tuple(p.shape) for k, p in model_cls(cfg).named_parameters()}


def _check_names(got: Mapping, expected: Mapping, cfg, what: str) -> None:
    missing = sorted(expected.keys() - got.keys())
    extra = sorted(got.keys() - expected.keys())
    if missing or extra:
        family = _FAMILIES[type(cfg)][0].__name__
        raise KeyError(f"{what} does not match {family} with {cfg.n_layer} layers: "
                       f"missing {missing[:5]}, unexpected {extra[:5]}")


def params_from_jax(np_tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors, the tree's dtypes) for a flax
    param tree of ``cfg``'s family (GPT-2, LLaMA or GPT-NeoX), scanned or not: full
    width, or quantized by the JAX engine (W8A16 ``*_kernel_q`` int8 codes
    and ``*_kernel_s`` fp32 scales in place of each dense ``*_kernel``,
    grouped by ``cfg.w8_group``). Raises ``KeyError`` on missing or
    unexpected leaves and ``ValueError`` on a shape mismatch."""
    out = _by_port_name(np_tree, cfg.n_layer, _FAMILIES[type(cfg)][1])
    w8 = any(k.endswith("_kernel_q") for k in out)
    expected = _param_shapes(dataclasses.replace(cfg, w8=w8))
    _check_names(out, expected, cfg, "flax tree")
    for k, shape in expected.items():
        if out[k].shape != shape:
            raise ValueError(f"{k}: flax shape {out[k].shape}, port expects {shape}")
    return {k: _tensor(out[k]) for k in expected}


def gpt2_params_from_jax(np_tree: Mapping, cfg: GPT2Config) -> dict[str, torch.Tensor]:
    """:func:`params_from_jax` for a GPT-2 tree."""
    return params_from_jax(np_tree, cfg)


def llama_params_from_jax(np_tree: Mapping, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """:func:`params_from_jax` for a LLaMA tree (``embed_tokens``, the
    ``layers`` stack, ``norm``, the untied ``lm_head``)."""
    return params_from_jax(np_tree, cfg)


def gptneox_params_from_jax(np_tree: Mapping, cfg: GPTNeoXConfig) -> dict[str, torch.Tensor]:
    """:func:`params_from_jax` for a GPT-NeoX tree (``embed_in``, the
    ``layers`` stack with the interleaved ``attention.qkv`` panel,
    ``final_ln``, the untied ``embed_out``)."""
    return params_from_jax(np_tree, cfg)


def adam8bit_state_from_jax(state, cfg: GPT2Config) -> dict:
    """The port's ``Adam8bit.state_dict()`` layout for a JAX
    ``Adam8bitState`` of a GPT-2 (any object with ``count``, ``m_codes``,
    ``r_codes`` and ``scales``; leaves numpy arrays, either ``scan_layers``
    layout): ``{"count", "m_codes", "r_codes", "scales"}`` keyed by the
    port's parameter names, CPU tensors. Codes keep the parameter's shape
    (int8 ``m``, uint8 ``r``); each scale keeps its ``(…, 1)`` row shape."""
    shapes = _param_shapes(cfg)
    codes = {}
    for key, dtype in (("m_codes", np.int8), ("r_codes", np.uint8)):
        tree = _by_port_name(getattr(state, key), cfg.n_layer)
        _check_names(tree, shapes, cfg, key)
        for k, shape in shapes.items():
            if tree[k].shape != shape or tree[k].dtype != dtype:
                raise ValueError(f"{key} {k}: {tree[k].dtype} {tree[k].shape}, port expects "
                                 f"{np.dtype(dtype)} {shape}")
        codes[key] = {k: _tensor(tree[k]) for k in shapes}
    # each scale leaf is an {"m", "r"} dict: split the tree by its last key
    halves = {}
    for which in ("m", "r"):
        flat = {n[:-2]: a for n, a in _flatten(state.scales) if n.endswith("." + which)}
        tree = _by_port_name(_nest(flat), cfg.n_layer)
        _check_names(tree, shapes, cfg, f"scales[{which!r}]")
        for k, shape in shapes.items():
            want = shape[:-1] + (1,) if shape else ()
            if tree[k].shape != want:
                raise ValueError(f"scale {which} of {k}: shape {tree[k].shape}, port expects "
                                 f"{want}")
        halves[which] = tree
    scales = {k: {w: _tensor(halves[w][k].astype(np.float32)) for w in "mr"} for k in shapes}
    return {"count": int(np.asarray(state.count)), **codes, "scales": scales}


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    """Dotted names back into a nested dict (the inverse of ``_flatten``)."""
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *heads, leaf = name.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = arr
    return tree


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16, which torch cannot wrap
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)   # a copy: the tree's arrays may be read-only
