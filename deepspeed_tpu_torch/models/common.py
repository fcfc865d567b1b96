"""Shared model plumbing: LayerNorm math, model outputs, the KV-cache
contract and the fused decode-tick dispatch.

Port of the serving half of ``deepspeed_tpu/models/common.py``. The cache
is a list with one dict per layer holding the leaves the JAX package names
(``cached_key``, ``cached_value``, ``cache_index``); the K/V buffers are
``(B, cache_len, H, D)`` and are updated IN PLACE (JAX returns a new cache
tree; the port saves the copy). ``cache_index`` is a host ``int``, so
slicing needs no device round trip.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.decode_layer import norm_proj_supported, post_attn_supported

KV_CACHE_LEAVES = ("cached_key", "cached_value")
CACHE_INDEX_LEAF = "cache_index"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last dim, cast back to x's dtype — the one
    norm math of every model module (the JAX package's ``layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class ModelOutput(dict):
    """Attribute-accessible output dict (``logits`` and friends)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def cache_leaf_kind(name: str) -> Optional[str]:
    """``"kv"`` for a K/V buffer, ``"index"`` for the write head, None for
    anything outside the ``append_kv_cache`` contract."""
    if name in KV_CACHE_LEAVES:
        return "kv"
    if name == CACHE_INDEX_LEAF:
        return "index"
    return None


def set_cache_index(cache: list, value: int) -> list:
    """Set every layer's write head to ``value`` (in place; returns cache)."""
    for layer in cache:
        for name in layer:
            if cache_leaf_kind(name) == "index":
                layer[name] = int(value)
    return cache


def init_layer_cache(batch: int, cache_len: int, heads: int, head_dim: int,
                     dtype, device) -> dict:
    shape = (batch, cache_len, heads, head_dim)
    return {"cached_key": torch.zeros(shape, dtype=dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=dtype, device=device),
            CACHE_INDEX_LEAF: 0}


def append_kv_cache(layer_cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Write this step's K/V ``(B, S, H, D)`` at the layer's write head and
    return ``(k_cache, v_cache, cur)`` with ``cur`` the head before the
    append. An append past the cache's end raises: the JAX package relies
    on ``dynamic_update_slice`` clamping its start there, which would
    overwrite live history."""
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    cur = layer_cache[CACHE_INDEX_LEAF]
    S = k.shape[1]
    if cur + S > ck.shape[1]:
        raise ValueError(f"KV cache append of {S} at position {cur} overruns "
                         f"cache_len {ck.shape[1]}")
    ck[:, cur:cur + S] = k
    cv[:, cur:cur + S] = v
    layer_cache[CACHE_INDEX_LEAF] = cur + S
    return ck, cv, cur


def decode_fused_enabled(cfg, device: torch.device) -> bool:
    """The fused decode-tick kernels: an explicit ``cfg.decode_fused`` wins;
    None means on for the card and off on the CPU (where the unfused chain
    is the stock path, as off the TPU in the JAX package)."""
    flag = getattr(cfg, "decode_fused", None)
    return device.type == "cuda" if flag is None else bool(flag)


def decode_fused_plan(cfg, rows: int, e: int, proj_outs: tuple, f: int,
                      device: torch.device) -> bool:
    """Whether THIS tick takes the fused kernels: enabled, and the shape
    predicates of both kernels hold (``decode_fused_plan`` of the JAX
    package, without its mesh and W8A16 cases)."""
    return (decode_fused_enabled(cfg, device)
            and all(norm_proj_supported(rows, e, n) for n in proj_outs)
            and post_attn_supported(rows, e, f))
