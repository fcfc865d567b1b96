"""GPT-2 in PyTorch: pre-LN blocks, tanh-GELU, learned positions, tied and
padded LM head.

Port of ``deepspeed_tpu/models/gpt2.py`` for serving. Parameters keep the
flax names and layouts — dense kernels are ``(in, out)`` with
``y = x @ W + b`` — so ``models/convert.py`` copies a flax tree without
transposes; the scanned stack becomes an ``nn.ModuleList`` ``h``.

``forward(ids)`` is the training-style forward (flash attention where the
shape allows). ``forward(ids, position_ids=..., cache=...)`` is the decode
mode: K/V are appended to the cache, single-token ticks run the fused
decode kernels when ``decode_fused_plan`` allows, and the rest runs the
unfused chain over the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.decode_layer import fused_norm_proj, fused_post_attn
from .common import ModelOutput, append_kv_cache, decode_fused_plan, layer_norm


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    cache_len: Optional[int] = None    # decode KV-cache length; None: n_positions
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    attn_impl: str = "auto"               # auto | jnp | flash
    vocab_pad_multiple: int = 128
    decode_fused: Optional[bool] = None   # None: on for the card, off on the CPU

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is not a multiple of n_head {self.n_head}")
        return self.n_embd // self.n_head


# the JAX package's presets
PRESETS = {
    "gpt2-tiny": dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=2),
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.5b": dict(n_embd=1600, n_layer=48, n_head=25),
}
PRESETS["gpt2-xl"] = PRESETS["gpt2-1.5b"]


def gpt2_config(preset: str = "gpt2-125m", **overrides) -> GPT2Config:
    if preset not in PRESETS:
        raise ValueError(f"unknown GPT-2 preset {preset!r}; valid: {sorted(PRESETS)}")
    return GPT2Config(**{**PRESETS[preset], **overrides})


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def _dense(x, kernel, bias, dtype):
    return x @ kernel.to(dtype) + bias.to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_epsilon
        self.scale = _param((cfg.n_embd,), device, dtype)
        self.bias = _param((cfg.n_embd,), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_embd
        self.c_attn_kernel = _param((E, 3 * E), device, dtype)
        self.c_attn_bias = _param((3 * E,), device, dtype)
        self.c_proj_kernel = _param((E, E), device, dtype)
        self.c_proj_bias = _param((E,), device, dtype)

    def _heads(self, qkv):
        B, S, _ = qkv.shape
        H, D = self.cfg.n_head, self.cfg.head_dim
        return [t.reshape(B, S, H, D) for t in qkv.split(self.cfg.n_embd, dim=-1)]

    def mix(self, qkv, mask, layer_cache):
        """Heads of the fused ``(B, S, 3E)`` projection → attention output
        ``(B, S, E)`` before the o-proj (cache appended in decode mode)."""
        B, S, _ = qkv.shape
        q, k, v = self._heads(qkv)
        if layer_cache is None:
            y = dot_product_attention(q, k, v, causal=True, mask=mask, impl=self.cfg.attn_impl)
        else:
            kc, vc, cur = append_kv_cache(layer_cache, k, v)
            y = cached_decode_attention(q, kc, vc, cur, mask)
        return y.reshape(B, S, self.cfg.n_embd)

    def forward(self, x, mask, layer_cache=None):
        dt = self.cfg.dtype
        y = self.mix(_dense(x, self.c_attn_kernel, self.c_attn_bias, dt), mask, layer_cache)
        return _dense(y, self.c_proj_kernel, self.c_proj_bias, dt)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E, F = cfg.n_embd, 4 * cfg.n_embd
        self.c_fc_kernel = _param((E, F), device, dtype)
        self.c_fc_bias = _param((F,), device, dtype)
        self.c_proj_kernel = _param((F, E), device, dtype)
        self.c_proj_bias = _param((E,), device, dtype)

    def forward(self, x):
        dt = self.cfg.dtype
        h = nn.functional.gelu(_dense(x, self.c_fc_kernel, self.c_fc_bias, dt),
                               approximate="tanh")   # gelu_new
        return _dense(h, self.c_proj_kernel, self.c_proj_bias, dt)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg, device, dtype)
        self.attn = SelfAttention(cfg, device, dtype)
        self.ln_2 = LayerNorm(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)

    def forward(self, x, mask=None, layer_cache=None):
        cfg = self.cfg
        B, S, E = x.shape
        if layer_cache is not None and S == 1 and \
                decode_fused_plan(cfg, B * S, E, (3 * E,), 4 * E, x.device):
            return self._fused_tick(x, mask, layer_cache)
        x = x + self.attn(self.ln_1(x), mask, layer_cache)
        return x + self.mlp(self.ln_2(x))

    def _fused_tick(self, x, mask, layer_cache):
        """A single-token tick through the two fused decode kernels around
        decode attention: LN→QKV, attention, o-proj→LN→MLP→residual."""
        cfg, dt, attn, mlp = self.cfg, self.cfg.dtype, self.attn, self.mlp
        qkv = fused_norm_proj(x, self.ln_1.scale, self.ln_1.bias,
                              attn.c_attn_kernel.to(dt), attn.c_attn_bias,
                              eps=cfg.layer_norm_epsilon)
        y = attn.mix(qkv, mask, layer_cache)
        return fused_post_attn(
            y, x, attn.c_proj_kernel.to(dt), attn.c_proj_bias,
            self.ln_2.scale, self.ln_2.bias,
            (mlp.c_fc_kernel.to(dt), mlp.c_fc_bias, mlp.c_proj_kernel.to(dt), mlp.c_proj_bias),
            eps=cfg.layer_norm_epsilon)


class GPT2LMHeadModel(nn.Module):
    """Causal-LM GPT-2 with tied embeddings; ``forward`` returns a
    :class:`ModelOutput` with ``logits`` ``(B, S, padded_vocab)``, the
    padded columns at ``finfo(dtype).min``.

    Parameters are created uninitialised (``torch.empty``): call
    :meth:`init_weights` or load a state dict."""

    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_embd
        self.wte = _param((cfg.padded_vocab_size, E), device, dtype)
        self.wpe = _param((cfg.n_positions, E), device, dtype)
        self.h = nn.ModuleList(Block(cfg, device, dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg, device, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT2LMHeadModel":
        """The flax initialisers: normal(0.02) for embeddings and input
        projections, normal(0.02 / sqrt(2 L)) for the two residual
        projections, zero biases, unit LayerNorm scale. Draws happen on the
        generator's device and are copied in, so a CPU generator gives the
        same weights wherever the model lives."""
        std = self.cfg.initializer_range
        proj_std = std / math.sqrt(2 * self.cfg.n_layer)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf.endswith("_bias") or leaf == "bias":
                p.zero_()
            else:
                s = proj_std if leaf == "c_proj_kernel" else std
                w = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
                p.copy_(w.normal_(0.0, s, generator=generator))
        return self

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                cache: Optional[list] = None) -> ModelOutput:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S = input_ids.shape
        if position_ids is None:
            if cache is not None:
                raise ValueError("decode mode requires explicit position_ids "
                                 "(the inference engine tracks them)")
            position_ids = torch.arange(S, device=input_ids.device)[None, :]
        h = self.wte.to(dt)[input_ids] + self.wpe.to(dt)[position_ids]
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i, block in enumerate(self.h):
            h = block(h, mask, None if cache is None else cache[i])
        h = self.ln_f(h)
        logits = h @ self.wte.to(dt).T
        if cfg.padded_vocab_size != cfg.vocab_size:
            # padded vocab columns out of the softmax
            logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
        return ModelOutput(logits=logits)
