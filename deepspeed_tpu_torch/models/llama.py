"""LLaMA in PyTorch: RMSNorm, SwiGLU MLP, full rotary, grouped-query
attention (``num_key_value_heads``), untied and padded LM head.

Port of ``deepspeed_tpu/models/llama.py`` for serving. Parameters keep the
flax names and layouts — dense kernels are ``(in, out)``, none has a bias —
so ``models/convert.py`` copies a flax tree without transposes; the
scanned stack becomes an ``nn.ModuleList`` ``layers``.

``forward(ids)`` is the full-sequence forward: the KV heads are repeated
to the query heads and attention takes the flash kernel where the shape
allows. ``forward(ids, position_ids=..., cache=...)`` is the decode mode:
the cache holds the KV heads only, ``(B, cache_len, KV, D)`` in any layout
of ``models/common.append_kv_cache``, and ``cached_decode_attention`` reads
it grouped, with no repeat. Single-token ticks take the fused decode
kernels when ``decode_fused_plan`` allows: three RMSNorm → projection
kernels (q, k, v), rotary, the append and decode attention, then the
o-proj → RMSNorm → SwiGLU → residual kernel (``llama.py:130-159``,
``:206-234`` of the JAX package).

``w8=True`` (set by ``init_inference``'s ``quant`` option) stores the seven
dense kernels of each block as W8A16 pairs (``*_kernel_q`` int8 codes,
``*_kernel_s`` fp32 scales per ``w8_group`` rows); the embedding, the head
and the norms stay full width. Training LLaMA (``remat``, the optimizer
path) is not ported and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.decode_layer import fused_norm_proj, fused_post_attn
from ..ops.rotary import apply_rotary_pos_emb
from .common import (ModelOutput, RMSNorm, append_kv_cache, cross_entropy_loss, declare_dense,
                     decode_fused_plan, dense, dense_weight, new_param, shift_labels)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 2048
    cache_len: Optional[int] = None       # decode KV-cache length; None: the position field
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None   # None: MHA
    intermediate_size: int = 5632
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    remat: bool = False                   # training: not ported
    attn_impl: str = "auto"               # auto | jnp | flash
    vocab_pad_multiple: int = 128
    # weight-only int8 serving (ops/w8.py). Set by init_inference.
    w8: bool = False
    w8_group: int = 128
    decode_fused: Optional[bool] = None   # None: on for the card, off on the CPU

    def __post_init__(self):
        if self.remat:
            raise NotImplementedError("LLaMA training (remat) is not ported to the PyTorch "
                                      "model yet (ROADMAP.md A8a)")
        if self.hidden_size % self.num_attention_heads or \
                self.num_attention_heads % self.kv_heads:
            raise ValueError(f"hidden_size {self.hidden_size}, {self.num_attention_heads} "
                             f"heads and {self.kv_heads} KV heads do not divide")

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    # the family-blind names the inference engine and the batcher read
    @property
    def n_layer(self) -> int:
        return self.num_hidden_layers

    @property
    def n_head(self) -> int:
        return self.num_attention_heads


# the JAX package's presets
PRESETS = {
    "llama-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       intermediate_size=128, max_position_embeddings=128),
    "llama-1b": dict(hidden_size=2048, num_hidden_layers=22,
                     num_attention_heads=32, num_key_value_heads=4,
                     intermediate_size=8192),
    "llama-7b": dict(hidden_size=4096, num_hidden_layers=32,
                     num_attention_heads=32, intermediate_size=11008),
}


def llama_config(preset: str = "llama-tiny", **overrides) -> LlamaConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; valid: {sorted(PRESETS)}")
    return LlamaConfig(**{**PRESETS[preset], **overrides})


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E, H, KV, D = cfg.hidden_size, cfg.n_head, cfg.kv_heads, cfg.head_dim
        for name, k, n in (("q_proj", E, H * D), ("k_proj", E, KV * D), ("v_proj", E, KV * D),
                           ("o_proj", H * D, E)):
            declare_dense(self, name, k, n, cfg, device, dtype, bias=False)

    def mix(self, q, k, v, position_ids, mask, layer_cache):
        """Projected q ``(B, S, H·D)``, k and v ``(B, S, KV·D)`` → rotary →
        attention output ``(B, S, H·D)`` before the o-proj (cache appended in
        decode mode; the KV heads repeated only on the full-sequence path)."""
        cfg = self.cfg
        B, S, _ = q.shape
        H, KV, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        q, k = apply_rotary_pos_emb(q.reshape(B, S, H, D), k.reshape(B, S, KV, D),
                                    position_ids, rotary_dim=D, theta=cfg.rope_theta)
        v = v.reshape(B, S, KV, D)
        if layer_cache is not None:
            kc, vc, cur = append_kv_cache(layer_cache, k, v, cfg.cache_len)
            y = cached_decode_attention(q, kc, vc, cur, mask)
        else:
            if KV != H:   # GQA: repeat the KV heads
                k, v = k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2)
            y = dot_product_attention(q, k, v, causal=True, mask=mask, impl=cfg.attn_impl)
        return y.reshape(B, S, H * D)

    def forward(self, x, position_ids, mask, layer_cache=None):
        dt = self.cfg.dtype
        q, k, v = (dense(x, dense_weight(self, n, dt)) for n in ("q_proj", "k_proj", "v_proj"))
        y = self.mix(q, k, v, position_ids, mask, layer_cache)
        return dense(y, dense_weight(self, "o_proj", dt))


class LlamaBlock(nn.Module):
    """Pre-norm block: RMSNorm → GQA attention → residual, RMSNorm → SwiGLU
    → residual."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E, F = cfg.hidden_size, cfg.intermediate_size
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.post_attention_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        for name, k, n in (("gate_proj", E, F), ("up_proj", E, F), ("down_proj", F, E)):
            declare_dense(self, name, k, n, cfg, device, dtype, bias=False)

    def forward(self, x, position_ids, mask=None, layer_cache=None):
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, E = x.shape
        D = cfg.head_dim
        if layer_cache is not None and S == 1 and decode_fused_plan(
                cfg, B * S, E, (cfg.n_head * D, cfg.kv_heads * D, cfg.kv_heads * D),
                cfg.intermediate_size, x.device, swiglu=True):
            return self._fused_tick(x, position_ids, mask, layer_cache)
        x = x + self.self_attn(self.input_norm(x), position_ids, mask, layer_cache)
        h = self.post_attention_norm(x)
        gate = dense(h, dense_weight(self, "gate_proj", dt))
        up = dense(h, dense_weight(self, "up_proj", dt))
        return x + dense(nn.functional.silu(gate) * up, dense_weight(self, "down_proj", dt))

    def _fused_tick(self, x, position_ids, mask, layer_cache):
        """A single-token tick through the fused decode kernels: RMSNorm → q,
        k and v (three kernels: the GQA panels stay narrow), rotary, the
        append and decode attention, then o-proj → RMSNorm → SwiGLU →
        residual."""
        cfg, dt, attn = self.cfg, self.cfg.dtype, self.self_attn
        eps, ns1 = cfg.rms_norm_eps, self.input_norm.scale
        q, k, v = (fused_norm_proj(x, ns1, None, dense_weight(attn, n, dt), None, rms=True,
                                   eps=eps) for n in ("q_proj", "k_proj", "v_proj"))
        y = attn.mix(q, k, v, position_ids, mask, layer_cache)
        mlp = tuple(dense_weight(self, n, dt) for n in ("gate_proj", "up_proj", "down_proj"))
        return fused_post_attn(y, x, dense_weight(attn, "o_proj", dt), None,
                               self.post_attention_norm.scale, None, mlp, swiglu=True,
                               rms=True, eps=eps)


class LlamaForCausalLM(nn.Module):
    """Causal-LM LLaMA with an untied head; ``forward`` returns a
    :class:`ModelOutput` with ``logits`` ``(B, S, padded_vocab)``, the
    padded columns at ``finfo(dtype).min``, and ``loss`` when given
    ``labels``.

    Parameters are created uninitialised (``torch.empty``): call
    :meth:`init_weights` or load a state dict."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.has_values = False
        E, Vp = cfg.hidden_size, cfg.padded_vocab_size
        self.embed_tokens = new_param((Vp, E), device, dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.lm_head = new_param((E, Vp), device, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaForCausalLM":
        """The flax initialisers: normal(0.02) for the embedding, the head
        and every dense kernel, unit RMSNorm scales (and under ``w8`` zero
        codes, unit scales). Draws happen on the generator's device and are
        copied in, so a CPU generator gives the same weights wherever the
        model lives."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf.endswith("_kernel_s"):
                p.fill_(1.0)
            elif leaf.endswith("_kernel_q"):
                p.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
                p.copy_(w.normal_(0.0, self.cfg.initializer_range, generator=generator))
        self.has_values = True
        return self

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.has_values = True
        return out

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                cache: Optional[list] = None, labels: Optional[torch.Tensor] = None,
                shift: bool = True) -> ModelOutput:
        """``labels`` adds the mean next-token ``loss`` (``shift=True``
        shifts them by one, for ``labels=input_ids``)."""
        cfg, dt = self.cfg, self.cfg.dtype
        B, S = input_ids.shape
        if position_ids is None:
            if cache is not None:
                raise ValueError("decode mode requires explicit position_ids "
                                 "(the inference engine tracks them)")
            position_ids = torch.arange(S, device=input_ids.device)[None, :]
        h = self.embed_tokens.to(dt)[input_ids]
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i, block in enumerate(self.layers):
            h = block(h, position_ids, mask, None if cache is None else cache[i])
        logits = self.norm(h) @ self.lm_head.to(dt)
        if cfg.padded_vocab_size != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, shift_labels(labels) if shift else labels)
        return out

    def dummy_inputs(self, batch_size: int = 2, seq_len: Optional[int] = None) -> dict:
        S = seq_len or min(self.cfg.max_position_embeddings, 128)
        ids = torch.zeros((batch_size, S), dtype=torch.long)
        return {"input_ids": ids, "labels": ids}

    def flops_per_token(self) -> float:
        """6·N_matmul + attention flops, for MFU accounting (the JAX
        package's formula)."""
        cfg = self.cfg
        E, L, D = cfg.hidden_size, cfg.num_hidden_layers, cfg.head_dim
        n = (2 * cfg.padded_vocab_size * E
             + L * (E * E + 2 * E * cfg.kv_heads * D + E * E + 3 * E * cfg.intermediate_size))
        return 6.0 * n + 12 * L * E * cfg.max_position_embeddings
