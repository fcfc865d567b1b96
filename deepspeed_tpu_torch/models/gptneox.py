"""GPT-NeoX (the Pythia family) in PyTorch: LayerNorm, partial half-split
rotary (``rotary_pct``), the interleaved qkv panel, exact-erf GELU, the
parallel residual ``x + attn(ln1 x) + mlp(ln2 x)`` (or the sequential one),
untied and padded ``embed_out`` head.

Port of ``deepspeed_tpu/models/gptneox.py`` for serving. Parameters keep the
flax names and layouts — dense kernels are ``(in, out)`` with ``y = x @ W +
b`` — so ``models/convert.py`` copies a flax tree without transposes; the
scanned stack becomes an ``nn.ModuleList`` ``layers``. The qkv panel
``(E, 3E)`` keeps the per-head interleaved order ``(H, 3, D)`` of HF NeoX:
its output is reshaped to ``(B, S, H, 3, D)``, never split into thirds.

``forward(ids)`` is the full-sequence forward (flash attention where the
shape allows). ``forward(ids, position_ids=..., cache=...)`` is the decode
mode over any layout of ``models/common.append_kv_cache``. Single-token
ticks take the fused decode kernels when ``decode_fused_plan`` allows: one
LayerNorm → qkv kernel, the partial rotary, the append and decode
attention, then one o-proj → LayerNorm → exact-GELU MLP → residual call
with the config's residual (``gptneox.py:138-163``, ``:201-231`` of the JAX
package).

``w8=True`` (set by ``init_inference``'s ``quant`` option) stores the four
dense kernels of each block as W8A16 pairs (``*_kernel_q`` int8 codes,
``*_kernel_s`` fp32 scales per ``w8_group`` rows); embeddings, the head,
norms and biases stay full width. Mixture of experts and training (``remat``,
the training engine) are not ported and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.decode_layer import fused_norm_proj, fused_post_attn
from ..ops.rotary import apply_rotary_pos_emb
from .common import (LayerNorm, ModelOutput, append_kv_cache, cross_entropy_loss,
                     declare_dense, decode_fused_plan, dense, dense_weight, new_param,
                     shift_labels)


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    max_position_embeddings: int = 2048
    cache_len: Optional[int] = None       # decode KV-cache length; None: the position field
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    remat: bool = False                   # training: not ported
    attn_impl: str = "auto"               # auto | jnp | flash
    vocab_pad_multiple: int = 128
    # weight-only int8 serving (ops/w8.py). Set by init_inference.
    w8: bool = False
    w8_group: int = 128
    decode_fused: Optional[bool] = None   # None: on for the card, off on the CPU
    moe: Optional[Any] = None             # mixture of experts: not ported

    def __post_init__(self):
        todo = "is not ported to the PyTorch model yet"
        if self.moe is not None:
            raise NotImplementedError(f"GPT-NeoX moe {todo} (ROADMAP.md A9)")
        if self.remat:
            raise NotImplementedError(f"GPT-NeoX training (remat) {todo} (ROADMAP.md A8b)")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of "
                             f"{self.num_attention_heads} heads")

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    # the family-blind names the inference engine and the batcher read
    @property
    def n_layer(self) -> int:
        return self.num_hidden_layers

    @property
    def n_head(self) -> int:
        return self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_attention_heads


# the JAX package's presets (vocab 50432, its own padding of Pythia's 50304)
PRESETS = {
    "neox-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=128),
    "pythia-1b": dict(hidden_size=2048, num_hidden_layers=16,
                      num_attention_heads=8, intermediate_size=8192),
    "neox-20b": dict(hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576),
}


def gptneox_config(preset: str = "neox-tiny", **overrides) -> GPTNeoXConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; valid: {sorted(PRESETS)}")
    return GPTNeoXConfig(**{**PRESETS[preset], **overrides})


class NeoXAttention(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        declare_dense(self, "qkv", E, 3 * E, cfg, device, dtype)
        declare_dense(self, "dense", E, E, cfg, device, dtype)

    def mix(self, qkv, position_ids, mask, layer_cache):
        """The interleaved ``(B, S, 3E)`` projection → partial rotary →
        attention output ``(B, S, E)`` before the o-proj (cache appended in
        decode mode)."""
        cfg = self.cfg
        B, S, _ = qkv.shape
        qkv = qkv.reshape(B, S, cfg.n_head, 3, cfg.head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        q, k = apply_rotary_pos_emb(q, k, position_ids, cfg.rotary_dim, cfg.rotary_emb_base)
        if layer_cache is None:
            y = dot_product_attention(q, k, v, causal=True, mask=mask, impl=cfg.attn_impl)
        else:
            kc, vc, cur = append_kv_cache(layer_cache, k, v, cfg.cache_len)
            y = cached_decode_attention(q, kc, vc, cur, mask)
        return y.reshape(B, S, cfg.hidden_size)

    def forward(self, x, position_ids, mask, layer_cache=None):
        dt = self.cfg.dtype
        qkv = dense(x, dense_weight(self, "qkv", dt), self.qkv_bias, dt)
        y = self.mix(qkv, position_ids, mask, layer_cache)
        return dense(y, dense_weight(self, "dense", dt), self.dense_bias, dt)


class NeoXBlock(nn.Module):
    """LayerNorm → attention and LayerNorm → exact-GELU MLP, added to the
    block input in parallel (``use_parallel_residual``) or in sequence."""

    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E, F = cfg.hidden_size, cfg.intermediate_size
        self.input_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device, dtype)
        self.attention = NeoXAttention(cfg, device, dtype)
        self.post_attention_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device, dtype)
        declare_dense(self, "dense_h_to_4h", E, F, cfg, device, dtype)
        declare_dense(self, "dense_4h_to_h", F, E, cfg, device, dtype)

    def forward(self, x, position_ids, mask=None, layer_cache=None):
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, E = x.shape
        if layer_cache is not None and S == 1 and decode_fused_plan(
                cfg, B * S, E, (3 * E,), cfg.intermediate_size, x.device):
            return self._fused_tick(x, position_ids, mask, layer_cache)
        attn = self.attention(self.input_ln(x), position_ids, mask, layer_cache)
        h = self.post_attention_ln(x if cfg.use_parallel_residual else x + attn)
        h = nn.functional.gelu(dense(h, dense_weight(self, "dense_h_to_4h", dt),
                                      self.dense_h_to_4h_bias, dt), approximate="none")
        mlp = dense(h, dense_weight(self, "dense_4h_to_h", dt), self.dense_4h_to_h_bias, dt)
        return x + attn + mlp

    def _fused_tick(self, x, position_ids, mask, layer_cache):
        """A single-token tick through the two fused decode kernels around
        the rotary and decode attention: LN → qkv, then o-proj → LN (of x
        under the parallel residual) → exact-GELU MLP → residual."""
        cfg, dt, attn = self.cfg, self.cfg.dtype, self.attention
        eps = cfg.layer_norm_eps
        qkv = fused_norm_proj(x, self.input_ln.scale, self.input_ln.bias,
                              dense_weight(attn, "qkv", dt), attn.qkv_bias, eps=eps)
        y = attn.mix(qkv, position_ids, mask, layer_cache)
        mlp = (dense_weight(self, "dense_h_to_4h", dt), self.dense_h_to_4h_bias,
               dense_weight(self, "dense_4h_to_h", dt), self.dense_4h_to_h_bias)
        return fused_post_attn(y, x, dense_weight(attn, "dense", dt), attn.dense_bias,
                               self.post_attention_ln.scale, self.post_attention_ln.bias, mlp,
                               eps=eps, exact_gelu=True,
                               parallel_residual=cfg.use_parallel_residual)


class GPTNeoXForCausalLM(nn.Module):
    """Causal-LM GPT-NeoX with an untied head; ``forward`` returns a
    :class:`ModelOutput` with ``logits`` ``(B, S, padded_vocab)``, the
    padded columns at ``finfo(dtype).min``, and ``loss`` when given
    ``labels``.

    Parameters are created uninitialised (``torch.empty``): call
    :meth:`init_weights` or load a state dict."""

    # the training engine refuses the model, naming the ROADMAP item that ports its training
    training_todo = "A8b"

    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.has_values = False
        E, Vp = cfg.hidden_size, cfg.padded_vocab_size
        self.embed_in = new_param((Vp, E), device, dtype)
        self.layers = nn.ModuleList(NeoXBlock(cfg, device, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device, dtype)
        self.embed_out = new_param((E, Vp), device, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPTNeoXForCausalLM":
        """The flax initialisers: normal(0.02) for the embedding, the head
        and every dense kernel, zero biases, unit LayerNorm scales (and under
        ``w8`` zero codes, unit scales). Draws happen on the generator's
        device and are copied in, so a CPU generator gives the same weights
        wherever the model lives."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf.endswith("_kernel_s"):
                p.fill_(1.0)
            elif leaf.endswith("_kernel_q") or leaf == "bias" or leaf.endswith("_bias"):
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
        h = self.embed_in.to(dt)[input_ids]
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        for i, block in enumerate(self.layers):
            h = block(h, position_ids, mask, None if cache is None else cache[i])
        logits = self.final_ln(h) @ self.embed_out.to(dt)
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
        E, L = cfg.hidden_size, cfg.num_hidden_layers
        n = (2 * cfg.padded_vocab_size * E
             + L * (4 * E * E + 2 * E * cfg.intermediate_size))
        return 6.0 * n + 12 * L * E * cfg.max_position_embeddings
