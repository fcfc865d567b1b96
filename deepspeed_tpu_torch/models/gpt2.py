"""GPT-2 in PyTorch: pre-LN blocks, tanh-GELU, learned positions, tied and
padded LM head.

Port of ``deepspeed_tpu/models/gpt2.py`` for training and serving.
Parameters keep the flax names and layouts — dense kernels are
``(in, out)`` with ``y = x @ W + b`` — so ``models/convert.py`` copies a
flax tree without transposes; the scanned stack becomes an
``nn.ModuleList`` ``h``.

``forward(ids, labels=...)`` is the training forward (flash attention,
forward and backward, where the shape allows): with ``loss_chunk`` set the
output holds only the memory-bounded head's ``loss`` (the chunked head,
or with ``loss_pallas`` the fused CE head kernels), else ``logits`` and the
dense ``loss``. ``remat=True`` checkpoints each block under
``remat_policy``: the JAX package's ``nothing_saveable``,
``everything_saveable`` and dot-saving policies, each with ``+flash``
(``models/common.resolve_remat_policy``). ``fused_mlp=True`` runs the MLP
through the fused FFN kernels (``ops/fused_mlp.py``) wherever the JAX
package's rule fuses it (:meth:`MLP.use_fused`): the forward in training,
prefill and unfused decode ticks, dx and dw in backward. Dropout, MoE and
``+offload`` are not ported and raise. ``forward(ids, position_ids=..., cache=...)`` is
the decode mode: K/V are appended to the cache, single-token ticks run the
fused decode kernels when ``decode_fused_plan`` allows, and the rest runs
the unfused chain over the cache. The cache is any layout of
``models/common.append_kv_cache`` (one write head, per-row heads, or the
paged arena) and ``position_ids`` are per row, ``(B, S)`` or ``(1, S)``:
``cached_decode_attention`` dispatches on the layout, as in the JAX
package.

``w8=True`` (set by ``init_inference``'s ``quant`` option) stores the four
dense kernels of each block as W8A16 pairs under the flax names
``*_kernel_q`` (int8 codes) and ``*_kernel_s`` (fp32 scales per
``w8_group`` rows), parameters that carry no gradient; the dense layers go
through ``ops/w8.w8a16_matmul`` and the fused decode tick hands the pairs to
the kernels. Embeddings, the tied head, norms and biases stay full width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from ..ops.attention import cached_decode_attention, dot_product_attention
from ..ops.decode_layer import fused_norm_proj, fused_post_attn
from ..ops.fused_mlp import fits_vmem, fused_mlp
from .common import (LayerNorm, ModelOutput, append_kv_cache, chunked_lm_loss,
                     cross_entropy_loss, declare_dense, decode_fused_plan, dense, dense_weight,
                     new_param, pallas_lm_loss, resolve_remat_policy, shift_labels)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    cache_len: Optional[int] = None    # decode KV-cache length; None: n_positions
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    embd_pdrop: float = 0.0               # dropout: only 0.0 is ported
    attn_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    remat: bool = False                   # activation checkpointing per block
    remat_policy: str = "nothing_saveable"
    attn_impl: str = "auto"               # auto | jnp | flash
    fused_mlp: bool = False               # the fused FFN kernels where MLP.use_fused allows
    vocab_pad_multiple: int = 128
    moe: Optional[Any] = None             # mixture of experts: not ported
    decode_fused: Optional[bool] = None   # None: on for the card, off on the CPU
    # chunked tied-head loss (common.chunked_lm_loss): token rows per chunk;
    # None = dense logits. With labels, the output then carries only "loss".
    loss_chunk: Optional[int] = None
    # chunked head backward: replay the logits saved in forward in the
    # compute dtype (True) or recompute them (False)
    loss_save_logits: bool = False
    # the fused CE head kernels (ops/fused_ce.py) for the loss_chunk head:
    # the logits never reach device memory. Without loss_chunk the dense
    # head runs, as in the JAX package.
    loss_pallas: bool = False
    # weight-only int8 serving (ops/w8.py): dense kernels stored as int8
    # codes + grouped fp32 scales. Set by init_inference.
    w8: bool = False
    w8_group: int = 128

    def __post_init__(self):
        todo = "is not ported to the PyTorch model yet"
        for name in ("embd_pdrop", "attn_pdrop", "resid_pdrop"):
            if getattr(self, name) > 0.0:
                raise NotImplementedError(f"{name} > 0 (dropout) {todo} (ROADMAP.md A2)")
        if self.moe is not None:
            raise NotImplementedError(f"moe {todo} (ROADMAP.md A9)")
        if self.remat:
            resolve_remat_policy(self.remat_policy)   # unknown or unported: raise at build

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} is not a multiple of n_head {self.n_head}")
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        """KV heads of the cache (the batcher's family-blind name): GPT-2 is MHA."""
        return self.n_head


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


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_embd
        declare_dense(self, "c_attn", E, 3 * E, cfg, device, dtype)
        declare_dense(self, "c_proj", E, E, cfg, device, dtype)

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
            kc, vc, cur = append_kv_cache(layer_cache, k, v, self.cfg.cache_len)
            y = cached_decode_attention(q, kc, vc, cur, mask)
        return y.reshape(B, S, self.cfg.n_embd)

    def forward(self, x, mask, layer_cache=None):
        dt = self.cfg.dtype
        y = self.mix(dense(x, dense_weight(self, "c_attn", dt), self.c_attn_bias, dt), mask,
                     layer_cache)
        return dense(y, dense_weight(self, "c_proj", dt), self.c_proj_bias, dt)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        E, F = cfg.n_embd, 4 * cfg.n_embd
        declare_dense(self, "c_fc", E, F, cfg, device, dtype)
        declare_dense(self, "c_proj", F, E, cfg, device, dtype)

    def use_fused(self) -> bool:
        """The JAX package's rule (``models/gpt2.py:322-330``): ``fused_mlp``,
        no residual dropout, full-width weights, and both panels within
        :func:`~deepspeed_tpu_torch.ops.fused_mlp.fits_vmem` at the compute
        dtype. Where the JAX rule also asks for a TPU, the port asks for
        nothing: CPU tensors run the kernels' plain versions."""
        cfg = self.cfg
        return (cfg.fused_mlp and cfg.resid_pdrop == 0.0 and not cfg.w8
                and fits_vmem(cfg.n_embd, 4 * cfg.n_embd, 128, cfg.dtype.itemsize))

    def forward(self, x):
        dt = self.cfg.dtype
        if self.use_fused():
            return fused_mlp(x, dense_weight(self, "c_fc", dt), self.c_fc_bias.to(dt),
                             dense_weight(self, "c_proj", dt), self.c_proj_bias.to(dt))
        h = nn.functional.gelu(dense(x, dense_weight(self, "c_fc", dt), self.c_fc_bias, dt),
                               approximate="tanh")   # gelu_new
        return dense(h, dense_weight(self, "c_proj", dt), self.c_proj_bias, dt)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device, dtype)
        self.attn = SelfAttention(cfg, device, dtype)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device, dtype)
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
        qkv = fused_norm_proj(x, self.ln_1.scale, self.ln_1.bias, dense_weight(attn, "c_attn", dt),
                              attn.c_attn_bias, eps=cfg.layer_norm_epsilon)
        y = attn.mix(qkv, mask, layer_cache)
        return fused_post_attn(
            y, x, dense_weight(attn, "c_proj", dt), attn.c_proj_bias,
            self.ln_2.scale, self.ln_2.bias,
            (dense_weight(mlp, "c_fc", dt), mlp.c_fc_bias, dense_weight(mlp, "c_proj", dt),
             mlp.c_proj_bias),
            eps=cfg.layer_norm_epsilon)


class GPT2LMHeadModel(nn.Module):
    """Causal-LM GPT-2 with tied embeddings; ``forward`` returns a
    :class:`ModelOutput` with ``logits`` ``(B, S, padded_vocab)``, the
    padded columns at ``finfo(dtype).min``, and ``loss`` when given
    ``labels`` (only ``loss`` under ``loss_chunk``).

    Parameters are created uninitialised (``torch.empty``): call
    :meth:`init_weights` or load a state dict. ``has_values`` says whether
    one of the two has run (the training engine then takes the values)."""

    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.has_values = False
        E = cfg.n_embd
        self.wte = new_param((cfg.padded_vocab_size, E), device, dtype)
        self.wpe = new_param((cfg.n_positions, E), device, dtype)
        self.h = nn.ModuleList(Block(cfg, device, dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT2LMHeadModel":
        """The flax initialisers: normal(0.02) for embeddings and input
        projections, normal(0.02 / sqrt(2 L)) for the two residual
        projections, zero biases, unit LayerNorm scale (and under ``w8`` the
        flax initialisers of the pairs: zero codes, unit scales). Draws happen
        on the generator's device and are copied in, so a CPU generator gives
        the same weights wherever the model lives."""
        std = self.cfg.initializer_range
        proj_std = std / math.sqrt(2 * self.cfg.n_layer)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf.endswith("_kernel_s"):
                p.fill_(1.0)
            elif leaf.endswith("_kernel_q"):
                p.zero_()
            elif leaf.endswith("_bias") or leaf == "bias":
                p.zero_()
            else:
                s = proj_std if leaf == "c_proj_kernel" else std
                w = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
                p.copy_(w.normal_(0.0, s, generator=generator))
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
        shifts them by one, for ``labels=input_ids``); with ``loss_chunk``
        the output then holds only ``loss``."""
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
        remat = None
        if cfg.remat and cache is None and torch.is_grad_enabled():
            remat = resolve_remat_policy(cfg.remat_policy)
        for i, block in enumerate(self.h):
            if remat is not None:
                h = remat(block, h, mask)
            else:
                h = block(h, mask, None if cache is None else cache[i])
        h = self.ln_f(h)
        tgt = None if labels is None else (shift_labels(labels) if shift else labels)
        if cfg.loss_chunk and tgt is not None:
            # memory-bounded head: the logits never exist whole (the JAX
            # package takes the fused head only on a TPU with a one-device
            # plan; the port always has one device, and the kernels run
            # wherever the tensors are on the card)
            kw = dict(vocab_size=cfg.vocab_size, padded_vocab_size=cfg.padded_vocab_size,
                      dtype=dt)
            if cfg.loss_pallas:
                return ModelOutput(loss=pallas_lm_loss(h, self.wte, tgt, **kw))
            return ModelOutput(loss=chunked_lm_loss(
                h, self.wte, tgt, chunk=cfg.loss_chunk, save_logits=cfg.loss_save_logits, **kw))
        logits = h @ self.wte.to(dt).T
        if cfg.padded_vocab_size != cfg.vocab_size:
            # padded vocab columns out of the softmax (in place on the
            # product's output, which its backward does not read: the
            # columns get zero gradient)
            logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
        out = ModelOutput(logits=logits)
        if tgt is not None:
            out["loss"] = cross_entropy_loss(logits, tgt)
        return out

    def dummy_inputs(self, batch_size: int = 2, seq_len: Optional[int] = None) -> dict:
        S = seq_len or min(self.cfg.n_positions, 128)
        ids = torch.zeros((batch_size, S), dtype=torch.long)
        return {"input_ids": ids, "labels": ids}

    def flops_per_token(self) -> float:
        """6·N_params + attention flops, for MFU accounting (the JAX
        package's formula)."""
        cfg = self.cfg
        n_params = (cfg.padded_vocab_size * cfg.n_embd + cfg.n_positions * cfg.n_embd
                    + cfg.n_layer * (12 * cfg.n_embd ** 2 + 13 * cfg.n_embd) + 2 * cfg.n_embd)
        attn = 12 * cfg.n_layer * cfg.n_embd * cfg.n_positions
        return 6.0 * n_params + attn
