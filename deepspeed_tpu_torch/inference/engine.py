"""Inference engine: ``engine(input_ids)`` forward and ``generate()``.

Port of ``deepspeed_tpu/inference/engine.py`` for one card. The engine
holds its own copy of the model's weights at the serving dtype on its
device; ``forward`` runs the model, ``generate`` prefills a KV cache and
then steps a plain Python tick loop (the JAX package's compiled
``lax.scan`` loop; CUDA graphs for the tick are later work).

The engine runs on the card: ``device=None`` means ``"cuda"``, and without
CUDA it raises unless the caller asks for ``device="cpu"``. On the card it
turns TF32 off for fp32 matmuls and convolutions, so fp32 results are full
fp32, and bf16 reductions in reduced precision off.

Options the JAX engine has and this slice does not port raise
``NotImplementedError`` (see ROADMAP.md) instead of being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from ..models.common import init_layer_cache
from ..models.convert import gpt2_params_from_jax, is_flax_tree
from ..models.gpt2 import GPT2LMHeadModel, LayerNorm
from ..utils.logging import logger


@dataclasses.dataclass
class InferenceConfig:
    """The ``init_inference`` keyword set of the JAX package."""

    mp_size: int = 1
    ep_size: int = 1
    dtype: Any = None                  # default bf16
    max_tokens: Optional[int] = None   # generation / cache limit
    checkpoint: Optional[str] = None
    quant: dict = dataclasses.field(default_factory=dict)
    decode_fused: Optional[bool] = None   # None keeps the model's own flag
    prefix_cache: Any = None
    specdec: Any = None
    paged_decode: Any = None

    @staticmethod
    def load(d) -> "InferenceConfig":
        if isinstance(d, InferenceConfig):
            return d
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(InferenceConfig)}
        extra = sorted(k for k in d if k not in known)
        if extra:
            raise ValueError(f"init_inference: unsupported keys {extra}")
        cfg = InferenceConfig(**d)
        cfg.check_ported()
        return cfg

    def check_ported(self) -> None:
        todo = "is not ported to the PyTorch/CUDA engine yet (ROADMAP.md, queue A)"
        if self.mp_size > 1 or self.ep_size > 1:
            raise NotImplementedError(f"mp_size/ep_size > 1 (multi-card serving) {todo}")
        if self.quant.get("enabled"):
            raise NotImplementedError(f"quant (int8 / fake-quant weights) {todo}")
        for name in ("prefix_cache", "specdec", "paged_decode", "checkpoint"):
            if getattr(self, name):
                raise NotImplementedError(f"{name} {todo}")


def resolve_device(device) -> torch.device:
    """``None`` → the card. Never moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_inference runs on the card and CUDA is not available; "
                           "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


class InferenceEngine:
    """Serving wrapper around a :class:`GPT2LMHeadModel`.

    ``params``: a state dict of the port, or a flax GPT-2 param tree of
    numpy arrays (converted by ``models/convert.py``); None takes the
    model's own weights."""

    def __init__(self, model: GPT2LMHeadModel = None, config=None,
                 params: Optional[Mapping] = None, device=None, **kwargs):
        merged = dict(config or {})
        merged.update(kwargs)
        self.config = InferenceConfig.load(merged)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        cfg = model.cfg
        dtype = self.config.dtype or torch.bfloat16
        over = {"dtype": dtype}
        if self.config.decode_fused is not None:
            over["decode_fused"] = bool(self.config.decode_fused)
        self.model_cfg = dataclasses.replace(cfg, **over)
        self._gen_limit, self.cache_len = self._limits(self.model_cfg)
        self.module = GPT2LMHeadModel(self.model_cfg, device=self.device, dtype=dtype)
        self.module.requires_grad_(False)
        self.load_params(model.state_dict() if params is None else params)

    def _limits(self, cfg):
        """Generation limit and KV-cache length: the learned-position rule of
        the JAX engine. The position table keeps the model's length, so
        ``max_tokens`` past it is capped; below it, the cache shrinks to
        ``max_tokens`` (decode reads the whole cache every tick). A
        ``cache_len`` set on the model config caps both."""
        model_limit = cfg.n_positions
        requested = self.config.max_tokens
        gen_limit, cache_len = model_limit, model_limit
        if requested and requested != model_limit:
            gen_limit = min(requested, model_limit)
            cache_len = gen_limit
            if requested > model_limit:
                logger.warning(f"max_tokens={requested} exceeds the learned position "
                               f"table (n_positions={model_limit}); generation is "
                               f"capped at {model_limit}")
        if cfg.cache_len:
            gen_limit = min(gen_limit, cfg.cache_len)
            cache_len = min(cfg.cache_len, cache_len)
        return gen_limit, cache_len

    @torch.no_grad()
    def load_params(self, params: Mapping) -> "InferenceEngine":
        """Copy weights in at the serving dtype. LayerNorm parameters take
        the serving dtype's values (as in the JAX engine, which stores every
        float leaf at it) but stay fp32 tensors, which the fused kernels
        read without a per-tick conversion."""
        if is_flax_tree(params):
            params = gpt2_params_from_jax(params, self.model_cfg)
        own = dict(self.module.named_parameters())
        missing = sorted(own.keys() - params.keys())
        extra = sorted(params.keys() - own.keys())
        if missing or extra:
            raise KeyError(f"load_params: missing {missing[:5]}, unexpected {extra[:5]}")
        norm = {f"{m}.{p}" for m, mod in self.module.named_modules()
                if isinstance(mod, LayerNorm) for p, _ in mod.named_parameters()}
        dtype = self.model_cfg.dtype
        for name, p in own.items():
            src = torch.as_tensor(params[name]).to(dtype)
            if name in norm:
                p.data = src.to(device=self.device, dtype=torch.float32)
            else:
                p.copy_(src)
        n = sum(p.numel() for p in own.values())
        logger.info(f"inference params loaded: {n / 1e6:.1f}M on {self.device}")
        return self

    # ------------------------------------------------------------------
    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """Logits ``(B, S, padded_vocab)`` at the serving dtype."""
        ids = self._ids(input_ids)
        if ids.shape[1] > self.model_cfg.n_positions:
            raise ValueError(f"sequence of {ids.shape[1]} exceeds the position table "
                             f"(n_positions={self.model_cfg.n_positions})")
        return self.module(ids).logits

    __call__ = forward

    def init_cache(self, batch_size: int) -> list:
        cfg = self.model_cfg
        return [init_layer_cache(batch_size, self.cache_len, cfg.n_head, cfg.head_dim,
                                 cfg.dtype, self.device) for _ in range(cfg.n_layer)]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0,
                 seed: int = 0, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None) -> torch.Tensor:
        """Prefill, then one tick per new token; returns ``(B, S +
        max_new_tokens)`` token ids on the engine's device.

        Greedy when ``temperature == 0``; ``top_k``, ``top_p`` and
        ``repetition_penalty`` follow the HF semantics. A sequence that
        emits ``eos_token_id`` is padded with ``pad_token_id`` (default: the
        EOS id) from then on. Sampling draws from a ``torch.Generator``
        seeded with ``seed``."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        if S + max_new_tokens > self._gen_limit:
            raise ValueError(f"prompt({S}) + max_new_tokens({max_new_tokens}) exceeds the "
                             f"generation limit {self._gen_limit} (max_tokens/model context)")
        cache = self.init_cache(B)
        positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
        logits = self.module(ids, position_ids=positions, cache=cache).logits
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pad = eos_token_id if pad_token_id is None else pad_token_id
        seen = None
        if repetition_penalty != 1.0:
            seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=self.device)
            seen.scatter_(1, ids, True)
        rows = torch.arange(B, device=self.device)

        token = _sample(logits[:, -1, :].float(), gen, temperature, top_k, top_p,
                        repetition_penalty, seen)
        done = None if eos_token_id is None else token == eos_token_id
        tokens = [token]
        for t in range(max_new_tokens - 1):
            if seen is not None:
                seen[rows, token] = True
            pos = torch.full((B, 1), S + t, device=self.device)
            logits = self.module(token[:, None], position_ids=pos, cache=cache).logits
            token = _sample(logits[:, -1, :].float(), gen, temperature, top_k, top_p,
                            repetition_penalty, seen)
            if done is not None:   # finished rows emit pad from then on
                token = torch.where(done, pad, token)
                done = done | (token == eos_token_id)
            tokens.append(token)
        return torch.cat([ids, torch.stack(tokens, dim=1)], dim=1)


def _penalized_logits(logits, repetition_penalty=1.0, seen_mask=None):
    """Repetition penalty on fp32 logits ``(B, V)``: seen tokens' logits are
    divided (if positive) or multiplied (if negative) by the penalty."""
    if seen_mask is not None:
        pen = torch.where(logits > 0, logits / repetition_penalty,
                          logits * repetition_penalty)
        logits = torch.where(seen_mask, pen, logits)
    return logits


def _filtered_logits(logits, temperature: float, top_k: int, top_p: float = 1.0):
    """Penalised logits → the categorical's input: temperature, top-k mask,
    nucleus mask (the smallest prefix of descending-probability tokens
    whose mass reaches ``top_p``; the top token always survives)."""
    scaled = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        mass_before = torch.cumsum(probs, dim=-1) - probs
        thr = torch.where(mass_before < top_p, sorted_desc,
                          torch.full_like(sorted_desc, float("inf"))).amin(-1, keepdim=True)
        scaled = scaled.masked_fill(scaled < thr, float("-inf"))
    return scaled


def _sample(logits, generator: torch.Generator, temperature: float, top_k: int = 0,
            top_p: float = 1.0, repetition_penalty: float = 1.0, seen_mask=None):
    """Greedy (``temperature <= 0``, first maximum on ties) or sampled token
    per row of fp32 logits ``(B, V)``."""
    logits = _penalized_logits(logits, repetition_penalty, seen_mask)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
