"""Inference engine: ``engine(input_ids)`` forward and ``generate()``.

Port of ``deepspeed_tpu/inference/engine.py`` for one card. The engine
builds a model of the family it is given (GPT-2, LLaMA or GPT-NeoX) and holds its own
copy of the weights at the serving dtype on its device; ``forward`` runs the
model, ``generate`` prefills a KV cache and then runs one decode tick per
new token. ``compiled_loop=True`` (the default, as in the JAX package, whose
loop is one ``lax.scan`` program) replays the tick as a CUDA graph on the
card (``inference/graphs.py``): the tick reads and writes the static
buffers of its batch width (:class:`_DecodeState`), and graphs are cached
per static key, at most :data:`GRAPH_CACHE` of them, as the JAX package
bounds its executables. ``compiled_loop=False`` steps the same tick function
eagerly and stops once every row is done.

The generation limit and the KV cache length follow the JAX engine's rule.
A model whose parameter shapes depend on its context field (GPT-2's learned
position table, ``n_positions``) keeps that length: ``max_tokens`` below it
shrinks the cache, above it is capped. A rotary model (LLaMA, GPT-NeoX;
``max_position_embeddings``) sizes its cache and limit from ``max_tokens``,
below or above the trained context. A ``cache_len`` set on the model config
caps both.

The engine runs on the card: ``device=None`` means ``"cuda"``, and without
CUDA it raises unless the caller asks for ``device="cpu"``. On the card it
turns TF32 off for fp32 matmuls and convolutions, so fp32 results are full
fp32, and bf16 reductions in reduced precision off.

``quant={"enabled": True}`` takes the JAX engine's two branches: with
``bits`` (or ``qtype``) 8 and no ``fake``, W8A16 serving — each dense
kernel is quantized at load (in fp32, before the cast to the serving dtype,
``group_size`` rows per scale, default 128) and stored as int8 codes + fp32
scales (``ops/w8.py``); a tree already quantized by the JAX engine is
copied as it is. Otherwise every ≥ 2-D leaf of the given tree, embeddings
included, is fake-quantized to ``bits`` in ``groups`` groups (default 64,
one group where the size does not divide) and stored at the serving dtype.

Options the JAX engine has and this slice does not port raise
``NotImplementedError`` (see ROADMAP.md) instead of being ignored.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..models.common import (STATIC_HEAD, LayerNorm, RMSNorm, advance_heads, init_layer_cache,
                             set_cache_index)
from ..models.convert import _tensor, is_flax_tree, params_from_jax
from ..ops.decode_layer import tickets_needed
from ..ops.quantizer import fake_quantize
from ..ops.w8 import quantize_state_dict
from ..utils.logging import logger
from .graphs import DecodeGraph

GRAPH_CACHE = 16    # decode graphs an engine keeps (the JAX engine's lru_cache(maxsize=16))
DECODE_WIDTHS = 4   # batch widths whose static decode buffers an engine keeps


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
        for name in ("specdec", "checkpoint"):
            if getattr(self, name):
                raise NotImplementedError(f"{name} {todo}")
        prefix_on = isinstance(self.prefix_cache, dict) or bool(self.prefix_cache)
        if prefix_on and self.paged_decode is False:
            raise NotImplementedError(f"prefix_cache with paged_decode=False (the gather "
                                      f"path) {todo}")


def resolve_device(device, entry: str = "init_inference") -> torch.device:
    """``None`` → the card. Never moves to the CPU by itself. On the card,
    TF32 is off for fp32 matmuls and convolutions (fp32 results are full
    fp32) and so are reduced-precision bf16 reductions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{entry} runs on the card and CUDA is not available; "
                               "pass device='cpu' to run the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def _position_field(cfg) -> str:
    """The config field naming a family's context length."""
    return "n_positions" if hasattr(cfg, "n_positions") else "max_position_embeddings"


def _params_depend_on(model_cls, cfg, field: str) -> bool:
    """True when a parameter SHAPE is a function of ``field`` (a learned
    position table sized by it): the JAX engine's ``_params_depend_on``,
    with models built on the meta device."""
    def shapes(c):
        with torch.device("meta"):
            return [tuple(p.shape) for p in model_cls(c).parameters()]

    return shapes(cfg) != shapes(dataclasses.replace(cfg, **{field: 2 * getattr(cfg, field)}))


@dataclasses.dataclass
class _DecodeState:
    """The static buffers ``generate``'s decode ticks run over at one batch
    width ``B``: a contiguous cache whose layers share one ``(B,)`` write
    head (``static_head``), the token and positions the next tick reads, the
    done flags, the seen mask of the repetition penalty ``(B, V)``, the
    penalty, EOS and pad values (device scalars, so that they are no part of
    a graph's key), the output rows ``(gen_limit, B)`` and the tick counter
    that indexes them, and the generator sampled ticks draw from."""

    cache: list
    head: torch.Tensor
    token: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    seen: torch.Tensor
    rep: torch.Tensor
    eos: torch.Tensor
    pad: torch.Tensor
    out: torch.Tensor
    idx: torch.Tensor
    generator: torch.Generator


class InferenceEngine:
    """Serving wrapper around a port model (``GPT2LMHeadModel``,
    ``LlamaForCausalLM`` or ``GPTNeoXForCausalLM``): the engine builds its
    own of the same class.

    ``params``: a state dict of the port, or a flax param tree of the
    model's family as numpy arrays (converted by ``models/convert.py``);
    None takes the model's own weights."""

    def __init__(self, model: torch.nn.Module = None, config=None,
                 params: Optional[Mapping] = None, device=None, **kwargs):
        merged = dict(config or {})
        merged.update(kwargs)
        self.config = InferenceConfig.load(merged)
        self.device = resolve_device(device)
        cfg = model.cfg
        dtype = self.config.dtype or torch.bfloat16
        over = {"dtype": dtype}
        q = self.config.quant
        bits = int(q.get("bits", q.get("qtype", 8)))
        # W8A16 serving, or the fake-quant load branch (the JAX engine's rule)
        self._w8 = bool(q.get("enabled")) and bits == 8 and not q.get("fake", False)
        self._fake_bits = bits if q.get("enabled") and not self._w8 else None
        if self._w8:
            over.update(w8=True, w8_group=int(q.get("group_size", 128)))
        if self.config.decode_fused is not None:
            over["decode_fused"] = bool(self.config.decode_fused)
        self.model_cfg = dataclasses.replace(cfg, **over)
        self._pos_field = _position_field(cfg)
        self._learned_positions = _params_depend_on(type(model), self.model_cfg, self._pos_field)
        self._gen_limit, self.cache_len = self._limits(self.model_cfg)
        # the decode model knows its cache length (the paged path slices its
        # gathered view to it), as the JAX engine's decode_cfg does
        self.model_cfg = dataclasses.replace(self.model_cfg, cache_len=self.cache_len)
        self.module = type(model)(self.model_cfg, device=self.device, dtype=dtype)
        self.module.requires_grad_(False)
        self._tickets = tickets_needed(self.module)
        # generate's static decode buffers by batch width, and its decode
        # graphs by static key (each with the state it was captured over)
        self._decode_states: OrderedDict = OrderedDict()
        self._graphs: OrderedDict = OrderedDict()
        self.params_version = 0   # bumped by load_params: graphs over old weights are stale
        self.load_params(model.state_dict() if params is None else params)

    def _limits(self, cfg):
        """Generation limit and KV-cache length, the JAX engine's rule. A
        learned position table keeps the model's length, so ``max_tokens``
        past it is capped; below it, the cache shrinks to ``max_tokens``
        (decode reads the whole cache every tick). A rotary model takes
        ``max_tokens`` as it is, below or above its trained context. A
        ``cache_len`` set on the model config caps both."""
        field = self._pos_field
        model_limit = getattr(cfg, field)
        requested = self.config.max_tokens
        gen_limit = cache_len = requested or model_limit
        if self._learned_positions and requested and requested > model_limit:
            gen_limit = cache_len = model_limit
            logger.warning(f"max_tokens={requested} exceeds the learned position "
                           f"table ({field}={model_limit}); generation is "
                           f"capped at {model_limit}")
        if cfg.cache_len:
            gen_limit = min(gen_limit, cfg.cache_len)
            cache_len = min(cfg.cache_len, cache_len)
        return gen_limit, cache_len

    @torch.no_grad()
    def load_params(self, params: Mapping) -> "InferenceEngine":
        """Copy weights in at the serving dtype, after the ``quant`` option's
        quantization. LayerNorm parameters take the serving dtype's values
        (as in the JAX engine, which stores every float leaf at it) but stay
        fp32 tensors, which the fused kernels read without a per-tick
        conversion. W8A16 codes stay int8 and their scales fp32."""
        if self._fake_bits is not None:   # on the tree as given, as JAX does
            params = self._fake_quantize(params)
        if is_flax_tree(params):
            params = params_from_jax(params, self.model_cfg)
        if self._w8 and any(k.endswith("_kernel") for k in params):
            params = quantize_state_dict(params, self.model_cfg.w8_group, device=self.device)
        own = dict(self.module.named_parameters())
        missing = sorted(own.keys() - params.keys())
        extra = sorted(params.keys() - own.keys())
        if missing or extra:
            raise KeyError(f"load_params: missing {missing[:5]}, unexpected {extra[:5]}")
        norm = {f"{m}.{p}" for m, mod in self.module.named_modules()
                if isinstance(mod, (LayerNorm, RMSNorm)) for p, _ in mod.named_parameters()}
        dtype = self.model_cfg.dtype
        for name, p in own.items():
            src = torch.as_tensor(params[name])
            if p.dtype == torch.int8:           # W8A16 codes
                if src.dtype != torch.int8:
                    raise TypeError(f"load_params: {name} must be int8 codes, not {src.dtype}")
                p.copy_(src)
            elif name.endswith("_kernel_s"):    # W8A16 scales stay fp32
                p.copy_(src.float())
            elif name in norm:
                p.data = src.to(dtype).to(device=self.device, dtype=torch.float32)
            else:
                p.copy_(src.to(dtype))
        # a graph holds the weights' addresses (a norm parameter's storage is
        # replaced above): graphs captured before this load are dropped
        self._decode_states.clear()
        self._graphs.clear()
        self.params_version += 1
        n = sum(p.numel() for p in own.values())
        logger.info(f"inference params loaded: {n / 1e6:.1f}M on {self.device}"
                    + (" (W8A16 dense kernels)" if self._w8 else ""))
        return self

    def _fake_quantize(self, tree: Mapping, prefix: str = "") -> dict:
        """Every ≥ 2-D leaf of a (nested or flat) param tree fake-quantized
        in fp32 to ``bits`` in ``groups`` groups, on the engine's device; one
        group, with a warning, where the size does not divide."""
        groups = int(self.config.quant.get("groups", 64))
        out = {}
        for key, v in tree.items():
            if isinstance(v, Mapping):
                out[key] = self._fake_quantize(v, f"{prefix}{key}.")
                continue
            t = v if isinstance(v, torch.Tensor) else _tensor(np.asarray(v))
            if t.ndim < 2:
                out[key] = v
                continue
            g = groups
            if t.numel() % groups:
                g = 1
                logger.warning(f"quantizing {prefix}{key} with ONE group (size {t.numel()} not "
                               f"divisible by {groups}) — coarser than requested")
            q = fake_quantize(t.to(self.device, torch.float32), self._fake_bits, g)
            out[key] = q if isinstance(v, torch.Tensor) else q.cpu().numpy()   # a flax leaf
        return out

    # ------------------------------------------------------------------
    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """Logits ``(B, S, padded_vocab)`` at the serving dtype."""
        ids = self._ids(input_ids)
        limit = getattr(self.model_cfg, self._pos_field)
        if self._learned_positions and ids.shape[1] > limit:
            raise ValueError(f"sequence of {ids.shape[1]} exceeds the position table "
                             f"({self._pos_field}={limit})")
        return self.module(ids).logits

    __call__ = forward

    def init_cache(self, batch_size: int, per_row: bool = True,
                   static_head: bool = False) -> list:
        """A zeroed contiguous cache, one dict per layer, with a ``(B,)``
        write head per row (``per_row=False``: one host ``int`` head, the
        static batch of a prefill). ``static_head``: the layers share one
        ``(B,)`` head that appends leave alone and a decode tick advances in
        place (``models/common.advance_heads``)."""
        cfg = self.model_cfg
        head = torch.zeros((batch_size,), dtype=torch.int32, device=self.device) \
            if static_head else None
        cache = [init_layer_cache(batch_size, self.cache_len, cfg.kv_heads, cfg.head_dim,
                                  cfg.dtype, self.device, per_row or static_head, head)
                 for _ in range(cfg.n_layer)]
        if static_head:
            for layer in cache:
                layer[STATIC_HEAD] = True
        return cache

    @torch.no_grad()
    def prefill(self, cache: list, input_ids, positions):
        """The batched (suffix) prefill the continuous batcher runs (the JAX
        engine's ``_compiled_prefill``): ``input_ids`` ``(B, S)`` at
        ``positions`` ``(1, S)`` or ``(B, S)`` appended to ``cache`` in
        place; returns ``(logits, cache)``."""
        ids = self._ids(input_ids)
        pos = torch.as_tensor(positions, dtype=torch.long, device=self.device)
        return self.module(ids, position_ids=pos, cache=cache).logits, cache

    def _decode_state(self, B: int) -> _DecodeState:
        """The static decode buffers of batch width ``B``, made at first use;
        the engine keeps :data:`DECODE_WIDTHS` widths and drops the graphs
        of a width it lets go."""
        st = self._decode_states.pop(B, None)
        if st is None:
            while len(self._decode_states) >= DECODE_WIDTHS:
                old, _ = self._decode_states.popitem(last=False)
                for key in [k for k in self._graphs if k[0] == old]:
                    del self._graphs[key]
            dev, long = self.device, torch.long
            cache = self.init_cache(B, static_head=True)
            st = _DecodeState(
                cache=cache, head=cache[0]["cache_index"],
                token=torch.zeros((B,), dtype=long, device=dev),
                pos=torch.zeros((B,), dtype=long, device=dev),
                done=torch.zeros((B,), dtype=torch.bool, device=dev),
                seen=torch.zeros((B, self.model_cfg.padded_vocab_size), dtype=torch.bool,
                                 device=dev),
                rep=torch.ones((), dtype=torch.float32, device=dev),
                eos=torch.full((), -1, dtype=long, device=dev),
                pad=torch.zeros((), dtype=long, device=dev),
                out=torch.zeros((self._gen_limit, B), dtype=long, device=dev),
                idx=torch.zeros((1,), dtype=long, device=dev),
                generator=torch.Generator(device=dev))
        self._decode_states[B] = st
        return st

    def _decode_tick(self, st: _DecodeState, temperature: float, top_k: int, top_p: float,
                     penalty: bool):
        """ONE decode tick over ``st``, in place (the JAX engine's
        ``_decode_tick``, shared by the compiled and the stepwise loop, so
        that they agree token for token by construction): the forward of
        the last token at its position appends to the cache, the next token
        is sampled, finished rows emit pad from then on, EOS latches done,
        the token joins the seen mask, lands in the output row the tick
        counter names, and the token, positions, head and counter advance."""
        module, seen = self.module, st.seen if penalty else None

        def tick():
            logits = module(st.token[:, None], position_ids=st.pos[:, None],
                            cache=st.cache).logits
            nxt = _sample(logits[:, -1, :].float(), st.generator, temperature, top_k, top_p,
                          st.rep, seen)
            nxt = torch.where(st.done, st.pad, nxt)
            st.done.logical_or_(nxt == st.eos)
            if seen is not None:
                seen.scatter_(1, nxt[:, None], True)
            st.out.index_copy_(0, st.idx, nxt[None])
            st.token.copy_(nxt)
            st.pos.add_(1)
            advance_heads(st.cache)
            st.idx.add_(1)

        return tick

    def _decode_graph(self, st: _DecodeState, key: tuple, tick) -> DecodeGraph:
        """The decode graph of ``key``, captured over ``st`` at its first
        run; the engine keeps the :data:`GRAPH_CACHE` most recently used."""
        entry = self._graphs.pop(key, None)
        if entry is None or entry[0] is not st:
            while len(self._graphs) >= GRAPH_CACHE:
                self._graphs.popitem(last=False)
            entry = (st, DecodeGraph(tick, self.device, st.generator, self._tickets))
        self._graphs[key] = entry
        return entry[1]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0,
                 seed: int = 0, eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 compiled_loop: bool = True) -> torch.Tensor:
        """Prefill, then one decode tick per new token; returns token ids on
        the engine's device.

        Greedy when ``temperature == 0``; ``top_k``, ``top_p`` and
        ``repetition_penalty`` follow the HF semantics. A sequence that
        emits ``eos_token_id`` is padded with ``pad_token_id`` (default: the
        EOS id) from then on. Sampling draws from a ``torch.Generator``
        seeded with ``seed``.

        ``compiled_loop=True`` runs every tick after the first token as a
        replay of a captured CUDA graph on the card (the same tick function
        without capture on the CPU) and always returns ``(B, S +
        max_new_tokens)``. ``compiled_loop=False`` steps the tick eagerly,
        reads the done flags back once a tick and stops once every row is
        done, so it may return fewer columns (the JAX package's two paths)."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        if S + max_new_tokens > self._gen_limit:
            raise ValueError(f"prompt({S}) + max_new_tokens({max_new_tokens}) exceeds the "
                             f"generation limit {self._gen_limit} (max_tokens/model context)")
        st = self._decode_state(B)
        set_cache_index(st.cache, 0)
        positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
        logits = self.module(ids, position_ids=positions, cache=st.cache).logits
        set_cache_index(st.cache, S)     # a static head: the prefill's appends left it at 0
        penalty = repetition_penalty != 1.0
        pad = eos_token_id if pad_token_id is None else pad_token_id
        st.rep.fill_(repetition_penalty)
        st.eos.fill_(-1 if eos_token_id is None else eos_token_id)
        st.pad.fill_(0 if pad is None else pad)
        if penalty:
            st.seen.zero_()
            st.seen.scatter_(1, ids, True)
        st.generator.manual_seed(seed)
        token = _sample(logits[:, -1, :].float(), st.generator, temperature, top_k, top_p,
                        st.rep, st.seen if penalty else None)
        st.token.copy_(token)
        st.pos.fill_(S)
        torch.eq(token, st.eos, out=st.done)
        if penalty:
            st.seen.scatter_(1, token[:, None], True)
        st.idx.zero_()
        tick = self._decode_tick(st, temperature, top_k, top_p, penalty)
        n = max(max_new_tokens - 1, 0)
        if compiled_loop:
            key = (B, self.cache_len, self.model_cfg.dtype, temperature <= 0.0, int(top_k),
                   float(top_p), float(temperature), penalty)
            self._decode_graph(st, key, tick).run(n)
        else:
            for t in range(n):
                tick()
                if eos_token_id is not None and bool(st.done.all()):
                    n = t + 1
                    break
        return torch.cat([ids, token[:, None], st.out[:n].T], dim=1)


def _penalized_logits(logits, repetition_penalty=1.0, seen_mask=None):
    """Repetition penalty on fp32 logits ``(B, V)``: seen tokens' logits are
    divided (if positive) or multiplied (if negative) by the penalty."""
    if seen_mask is not None:
        pen = torch.where(logits > 0, logits / repetition_penalty,
                          logits * repetition_penalty)
        logits = torch.where(seen_mask, pen, logits)
    return logits


def _filtered_logits(logits, temperature, top_k: int, top_p=1.0):
    """Penalised logits → the categorical's input: temperature, top-k mask,
    nucleus mask (the smallest prefix of descending-probability tokens
    whose mass reaches ``top_p``; the top token always survives).

    ``temperature`` and ``top_p`` are python floats (one value for the
    batch) or ``(B,)`` tensors, one per row (the continuous batcher); a
    per-row ``top_p`` keeps the nucleus live for every row, as the JAX
    package's traced ``top_p`` does (``<= 0`` means 1)."""
    if isinstance(temperature, torch.Tensor):
        scaled = logits / temperature.clamp(min=1e-6)[:, None]
    else:
        scaled = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if isinstance(top_p, torch.Tensor):
        p = torch.where(top_p <= 0.0, torch.ones_like(top_p), top_p)[:, None]
    elif 0.0 < top_p < 1.0:
        p = top_p
    else:
        return scaled
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # the nucleus's mass in fp64: an fp32 softmax's normaliser rounds apart
    # on the card and the CPU (~1e-6 at V = 50257), and bf16-valued logits
    # tie in blocks, so in fp32 a tied block at the boundary can be kept on
    # one device and dropped on the other
    probs = torch.softmax(sorted_desc.double(), dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    thr = torch.where(mass_before < p, sorted_desc,
                      torch.full_like(sorted_desc, float("inf"))).amin(-1, keepdim=True)
    return scaled.masked_fill(scaled < thr, float("-inf"))


def _sample(logits, generator: torch.Generator, temperature: float, top_k: int = 0,
            top_p: float = 1.0, repetition_penalty: float = 1.0, seen_mask=None):
    """Greedy (``temperature <= 0``, first maximum on ties) or sampled token
    per row of fp32 logits ``(B, V)``."""
    logits = _penalized_logits(logits, repetition_penalty, seen_mask)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
