"""Shared model plumbing: LayerNorm and RMSNorm math and modules, the dense
layer (full width or W8A16), model outputs, the
losses, the remat policies, the KV-cache contract and the fused decode-tick
dispatch.

Port of ``deepspeed_tpu/models/common.py``. The losses are
:func:`cross_entropy_loss` (dense logits), :func:`chunked_lm_loss`, the
tied-head cross-entropy whose ``(N, V)`` fp32 logits and cotangent never
exist whole (``_FusedCE``, the JAX package's ``_fused_ce`` custom vjp), and
:func:`pallas_lm_loss`, the same loss through the fused CE head kernels
(``ops/fused_ce.py``), whose logits never reach device memory at all.

The cache is a list with one dict per layer holding the leaves the JAX
package names (``cached_key``, ``cached_value``, ``cache_index`` and, in a
paged cache, ``page_table``). Every append writes IN PLACE (JAX returns a
new cache tree and leans on buffer donation; the port saves the copy, so
the JAX donation/``adopt`` dance has no counterpart here).

Three layouts share :func:`append_kv_cache`:

- contiguous, one write head: K/V ``(B, cache_len, KV, D)`` (the KV heads:
  ``n_head`` without grouped-query attention), ``cache_index``
  a host ``int`` (``engine.generate``, prefill caches), so slicing needs no
  device round trip;
- contiguous, per-row heads: the same buffers with ``cache_index`` a
  ``(B,)`` int32 tensor (the continuous batcher's slot pool, where JAX
  vmaps a one-row cache per slot);
- paged: K/V are the shared page arena ``(P, pt, KV, D)``, ``page_table``
  ``(B, T)`` int32 and ``cache_index`` ``(B,)`` lengths (page-resident
  serving, ``inference/kvreuse.py``).

An append advances the head by binding ``cur + S`` in the layer's dict. A
decode tick that is captured as a CUDA graph cannot do that: the graph
reads fixed addresses. Its cache carries ``static_head`` (True): every layer
shares ONE ``(B,)`` head tensor, an append leaves it as it is, and the tick
advances it in place once, after every layer has read it
(:func:`advance_heads`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ..ops import flash_attention as _flash  # noqa: F401 (registers the flash forward op)
from ..ops.decode_layer import norm_proj_supported, post_attn_supported
from ..ops.fused_ce import fused_ce_sum
from ..ops.paged_attention import PagedKV
from ..ops.w8 import w8_group_size, w8a16_matmul

KV_CACHE_LEAVES = ("cached_key", "cached_value")
CACHE_INDEX_LEAF = "cache_index"
# present only in PAGED caches (inference/kvreuse.py builds them): the
# per-row page table mapping token range [j*pt, (j+1)*pt) to an arena page.
# Its presence is how append_kv_cache detects paged mode.
PAGE_TABLE_LEAF = "page_table"
# True in a decode tick's cache: the layers share one head tensor that the
# tick advances in place (advance_heads); appends leave it as it is
STATIC_HEAD = "static_head"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last dim, cast back to x's dtype — the one
    norm math of every model module (the JAX package's ``layer_norm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMSNorm (LLaMA) over the last dim, cast back to x's dtype (the
    JAX package's ``rms_norm``)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def new_param(shape, device, dtype) -> torch.nn.Parameter:
    """An uninitialised parameter (``torch.empty``)."""
    return torch.nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class LayerNorm(torch.nn.Module):
    """LayerNorm of ``width`` channels (``scale``, ``bias``), every family's:
    the inference engine keeps the parameters of this class and of
    :class:`RMSNorm` fp32, which the fused decode kernels read."""

    def __init__(self, width: int, eps: float, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = new_param((width,), device, dtype)
        self.bias = new_param((width,), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class RMSNorm(torch.nn.Module):
    """RMSNorm of ``width`` channels (``scale`` only)."""

    def __init__(self, width: int, eps: float, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = new_param((width,), device, dtype)

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


def declare_dense(mod: torch.nn.Module, name: str, k: int, n: int, cfg, device, dtype,
                  bias: bool = True) -> None:
    """A dense layer's parameters under the flax names: ``name_kernel``
    ``(k, n)``, or under ``cfg.w8`` the pair ``name_kernel_q`` (int8
    ``(k, n)``) and ``name_kernel_s`` (fp32 ``(k/g, n)``), parameters that
    carry no gradient; and with ``bias`` ``name_bias``."""
    if cfg.w8:
        g = w8_group_size(k, cfg.w8_group)
        for suffix, shape, dt in (("_kernel_q", (k, n), torch.int8),
                                  ("_kernel_s", (k // g, n), torch.float32)):
            setattr(mod, name + suffix, torch.nn.Parameter(
                torch.empty(shape, device=device, dtype=dt), requires_grad=False))
    else:
        setattr(mod, name + "_kernel", new_param((k, n), device, dtype))
    if bias:
        setattr(mod, name + "_bias", new_param((n,), device, dtype))


def dense_weight(mod: torch.nn.Module, name: str, dtype):
    """The dense kernel at the compute dtype, or its W8A16 (codes, scales) pair."""
    if mod.cfg.w8:
        return getattr(mod, name + "_kernel_q"), getattr(mod, name + "_kernel_s")
    return getattr(mod, name + "_kernel").to(dtype)


def dense(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None, dtype=None):
    """``x @ W (+ b)``: ``weight`` a full-width kernel or a W8A16 pair
    (:func:`dense_weight`); the bias is cast to ``dtype``."""
    y = w8a16_matmul(x, *weight) if isinstance(weight, tuple) else x @ weight
    return y if bias is None else y + bias.to(dtype)


class ModelOutput(dict):
    """Attribute-accessible output dict (``logits`` and friends)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


# the JAX package's dot-saving bases (``jax.checkpoint_policies``), as the
# aten ops each saves: dots without batch dims are ``mm``/``addmm`` (a
# ``(B, S, E) @ (E, F)`` folds to ``mm``), dots with batch dims
# ``bmm``/``baddbmm``
_NO_BATCH_DOTS = ("mm", "addmm")
_BATCH_DOTS = ("bmm", "baddbmm")
REMAT_BASES = {
    "nothing_saveable": (),
    "everything_saveable": None,          # None: save every op
    "dots_saveable": _NO_BATCH_DOTS + _BATCH_DOTS,
    "checkpoint_dots": _NO_BATCH_DOTS + _BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}


def resolve_remat_policy(name: str):
    """Config remat-policy name → ``remat(fn, *args)``, which runs ``fn``
    under activation checkpointing (port of the JAX package's
    ``resolve_remat_policy``, ``models/common.py:55-119``).

    The bases are :data:`REMAT_BASES`. ``nothing_saveable`` keeps nothing
    inside the block and recomputes it all in backward
    (``torch.utils.checkpoint`` without reentrancy); ``everything_saveable``
    keeps everything (no recompute); the dot-saving bases keep the outputs
    of the matrix products and recompute everything else (the norms, the
    activations, the bf16 weight casts), through PyTorch's selective
    checkpoint, which sees aten ops (each op of the block passes through
    its Python dispatch mode, in forward and in recompute: a host cost
    per op, which dominates a small-batch step on the card; ROADMAP.md's
    first train lever). ``"<base>+flash"`` also keeps the
    flash forward op's outputs (``out`` and ``lse``, the JAX package's
    ``flash_out`` / ``flash_lse`` names), so backward does not rerun the
    forward kernel. ``+offload`` (cpu_checkpointing) raises
    ``NotImplementedError``; unknown bases and suffixes raise
    ``ValueError``."""
    parts = name.split("+")
    base, extras = parts[0], parts[1:]
    bad = [e for e in extras if e not in ("flash", "offload")]
    if bad:
        raise ValueError(f"unknown remat policy suffix {bad[0]!r} in "
                         f"{name!r} (supported: '+flash', '+offload')")
    if base not in REMAT_BASES:
        raise ValueError(f"unknown remat policy {base!r}; ported: {sorted(REMAT_BASES)}")
    if "offload" in extras:
        raise NotImplementedError(
            f"remat policy {name!r}: cpu_checkpointing (+offload) is not ported to the "
            "PyTorch engine yet (ROADMAP.md A11)")
    saved = REMAT_BASES[base]
    if saved is None:                     # everything saved: nothing to recompute
        return lambda fn, *args: fn(*args)
    flash = "flash" in extras
    if not saved and not flash:
        return functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)
    packets = {getattr(torch.ops.aten, op) for op in saved}
    if flash:
        packets.add(torch.ops.ds_tpu_torch.flash_attention_fwd)
    save, recompute = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, op, *args, **kwargs):
        return save if op.overloadpacket in packets else recompute

    return functools.partial(
        torch.utils.checkpoint.checkpoint, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts, policy))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy with ignore-index masking, fp32 softmax."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, safe[..., None]).squeeze(-1)
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def shift_labels(input_ids: torch.Tensor, pad_id: int = -100) -> torch.Tensor:
    """Next-token labels for causal LM: ``labels[t] = input_ids[t+1]``."""
    return torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], pad_id)], dim=1)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as an fp32 result accumulated in fp32 (the JAX package's
    ``preferred_element_type=float32``), whatever the inputs' dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedCE(torch.autograd.Function):
    """Chunked tied-head cross-entropy, summed over tokens (the JAX
    package's ``_fused_ce``). Inputs: ``hf (K, C, E)`` token chunks,
    ``wteT (E, Vp)``, ``tf (K, C)`` labels.

    The forward forms each chunk's ``(C, Vp)`` fp32 logits, keeps only their
    per-token ``logz``, and frees them (or keeps a copy in ``hf``'s dtype
    when ``save_logits``). The backward recomputes each chunk's logits, or
    replays the saved copy, and builds ``(p − onehot)·g`` chunk by chunk in
    place: the ``(N, Vp)`` fp32 cotangent never exists whole. Padded vocab
    columns sit at ``finfo(fp32).min`` in every pass, so their probability
    and gradient are 0."""

    @staticmethod
    def _logits(hc, wteT, vocab_size):
        logits = _mm_f32(hc, wteT)
        if wteT.shape[1] != vocab_size:
            logits[:, vocab_size:] = torch.finfo(torch.float32).min
        return logits

    @staticmethod
    def forward(ctx, hf, wteT, tf, vocab_size: int, ignore_index: int, save_logits: bool):
        total = torch.zeros((), dtype=torch.float32, device=hf.device)
        logzs, saved = [], []
        for hc, tc in zip(hf, tf):
            logits = _FusedCE._logits(hc, wteT, vocab_size)
            valid = tc != ignore_index
            safe = torch.where(valid, tc, 0).long()
            logz = torch.logsumexp(logits, dim=-1)
            nll = logz - logits.gather(1, safe[:, None])[:, 0]
            total += torch.where(valid, nll, 0.0).sum()
            logzs.append(logz)
            if save_logits:
                saved.append(logits.to(hf.dtype))
            del logits
        ctx.save_for_backward(hf, wteT, tf, torch.stack(logzs), *saved)
        ctx.vocab_size, ctx.ignore_index, ctx.save_logits = vocab_size, ignore_index, save_logits
        return total

    @staticmethod
    def backward(ctx, g):
        hf, wteT, tf, logzs, *saved = ctx.saved_tensors
        V = ctx.vocab_size
        dh = torch.empty_like(hf)
        dwteT = torch.zeros(wteT.shape, dtype=torch.float32, device=wteT.device)
        rows = torch.arange(hf.shape[1], device=hf.device)
        for c, (hc, tc) in enumerate(zip(hf, tf)):
            if ctx.save_logits:
                logits = saved[c].float()
                if wteT.shape[1] != V:
                    logits[:, V:] = torch.finfo(torch.float32).min
            else:
                logits = _FusedCE._logits(hc, wteT, V)
            valid = tc != ctx.ignore_index
            safe = torch.where(valid, tc, 0).long()
            p = logits.sub_(logzs[c][:, None]).exp_()                 # softmax rows
            p[rows, safe] -= 1.0                                      # p − onehot
            p.mul_((g * valid)[:, None])
            dlog = p.to(hc.dtype)
            del logits, p
            dh[c] = dlog @ wteT.T
            dwteT += _mm_f32(hc.T, dlog)
        return dh, dwteT.to(wteT.dtype), None, None, None, None


def chunked_lm_loss(h: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor, *,
                    vocab_size: int, padded_vocab_size: int, chunk: int, dtype,
                    ignore_index: int = -100, save_logits: bool = False) -> torch.Tensor:
    """Tied-head mean cross-entropy without the ``(B, S, V)`` fp32 logits or
    their cotangent (:class:`_FusedCE`); the same loss as the dense path.
    ``chunk >= B·S`` is one full-width chunk: one head matmul per pass."""
    B, S, E = h.shape
    if wte.shape[0] != padded_vocab_size:
        raise ValueError(f"wte has {wte.shape[0]} rows, padded vocab is {padded_vocab_size}")
    N = B * S
    chunk = min(chunk, N)
    hf, tf = h.reshape(N, E), labels.reshape(N)
    pad = (-N) % chunk
    if pad:
        hf = torch.cat([hf, hf.new_zeros((pad, E))])
        tf = torch.cat([tf, tf.new_full((pad,), ignore_index)])
    hf, tf = hf.reshape(-1, chunk, E), tf.reshape(-1, chunk)
    nll_sum = _FusedCE.apply(hf, wte.to(dtype).T, tf, vocab_size, ignore_index,
                             bool(save_logits))
    return nll_sum / (tf != ignore_index).sum().clamp(min=1)


def pallas_lm_loss(h: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor, *,
                   vocab_size: int, padded_vocab_size: int, dtype,
                   ignore_index: int = -100) -> torch.Tensor:
    """Tied-head mean cross-entropy on the fused CE head
    (:func:`~deepspeed_tpu_torch.ops.fused_ce.fused_ce_sum`: the kernels on
    CUDA tensors, their plain version on the CPU); the same contract as
    :func:`chunked_lm_loss`. The JAX wrapper pads the tokens to its tile with
    ``ignore_index`` rows; the kernels mask a ragged tile instead, which
    gives the same sum and the same valid count."""
    B, S, E = h.shape
    if wte.shape[0] != padded_vocab_size:
        raise ValueError(f"wte has {wte.shape[0]} rows, padded vocab is {padded_vocab_size}")
    tf = labels.reshape(B * S)
    nll_sum = fused_ce_sum(h.reshape(B * S, E), wte.to(dtype).T, tf, vocab_size, ignore_index)
    return nll_sum / (tf != ignore_index).sum().clamp(min=1)


def cache_leaf_kind(name: str) -> Optional[str]:
    """``"kv"`` for a K/V buffer (contiguous or the paged arena),
    ``"index"`` for the write head, ``"table"`` for a paged cache's page
    table, None for anything outside the ``append_kv_cache`` contract."""
    if name in KV_CACHE_LEAVES:
        return "kv"
    if name == CACHE_INDEX_LEAF:
        return "index"
    if name == PAGE_TABLE_LEAF:
        return "table"
    return None


def set_cache_index(cache: list, value) -> list:
    """Set every layer's write head to ``value`` (returns cache): an
    ``int`` head stays an ``int``; a per-row head is written in place (the
    same tensor, so a captured tick that reads it sees the new value) with
    ``value`` (an ``int`` or a ``(B,)`` tensor) in every row."""
    for layer in cache:
        for name in layer:
            if cache_leaf_kind(name) == "index":
                cur = layer[name]
                if not isinstance(cur, torch.Tensor):
                    layer[name] = int(value)
                elif isinstance(value, torch.Tensor):
                    cur.copy_(value)
                else:
                    cur.fill_(int(value))
    return cache


def advance_heads(cache: list, n: int = 1) -> None:
    """Advance the write heads of a ``static_head`` cache by ``n`` in place,
    each distinct head tensor once (the layers share one)."""
    done = set()
    for layer in cache:
        head = layer[CACHE_INDEX_LEAF]
        if id(head) not in done:
            done.add(id(head))
            head.add_(n)


def init_layer_cache(batch: int, cache_len: int, heads: int, head_dim: int,
                     dtype, device, per_row: bool = False, head=None) -> dict:
    """One layer's contiguous cache; ``per_row`` gives each row its own
    ``(B,)`` int32 write head instead of one host ``int``. ``head``: a
    ``(B,)`` int32 head the layers of a ``static_head`` cache share."""
    shape = (batch, cache_len, heads, head_dim)
    if head is None:
        head = torch.zeros((batch,), dtype=torch.int32, device=device) if per_row else 0
    return {"cached_key": torch.zeros(shape, dtype=dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=dtype, device=device),
            CACHE_INDEX_LEAF: head}


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once: the appends run per layer
    per tick and each ``arange`` would be a launch."""
    return torch.arange(n, device=device)


def append_kv_cache(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
                    cache_len: Optional[int] = None):
    """Write this step's K/V ``(B, S, H, D)`` at the layer's write head(s)
    and return ``(k_cache, v_cache, cur)`` with ``cur`` the head before the
    append: an ``int``, or ``(B,)`` for per-row heads. A paged cache takes
    :func:`_append_paged_kv_cache` and returns :class:`PagedKV` carriers
    that carry ``cache_len``, the contiguous cache length the model would
    have used (None: the table's span).

    A contiguous append past the cache's end raises on the CPU: the JAX
    package relies on ``dynamic_update_slice`` clamping its start there,
    which would overwrite live history. The continuous batcher sizes its
    decode windows so that no row's head reaches the end (a host check,
    ``serving.py``), so the per-row append on the card carries no check
    that would need a device→host sync. Each row writes only at its own
    ``(row, position)`` pairs, never into another row.

    A ``static_head`` cache keeps its head: the caller advances it
    (:func:`advance_heads`) once every layer has appended."""
    if PAGE_TABLE_LEAF in layer_cache:
        return _append_paged_kv_cache(layer_cache, k, v, cache_len)
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    cur = layer_cache[CACHE_INDEX_LEAF]
    B, S = k.shape[:2]
    S_max = ck.shape[1]
    if not isinstance(cur, torch.Tensor):
        if cur + S > S_max:
            raise ValueError(f"KV cache append of {S} at position {cur} overruns "
                             f"cache_len {S_max}")
        ck[:, cur:cur + S] = k
        cv[:, cur:cur + S] = v
        layer_cache[CACHE_INDEX_LEAF] = cur + S
        return ck, cv, cur
    pos = cur.long()[:, None] + _arange(S, ck.device)[None, :]          # (B, S)
    if not ck.is_cuda and int(pos.max()) >= S_max:
        raise ValueError(f"KV cache append of {S} at per-row heads {cur.tolist()} "
                         f"overruns cache_len {S_max}")
    rows = _arange(B, ck.device)[:, None]
    ck[rows, pos] = k
    cv[rows, pos] = v
    if not layer_cache.get(STATIC_HEAD):
        layer_cache[CACHE_INDEX_LEAF] = cur + S
    return ck, cv, cur


def _append_paged_kv_cache(layer_cache: dict, k: torch.Tensor, v: torch.Tensor,
                           cache_len: Optional[int]):
    """Paged append (``_append_paged_kv_cache`` of the JAX package): the
    ``cached_key``/``cached_value`` leaves are the SHARED page arena
    ``(P, pt, KV, D)``, ``page_table`` is ``(B, T)`` and ``cache_index`` is
    per-row lengths ``(B,)``. The new K/V lands at each row's write head
    through the table — a scatter of O(new tokens), not O(history), in
    place. Rows whose head has run past their allocation (free slots ticking
    on, bucket-pad overshoot) resolve to the table's trailing trash entries
    (``blk = min(pos // pt, T - 1)``) — never another slot's pages."""
    ck, cv = layer_cache["cached_key"], layer_cache["cached_value"]
    table = layer_cache[PAGE_TABLE_LEAF]
    lengths = layer_cache[CACHE_INDEX_LEAF]                             # (B,)
    S = k.shape[1]
    pt, T = ck.shape[1], table.shape[1]
    pos = lengths.long()[:, None] + _arange(S, ck.device)[None, :]      # (B, S)
    blk = torch.clamp(pos // pt, max=T - 1)                             # overshoot →
    pids = torch.gather(table, 1, blk).long()                           # trash entry
    offs = pos % pt
    ck[pids, offs] = k
    cv[pids, offs] = v
    if not layer_cache.get(STATIC_HEAD):
        layer_cache[CACHE_INDEX_LEAF] = lengths + S
    cache_len = T * pt if cache_len is None else int(cache_len)
    return (PagedKV(ck, table, cache_len), PagedKV(cv, table, cache_len), lengths)


def decode_fused_enabled(cfg, device: torch.device) -> bool:
    """The fused decode-tick kernels: an explicit ``cfg.decode_fused`` wins;
    None means on for the card and off on the CPU (where the unfused chain
    is the stock path, as off the TPU in the JAX package)."""
    flag = getattr(cfg, "decode_fused", None)
    return device.type == "cuda" if flag is None else bool(flag)


def _w8_groups(cfg, k: int) -> int:
    """Scale groups of a K-row dense panel under ``cfg.w8`` (1 without it)."""
    if not getattr(cfg, "w8", False):
        return 1
    return k // w8_group_size(k, int(getattr(cfg, "w8_group", 128)))


def decode_fused_plan(cfg, rows: int, e: int, proj_outs: tuple, f: int,
                      device: torch.device, swiglu: bool = False) -> bool:
    """Whether THIS tick takes the fused kernels: enabled, and the shape
    predicates of both kernels hold, W8A16 group rules included
    (``decode_fused_plan`` of the JAX package, without its mesh case).
    ``proj_outs``: the attention projection widths (one fused panel, or
    q/k/v under GQA); ``swiglu``: the three-panel MLP, which the JAX package
    passes for its TPU tile budget. The CUDA kernels have no tile budget,
    so it changes no predicate here."""
    w8 = bool(getattr(cfg, "w8", False))
    return (decode_fused_enabled(cfg, device)
            and all(norm_proj_supported(rows, e, n, w8, _w8_groups(cfg, e)) for n in proj_outs)
            and post_attn_supported(rows, e, f, w8, _w8_groups(cfg, e), _w8_groups(cfg, f)))
