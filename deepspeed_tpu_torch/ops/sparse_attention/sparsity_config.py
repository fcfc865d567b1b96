"""Block-sparsity layout generators.

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept as
its own copy (the port imports nothing of the JAX package): the same five
config families — Dense / Fixed / Variable / BigBird / BSLongformer — with
the same arguments, validation errors and numpy RNG calls
(``np.random.default_rng(0)``), so that a config gives the same block
layout ``(heads, S/block, S/block)`` of 0/1 bit for bit in both packages.
The layouts feed either the masked dense path or the block-sparse kernel
(``sparse_self_attention``).
"""
from __future__ import annotations

import numpy as np


class SparsityConfig:
    """Base: block size + head layout sharing (reference :SparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        if block < 1:
            raise ValueError("block must be >= 1")
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def num_layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend (the correctness oracle)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern (reference FixedSparsityConfig):
    local windows of ``num_local_blocks`` + attention to the last
    ``num_global_blocks`` of each window (the "summary" columns);
    unidirectional (causal) variants mask the future."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention needs bidirectional")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("different global patterns require "
                             "different_layout_per_head")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(self.num_layout_heads):
            pattern = h % self.num_different_global_patterns
            # local windows
            for start in range(0, n, L):
                end = min(start + L, n)
                for qi in range(start, end):
                    k_hi = (qi + 1) if self.attention == "unidirectional" else end
                    layout[h, qi, start:k_hi] = 1
            # global columns: last G blocks of each window (shifted per pattern)
            for start in range(0, n, L):
                g_lo = start + L - (pattern + 1) * G
                g_hi = g_lo + G
                if g_lo < 0:
                    continue
                if self.attention == "unidirectional":
                    layout[h, g_hi:, g_lo:g_hi] = 1   # later queries see them
                else:
                    layout[h, :, g_lo:g_hi] = 1
                    if self.horizontal_global_attention:
                        layout[h, g_lo:g_hi, :] = 1
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=np.int64))
            layout = layout * tril[None]
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Reference VariableSparsityConfig: custom local window list + global
    indices, optional random blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: list[int] | None = None,
                 global_block_indices: list[int] | None = None,
                 global_block_end_indices: list[int] | None = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices length mismatch")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(0)
        for h in range(self.num_layout_heads):
            # local windows of varying size; last size repeats
            start = 0
            wi = 0
            while start < n:
                w = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                for qi in range(start, end):
                    k_hi = (qi + 1) if self.attention == "unidirectional" else end
                    layout[h, qi, start:k_hi] = 1
                start, wi = end, wi + 1
            # globals
            if self.global_block_end_indices is None:
                for gi in self.global_block_indices:
                    if gi < n:
                        layout[h, :, gi] = 1
                        if self.horizontal_global_attention:
                            layout[h, gi, :] = 1
            else:
                for gi, ge in zip(self.global_block_indices,
                                  self.global_block_end_indices):
                    layout[h, :, gi:ge] = 1
                    if self.horizontal_global_attention:
                        layout[h, gi:ge, :] = 1
            # random blocks
            for qi in range(n):
                for _ in range(self.num_random_blocks):
                    layout[h, qi, int(rng.integers(0, n))] = 1
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=np.int64))
            layout = layout * tril[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC: random + sliding window + global (reference
    BigBirdSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        if n < max(self.num_random_blocks, self.num_sliding_window_blocks,
                   self.num_global_blocks):
            raise ValueError("sequence too short for BigBird pattern")
        rng = np.random.default_rng(0)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for qi in range(n):
                layout[h, qi, max(0, qi - w):min(n, qi + w + 1)] = 1  # window
                choices = rng.choice(n, self.num_random_blocks, replace=False)
                layout[h, qi, choices] = 1                            # random
            g = self.num_global_blocks
            layout[h, :, :g] = 1                                      # global cols
            layout[h, :g, :] = 1                                      # global rows
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=np.int64))
            layout = layout * tril[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global index blocks
    (reference BSLongformerSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: list[int] | None = None,
                 global_block_end_indices: list[int] | None = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for qi in range(n):
                layout[h, qi, max(0, qi - w):min(n, qi + w + 1)] = 1
            if self.global_block_end_indices is None:
                for gi in self.global_block_indices:
                    if gi < n:
                        layout[h, :, gi] = 1
                        layout[h, gi, :] = 1
            else:
                for gi, ge in zip(self.global_block_indices,
                                  self.global_block_end_indices):
                    layout[h, :, gi:ge] = 1
                    layout[h, gi:ge, :] = 1
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=np.int64))
            layout = layout * tril[None]
        return self.check_and_propagate_first_head_layout(layout)
