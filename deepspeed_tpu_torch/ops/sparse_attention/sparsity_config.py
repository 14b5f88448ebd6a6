"""Sparsity configurations: block-layout generators for sparse attention.

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(numpy only; importing the JAX package would pull in JAX).  The classes,
constructor checks and ``random.Random(h)`` seeding are the same, so every
``make_layout`` is array-equal to the JAX package's.  Same config surface
as the reference's ``deepspeed/ops/sparse_attention/sparsity_config.py``
(Dense/Fixed/Variable/BigBird/BSLongformer/LocalSlidingWindow, block size,
per-head layouts, 'unidirectional'/'bidirectional' attention):

- Fixed: "Generating Long Sequences with Sparse Transformers" (Child et
  al. 2019) — local windows plus summary ("global") positions at the end
  of each window that every later query may attend.
- BigBird: window + global + random blocks (Zaheer et al. 2020).
- BSLongformer: sliding window + designated global blocks that attend and
  are attended everywhere (Beltagy et al. 2020), block-sparse variant.
- Variable: per-window sizes, explicit global indices, optional random
  blocks — the reference's catch-all.

``make_layout(seq_len)`` returns a numpy [num_heads, nq, nk] 0/1 array
consumed by ``ops.kernels.block_sparse_attention`` (which also applies the
causal triangle for 'unidirectional').
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: dense unless subclassed (reference SparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def num_layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def check_seq(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be divisible by block {self.block}")
        return seq_len // self.block

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        return np.zeros((self.num_layout_heads, n, n), np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        if layout.shape[0] == 1 and self.num_heads > 1:
            layout = np.broadcast_to(
                layout, (self.num_heads,) + layout.shape[1:]).copy()
        return layout


class DenseSparsityConfig(SparsityConfig):
    """Full attention expressed as a (degenerate) block layout."""

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        return np.ones((self.num_layout_heads, n, n), np.int64)


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern.

    Each query attends its local window of ``num_local_blocks`` and the
    trailing ``num_global_blocks`` blocks of every preceding window (the
    summary stripes).  With ``different_layout_per_head`` and
    ``num_different_global_patterns`` > 1, head groups use different
    positions within the window as the summary stripe.
    ``horizontal_global_attention`` additionally opens the summary rows
    (bidirectional only).
    """

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"bad attention type {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires "
                             "different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("more global patterns than window positions")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        H = self.num_layout_heads
        layout = np.zeros((H, n, n), np.int64)
        w, g = self.num_local_blocks, self.num_global_blocks
        for h in range(H):
            pattern = (h * self.num_different_global_patterns // max(H, 1)) \
                if self.num_different_global_patterns > 1 else 0
            # local windows
            for start in range(0, n, w):
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
            # summary stripes: the g blocks ending each window (shifted by
            # the head's pattern index), visible to all later queries
            for start in range(0, n, w):
                hi = min(start + w - pattern * g, n)
                lo = max(hi - g, 0)
                if lo >= hi:
                    continue
                layout[h, hi:, lo:hi] = 1
                if self.horizontal_global_attention:
                    layout[h, lo:hi, :] = 1
        if self.attention == "unidirectional":
            layout = layout * np.tril(np.ones((n, n), np.int64))[None]
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Custom windows + explicit globals + random blocks (reference :421)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices length mismatch")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _global_cols(self, n: int) -> List[int]:
        cols: List[int] = []
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < n]
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                cols.extend(range(s, min(e, n)))
        return cols

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        H = self.num_layout_heads
        layout = np.zeros((H, n, n), np.int64)
        # local windows: sizes from the list, last size repeats
        for h in range(H):
            start = 0
            i = 0
            while start < n:
                w = self.local_window_blocks[
                    min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
                start, i = end, i + 1
            for c in self._global_cols(n):
                layout[h, :, c] = 1
                if self.horizontal_global_attention:
                    layout[h, c, :] = 1
            rng = random.Random(h)
            for r in range(n):
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(n)] = 1
        if self.attention == "unidirectional":
            layout = layout * np.tril(np.ones((n, n), np.int64))[None]
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """window + global(first/last) + random (Zaheer et al.; reference :559)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        H = self.num_layout_heads
        layout = np.zeros((H, n, n), np.int64)
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        for h in range(H):
            for r in range(n):
                layout[h, r, max(0, r - w):min(n, r + w + 1)] = 1
            layout[h, :, :g] = 1   # global columns (first blocks)
            layout[h, :g, :] = 1   # global rows
            if self.attention == "bidirectional":
                layout[h, :, n - g:] = 1
                layout[h, n - g:, :] = 1
            rng = random.Random(h)
            for r in range(n):
                lo = 0 if self.attention == "bidirectional" else None
                hi = n if self.attention == "bidirectional" else r + 1
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(hi if hi else n)] = 1
        if self.attention == "unidirectional":
            layout = layout * np.tril(np.ones((n, n), np.int64))[None]
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely-local sliding window attention — each query block sees the
    ``num_sliding_window_blocks``-wide band around its diagonal and nothing
    else (reference LocalSlidingWindowSparsityConfig,
    sparsity_config.py:686).  Unidirectional keeps only the trailing half
    of the band (the causal prefix)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"bad attention type {attention!r}")
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds the {n} blocks in a row")
        H = self.num_layout_heads
        layout = np.zeros((H, n, n), np.int64)
        w = self.num_sliding_window_blocks // 2
        for r in range(n):
            end = min(r + w + 1, n) if self.attention == "bidirectional" \
                else r + 1
            layout[:, r, max(0, r - w):end] = 1
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + designated global blocks
    (reference BSLongformerSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 128,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def setup_layout(self, seq_len: int) -> np.ndarray:
        n = self.check_seq(seq_len)
        H = self.num_layout_heads
        layout = np.zeros((H, n, n), np.int64)
        w = self.num_sliding_window_blocks // 2
        if self.global_block_end_indices is None:
            glob = [i for i in self.global_block_indices if i < n]
        else:
            glob = []
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                glob.extend(range(s, min(e, n)))
        for h in range(H):
            for r in range(n):
                layout[h, r, max(0, r - w):min(n, r + w + 1)] = 1
            for c in glob:
                layout[h, :, c] = 1
                layout[h, c, :] = 1
        if self.attention == "unidirectional":
            layout = layout * np.tril(np.ones((n, n), np.int64))[None]
        return layout
