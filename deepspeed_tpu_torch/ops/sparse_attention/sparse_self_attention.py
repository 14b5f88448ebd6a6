"""SparseSelfAttention: attention restricted by a SparsityConfig.

The port of ``ops/sparse_attention/sparse_self_attention.py`` (the
reference's ``deepspeed/ops/sparse_attention/sparse_self_attention.py:11``)
over the port's block-sparse kernels (``ops/kernels/block_sparse_attention``).

Functional: ``SparseSelfAttention(config)(q, k, v)`` with q, k, v
``[B, S, H, D]`` returns O; layouts are cached per sequence length, and
their index tables per layout and device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..kernels.block_sparse_attention import block_sparse_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class SparseSelfAttention:
    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 sm_scale: Optional[float] = None,
                 num_heads: Optional[int] = None):
        if sparsity_config is None:
            assert num_heads is not None, \
                "need a SparsityConfig or num_heads for the default Fixed config"
            sparsity_config = FixedSparsityConfig(num_heads=num_heads)
        self.sparsity_config = sparsity_config
        self.sm_scale = sm_scale
        self._layouts: Dict[int, np.ndarray] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    @property
    def causal(self) -> bool:
        return getattr(self.sparsity_config, "attention",
                       "bidirectional") == "unidirectional"

    def __call__(self, q, k, v, causal: Optional[bool] = None):
        B, S, H, D = q.shape
        assert H == self.sparsity_config.num_heads, \
            f"q has {H} heads, config {self.sparsity_config.num_heads}"
        layout = self.get_layout(S)
        return block_sparse_attention(
            q, k, v, layout, block=self.sparsity_config.block,
            causal=self.causal if causal is None else causal,
            sm_scale=self.sm_scale)[0]

    def density(self, seq_len: int, causal: Optional[bool] = None) -> float:
        """Fraction of live blocks (after the causal triangle)."""
        layout = np.asarray(self.get_layout(seq_len), bool)
        c = self.causal if causal is None else causal
        if c:
            n = layout.shape[-1]
            tri = np.tril(np.ones((n, n), bool))
            return float(layout[:, tri].mean())
        return float(layout.mean())
