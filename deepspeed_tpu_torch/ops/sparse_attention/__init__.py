"""Sparse attention: layout generators (``sparsity_config``) and
``SparseSelfAttention`` over the block-sparse kernels."""

from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)

__all__ = ["SparseSelfAttention", "SparsityConfig", "DenseSparsityConfig",
           "FixedSparsityConfig", "VariableSparsityConfig",
           "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "LocalSlidingWindowSparsityConfig"]
