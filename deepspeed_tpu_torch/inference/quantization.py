"""Weight-only int8 serving: the port of ``inference/quantization.py``
(its weight-only half).

The big matmul weights are stored as int8 codes with one fp32 scale per
last-dim vector (``groups = prod(shape[:-1])`` of the grouped quantizer,
``ops/kernels/quantizer.py``; the ``quantizer`` kernel on CUDA) and
dequantized when a layer reads them; compute stays in the serving dtype.

:class:`Int8Param` duck-types the two operations the port's model performs
on a weight (``w[idx]`` to slice a layer off a stacked leaf, and
``.to(dtype)`` before a matmul), so ``models/gpt.py`` serves int8 weights
unchanged.  Where XLA fuses the JAX package's ``astype`` dequantization
into the consuming matmul, eager PyTorch materialises each layer's
dequantized weight once per forward: the host and memory cost of int8
storage until a fused int8-weight GEMM replaces it (PERF.md).

The true int8 x int8 → int32 compute path (``quant.int8_compute``,
``ops/int8.py``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..ops.kernels.quantizer import quantize_rows

#: leaf names (last path component) of the big matmul weights in the
#: stacked GPT tree (``models/gpt.py``); ``lm_head`` covers untied heads.
#: ``wte`` stays in the serving dtype: with tied embeddings it is also the
#: logit matrix, the most precision-sensitive product of the model.
QUANTIZE_LEAVES = frozenset({"wqkv", "wo", "wi", "wo_mlp", "lm_head"})


@dataclasses.dataclass
class Int8Param:
    """int8 codes in the weight's shape and fp32 scales of shape
    ``shape[:-1] + (1,)``.  ``to(dtype)`` dequantizes; ``w[idx]`` slices
    codes and scales together."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, idx) -> "Int8Param":
        return Int8Param(q=self.q[idx], scale=self.scale[idx])

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """The dequantized weight, ``(q * scale)`` in fp32 cast to
        ``dtype``."""
        return (self.q.float() * self.scale).to(dtype)


def quantize_leaf(w: torch.Tensor) -> Int8Param:
    """Symmetric per-last-dim-vector int8 quantization of ``w``, read in
    its own dtype (the kernel widens it in registers, exactly)."""
    rows = w.reshape(-1, w.shape[-1])
    q, scale, _ = quantize_rows(rows, 8, True, offsets=False)
    return Int8Param(q=q.view(w.shape), scale=scale.view(w.shape[:-1] + (1,)))


def quantize_params_int8(params: dict, leaves=None) -> Tuple[dict, int]:
    """Replace the big matmul weights (:data:`QUANTIZE_LEAVES`, or
    ``leaves``) of a nested parameter dict with :class:`Int8Param` leaves.
    Returns ``(new_params, n_quantized)``; LayerNorms, biases and the
    embeddings stay as they are."""
    if leaves is None:
        leaves = QUANTIZE_LEAVES
    n = 0

    def walk(tree):
        nonlocal n
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in leaves and getattr(leaf, "ndim", 0) >= 2:
                out[name] = quantize_leaf(leaf)
                n += 1
            else:
                out[name] = leaf
        return out

    return walk(params), n


def param_bytes(params: Any) -> int:
    """Bytes held by a parameter tree (codes and scales of an
    :class:`Int8Param` counted both)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, Int8Param):
        return params.nbytes
    return params.numel() * params.element_size()
