"""Shared helpers for the port's hand-written kernels.

The dispatch rule (counterpart of the JAX package's ``use_pallas``): a
wrapper given CUDA tensors launches its kernel, a wrapper given CPU
tensors runs the kernel's plain PyTorch version.  The device of the
inputs is the only switch: there is no environment override and no
fallback from a kernel that fails to build or launch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: the C interface's dtype codes (``csrc/common.cuh`` ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dims each attention kernel is instantiated for (its source's
#: ``switch (D)``): 32, 64 and 128, and 80 and 96, which run in the tile
#: of 128 (``csrc/common.cuh`` ``tile_dim``)
HEAD_DIMS = (32, 64, 80, 96, 128)
KERNEL_HEAD_DIMS = {name: HEAD_DIMS for name in (
    "flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
    "decode_attn", "decode_attn_int8", "chunk_attn", "chunk_attn_int8",
    "block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")}


def tile_dim(D: int) -> int:
    """The head dim of the tile a kernel computes D in (``csrc/common.cuh``
    ``tile_dim``): D 80 and 96 in the tile of 128."""
    return 32 if D <= 32 else 64 if D <= 64 else 128


def count_head_dim(cls, D: int) -> None:
    """Add one launch at head dim ``D`` to a wrapper class's
    ``dim_launches`` (head dim -> launches)."""
    cls.dim_launches[D] = cls.dim_launches.get(D, 0) + 1


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; anything else raises."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, kinds))}")
    dev = kinds.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Validate what every attention kernel takes: one dtype among
    fp32/fp16/bf16, a head dim the kernel ``name`` was instantiated for
    (:data:`KERNEL_HEAD_DIMS`), a unit-stride last dim and 16-byte aligned
    rows.  Returns the dtype."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(want one of {list(DTYPE_CODES)})")
    D = tensors[0].shape[-1]
    dims = KERNEL_HEAD_DIMS[name]
    if D not in dims:
        raise ValueError(f"{name}: head dim {D} not supported (the kernel "
                         f"is instantiated for {dims})")
    vec = 16 // tensors[0].element_size()
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if t.shape[-1] != D:
            raise ValueError(f"{name}: head dims differ ({D} vs "
                             f"{t.shape[-1]})")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(stride {t.stride(-1)})")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be 16-byte aligned "
                             f"(strides {t.stride()}, ptr {t.data_ptr()})")
    return dtype


def check_stats(name: str, shape, *stats: torch.Tensor) -> None:
    """The backward kernels' lse and delta: contiguous fp32 of ``shape``
    ([B, H, Sq])."""
    for t in stats:
        if (t.dtype != torch.float32 or t.shape != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 "
                             f"[B, H, Sq] = {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def strides3(*tensors: torch.Tensor) -> list:
    """The (batch, seq, head) strides of each [B, S, H, D] tensor, in the
    order the kernels' C interfaces take them."""
    return [s for t in tensors for s in t.stride()[:3]]


def softmax_scale(D: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
