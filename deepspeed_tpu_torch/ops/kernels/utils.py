"""Shared helpers for the port's hand-written kernels.

The dispatch rule (counterpart of the JAX package's ``use_pallas``): a
wrapper given CUDA tensors launches its kernel, a wrapper given CPU
tensors runs the kernel's plain PyTorch version.  The device of the
inputs is the only switch: there is no environment override and no
fallback from a kernel that fails to build or launch.
"""

from __future__ import annotations

import torch

#: the C interface's dtype codes (``csrc/common.cuh`` ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dims the kernels are instantiated for (``csrc`` ``switch (D)``)
HEAD_DIMS = (32, 64, 128)


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
    fp32/fp16/bf16, a head dim it was instantiated for, a unit-stride last
    dim and 16-byte aligned rows.  Returns the dtype."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(want one of {list(DTYPE_CODES)})")
    D = tensors[0].shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported (want one of "
                         f"{HEAD_DIMS})")
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
