"""Inference config (reference ``inference/config.py``
``DeepSpeedInferenceConfig``): serving dtype, KV-cache dtype,
tensor parallelism and ``max_out_tokens``.

Options the JAX package has and this port does not yet (tensor
parallelism, int8 weights, the int8 KV cache, quantization, MoE) raise
at construction; none is ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..runtime.config_utils import DeepSpeedConfigModel

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    dtype: str = "bfloat16"
    #: "auto" caches K/V in the compute dtype (the only cache ported)
    kv_cache_dtype: str = "auto"
    tensor_parallel: Dict = dataclasses.field(default_factory=dict)
    quant: Dict = dataclasses.field(default_factory=dict)
    moe: Dict = dataclasses.field(default_factory=dict)
    #: accepted for reference parity; neither engine reads it
    max_out_tokens: int = 1024

    DEPRECATED_FIELDS = {"mp_size": "tensor_parallel"}

    def __post_init__(self):
        if isinstance(self.tensor_parallel, int):
            self.tensor_parallel = {"tp_size": self.tensor_parallel}
        dtype = str(self.dtype).replace("torch.", "")
        if dtype == "int8":
            raise NotImplementedError(
                'dtype="int8" (int8 weight serving) is not ported yet')
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={self.dtype!r} (want one of "
                             f"{sorted(_DTYPES)})")
        if self.kv_cache_dtype == "int8":
            raise NotImplementedError(
                'kv_cache_dtype="int8" (the int8 KV cache) is not ported yet')
        if self.kv_cache_dtype != "auto":
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} (want 'auto')")
        if self.tp_size > 1:
            raise NotImplementedError(
                f"tensor_parallel.tp_size={self.tp_size}: tensor-parallel "
                "serving is not ported yet")
        if self.quant.get("enabled") or self.quant.get("int8_compute"):
            raise NotImplementedError("quantized serving is not ported yet")
        if self.moe:
            raise NotImplementedError("MoE serving is not ported yet")
        if self.max_out_tokens < 1:
            raise ValueError(
                f"max_out_tokens must be >= 1, got {self.max_out_tokens}")

    @property
    def tp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[str(self.dtype).replace("torch.", "")]
