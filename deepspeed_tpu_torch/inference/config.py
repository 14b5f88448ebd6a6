"""Inference config (reference ``inference/config.py``
``DeepSpeedInferenceConfig``): serving dtype (``"int8"``: int8 weights
with bf16 compute), KV-cache dtype (``"int8"``: int8 codes with one fp32
scale per head vector), quantization, tensor parallelism and
``max_out_tokens``.

Options the JAX package has and this port does not yet (tensor
parallelism, ``quant.int8_compute``, weights of other than 8 bits, MoE)
raise at construction; none is ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..runtime.config_utils import DeepSpeedConfigModel

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "int8": torch.int8}


@dataclasses.dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    #: accepted for reference parity: ``dtype="int8"`` selects int8 weights
    enabled: bool = False
    #: only 8 is ported (int8 codes); other widths raise
    bits: int = 8
    #: int8 x int8 -> int32 GEMMs (JAX ``ops/int8.py``): not ported, raises
    int8_compute: bool = False

    def __post_init__(self):
        if self.int8_compute:
            raise NotImplementedError(
                "quant.int8_compute (int8 x int8 -> int32 GEMMs) is not "
                'ported yet; dtype="int8" serves int8 weights with bf16 '
                "compute")
        if self.bits != 8:
            raise NotImplementedError(
                f"quant.bits={self.bits}: only 8-bit weights are served")


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    #: "int8" stores the big matmul weights as int8 codes and per-vector
    #: scales and computes in bf16 (weight-only int8)
    dtype: str = "bfloat16"
    #: "auto" caches K/V in the compute dtype; "int8" as int8 codes with one
    #: fp32 scale per head vector
    kv_cache_dtype: str = "auto"
    tensor_parallel: Dict = dataclasses.field(default_factory=dict)
    quant: Dict = dataclasses.field(default_factory=dict)
    moe: Dict = dataclasses.field(default_factory=dict)
    #: accepted for reference parity; neither engine reads it
    max_out_tokens: int = 1024
    #: accepted for reference parity: DSUNet/DSVAE run eagerly, CUDA-graph
    #: capture is not ported yet
    enable_cuda_graph: bool = False

    DEPRECATED_FIELDS = {"mp_size": "tensor_parallel"}

    def __post_init__(self):
        if isinstance(self.tensor_parallel, int):
            self.tensor_parallel = {"tp_size": self.tensor_parallel}
        dtype = str(self.dtype).replace("torch.", "")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={self.dtype!r} (want one of "
                             f"{sorted(_DTYPES)})")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} (want 'auto' or "
                "'int8')")
        if self.tp_size > 1:
            raise NotImplementedError(
                f"tensor_parallel.tp_size={self.tp_size}: tensor-parallel "
                "serving is not ported yet")
        self.quantization = QuantizationConfig.from_dict(self.quant or {})
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
