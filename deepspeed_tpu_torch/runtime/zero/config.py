"""ZeRO configuration.

The port of the JAX package's ``runtime/zero/config.py`` (the counterpart
of the reference's ``deepspeed/runtime/zero/config.py``
``DeepSpeedZeroConfig``, :78, and ``zero/offload_config.py``).  Every
knob of the reference is accepted with its ``stage3_*`` aliases, but the
port runs on one device: stage 0 and stage 1 (whose optimizer-state
sharding over one rank is the same math) are ported, and with them
ZeRO-Offload of the optimizer state (``offload_optimizer.device``
``"cpu"`` or ``"nvme"``).  Stage 2 and 3, parameter offload and the
quantized collectives raise ``NotImplementedError`` (ROADMAP.md Queue 1,
"Multi-GPU"), and so does the offload's ``grad_compression`` (Queue 1
#8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..config_utils import DeepSpeedConfigModel

ZERO_OPTIMIZATION = "zero_optimization"

_NOT_PORTED = ("is not ported yet: the port trains on one device with ZeRO "
               "stage 0 or 1 (ROADMAP.md Queue 1, 'Multi-GPU')")


class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """Where the optimizer state and the fp32 master live (JAX
    ``zero/config.py:37-63``)."""

    device: str = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    #: error-feedback compression of the gradient stream: only "none" is
    #: ported (the JAX package's "onebit" and "int8": Queue 1 #8)
    grad_compression: str = "none"
    compression_block: int = 2048
    compression_residual_dtype: str = "fp32"
    #: overlap the next leaf's device-to-host transfer with this leaf's
    #: host Adam and upload; costs one more in-flight 16-bit leaf of
    #: device memory (the engine turns it off when that does not fit)
    pipeline_transfers: bool = True

    def __post_init__(self):
        devices = (OffloadDeviceEnum.none, OffloadDeviceEnum.cpu,
                   OffloadDeviceEnum.nvme)
        if self.device not in devices:
            raise ValueError(f"offload_optimizer.device={self.device!r} "
                             f"(want one of {devices})")
        if str(self.grad_compression).lower() != "none":
            raise NotImplementedError(
                "zero_optimization.offload_optimizer.grad_compression="
                f"{self.grad_compression!r} is not ported yet (ROADMAP.md "
                "Queue 1 #8, the compressed offload stream)")
        if self.device == OffloadDeviceEnum.nvme and not self.nvme_path:
            raise ValueError("offload_optimizer.device 'nvme' requires "
                             "nvme_path")


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """The ``zero_optimization`` section (reference zero/config.py:78)."""

    DEPRECATED_FIELDS = {
        "cpu_offload": "offload_optimizer",
        "cpu_offload_params": "offload_param",
        "stage3_prefetch_bucket_size": "prefetch_bucket_size",
        "stage3_param_persistence_threshold": "param_persistence_threshold",
        "stage3_model_persistence_threshold": "model_persistence_threshold",
        "stage3_max_live_parameters": "max_live_parameters",
        "stage3_max_reuse_distance": "max_reuse_distance",
        "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
        "stage3_gather_fp16_weights_on_model_save": "gather_16bit_weights_on_model_save",
    }

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[Dict] = None
    offload_optimizer: Optional[Dict] = None
    sub_group_size: int = int(1e9)
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e15) // 2
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    quantized_collectives: str = "none"
    quantized_block: int = 2048

    offload_optimizer_config: DeepSpeedZeroOffloadOptimizerConfig = \
        dataclasses.field(default_factory=DeepSpeedZeroOffloadOptimizerConfig)

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ValueError(f"zero stage must be 0-3, got {self.stage}")
        if self.stage >= 2:
            raise NotImplementedError(f"ZeRO stage {self.stage} {_NOT_PORTED}")
        value = self.offload_param
        device = value.get("device", "cpu") if isinstance(value, dict) \
            else ("cpu" if value else "none")
        if device != "none":
            raise NotImplementedError(
                f"zero_optimization.offload_param {_NOT_PORTED} (ZeRO-3 "
                "parameter offload and its swapper)")
        # the deprecated boolean ``cpu_offload`` arrives here as a bool
        if isinstance(self.offload_optimizer, bool):
            self.offload_optimizer = {"device": "cpu"} \
                if self.offload_optimizer else None
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer_config = \
                DeepSpeedZeroOffloadOptimizerConfig.from_dict(
                    self.offload_optimizer)
        if str(self.quantized_collectives).lower() != "none":
            raise NotImplementedError(
                f"zero_optimization.quantized_collectives {_NOT_PORTED}")
        if self.overlap_comm is None:
            # reference default: True for stage 3, False otherwise
            self.overlap_comm = self.stage == 3

    @property
    def offload_optimizer_device(self) -> str:
        return self.offload_optimizer_config.device
