"""Adam (fused kernel over flat buffers, or the host SIMD Adam of
ZeRO-Offload) and plain SGD."""

from .cpu_adam import DeepSpeedCPUAdam, cpu_adam_step
from .fused_adam import SGD, FusedAdam

__all__ = ["DeepSpeedCPUAdam", "FusedAdam", "SGD", "cpu_adam_step"]
