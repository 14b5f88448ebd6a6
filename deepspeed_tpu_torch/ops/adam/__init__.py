"""Adam (fused kernel over flat buffers) and plain SGD."""

from .fused_adam import SGD, FusedAdam

__all__ = ["FusedAdam", "SGD"]
