"""ZeRO configuration of the port (one device: stage 0 and 1)."""

from .config import ZERO_OPTIMIZATION, DeepSpeedZeroConfig

__all__ = ["DeepSpeedZeroConfig", "ZERO_OPTIMIZATION"]
