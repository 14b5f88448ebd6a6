"""LAMB (two fused kernels over flat buffers)."""

from .fused_lamb import FusedLamb

__all__ = ["FusedLamb"]
