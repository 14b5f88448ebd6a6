"""Operators of the port: the hand-written CUDA kernels and their plain
PyTorch versions (``ops/kernels``), and the optimizers that run them
(``FusedAdam``, ``FusedLamb``; ``SGD`` is plain torch)."""

from .adam import SGD, FusedAdam
from .lamb import FusedLamb

__all__ = ["FusedAdam", "FusedLamb", "SGD"]
