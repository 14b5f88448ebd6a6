"""The host extensions of ZeRO-Offload, built with ``g++`` (the port of
the JAX package's ``ops/op_builder``)."""

from .async_io import AsyncIOBuilder
from .builder import OpBuilder, cpu_arch, simd_width
from .cpu_adam import CPUAdamBuilder

__all__ = ["AsyncIOBuilder", "CPUAdamBuilder", "OpBuilder", "cpu_arch",
           "simd_width"]
