"""NVMe swapping of ZeRO-Offload's optimizer state (the port of the JAX
package's ``runtime/swap_tensor``, the counterpart of the reference's
``deepspeed/runtime/swap_tensor/``) over the async file I/O engine of
``csrc/aio/ds_aio.cpp``.  Stage 3's parameter swapper
(``partitioned_param_swapper.py``) is not ported (ROADMAP.md Queue 1 #7)."""

from .aio_config import AioConfig
from .aio_handle import AsyncIOHandle
from .async_swapper import AsyncTensorSwapper
from .optimizer_swapper import OptimizerStateSwapper

__all__ = ["AioConfig", "AsyncIOHandle", "AsyncTensorSwapper",
           "OptimizerStateSwapper"]
