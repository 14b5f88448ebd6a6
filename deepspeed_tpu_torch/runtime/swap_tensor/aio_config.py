"""The ``aio`` section of the config (JAX ``runtime/swap_tensor/
aio_config.py``, reference ``runtime/swap_tensor/aio_config.py``)."""

from __future__ import annotations

import dataclasses

from ..config_utils import DeepSpeedConfigModel

AIO = "aio"


@dataclasses.dataclass
class AioConfig(DeepSpeedConfigModel):
    block_size: int = 1 << 20
    #: accepted for parity with the reference; the pool's depth is its
    #: thread count
    queue_depth: int = 8
    thread_count: int = 4
    single_submit: bool = False
    overlap_events: bool = True
    use_o_direct: bool = False
