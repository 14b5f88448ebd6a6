"""Serving config: the ``ServingConfig`` fields the port's ``SlotBatcher``
reads (the JAX package's ``serving/config.py``).

The gateway's sections (paging, speculation, overload, transport) and its
queue/deadline/prefix-pool knobs are not ported yet: setting one raises
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.config_utils import DeepSpeedConfigModel

#: JAX ``ServingConfig`` keys whose subsystems are not ported yet
_NOT_PORTED = ("queue_capacity", "default_max_new_tokens",
               "default_deadline_s", "seed", "max_cached_prefixes",
               "prefix_ttl_s", "journal_every_ticks", "eos_token_id",
               "idle_wait_s", "warm_start", "paging", "speculative",
               "overload", "transport")


@dataclasses.dataclass
class ServingConfig(DeepSpeedConfigModel):
    """Continuous-batching knobs of the port's ``SlotBatcher``."""

    #: decode-batch width B: the slot cache is [L, B, max_len, H, D]
    slots: int = 4
    #: per-slot cache length (prompt + reply budget); None = model
    #: context.  Bucketed to a power of two, as in the JAX package.
    max_len: Optional[int] = None
    #: admission prefill chunk width: prompts pad up to a multiple and
    #: prefill through fixed-width chunks
    prefill_chunk: int = 16
    #: sampling filter of the sampled slots
    top_k: int = 0
    top_p: float = 1.0

    @classmethod
    def from_dict(cls, data=None, **overrides) -> "ServingConfig":
        data = dict(data or {})
        data.update(overrides)
        unported = sorted(k for k in _NOT_PORTED if k in data)
        if unported:
            raise NotImplementedError(
                f"serving config keys {unported} belong to subsystems that "
                "are not ported yet")
        return super().from_dict(data)

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"serving.slots must be >= 1, got {self.slots}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"serving.prefill_chunk must be >= 1, got "
                f"{self.prefill_chunk}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"serving.top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"serving.top_k must be >= 0, got {self.top_k}")
        if self.max_len is not None and self.max_len < 2:
            raise ValueError(
                f"serving.max_len must be >= 2 (a prompt token and a reply "
                f"token), got {self.max_len}")
