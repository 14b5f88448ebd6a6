"""Serving config: the ``ServingConfig`` fields the port's ``SlotBatcher``
and ``ServingGateway`` read (the JAX package's ``serving/config.py``, with
its defaults and validation).

The gateway's subsystem sections (paging, speculation, overload,
transport) are not ported yet: setting one raises
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.config_utils import DeepSpeedConfigModel

#: JAX ``ServingConfig`` keys whose subsystems are not ported yet
_NOT_PORTED = ("paging", "speculative", "overload", "transport")


@dataclasses.dataclass
class ServingConfig(DeepSpeedConfigModel):
    """Continuous-batching gateway knobs."""

    #: decode-batch width B: the slot cache is [L, B, max_len, H, D]
    slots: int = 4
    #: per-slot cache length (prompt + reply budget); None = model
    #: context.  Bucketed to a power of two, as in the JAX package.
    max_len: Optional[int] = None
    #: admission prefill chunk width: prompts pad up to a multiple and
    #: prefill through fixed-width chunks
    prefill_chunk: int = 16
    #: bounded admission queue; submit() past this rejects loudly
    queue_capacity: int = 64
    #: reply budget when a request doesn't name one
    default_max_new_tokens: int = 64
    #: seconds from submit to completion before a request times out
    #: (None = no deadline unless the request carries one)
    default_deadline_s: Optional[float] = None
    #: sampling filter of the sampled slots
    top_k: int = 0
    top_p: float = 1.0
    #: base seed of the per-request sampling generators (requests may pin
    #: their own)
    seed: int = 0
    #: LRU-bounded pool of shared prefixes (system prompts, prefilled once
    #: and copied into each admission); 0 disables the pool
    max_cached_prefixes: int = 8
    #: a pooled prefix idle longer than this is evicted on the next sweep
    prefix_ttl_s: float = 600.0
    #: journal a ``serve.tick`` snapshot every N ticks (0 = off)
    journal_every_ticks: int = 0
    #: default eos: rows emitting it finish early (None = run the budget)
    eos_token_id: Optional[int] = None
    #: scheduler idle wait between queue polls, seconds
    idle_wait_s: float = 0.02
    #: run ``SlotBatcher.prewarm`` at construction: the kernels' build and
    #: the library handles' set-up land before the first request
    warm_start: bool = False

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
        if self.queue_capacity < 1:
            raise ValueError(
                f"serving.queue_capacity must be >= 1, got "
                f"{self.queue_capacity}")
        if self.default_max_new_tokens < 1:
            raise ValueError(
                f"serving.default_max_new_tokens must be >= 1, got "
                f"{self.default_max_new_tokens}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"serving.top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"serving.top_k must be >= 0, got {self.top_k}")
        if self.max_cached_prefixes < 0:
            raise ValueError(
                f"serving.max_cached_prefixes must be >= 0, got "
                f"{self.max_cached_prefixes}")
        if self.default_deadline_s is not None and self.default_deadline_s <= 0:
            raise ValueError(
                f"serving.default_deadline_s must be > 0, got "
                f"{self.default_deadline_s}")
        if self.max_len is not None and self.max_len < 2:
            raise ValueError(
                f"serving.max_len must be >= 2 (a prompt token and a reply "
                f"token), got {self.max_len}")
        if self.journal_every_ticks < 0:
            raise ValueError(
                f"serving.journal_every_ticks must be >= 0, got "
                f"{self.journal_every_ticks}")
        if self.idle_wait_s <= 0:
            raise ValueError(
                f"serving.idle_wait_s must be > 0, got {self.idle_wait_s}")
