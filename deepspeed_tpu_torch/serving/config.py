"""Serving config: the ``ServingConfig`` fields the port's ``SlotBatcher``
and ``ServingGateway`` read (the JAX package's ``serving/config.py``, with
its defaults and validation), and the ``speculative`` section
(:class:`SpeculativeConfig`, typed view ``speculative_config``).

The gateway's other subsystem sections (paging, overload, transport) are
not ported yet: setting one raises ``NotImplementedError`` instead of
being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..runtime.config import DeepSpeedConfigError
from ..runtime.config_utils import DeepSpeedConfigModel

#: JAX ``ServingConfig`` keys whose subsystems are not ported yet
_NOT_PORTED = ("paging", "overload", "transport")

#: keys a ``"speculative"."draft"`` geometry spec may carry
_DRAFT_SPEC_KEYS = ("n_layer", "d_model", "n_head", "seed")


@dataclasses.dataclass
class SpeculativeConfig(DeepSpeedConfigModel):
    """The ``"serving"."speculative"`` section: batched draft/verify rounds
    in the continuous-batching tick loop.  A wrong draft spec raises
    :class:`~deepspeed_tpu_torch.runtime.config.DeepSpeedConfigError` at
    config time."""

    #: switch the tick loop from one-token decode steps to draft_k-token
    #: draft/verify rounds (the same output semantics)
    enabled: bool = False
    #: draft proposals per round; bucketed so the k+1 verify window is a
    #: power of two (``bucket_draft_k``)
    draft_k: int = 3
    #: draft geometry spec ``{"n_layer", "d_model", "n_head", "seed"}``:
    #: builds a random-init dense GPT draft over the target's vocabulary
    #: when no draft is passed to ``engine.serve(draft=...)``.  None: a
    #: draft engine or ``(GPTConfig, params)`` must be passed.
    draft: Optional[Dict] = None

    def __post_init__(self):
        if not isinstance(self.draft_k, int) or isinstance(self.draft_k, bool) \
                or not 1 <= self.draft_k <= 64:
            raise DeepSpeedConfigError(
                f"serving.speculative.draft_k must be an int in [1, 64], "
                f"got {self.draft_k!r}")
        if self.draft is None:
            return
        if not isinstance(self.draft, dict):
            raise DeepSpeedConfigError(
                "serving.speculative.draft must be a dict draft-model "
                f"spec with keys {_DRAFT_SPEC_KEYS}, got "
                f"{type(self.draft).__name__}")
        unknown = sorted(set(self.draft) - set(_DRAFT_SPEC_KEYS))
        if unknown:
            raise DeepSpeedConfigError(
                f"serving.speculative.draft: unknown keys {unknown} "
                f"(known: {_DRAFT_SPEC_KEYS})")
        for k in ("n_layer", "d_model", "n_head"):
            if k in self.draft and (
                    not isinstance(self.draft[k], int)
                    or isinstance(self.draft[k], bool)
                    or self.draft[k] < 1):
                raise DeepSpeedConfigError(
                    f"serving.speculative.draft.{k} must be an int >= 1, "
                    f"got {self.draft[k]!r}")


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
    #: the library handles' set-up land before the first request (with
    #: speculation: every ladder level's tick too)
    warm_start: bool = False
    #: raw "speculative" section (typed view: ``speculative_config``):
    #: batched draft/verify in the tick loop; see :class:`SpeculativeConfig`
    speculative: Optional[Dict] = None

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
        # the typed view is an attribute, not a field: dict round trips and
        # equality read the raw section only
        if isinstance(self.speculative, SpeculativeConfig):
            self.speculative = self.speculative.to_dict()
        self.speculative_config = SpeculativeConfig.from_dict(
            self.speculative or {})
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
