"""The ``"checkpoint"`` config section, typed.

The port of the JAX package's ``runtime/checkpoint_engine/config.py``:
one validated section covering the durability subsystem, with the JAX
package's keys and defaults:

.. code-block:: json

    {"checkpoint": {
        "async_save": false,
        "integrity": true,
        "verify_on_load": true,
        "keep_last": null,
        "writers": 2,
        "retries": {"max_attempts": 3, "backoff_base": 0.05,
                    "backoff_max": 2.0, "jitter": 0.25},
        "commit": {"enabled": true, "barrier_deadline_s": 300.0,
                   "barrier_poll_s": 0.02, "barrier_backoff_max_s": 1.0,
                   "consensus_deadline_s": 120.0, "sweep_on_start": true,
                   "sweep_min_age_s": 0.0},
        "tag_validation": "Warn",
        "load_universal_checkpoint": false
    }}

Validated dataclass-model style like ``zero/config.py``
(``DeepSpeedZeroConfig``); an unknown key raises, as everywhere in the
port's configs.  ``load_universal_checkpoint: true`` is refused by
``runtime/config.py`` (universal checkpoints are ROADMAP.md Queue 1 #8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..config_utils import DeepSpeedConfigModel

CHECKPOINT = "checkpoint"

TAG_VALIDATION_MODES = ("ignore", "warn", "fail")


@dataclasses.dataclass
class CheckpointRetryConfig(DeepSpeedConfigModel):
    """Retry policy for checkpoint storage writes: exponential backoff with
    multiplicative jitter, bounded attempts.  Attempt ``i`` (0-based) sleeps
    ``min(backoff_max, backoff_base * 2**i) * (1 + jitter*U[0,1))`` before
    retrying; after ``max_attempts`` total attempts the error propagates."""

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"checkpoint retries.max_attempts must be >= 1, got "
                f"{self.max_attempts}")
        if self.backoff_base < 0 or self.backoff_max < 0:
            raise ValueError("checkpoint retry backoff must be >= 0")
        if self.jitter < 0:
            raise ValueError(
                f"checkpoint retries.jitter must be >= 0, got {self.jitter}")


@dataclasses.dataclass
class CheckpointCommitConfig(DeepSpeedConfigModel):
    """Multi-host two-phase commit + resume consensus (``commit.py``).

    Every rank votes with an atomic ``rank<N>.ready`` manifest; the
    coordinator polls the commit barrier (deadline + exponential backoff
    from ``barrier_poll_s`` up to ``barrier_backoff_max_s``), verifies the
    votes, and publishes ``commit.json`` before the ``latest`` marker may
    move.  Resume runs a min-over-proposals consensus bounded by
    ``consensus_deadline_s``.  ``sweep_on_start`` quarantines torn tags at
    startup; ``sweep_min_age_s`` is the grace window retention-time sweeps
    give a sibling writer's in-flight tag.
    """

    enabled: bool = True
    barrier_deadline_s: float = 300.0
    barrier_poll_s: float = 0.02
    barrier_backoff_max_s: float = 1.0
    consensus_deadline_s: float = 120.0
    sweep_on_start: bool = True
    sweep_min_age_s: float = 0.0

    def __post_init__(self):
        for name in ("barrier_deadline_s", "barrier_poll_s",
                     "barrier_backoff_max_s", "consensus_deadline_s"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(
                    f"checkpoint commit.{name} must be > 0, got "
                    f"{getattr(self, name)}")
        if self.sweep_min_age_s < 0:
            raise ValueError(
                f"checkpoint commit.sweep_min_age_s must be >= 0, got "
                f"{self.sweep_min_age_s}")


@dataclasses.dataclass
class DeepSpeedCheckpointConfig(DeepSpeedConfigModel):
    """Durability + backend selection for the checkpoint path.

    ``integrity`` writes a per-tag ``manifest.json`` (sizes + SHA-256) at
    publish time; ``verify_on_load`` makes resume walk tags newest→oldest
    until one verifies AND deserializes (the verified-fallback chain);
    ``keep_last`` prunes old tags after each successful publish, never
    deleting the newest *verified* tag.
    """

    #: background writer threads + deferred publish (nebula role)
    async_save: bool = False
    #: writer-pool size for async_save
    writers: int = 2
    #: write manifest.json (file list, byte sizes, sha256) at publish
    integrity: bool = True
    #: resume walks the verified-fallback chain instead of dying on the
    #: first corrupt/missing tag
    verify_on_load: bool = True
    #: retention: keep this many newest tags (None/0 = keep everything)
    keep_last: Optional[int] = None
    #: raw "retries" subsection (typed view: ``retry``)
    retries: Optional[Dict] = None
    #: raw "commit" subsection (typed view: ``commit_config``) — the
    #: multi-host two-phase commit + resume consensus protocol
    commit: Optional[Dict] = None
    #: reference parity knobs (parsed in runtime/config.py as well)
    tag_validation: str = "Warn"
    load_universal_checkpoint: bool = False

    retry: CheckpointRetryConfig = dataclasses.field(
        default_factory=CheckpointRetryConfig)
    commit_config: CheckpointCommitConfig = dataclasses.field(
        default_factory=CheckpointCommitConfig)

    def __post_init__(self):
        if isinstance(self.retries, dict):
            self.retry = CheckpointRetryConfig.from_dict(self.retries)
        if isinstance(self.commit, dict):
            self.commit_config = CheckpointCommitConfig.from_dict(self.commit)
        if self.keep_last is not None:
            self.keep_last = int(self.keep_last)
            if self.keep_last <= 0:
                self.keep_last = None
        if self.writers < 1:
            raise ValueError(
                f"checkpoint writers must be >= 1, got {self.writers}")
        if str(self.tag_validation).lower() not in TAG_VALIDATION_MODES:
            raise ValueError(
                f"checkpoint tag_validation must be one of "
                f"{TAG_VALIDATION_MODES} (any case), got {self.tag_validation!r}")
