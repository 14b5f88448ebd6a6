"""The ``"supervision"`` config section, typed: the port of the JAX
package's ``runtime/supervision/config.py``.

.. code-block:: json

    {"supervision": {
        "enabled": true,
        "step_deadline_s": 1800,
        "collective_deadline_s": 600,
        "event_journal": null,
        "preempt_save_deadline_s": null,
        "heartbeat": {"enabled": true, "interval_s": 15, "gap_s": 60,
                      "dir": null, "slow_factor": null,
                      "slow_min_intervals": 2},
        "rollback": {"max_rollbacks": 2, "lr_factor": 0.5,
                     "reset_loss_scale": true, "skip_batches": 0}
    }}

``null`` deadlines disable the corresponding watchdog arming;
``event_journal``/``heartbeat.dir`` default to paths under the runner's
checkpoint directory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..config_utils import DeepSpeedConfigModel

SUPERVISION = "supervision"


@dataclasses.dataclass
class HeartbeatConfig(DeepSpeedConfigModel):
    """Per-process heartbeat files + gap detection."""

    enabled: bool = False
    #: seconds between beats (daemon thread in each process)
    interval_s: float = 15.0
    #: a rank whose newest beat is older than this is reported dead
    gap_s: float = 60.0
    #: shared directory for the beat files (None → <save_dir>/heartbeats)
    dir: Optional[str] = None
    #: a rank whose observed beat interval exceeds ``slow_factor ×`` its
    #: advertised interval (sustained over ``slow_min_intervals`` beats) is
    #: classified slow — journaled once per transition as
    #: ``heartbeat.slow`` (None disables slow-rank detection)
    slow_factor: Optional[float] = None
    #: consecutive drifted intervals before the slow transition fires
    slow_min_intervals: int = 2

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError(
                f"supervision heartbeat.interval_s must be > 0, got "
                f"{self.interval_s}")
        if self.gap_s <= self.interval_s:
            raise ValueError(
                f"supervision heartbeat.gap_s ({self.gap_s}) must exceed "
                f"interval_s ({self.interval_s}) or every live host looks "
                f"dead between beats")
        if self.slow_factor is not None and float(self.slow_factor) <= 1.0:
            raise ValueError(
                f"supervision heartbeat.slow_factor must be > 1 (or null to "
                f"disable), got {self.slow_factor}")
        if self.slow_min_intervals < 1:
            raise ValueError(
                f"supervision heartbeat.slow_min_intervals must be >= 1, "
                f"got {self.slow_min_intervals}")


@dataclasses.dataclass
class RollbackConfig(DeepSpeedConfigModel):
    """Divergence recovery: bounded rollback-and-retry.

    On a consecutive-NaN streak the supervisor reloads the newest VERIFIED
    tag (the checkpoint fallback chain), optionally shrinks the LR and resets the
    loss scale, skips ``skip_batches`` batches past the window that poisoned
    the run, and retries — at most ``max_rollbacks`` consecutive times
    before aborting for real.  ``max_rollbacks=0`` keeps the old
    abort-immediately behavior.
    """

    max_rollbacks: int = 2
    #: multiply every param group's LR by this on each rollback (1.0 = keep)
    lr_factor: float = 1.0
    #: reinitialize the dynamic loss-scale state after reload (the carried
    #: scale/hysteresis belongs to the diverged trajectory)
    reset_loss_scale: bool = True
    #: batches to consume without training after reload — steps past the
    #: data window that fed the divergence
    skip_batches: int = 0

    def __post_init__(self):
        if self.max_rollbacks < 0:
            raise ValueError(
                f"supervision rollback.max_rollbacks must be >= 0, got "
                f"{self.max_rollbacks}")
        if not (0.0 < self.lr_factor <= 1.0):
            raise ValueError(
                f"supervision rollback.lr_factor must be in (0, 1], got "
                f"{self.lr_factor}")
        if self.skip_batches < 0:
            raise ValueError(
                f"supervision rollback.skip_batches must be >= 0, got "
                f"{self.skip_batches}")


@dataclasses.dataclass
class DeepSpeedSupervisionConfig(DeepSpeedConfigModel):
    """Hang detection + heartbeats + divergence recovery, as one section."""

    enabled: bool = True
    #: watchdog deadline armed around each train step (None = no step guard)
    step_deadline_s: Optional[float] = None
    #: watchdog deadline armed around host-plane collectives (the port has
    #: no comm layer yet: the deadline arms the watchdog like a step's)
    collective_deadline_s: Optional[float] = None
    #: JSONL event journal path (None → <save_dir>/events.jsonl)
    event_journal: Optional[str] = None
    #: proactive checkpoint-on-SIGTERM budget: the first preemption signal
    #: starts this clock, and the drain save is attempted only while it has
    #: time left — journaled ``ckpt.preempt_save`` on success within the
    #: deadline, ``ckpt.preempt_save_timeout`` otherwise (None: an
    #: unbounded drain; a second SIGTERM still exits at once)
    preempt_save_deadline_s: Optional[float] = None
    #: raw subsections (typed views: ``heartbeat_config``/``rollback_config``)
    heartbeat: Optional[Dict] = None
    rollback: Optional[Dict] = None

    heartbeat_config: HeartbeatConfig = dataclasses.field(
        default_factory=HeartbeatConfig)
    rollback_config: RollbackConfig = dataclasses.field(
        default_factory=RollbackConfig)

    def __post_init__(self):
        if isinstance(self.heartbeat, dict):
            self.heartbeat_config = HeartbeatConfig.from_dict(self.heartbeat)
        if isinstance(self.rollback, dict):
            self.rollback_config = RollbackConfig.from_dict(self.rollback)
        for name in ("step_deadline_s", "collective_deadline_s",
                     "preempt_save_deadline_s"):
            v = getattr(self, name)
            if v is not None and float(v) <= 0:
                raise ValueError(
                    f"supervision {name} must be > 0 (or null to disable), "
                    f"got {v}")
