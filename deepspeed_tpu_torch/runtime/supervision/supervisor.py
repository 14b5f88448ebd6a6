"""RunSupervisor: the decide-and-recover half of supervision — the port
of the JAX package's ``runtime/supervision/supervisor.py``.

The detectors (NaN streak in the runner, watchdog, heartbeat monitor) feed
this policy; it decides between *recover in place* and *abort* and journals
every decision.  The recovery is divergence rollback-and-retry:

divergence → reload newest VERIFIED tag (the checkpoint fallback chain
walks past corrupt tags) → optionally shrink LR / reset the loss scale →
skip the data window that fed the divergence → retry — at most
``max_rollbacks`` CONSECUTIVE times.  "Consecutive" is anchored on forward
progress: a checkpoint published *beyond* the last rollback's origin
proves the retry took, and resets the budget.  A run that diverges
forever therefore aborts after ``max_rollbacks`` reloads instead of
looping on a burning card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ...utils.logging import logger
from .config import DeepSpeedSupervisionConfig
from .events import EventKind


class RunSupervisor:
    """Bounded rollback-and-retry over an engine's checkpoint directory.

    Duck-typed against the engine surface the runner already relies on:
    ``load_checkpoint(save_dir)`` (verified-fallback chain), ``global_steps``,
    and optionally ``optimizer.param_groups`` (LR shrink) and
    ``reset_loss_scale()``.
    """

    def __init__(self, engine, save_dir: str,
                 config: Optional[DeepSpeedSupervisionConfig] = None,
                 journal=None):
        self.engine = engine
        self.save_dir = save_dir
        self.config = config or DeepSpeedSupervisionConfig.from_dict({})
        self.journal = journal
        self.consecutive_rollbacks = 0
        self.total_rollbacks = 0
        #: step the newest rollback started from; progress past it resets
        #: the consecutive budget
        self._last_rollback_from_step: Optional[int] = None

    # ---------------------------------------------------------------- emit
    def _emit(self, kind: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.emit(kind, **fields)

    # ------------------------------------------------------------ progress
    def on_checkpoint(self, step: int) -> None:
        """A tag published at ``step`` — forward progress.  A checkpoint
        beyond the last rollback's origin proves the retry recovered."""
        if self.consecutive_rollbacks and \
                self._last_rollback_from_step is not None and \
                step > self._last_rollback_from_step:
            self._emit(EventKind.ROLLBACK_RECOVERED, step=step,
                       rollbacks=self.consecutive_rollbacks)
            logger.info(
                f"[supervision] recovered: step {step} passed the "
                f"divergence at step {self._last_rollback_from_step} after "
                f"{self.consecutive_rollbacks} rollback(s)")
            self.consecutive_rollbacks = 0
            self._last_rollback_from_step = None

    # ---------------------------------------------------------- divergence
    def on_divergence(self, step: int, loss: float) -> Optional[Dict[str, Any]]:
        """Decide recovery for a confirmed divergence at ``step``.

        Returns a directive ``{"to_step", "skip_batches", "quarantine"}``
        when the run should retry from the reloaded state, or ``None`` when
        it must abort (budget exhausted, or nothing verified to roll back
        to).  The engine's state has already been rolled back when a
        directive is returned.

        With a resumable data iterator registered on the engine, the
        poisoned window is an ABSOLUTE quarantine ``[restored_data_step,
        divergence_data_step + skip_batches)``: the checkpoint reload
        rewinds the loader, the window is journaled (``data.quarantine``)
        and installed on the loader, and the replay provably skips exactly
        the batches that fed the divergence.  Without one, the directive
        falls back to the old relative ``skip_batches`` count, which is
        honest only about the iterator position it happens to start from.
        """
        rb = self.config.rollback_config
        if self.consecutive_rollbacks >= rb.max_rollbacks:
            self._emit(EventKind.DIVERGENCE_ABORT, step=step, loss=loss,
                       rollbacks=self.consecutive_rollbacks,
                       max_rollbacks=rb.max_rollbacks,
                       reason="max_rollbacks exhausted")
            return None
        # the loader position at divergence must be read BEFORE the reload
        # rewinds it — that position is the end of the poisoned window
        loader = getattr(self.engine, "data_iterator", None)
        if loader is None or not (hasattr(loader, "step")
                                  and hasattr(loader, "quarantine")):
            loader = None
        div_data_step = int(loader.step) if loader is not None else None
        loaded, _ = self.engine.load_checkpoint(self.save_dir)
        if loaded is None:
            self._emit(EventKind.DIVERGENCE_ABORT, step=step, loss=loss,
                       rollbacks=self.consecutive_rollbacks,
                       reason="no verified checkpoint to roll back to")
            return None
        self.consecutive_rollbacks += 1
        self.total_rollbacks += 1
        self._last_rollback_from_step = step
        to_step = int(getattr(self.engine, "global_steps", 0))
        quarantine = None
        if loader is not None:
            q_from = int(loader.step)  # rewound by the checkpoint reload
            q_to = div_data_step + rb.skip_batches
            if q_to > q_from:
                loader.quarantine(q_from, q_to)
                quarantine = (q_from, q_to)
                self._emit(EventKind.DATA_QUARANTINE, from_step=q_from,
                           to_step=q_to,
                           divergence_step=step)
        lr_factor = self._shrink_lr(rb.lr_factor)
        scale_reset = self._reset_loss_scale() if rb.reset_loss_scale else False
        skip_batches = 0 if quarantine is not None else rb.skip_batches
        logger.warning(
            f"[supervision] divergence at step {step} (loss={loss}): rolled "
            f"back to verified step {to_step} "
            f"({self.consecutive_rollbacks}/{rb.max_rollbacks} consecutive), "
            f"lr_factor={lr_factor}, loss_scale_reset={scale_reset}, "
            + (f"quarantined data steps [{quarantine[0]}, {quarantine[1]})"
               if quarantine is not None
               else f"skipping {skip_batches} batch(es)"))
        self._emit(EventKind.ROLLBACK, from_step=step, to_step=to_step,
                   loss=loss,
                   index=self.consecutive_rollbacks,
                   max_rollbacks=rb.max_rollbacks, lr_factor=lr_factor,
                   loss_scale_reset=scale_reset,
                   skip_batches=skip_batches,
                   quarantine=list(quarantine) if quarantine else None)
        directive = {"to_step": to_step, "skip_batches": skip_batches}
        if quarantine is not None:
            directive["quarantine"] = quarantine
        return directive

    # ------------------------------------------------------------- knobs
    def _shrink_lr(self, factor: float) -> float:
        if factor >= 1.0:
            return 1.0
        groups = getattr(getattr(self.engine, "optimizer", None),
                         "param_groups", None)
        if not groups:
            return 1.0
        for g in groups:
            if "lr" in g:
                g["lr"] = float(g["lr"]) * factor
        return factor

    def _reset_loss_scale(self) -> bool:
        reset = getattr(self.engine, "reset_loss_scale", None)
        if reset is None:
            return False
        try:
            reset()
            return True
        except Exception as e:  # a failed knob must not veto the rollback
            logger.warning(f"[supervision] reset_loss_scale failed: {e}")
            return False
