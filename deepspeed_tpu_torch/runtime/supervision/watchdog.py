"""Step watchdog: a deadline timer that turns invisible hangs into
bounded restarts — the port of the JAX package's
``runtime/supervision/watchdog.py``.

A hung input pipeline or a wedged step does not crash — it burns a whole
preemptible card silently until a human notices.  The watchdog is a
single daemon thread with a deadline; the train loop arms it around each
step (:meth:`StepWatchdog.guard`).  If a deadline expires the watchdog

1. dumps **every** thread's stack (:func:`dump_all_stacks` — the hang's
   post-mortem, because after ``os.abort`` there is nothing left to read),
2. emits a structured ``watchdog.expired`` event to the journal, and
3. aborts the process (``SIGABRT`` by default) so the launcher restarts it
   and the verified resume takes over.

An ``on_expire`` callback observes expiry instead of aborting (tests, or
an embedder's own teardown).

Arming is re-entrant: a nested guard tightens the deadline for its
duration and restores the outer one on exit.  :func:`comm_guard` and
:func:`set_global_watchdog` keep the JAX package's hookup for host-plane
collectives; the port has no comm layer yet, so nothing calls
:func:`comm_guard` and a registered watchdog only sits there.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

from ...utils.lock_watch import LockName, TrackedRLock
from ...utils.logging import logger
from .events import EventKind


def dump_all_stacks() -> str:
    """Format the current stack of every live thread (the hang snapshot)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"--- Thread {names.get(ident, '?')} (ident={ident}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


class StepWatchdog:
    """One daemon thread, one deadline at a time, re-armed per step.

    Args:
      deadline_s: default deadline applied by :meth:`arm`/:meth:`guard`
        when none is given per call.
      journal: optional :class:`EventJournal`; expiry emits
        ``watchdog.expired`` with the label, deadline, and stack dump.
      on_expire: called with the event record instead of aborting (tests;
        also lets an embedder translate expiry into its own teardown).
      abort_signal: delivered to this process on expiry when no
        ``on_expire`` is set — SIGABRT so the launcher sees an abnormal
        exit, not a clean one.
    """

    def __init__(self, deadline_s: float, journal=None,
                 on_expire: Optional[Callable[[Dict[str, Any]], None]] = None,
                 abort_signal: int = signal.SIGABRT):
        if deadline_s <= 0:
            raise ValueError(f"watchdog deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.journal = journal
        self.on_expire = on_expire
        self.abort_signal = abort_signal
        self.expired_count = 0
        # reentrant so _ensure_thread can take it from arm()'s callers
        self._cond = threading.Condition(
            TrackedRLock(LockName.SUPERVISION_WATCHDOG))
        self._deadline: Optional[float] = None  # time.monotonic() when armed
        self._label: Optional[str] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- arming
    def _ensure_thread(self) -> None:
        with self._cond:  # _stop/_thread share the cond with the loop
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False  # re-armable after stop() (runner reuse)
            self._thread = threading.Thread(
                target=self._loop, name="step-watchdog", daemon=True)
            self._thread.start()

    def arm(self, label: str, deadline_s: Optional[float] = None
            ) -> Tuple[Optional[float], Optional[str]]:
        """Start (or re-target) the countdown; returns the previous
        (deadline, label) so nested guards can restore it."""
        d = self.deadline_s if deadline_s is None else float(deadline_s)
        with self._cond:
            prev = (self._deadline, self._label)
            self._deadline = time.monotonic() + d
            self._label = label
            self._cond.notify_all()
        self._ensure_thread()
        return prev

    def disarm(self) -> None:
        self._restore((None, None))

    def _restore(self, prev: Tuple[Optional[float], Optional[str]]) -> None:
        with self._cond:
            self._deadline, self._label = prev
            self._cond.notify_all()

    @contextmanager
    def guard(self, label: str, deadline_s: Optional[float] = None):
        """``with watchdog.guard("train.step"): ...`` — armed on entry,
        previous arming (or none) restored on exit."""
        prev = self.arm(label, deadline_s)
        try:
            yield self
        finally:
            self._restore(prev)

    def stop(self, timeout: float = 1.0) -> None:
        """Shut the watchdog thread down (end of run); the join is bounded
        so a wedged expiry path cannot hang the caller's teardown."""
        with self._cond:
            self._stop = True
            self._deadline = None
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                logger.warning(
                    "[supervision] watchdog thread did not exit within "
                    f"{timeout:.1f}s")

    # ------------------------------------------------------------- expiry
    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                remaining = self._deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(remaining)
                    continue
                label, deadline = self._label, self._deadline
                self._deadline, self._label = None, None  # one-shot
            self._expire(label)

    def _expire(self, label: Optional[str]) -> None:
        self.expired_count += 1
        stacks = dump_all_stacks()
        logger.error(
            f"[supervision] watchdog expired at {label!r} after "
            f"{self.deadline_s:.1f}s — dumping all thread stacks and "
            f"aborting:\n{stacks}")
        rec = {"label": label, "deadline_s": self.deadline_s, "stacks": stacks}
        if self.journal is not None:
            rec = self.journal.emit(EventKind.WATCHDOG_EXPIRED, **rec)
        if self.on_expire is not None:
            self.on_expire(rec)
        else:  # pragma: no cover - kills the test process by design
            os.kill(os.getpid(), self.abort_signal)


# --------------------------------------------------------------------------
# Global hookup for comm-plane guarding: a comm layer cannot own a watchdog
# (the runner does), so the runner registers it here and every host-plane
# collective would route through comm_guard.  No watchdog registered →
# zero-cost passthrough.
# --------------------------------------------------------------------------

_global: Optional[StepWatchdog] = None
_global_deadline_s: Optional[float] = None


def set_global_watchdog(wd: Optional[StepWatchdog],
                        collective_deadline_s: Optional[float] = None) -> None:
    """Register (or with ``None`` clear) the watchdog guarding collectives."""
    global _global, _global_deadline_s
    _global = wd
    _global_deadline_s = collective_deadline_s


def get_global_watchdog() -> Optional[StepWatchdog]:
    return _global


@contextmanager
def comm_guard(label: str):
    """Arm the registered watchdog around a host-plane collective."""
    wd = _global
    if wd is None:
        yield
        return
    prev = wd.arm(label, _global_deadline_s)
    try:
        yield
    finally:
        wd._restore(prev)
