"""Fault-injection (chaos) layer for durability testing.

The port of the JAX package's ``utils/fault_injection.py`` (its fault
classes, registry and ``corrupt_file``).  Named failure points are
compiled into the checkpoint storage and commit paths; with no fault
installed, ``fire()`` is a dict lookup that finds nothing, so production
pays one branch per point.  Tests install faults (directly or via the
:func:`inject` context manager) and drive the real code paths.

Points wired in the port (the JAX package's names and contexts):

========================  =====================================================
``ckpt.write``            start of every npz/text write attempt (inside the
                          retry loop — raising here exercises backoff);
                          ctx: ``path``
``ckpt.post_write``       after the atomic replace landed the final file;
                          ctx: ``path`` (truncate/corrupt faults model torn
                          writes and bitrot)
``ckpt.publish``          just before the ``latest`` marker is written;
                          ctx: ``tag``
``ckpt.rank_write``       start of a rank's phase-1 ready-manifest write
                          (commit protocol); ctx: ``path``, ``tag``,
                          ``rank`` (``DelaySeconds`` models a straggler
                          rank, ``FailNTimes`` a killed writer)
``ckpt.commit_barrier``   each poll of the coordinator's commit barrier;
                          ctx: ``tag`` (``HangFor`` models a wedged
                          barrier; raising models a coordinator fault)
``ckpt.publish_commit``   just before ``commit.json`` is written — after
                          every rank voted ready; ctx: ``tag``
``train.step_begin``      the elastic runner, before each step's train call,
                          inside the step watchdog's guard; ctx: ``step``
                          (``HangFor`` models a hung step)
``train.loss``            after each step, with the loss in a mutable
                          ``box``; ctx: ``step``, ``box``
                          (``NaNLossWindow`` poisons a window)
``train.step``            after each step's divergence check, before the
                          periodic save; ctx: ``step`` (``SignalAtStep``
                          models the preemption notice)
``supervision.heartbeat`` each heartbeat write; ctx: ``path``, ``rank``
``data.next``             the resumable loader, before a batch's samples
                          are read; ctx: ``step``, ``epoch``
``data.collate``          before a batch is collated; ctx: ``step``,
                          ``indices`` (``BadRecord`` models a bad sample)
========================  =====================================================

The subprocess fault plans (``DS_FAULT_PLAN``) are not ported.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from . import lock_watch

#: every fault point wired in the port
FAULT_POINTS = frozenset({
    "ckpt.write",
    "ckpt.post_write",
    "ckpt.publish",
    "ckpt.rank_write",
    "ckpt.commit_barrier",
    "ckpt.publish_commit",
    "train.step",
    "train.step_begin",
    "train.loss",
    "supervision.heartbeat",
    "data.next",
    "data.collate",
})

# points with faults installed; guarded by _lock for install/clear, read
# without it in fire() (list snapshot semantics are enough for tests)
_faults: Dict[str, List["Fault"]] = {}
_lock = lock_watch.TrackedLock(lock_watch.LockName.FAULTS_INSTALL)


class FaultError(OSError):
    """The exception injected write-failure faults raise by default."""


class BadRecordError(ValueError):
    """The exception :class:`BadRecord` raises — a decode/collate failure,
    distinct from the I/O-flavored :class:`FaultError` so data-pipeline
    tests can assert the bad-record path specifically."""


class Fault:
    """Base fault: subclasses implement ``fire(point, **ctx)``."""

    def fire(self, point: str, **ctx) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    @staticmethod
    def _matches(match: Optional[str], path: Optional[str]) -> bool:
        return match is None or (path is not None and match in str(path))


class FailNTimes(Fault):
    """Raise on the first ``n`` matching fires, then pass (transient error).

    ``n=None`` fails forever (permanent error).  ``match`` restricts the
    fault to paths containing the substring.  ``fired`` counts injections so
    tests can assert the retry loop actually exercised them.
    """

    def __init__(self, n: Optional[int] = 1, match: Optional[str] = None,
                 exc_type=FaultError):
        self.remaining = n
        self.match = match
        self.exc_type = exc_type
        self.fired = 0

    def fire(self, point: str, path: Optional[str] = None, **ctx) -> None:
        if not self._matches(self.match, path):
            return
        if self.remaining is None or self.remaining > 0:
            if self.remaining is not None:
                self.remaining -= 1
            self.fired += 1
            raise self.exc_type(
                f"injected failure #{self.fired} at {point} ({path})")


class TruncateAfterBytes(Fault):
    """Truncate the just-written file to ``nbytes`` (a torn/partial write
    that still made it to the final path).  Fires once per matching path
    unless ``once=False``."""

    def __init__(self, nbytes: int, match: Optional[str] = None,
                 once: bool = True):
        self.nbytes = nbytes
        self.match = match
        self.once = once
        self.fired = 0

    def fire(self, point: str, path: Optional[str] = None, **ctx) -> None:
        if path is None or not self._matches(self.match, path):
            return
        if self.once and self.fired:
            return
        if os.path.exists(path) and os.path.getsize(path) > self.nbytes:
            with open(path, "r+b") as f:
                f.truncate(self.nbytes)
            self.fired += 1


class CorruptRandomBytes(Fault):
    """Flip ``nbytes`` bytes at deterministic pseudo-random offsets (bitrot
    past the npz header so sizes still match but digests don't)."""

    def __init__(self, nbytes: int = 8, seed: int = 0,
                 match: Optional[str] = None, once: bool = True):
        self.nbytes = nbytes
        self.seed = seed
        self.match = match
        self.once = once
        self.fired = 0

    def fire(self, point: str, path: Optional[str] = None, **ctx) -> None:
        if path is None or not self._matches(self.match, path):
            return
        if self.once and self.fired:
            return
        corrupt_file(path, nbytes=self.nbytes, seed=self.seed)
        self.fired += 1


class SignalAtStep(Fault):
    """Deliver ``sig`` to this process when the train loop reaches ``step``
    (the cloud preemption notice, scripted)."""

    def __init__(self, step: int, sig: int = signal.SIGTERM):
        self.step = step
        self.sig = sig
        self.fired = 0

    def fire(self, point: str, step: Optional[int] = None, **ctx) -> None:
        if step == self.step:
            self.fired += 1
            os.kill(os.getpid(), self.sig)


class KillAtStep(SignalAtStep):
    """SIGKILL this process when the train loop reaches ``step`` — the hard
    preemption (no notice, no drain).  The goodput fleet's bread and
    butter: the supervisor must detect the corpse and respawn the rank."""

    def __init__(self, step: int, sig: int = signal.SIGKILL):
        super().__init__(step, sig=sig)


class ExitAtStep(Fault):
    """``os._exit(code)`` when the loop reaches ``step`` — a crashing
    worker that dies with a nonzero exit code instead of a signal (OOM
    killer shims, assertion aborts, container evictions)."""

    def __init__(self, step: int, code: int = 3):
        self.step = int(step)
        self.code = int(code)
        self.fired = 0

    def fire(self, point: str, step: Optional[int] = None, **ctx) -> None:
        if step == self.step:
            self.fired += 1
            os._exit(self.code)


class NaNLossWindow(Fault):
    """Overwrite the step loss with NaN while ``from_step <= step <
    to_step`` — the poisoned batch window that feeds a divergence.

    Fires at ``train.loss``, whose ctx carries a mutable ``box`` dict
    (``{"loss": x}``); the fault rewrites ``box["loss"]``.  ``n`` bounds the
    total injections (default: the window width) so a rollback that
    quarantines the poisoned batches and retrains the same step numbers is
    not re-poisoned — the fault models bad *data*, which the quarantine
    removed, not bad step indices.
    """

    def __init__(self, from_step: int, to_step: int, n: Optional[int] = None,
                 value: float = float("nan")):
        self.from_step = int(from_step)
        self.to_step = int(to_step)
        self.remaining = int(to_step - from_step) if n is None else n
        self.value = float(value)
        self.fired = 0

    def fire(self, point: str, step: Optional[int] = None,
             box: Optional[dict] = None, **ctx) -> None:
        if box is None or step is None:
            return
        if not (self.from_step <= step < self.to_step):
            return
        if self.remaining is not None and self.remaining <= 0:
            return
        if self.remaining is not None:
            self.remaining -= 1
        self.fired += 1
        box["loss"] = self.value


class BadRecord(Fault):
    """Raise :class:`BadRecordError` at ``data.next``/``data.collate`` —
    the unreadable shard or malformed sample.

    ``steps`` restricts the fault to specific absolute batch steps (every
    matching fire otherwise); ``n`` bounds the total raises (``None`` =
    every matching fire).  ``fired`` counts injections so tests can assert
    the skip path actually ran.
    """

    def __init__(self, n: Optional[int] = 1, steps: Optional[List[int]] = None,
                 exc_type=BadRecordError):
        self.remaining = n
        self.steps = set(steps) if steps is not None else None
        self.exc_type = exc_type
        self.fired = 0

    def fire(self, point: str, step: Optional[int] = None, **ctx) -> None:
        if self.steps is not None and step not in self.steps:
            return
        if self.remaining is not None and self.remaining <= 0:
            return
        if self.remaining is not None:
            self.remaining -= 1
        self.fired += 1
        raise self.exc_type(
            f"injected bad record #{self.fired} at {point} (step {step})")


class HangFor(Fault):
    """Block at the fault point for up to ``seconds`` — the injected hang.

    The block is an interruptible :class:`threading.Event` wait, so a
    watchdog test can observe expiry and then :meth:`release` the hung
    "step" instead of sleeping out the full duration.  Fires once per
    install unless ``once=False``.
    """

    def __init__(self, seconds: float, match: Optional[str] = None,
                 once: bool = True):
        self.seconds = float(seconds)
        self.match = match
        self.once = once
        self.fired = 0
        self._release = threading.Event()

    def fire(self, point: str, path: Optional[str] = None, **ctx) -> None:
        if not self._matches(self.match, path):
            return
        if self.once and self.fired:
            return
        self.fired += 1
        self._release.wait(self.seconds)

    def release(self) -> None:
        """Un-hang every current and future fire of this fault."""
        self._release.set()


class DelaySeconds(Fault):
    """Sleep ``seconds`` on each of the first ``n`` matching fires (a slow
    host / degraded storage, as opposed to :class:`HangFor`'s dead one).
    ``n=None`` delays every fire."""

    def __init__(self, seconds: float, n: Optional[int] = None,
                 match: Optional[str] = None):
        self.seconds = float(seconds)
        self.remaining = n
        self.match = match
        self.fired = 0

    def fire(self, point: str, path: Optional[str] = None, **ctx) -> None:
        if not self._matches(self.match, path):
            return
        if self.remaining is not None:
            if self.remaining <= 0:
                return
            self.remaining -= 1
        self.fired += 1
        time.sleep(self.seconds)


def corrupt_file(path: str, nbytes: int = 8, seed: int = 0) -> None:
    """Flip ``nbytes`` bytes of ``path`` in place (size-preserving)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        for _ in range(nbytes):
            off = rng.randrange(size)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------- registry
def install(point: str, fault: Fault) -> Fault:
    with _lock:
        _faults.setdefault(point, []).append(fault)
    return fault


def remove(point: str, fault: Fault) -> None:
    with _lock:
        lst = _faults.get(point, [])
        if fault in lst:
            lst.remove(fault)
        if not lst:
            _faults.pop(point, None)


def clear(point: Optional[str] = None) -> None:
    with _lock:
        if point is None:
            _faults.clear()
        else:
            _faults.pop(point, None)


def fire(point: str, **ctx) -> None:
    """Trip every fault installed at ``point`` (no-op when none are)."""
    lst = _faults.get(point)
    if not lst:
        return
    for fault in list(lst):
        fault.fire(point, **ctx)


@contextmanager
def inject(point: str, fault: Fault):
    """``with inject("ckpt.write", FailNTimes(2)) as f: ...`` — installed on
    entry, removed on exit no matter how the body ends."""
    install(point, fault)
    try:
        yield fault
    finally:
        remove(point, fault)
