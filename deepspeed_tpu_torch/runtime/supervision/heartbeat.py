"""Host heartbeats: dead hosts get *reported*, not discovered by hanging
— the port of the JAX package's ``runtime/supervision/heartbeat.py``,
with its file format (``rank<N>.json``: rank, pid, step, ts, mono_ts,
interval_s), so a monitor of either package reads either's beats.

Each process atomically rewrites a tiny ``rank<N>.json`` in a shared
directory every ``interval_s``; the monitor (rank 0, or an external
babysitter) reads them all and reports any rank whose beat is older than
``gap_s`` — so the restart decision can *name* the dead host instead of
guessing.

The write path routes through the ``supervision.heartbeat`` fault point,
so chaos tests inject stalls (``DelaySeconds``/``HangFor``) and write
failures without touching a real clock or filesystem fault.
"""

from __future__ import annotations

import json
import os
import threading
import time
# bound at import so tests that stub this module's `time` (wall-clock
# advancement) keep a real monotonic source for the clock handshake
from time import monotonic as _monotonic
from typing import Any, Dict, List, Optional, Tuple

from ...utils import fault_injection
from ...utils.lock_watch import LockName, TrackedLock
from ...utils.logging import logger
from .events import EventKind

_FILE_FMT = "rank{rank}.json"


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, _FILE_FMT.format(rank=rank))


class HeartbeatWriter:
    """Per-process beat: atomic tmp+replace of ``rank<N>.json``.

    ``beat()`` may be called manually (e.g. per train step); ``start()``
    runs a daemon thread beating every ``interval_s`` so a step that hangs
    for minutes still shows a *live* host (the watchdog owns hung-step
    detection; heartbeats own dead-process detection — a beating host with
    a hung step must not look dead).
    """

    def __init__(self, directory: str, rank: int, interval_s: float = 15.0,
                 journal=None):
        self.directory = str(directory)
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        self.journal = journal
        self.beats = 0
        self._step = 0
        # guards beats/_step (written by both the beat thread and the train
        # loop's note_step); the file write itself stays OUTSIDE the lock
        self._lock = TrackedLock(LockName.SUPERVISION_HEARTBEAT)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)

    @property
    def path(self) -> str:
        return heartbeat_path(self.directory, self.rank)

    def note_step(self, step: int) -> None:
        """Record the current step without writing — the next beat carries
        it (per-step writes would put a file op on the train hot path)."""
        with self._lock:
            self._step = int(step)

    def beat(self, step: Optional[int] = None) -> None:
        """Write one heartbeat now (failures are logged, never fatal —
        losing a beat is strictly better than killing the host over it)."""
        with self._lock:
            if step is not None:
                self._step = int(step)
            cur_step = self._step
        try:
            fault_injection.fire("supervision.heartbeat", path=self.path,
                                 rank=self.rank)
            # interval_s rides in the payload so a monitor can judge beat
            # cadence drift (slow-rank detection) without being configured
            # with every writer's interval
            # ts/mono_ts pair doubles as a per-process clock handshake for
            # trace merging (wall − monotonic offset is constant per pid)
            payload = {"rank": self.rank, "pid": os.getpid(),
                       "step": cur_step, "ts": time.time(),
                       "mono_ts": _monotonic(),
                       "interval_s": self.interval_s}
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            with self._lock:
                self.beats += 1
        except OSError as e:
            logger.warning(f"[supervision] heartbeat write failed: {e}")

    def start(self) -> "HeartbeatWriter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"heartbeat-rank{self.rank}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        self.beat()
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, timeout: float = 1.0) -> None:
        """Stop the beat thread; the join is bounded so a beat stuck on a
        wedged filesystem cannot hang teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning(
                    "[supervision] heartbeat thread did not exit within "
                    f"{timeout:.1f}s")
            self._thread = None


class HeartbeatMonitor:
    """Rank 0's view: which ranks are beating, which have gone quiet.

    ``check()`` is pull-based (call it at step boundaries or from a cron) —
    a monitor thread that itself blocks in a collective would be useless.
    Every newly-stale rank is journaled once as ``heartbeat.gap``; a rank
    that resumes beating is journaled as ``heartbeat.recovered``.

    Slow-rank classification (``slow_factor``): a rank that keeps beating
    but whose observed beat-to-beat interval exceeds ``slow_factor ×`` the
    interval its own payload advertises — sustained over
    ``slow_min_intervals`` consecutive beats — is the straggler the gap
    detector cannot see (it never goes stale, it just drags the pod).  The
    transition is journaled once as ``heartbeat.slow``; dropping back under
    the factor journals ``heartbeat.recovered`` (with ``slow=True``).
    """

    def __init__(self, directory: str, gap_s: float = 60.0, journal=None,
                 expected_ranks: Optional[int] = None,
                 slow_factor: Optional[float] = None,
                 slow_min_intervals: int = 2):
        self.directory = str(directory)
        self.gap_s = float(gap_s)
        self.journal = journal
        self.expected_ranks = expected_ranks
        self.slow_factor = None if slow_factor is None else float(slow_factor)
        self.slow_min_intervals = max(1, int(slow_min_intervals))
        self._stale_ranks: set = set()
        self._slow_ranks: set = set()
        #: rank → (last observed beat ts, consecutive drifted intervals)
        self._beat_track: Dict[int, Tuple[float, int]] = {}

    def read_beats(self) -> Dict[int, Dict[str, Any]]:
        beats: Dict[int, Dict[str, Any]] = {}
        if not os.path.isdir(self.directory):
            return beats
        for name in os.listdir(self.directory):
            if not (name.startswith("rank") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    rec = json.load(f)
                beats[int(rec["rank"])] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn beat: treated as missing, not fatal
        return beats

    def check(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Classify ranks as alive/stale/missing against ``gap_s``.

        ``now`` is injectable so tests age beats without sleeping.
        """
        now = time.time() if now is None else now
        beats = self.read_beats()
        alive: List[int] = []
        stale: List[Dict[str, Any]] = []
        for rank, rec in sorted(beats.items()):
            age = now - float(rec.get("ts", 0.0))
            if age > self.gap_s:
                stale.append({"rank": rank, "age_s": age,
                              "last_step": rec.get("step")})
            else:
                alive.append(rank)
        missing: List[int] = []
        if self.expected_ranks is not None:
            missing = [r for r in range(self.expected_ranks) if r not in beats]
        for rec in stale:
            if rec["rank"] not in self._stale_ranks:
                self._stale_ranks.add(rec["rank"])
                logger.warning(
                    f"[supervision] heartbeat gap: rank {rec['rank']} last "
                    f"beat {rec['age_s']:.1f}s ago (gap_s={self.gap_s})")
                if self.journal is not None:
                    self.journal.emit(EventKind.HEARTBEAT_GAP, **rec)
        for rank in sorted(self._stale_ranks - {s["rank"] for s in stale}):
            self._stale_ranks.discard(rank)
            if self.journal is not None:
                self.journal.emit(EventKind.HEARTBEAT_RECOVERED, rank=rank)
        slow = self._classify_slow(beats)
        return {"alive": alive, "stale": stale, "missing": missing,
                "slow": slow}

    def _classify_slow(self, beats: Dict[int, Dict[str, Any]]) -> List[int]:
        """Update beat-cadence tracking from freshly-read beats and return
        the ranks currently classified slow.  Only a *new* beat advances
        the tracker (``check`` is usually polled faster than ranks beat),
        and stale ranks are the gap detector's problem, not this one's."""
        if self.slow_factor is None:
            return sorted(self._slow_ranks)
        for rank, rec in sorted(beats.items()):
            ts = float(rec.get("ts", 0.0))
            expected = rec.get("interval_s")
            prev = self._beat_track.get(rank)
            if prev is None or expected is None:
                self._beat_track[rank] = (ts, 0)
                continue
            prev_ts, drift = prev
            if ts <= prev_ts or rank in self._stale_ranks:
                continue  # no new beat yet / already reported dead
            observed = ts - prev_ts
            expected = float(expected)
            if expected > 0 and observed > self.slow_factor * expected:
                drift += 1
                if drift >= self.slow_min_intervals and \
                        rank not in self._slow_ranks:
                    self._slow_ranks.add(rank)
                    logger.warning(
                        f"[supervision] heartbeat slow: rank {rank} beating "
                        f"every {observed:.2f}s vs advertised {expected:.2f}s "
                        f"({observed / expected:.1f}x, "
                        f"slow_factor={self.slow_factor})")
                    if self.journal is not None:
                        self.journal.emit(
                            EventKind.HEARTBEAT_SLOW, rank=rank,
                            observed_s=observed, expected_s=expected,
                            factor=observed / expected,
                            last_step=rec.get("step"))
            else:
                drift = 0
                if rank in self._slow_ranks:
                    self._slow_ranks.discard(rank)
                    if self.journal is not None:
                        self.journal.emit(EventKind.HEARTBEAT_RECOVERED,
                                          rank=rank, slow=True)
            self._beat_track[rank] = (ts, drift)
        return sorted(self._slow_ranks)
