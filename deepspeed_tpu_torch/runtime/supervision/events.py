"""The run's event journal: one JSON object per line, append-only.

The port of the JAX package's ``runtime/supervision/events.py`` (its
``EventKind``, ``EventJournal`` and ``read_events``), with the JAX
package's kind strings and fields: everything the run supervision decides
or observes lands here — rollbacks, watchdog expiries, preemption
signals, heartbeat gaps, data quarantines, checkpoint commits — so a
post-mortem can reconstruct why a run restarted, and a journal written
by either package reads the same.  JSONL because partial final lines from
a killed process must not poison the rest of the file:
:func:`read_events` skips torn trailing records instead of raising.

Schema (every record):

.. code-block:: json

    {"ts": 1723.4, "seq": 7, "rank": 0, "kind": "ckpt.committed", ...}

``kind`` namespaces the rest of the fields.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ...utils.jsonl import read_jsonl
from ...utils.lock_watch import LockName, TrackedRLock
from ...utils.logging import logger


class EventKind:
    """The journal event kinds the port emits, with the JAX package's
    strings: the run supervision's, the data loader's, the checkpoint
    protocol's, the serving gateway's, the telemetry's and the lock
    watchdog's."""

    ROLLBACK = "rollback"
    ROLLBACK_RECOVERED = "rollback.recovered"
    DIVERGENCE_ABORT = "divergence.abort"
    WATCHDOG_EXPIRED = "watchdog.expired"
    PREEMPT_SIGNAL = "preempt.signal"
    HEARTBEAT_GAP = "heartbeat.gap"
    HEARTBEAT_RECOVERED = "heartbeat.recovered"
    HEARTBEAT_SLOW = "heartbeat.slow"
    DATA_QUARANTINE = "data.quarantine"
    DATA_QUARANTINE_SKIP = "data.quarantine.skip"
    DATA_BAD_RECORD = "data.bad_record"
    DATA_BAD_RECORD_ABORT = "data.bad_record.abort"
    DATA_ITERATOR_RESTORE = "data.iterator_restore"
    DATA_BATCH = "data.batch"
    CKPT_COMMITTED = "ckpt.committed"
    CKPT_COMMIT_TIMEOUT = "ckpt.commit_timeout"
    CKPT_RESUME_CONSENSUS = "ckpt.resume_consensus"
    CKPT_CONSENSUS_FAILURE = "ckpt.consensus_failure"
    CKPT_TORN_TAG = "ckpt.torn_tag"
    CKPT_PREEMPT_SAVE = "ckpt.preempt_save"
    CKPT_PREEMPT_SAVE_TIMEOUT = "ckpt.preempt_save_timeout"
    SERVE_REQUEST = "serve.request"
    SERVE_ADMIT = "serve.admit"
    SERVE_REJECT = "serve.reject"
    SERVE_CANCEL = "serve.cancel"
    SERVE_TIMEOUT = "serve.timeout"
    SERVE_DONE = "serve.done"
    SERVE_EVICT = "serve.evict"
    SERVE_TICK = "serve.tick"
    TRACE_EXPORT = "trace.export"
    CONCURRENCY_LOCK_CYCLE = "concurrency.lock_cycle"
    CONCURRENCY_CONTENTION = "concurrency.contention"


#: every registered kind, as a set of strings
EVENT_KINDS = frozenset(
    v for k, v in vars(EventKind).items()
    if not k.startswith("_") and isinstance(v, str))


class EventJournal:
    """Append-only JSONL journal, safe to call from any thread (the async
    checkpoint writer's chain thread emits too).

    Each :meth:`emit` lands as ONE ``os.write`` on an ``O_APPEND`` fd — the
    kernel serializes whole records, so concurrent emitters (threads, or a
    second process appending to the same journal) can never interleave
    bytes mid-line, and a crashed process loses at most the record being
    written.  The file is readable while the run is live.
    """

    def __init__(self, path: str, rank: int = 0):
        self.path = str(path)
        self.rank = int(rank)
        # reentrant: emit() may be re-entered by a signal handler that
        # fires while the main thread is itself mid-emit — a plain Lock
        # deadlocks.  Tracked at JOURNAL_EMIT (innermost in LOCK_ORDER:
        # everything journals, nothing is acquired while journaling).
        self._lock = TrackedRLock(LockName.JOURNAL_EMIT)
        self._seq = 0
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Append one event; returns the record written."""
        with self._lock:
            self._seq += 1
            rec = {"ts": time.time(), "seq": self._seq, "rank": self.rank,
                   "kind": str(kind)}
            rec.update(fields)
            try:
                line = json.dumps(rec, default=str)
            except (TypeError, ValueError):
                # never let an odd payload take down the run being journaled
                rec = {"ts": rec["ts"], "seq": rec["seq"], "rank": rec["rank"],
                       "kind": rec["kind"], "repr": repr(fields)}
                line = json.dumps(rec, default=str)
            try:
                # one O_APPEND write per record: whole-record atomicity even
                # against emitters this lock doesn't cover (other processes)
                fd = os.open(self.path,
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                try:
                    os.write(fd, (line + "\n").encode("utf-8"))
                finally:
                    os.close(fd)
            except OSError as e:  # journal loss must not kill the run
                logger.warning(f"[supervision] event journal write failed: {e}")
            return rec

    def read(self) -> List[Dict[str, Any]]:
        return read_events(self.path)


def read_events(path: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse a journal; torn/garbage lines are skipped, not fatal.

    ``kind`` filters to one event kind.
    """
    return read_jsonl(path, kind=kind)
