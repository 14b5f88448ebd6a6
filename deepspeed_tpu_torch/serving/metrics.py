"""Serving metrics: thread-safe counters + a snapshot the journal, the
smoke run and operators share (the port of the JAX package's
``serving/metrics.py``, without the counters of its paging, speculative,
overload and compile-watch subsystems, which are not ported).

Kept deliberately dumb — monotonically increasing counters plus a TTFT
:class:`~deepspeed_tpu_torch.telemetry.metrics.Histogram` (the same
object the telemetry ``metrics.jsonl`` stream samples, so the two cannot
disagree).  Percentile math on the raw reservoir stays in the consumer,
not the hot path; the snapshot's ``ttft_s`` list is that reservoir.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..telemetry.metrics import Histogram, MetricName
from ..utils.lock_watch import LockName, TrackedLock

#: TTFT samples kept (oldest dropped) — enough for p99 at bench scale
_TTFT_CAP = 4096


class ServingMetrics:
    def __init__(self):
        self._lock = TrackedLock(LockName.SERVE_METRICS)
        self.t_start = time.monotonic()
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.cancelled = 0
        self.timeouts = 0
        self.failed = 0
        self.evictions = 0
        self.prefix_hits = 0
        self.prefix_builds = 0
        self.ticks = 0
        self.tokens_out = 0
        self.active_slot_ticks = 0   # sum over ticks of active slots
        self.slot_ticks = 0          # sum over ticks of total slots
        #: time-to-first-token, seconds — the shared telemetry histogram
        #: (count/sum exact, reservoir bounded at :data:`_TTFT_CAP`)
        self.ttft = Histogram(MetricName.SERVE_TTFT_S, cap=_TTFT_CAP)

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def record_tick(self, active: int, slots: int, tokens: int) -> None:
        with self._lock:
            self.ticks += 1
            self.tokens_out += tokens
            self.active_slot_ticks += active
            self.slot_ticks += slots

    def record_ttft(self, seconds: float) -> None:
        self.ttft.observe(float(seconds))

    def snapshot(self, queue_depth: Optional[int] = None) -> Dict:
        """One coherent view: counters, slot occupancy, tokens/sec over
        the gateway's lifetime, and the raw TTFT reservoir."""
        with self._lock:
            elapsed = max(time.monotonic() - self.t_start, 1e-9)
            snap = {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "cancelled": self.cancelled,
                "timeouts": self.timeouts,
                "failed": self.failed,
                "evictions": self.evictions,
                "prefix_hits": self.prefix_hits,
                "prefix_builds": self.prefix_builds,
                "ticks": self.ticks,
                "tokens_out": self.tokens_out,
                "elapsed_s": elapsed,
                "tokens_per_s": self.tokens_out / elapsed,
                "slot_occupancy": (self.active_slot_ticks / self.slot_ticks
                                   if self.slot_ticks else 0.0),
            }
        snap["ttft_s"] = self.ttft.values()
        if queue_depth is not None:
            snap["queue_depth"] = queue_depth
        return snap
