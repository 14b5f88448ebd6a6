"""Span tracing: nestable, thread-aware wall-clock spans over the hot
paths — the port of the JAX package's ``telemetry/spans.py``.

One :class:`Tracer` per owner (the train engine); the instrumented code
wraps each phase in ``with tracer.span(SpanName.X):`` and the tracer
records ``(name, start, duration, thread, depth)`` rows.  The rows feed:

- the ``wall_clock_breakdown`` log line (``time (ms) | ...``, from the
  span aggregates);
- the per-step timeline exported as Chrome/Perfetto ``trace_event`` JSON
  (``telemetry/export.py``), where nesting falls out of ts/dur on a tid.

Design constraints, in order:

1. **Near-zero cost when disabled.**  ``span()`` on a disabled tracer is
   one attribute read and returns a shared no-op context manager — no
   allocation, no clock read, no lock, no device call.
2. **Launch-time by default.**  CUDA calls return once the work is
   queued; a span measures host-side wall time unless the tracer was
   built with ``synced=True``, which calls ``torch.cuda.synchronize`` on
   the tracer's device at both edges (the calibration mode) and notes
   each barrier on the owner's ``sync_registry`` as a host sync.
3. **Single-source names.**  Every span name is a :class:`SpanName`
   constant, with the JAX package's strings (a trace of the port passes
   the JAX package's ``validate_trace``); :meth:`Tracer.span` validates
   at runtime.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.lock_watch import LockName, TrackedLock

__all__ = ["SpanName", "SPAN_NAMES", "SpanRecord", "Tracer"]


class SpanName:
    """Single source of truth for every span name the port records (the
    JAX package's strings; its serving, pipeline, gradient-collapse and
    comm spans wait for those layers of the port)."""

    #: one optimizer step end-to-end (the fused whole-batch path)
    TRAIN_STEP = "train.step"
    #: pulling the next batch from the data iterator (elastic runner loop)
    TRAIN_DATA_FETCH = "train.data_fetch"
    #: a micro-batch's loss (the model's forward)
    TRAIN_FWD = "train.fwd"
    #: a micro-batch's backward and its add into the fp32 accumulator
    TRAIN_BWD = "train.bwd"
    #: gas-boundary optimizer apply (norm, clip, the optimizer kernel, the
    #: loss-scale update)
    TRAIN_OPTIMIZER = "train.optimizer"
    #: a sanctioned device→host read on the step path (label in args)
    TRAIN_HOST_SYNC = "train.host_sync"
    #: engine.save_checkpoint end-to-end (shard writes + manifest)
    CKPT_SAVE = "ckpt.save"
    #: the two-phase commit barrier + marker publish
    CKPT_COMMIT = "ckpt.commit"
    #: engine.load_checkpoint end-to-end (fallback walk + load)
    CKPT_LOAD = "ckpt.load"
    #: ElasticTrainRunner.resume (sweep + checkpoint load)
    ELASTIC_RESUME = "elastic.resume"
    #: divergence rollback: reload verified tag + quarantine install
    ELASTIC_ROLLBACK = "elastic.rollback"


#: every registered span name, as a frozenset of strings
SPAN_NAMES = frozenset(
    v for k, v in vars(SpanName).items()
    if not k.startswith("_") and isinstance(v, str))


@dataclass(frozen=True)
class SpanRecord:
    """One finished span."""

    name: str
    t0: float        # tracer clock (monotonic seconds) at entry
    dur: float       # seconds
    tid: int         # thread ident
    thread: str      # thread name (Perfetto track label)
    depth: int       # nesting depth within this thread (0 = top level)
    args: Optional[Dict[str, Any]] = None


class _NoopSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def _device_barrier(device: Optional[torch.device]) -> None:
    """Block until the work queued on ``device`` finishes (calibration
    mode); nothing on the host."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    """A live span; created only when the tracer is enabled."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self._depth = tr._enter_thread()
        if tr.synced:
            tr._sync()
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        if tr.synced:
            tr._sync()
        dur = tr._clock() - self._t0
        tr._exit_thread()
        tr._record(self._name, self._t0, dur, self._depth, self._args)
        return False


class Tracer:
    """Collects spans; thread-safe, bounded, cheap to leave disabled.

    Args:
      enabled: record spans (a disabled tracer's :meth:`span` returns a
        shared no-op context).
      capacity: raw records kept for export; past it new records are
        DROPPED (counted in :attr:`dropped`) — the per-name aggregates keep
        counting, so breakdown logs and inventories stay exact while the
        exportable timeline stays bounded.
      synced: block on a device barrier at span entry and exit
        (calibration mode: spans then measure execution, not launch).
        Each barrier is noted on ``sync_registry`` as a ``span.sync`` host
        sync.
      sync_registry: the owner (duck-typed ``note_host_sync``; the engine)
        the synced mode reports its barriers to.
      device: the device the synced mode waits for (None or a CPU device:
        no barrier).
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536,
                 synced: bool = False, sync_registry: Any = None,
                 name: str = "run", device: Optional[torch.device] = None):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.synced = bool(synced)
        self._sync_registry = sync_registry
        self._clock = time.monotonic
        self._lock = TrackedLock(LockName.TELEMETRY_SPANS)
        self._records: List[SpanRecord] = []
        self._agg: Dict[str, Tuple[int, float]] = {}
        self._local = threading.local()
        self.dropped = 0

    # ------------------------------------------------------------- tracing
    def span(self, name: str, **args: Any):
        """Context manager timing one phase.  ``name`` must be a
        registered :class:`SpanName`; extra kwargs land in the exported
        trace event's ``args``."""
        if not self.enabled:
            return _NOOP
        if name not in SPAN_NAMES:
            raise ValueError(
                f"span name '{name}' is not registered in SpanName "
                "(telemetry/spans.py) — register it first")
        return _Span(self, name, args or None)

    def _enter_thread(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return depth

    def _exit_thread(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1

    def _sync(self) -> None:
        _device_barrier(self.device)
        if self._sync_registry is not None:
            self._sync_registry.note_host_sync("span.sync")

    def _record(self, name: str, t0: float, dur: float, depth: int,
                args: Optional[Dict[str, Any]]) -> None:
        th = threading.current_thread()
        with self._lock:
            count, total = self._agg.get(name, (0, 0.0))
            self._agg[name] = (count + 1, total + dur)
            if len(self._records) >= self.capacity:
                self.dropped += 1
                return
            self._records.append(SpanRecord(
                name=name, t0=t0, dur=dur, tid=th.ident or 0,
                thread=th.name, depth=depth, args=args))

    # ------------------------------------------------------------- queries
    def spans(self) -> List[SpanRecord]:
        """All recorded spans, in completion order."""
        with self._lock:
            return list(self._records)

    def aggregates(self) -> Dict[str, Dict[str, float]]:
        """Per-name ``{"count": n, "total_s": s}`` — exact even when the
        raw record list hit capacity."""
        with self._lock:
            return {name: {"count": c, "total_s": t}
                    for name, (c, t) in sorted(self._agg.items())}

    def span_inventory(self) -> List[str]:
        """Sorted distinct span names observed (the pinned inventory)."""
        with self._lock:
            return sorted(self._agg)
