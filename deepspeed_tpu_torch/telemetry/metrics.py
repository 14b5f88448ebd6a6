"""The metrics stream: counters/gauges/histograms + a JSONL sampler — the
port of the JAX package's ``telemetry/metrics.py``, with its row schema
(``{"ts", "seq", "rank", "kind": "metrics.sample", "m": {...},
"step"}``) and metric names.

Instruments are deliberately dumb and thread-safe: counters only go up,
gauges hold the last value, histograms keep count/sum plus a bounded
reservoir so percentile math is exact for short runs and bounded for
endless ones.  Every instrument name is a :class:`MetricName` constant,
validated at creation time.

:class:`MetricsSampler` appends one ``metrics.sample`` JSON object per
line to a ``metrics.jsonl`` sidecar (the same torn-line-tolerant
append/read contract as the supervision ``events.jsonl``: a killed process
loses at most the line being written, and :func:`read_metrics` skips torn
trailing records instead of raising).

Online MFU rides on the analytic FLOPs model (``models/gpt.py::
flops_per_token``) and the card's peak from :func:`peak_flops_per_chip`:
:func:`analytic_mfu` is pure arithmetic.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from ..utils.jsonl import read_jsonl
from ..utils import lock_watch
from ..utils.lock_watch import LockName, TrackedLock
from ..utils.logging import logger

__all__ = [
    "MetricName", "METRIC_NAMES", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "MetricsSampler", "read_metrics", "analytic_mfu",
    "peak_flops_per_chip", "host_rss_bytes", "live_buffer_bytes",
    "lock_watch_metrics",
]


class MetricName:
    """Single source of truth for every metric name the port streams (the
    JAX package's strings; its paging, speculative, overload, transport,
    comm and compile metrics wait for those layers of the port)."""

    #: histogram of optimizer-step wall seconds (boundary to boundary)
    STEP_TIME_S = "train.step_time_s"
    #: tokens trained per second, over the sampler window
    TOKENS_PER_S = "train.tokens_per_s"
    #: online model-FLOPs utilization (0 when the card's peak is unknown)
    MFU = "train.mfu"
    #: achieved model TFLOP/s (tokens/s × analytic FLOPs/token)
    TFLOPS = "train.tflops"
    #: engine.global_steps at sample time
    STEPS = "train.steps"
    #: engine.skipped_steps (overflow-skipped) at sample time
    SKIPPED_STEPS = "train.skipped_steps"
    #: host process resident set size, bytes (0 without psutil)
    HOST_RSS_BYTES = "mem.host_rss_bytes"
    #: bytes the device's caching allocator holds in live tensors
    HBM_LIVE_BYTES = "mem.hbm_live_bytes"
    #: cumulative sanctioned host syncs the engine noted
    HOST_SYNCS = "compile.host_syncs"
    #: admission queue depth at sample time
    SERVE_QUEUE_DEPTH = "serve.queue_depth"
    #: lifetime mean slot occupancy (active slot-ticks / slot-ticks)
    SERVE_OCCUPANCY = "serve.occupancy"
    #: histogram of time-to-first-token seconds
    SERVE_TTFT_S = "serve.ttft_s"
    #: decode tokens emitted per second over the gateway lifetime
    SERVE_TOKENS_PER_S = "serve.tokens_per_s"
    #: histogram of per-round speculative acceptance rate (accepted /
    #: proposed over the round's live slots)
    SERVE_SPEC_ACCEPT_RATE = "serve.spec_accept_rate"
    #: histogram of tokens emitted per speculative tick (all live slots)
    SERVE_SPEC_TOKENS_PER_TICK = "serve.spec_tokens_per_tick"
    #: divergence rollbacks performed by the run supervisor
    ROLLBACKS = "elastic.rollbacks"
    #: tracked-lock contended acquisitions, process total
    CONCURRENCY_LOCK_CONTENTION = "concurrency.lock_contention"
    #: seconds spent waiting on contended tracked locks, process total
    CONCURRENCY_LOCK_WAIT_S = "concurrency.lock_wait_s"
    #: histogram block of tracked-lock hold seconds (count/mean/p50/p99)
    CONCURRENCY_LOCK_HOLD_S = "concurrency.lock_hold_s"
    #: per-lock table: acquisitions, contentions, wait_s, hold_p99_s
    CONCURRENCY_LOCKS = "concurrency.locks"


#: every registered metric name, as a frozenset of strings
METRIC_NAMES = frozenset(
    v for k, v in vars(MetricName).items()
    if not k.startswith("_") and isinstance(v, str))


def _require_registered(name: str) -> str:
    if name not in METRIC_NAMES:
        raise ValueError(
            f"metric name '{name}' is not registered in MetricName "
            "(telemetry/metrics.py) — register it first")
    return name


class Counter:
    """Monotonically increasing count."""

    def __init__(self, name: str):
        self.name = name
        self._lock = TrackedLock(LockName.TELEMETRY_METRIC)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value-wins scalar."""

    def __init__(self, name: str):
        self.name = name
        self._lock = TrackedLock(LockName.TELEMETRY_METRIC)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """count/sum plus a bounded sample reservoir (oldest dropped).

    The reservoir keeps percentile math exact for short runs while
    bounding memory for endless ones; ``count``/``sum`` stay exact
    regardless.
    """

    def __init__(self, name: str = "", cap: int = 4096):
        self.name = name
        self.cap = int(cap)
        self._lock = TrackedLock(LockName.TELEMETRY_METRIC)
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._samples.append(v)
            if len(self._samples) > self.cap:
                del self._samples[:len(self._samples) - self.cap]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def values(self) -> List[float]:
        """The raw reservoir (newest ``cap`` observations)."""
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile (``ceil(q/100 · n)``-th sample) over the
        reservoir; None when empty.

        Defined for every reservoir size: one sample answers every ``q``
        with itself, two samples split at the median (p50 → lower, p99 →
        upper) — no index errors and no banker's-rounding surprises on the
        tiny per-phase histograms critical-path stats are built from.
        """
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
        rank = math.ceil(min(100.0, max(0.0, float(q))) / 100.0 * len(s))
        return s[min(len(s) - 1, max(0, rank - 1))]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n, total = self._count, self._sum
        return {
            "count": n,
            "mean": (total / n) if n else None,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named instruments, created on first use, names validated against
    :data:`METRIC_NAMES`.  One registry per owner (engine, gateway)."""

    def __init__(self, name: str = "telemetry"):
        self.name = name
        self._lock = TrackedLock(LockName.TELEMETRY_REGISTRY)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        _require_registered(name)
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        _require_registered(name)
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        _require_registered(name)
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, cap=cap)
            return self._histograms[name]

    def snapshot(self) -> Dict[str, Any]:
        """One flat dict: counters/gauges by name, histograms as
        ``{count, mean, p50, p99}`` blocks."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        out: Dict[str, Any] = {}
        for name, c in counters.items():
            out[name] = c.value
        for name, g in gauges.items():
            out[name] = g.value
        for name, h in histograms.items():
            out[name] = h.snapshot()
        return out


def lock_watch_metrics() -> Dict[str, Any]:
    """Sampler source feeding tracked-lock telemetry into ``metrics.sample``
    rows: total contended acquisitions, total wait seconds, a hold-time
    histogram block, and the per-lock table.  Returns ``{}`` before any
    tracked lock has been acquired, so runs that never touch one emit no
    extra keys.

    Attach with ``sampler.attach_source(lock_watch_metrics)`` (the serving
    gateway does).
    """
    stats = lock_watch.lock_stats()
    if not stats:
        return {}
    holds: List[float] = []
    table: Dict[str, Any] = {}
    contentions = 0
    wait_s = 0.0
    for name, s in stats.items():
        holds.extend(s["holds"])
        contentions += s["contentions"]
        wait_s += s["wait_s"]
        hs = sorted(s["holds"])
        table[name] = {
            "acquisitions": s["acquisitions"],
            "contentions": s["contentions"],
            "wait_s": round(s["wait_s"], 6),
            "hold_p99_s": round(
                hs[min(len(hs) - 1, math.ceil(0.99 * len(hs)) - 1)], 6)
            if hs else None,
        }
    holds.sort()
    n = len(holds)
    return {
        MetricName.CONCURRENCY_LOCK_CONTENTION: contentions,
        MetricName.CONCURRENCY_LOCK_WAIT_S: round(wait_s, 6),
        MetricName.CONCURRENCY_LOCK_HOLD_S: {
            "count": n,
            "mean": round(sum(holds) / n, 6) if n else None,
            "p50": round(holds[min(n - 1, math.ceil(0.50 * n) - 1)], 6)
            if n else None,
            "p99": round(holds[min(n - 1, math.ceil(0.99 * n) - 1)], 6)
            if n else None,
        },
        MetricName.CONCURRENCY_LOCKS: table,
    }


# ---------------------------------------------------------------- sampler
class MetricsSampler:
    """Appends ``metrics.sample`` rows to a JSONL sidecar.

    Sources are zero-arg callables returning ``{metric_name: value}``
    dicts merged into every sample (names validated against
    :data:`METRIC_NAMES`; a source raising is logged and skipped — a
    broken gauge must not take down the run it measures).  A bound
    method is held weakly, so the sampler never keeps its owner (an
    engine and its device buffers) alive: a source whose owner is gone
    is skipped.  A first row is
    written at :meth:`start` so the file exists (and is parseable) from
    the moment the run does.
    """

    def __init__(self, registry: MetricsRegistry, path: Optional[str],
                 rank: int = 0, interval_steps: int = 1):
        self.registry = registry
        self.path = str(path) if path else None
        self.rank = int(rank)
        self.interval_steps = max(1, int(interval_steps))
        self._lock = TrackedLock(LockName.TELEMETRY_SAMPLER)
        self._seq = 0
        self._sources: List[Callable[[], Optional[Callable]]] = []
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def attach_source(self, fn: Callable[[], Dict[str, Any]]) -> None:
        ref = weakref.WeakMethod(fn) if inspect.ismethod(fn) \
            else (lambda: fn)
        with self._lock:
            self._sources.append(ref)

    def start(self) -> None:
        """Write the run's first sample (existence marker)."""
        self.sample(step=None)

    def should_sample(self, step: int) -> bool:
        return self.enabled and step % self.interval_steps == 0

    def sample(self, step: Optional[int] = None,
               **extra: Any) -> Optional[Dict[str, Any]]:
        """Append one sample row; returns the record written (None when
        the sampler has no path)."""
        if not self.enabled:
            return None
        m = self.registry.snapshot()
        with self._lock:
            sources = [ref() for ref in self._sources]
        for fn in sources:
            if fn is None:
                continue
            try:
                fields = fn() or {}
            except Exception as e:
                logger.warning(f"[telemetry] metrics source failed: {e!r}")
                continue
            for name, value in fields.items():
                _require_registered(name)
                m[name] = value
        with self._lock:
            self._seq += 1
            rec: Dict[str, Any] = {
                "ts": time.time(), "seq": self._seq, "rank": self.rank,
                "kind": "metrics.sample", "m": m,
            }
            if step is not None:
                rec["step"] = int(step)
            rec.update(extra)
            try:
                line = json.dumps(rec, default=str)
                with open(self.path, "a") as f:
                    f.write(line + "\n")
                    f.flush()
            except (OSError, TypeError, ValueError) as e:
                # telemetry loss must never take down the run it measures
                logger.warning(f"[telemetry] metrics write failed: {e}")
        return rec


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Parse a ``metrics.jsonl``; torn/garbage lines are skipped, not
    fatal (the ``read_events`` contract)."""
    return read_jsonl(path)


# ------------------------------------------------------------- online MFU
#: peak dense bf16 FLOP/s by ``torch.cuda.get_device_name``: the H100 SXM's
#: 989 TFLOP/s.  The PCIe and NVL H100s have lower peaks and are not listed.
_PEAK_BY_NAME = {"NVIDIA H100 80GB HBM3": 989e12}


def peak_flops_per_chip(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a ``torch.cuda.get_device_name`` string;
    None when the card is not in the table (the CPU, other cards) — callers
    then report MFU 0."""
    return _PEAK_BY_NAME.get(device_name or "")


def analytic_mfu(tokens_per_s: float, flops_per_token: float,
                 peak_flops: Optional[float],
                 n_chips: int = 1) -> Dict[str, float]:
    """The MFU arithmetic, online: achieved model FLOP/s = tokens/s ×
    analytic FLOPs/token; MFU = achieved / (peak × chips).

    Returns ``{"tflops": ..., "mfu": ...}`` (mfu 0.0 when the peak is
    unknown)."""
    achieved = float(tokens_per_s) * float(flops_per_token)
    mfu = achieved / (float(peak_flops) * max(1, int(n_chips))) \
        if peak_flops else 0.0
    return {"tflops": achieved / 1e12, "mfu": mfu}


# ------------------------------------------------------- memory sampling
def host_rss_bytes() -> int:
    """Resident set size of this process (0 without psutil)."""
    try:
        import psutil

        return int(psutil.Process().memory_info().rss)
    except Exception:  # pragma: no cover — optional dependency probe
        return 0


def live_buffer_bytes(device=None) -> int:
    """Bytes of live tensors on ``device`` by the CUDA caching allocator's
    count (0 for the CPU or None)."""
    if device is None or torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))
