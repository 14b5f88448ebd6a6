"""Telemetry of the port: span tracing, the metrics stream and trace
export (the JAX package's ``telemetry/``; its fleet critical-path module and
most of its trace propagation wait for a fleet, ROADMAP.md Queue 1 #5).

- :mod:`.spans` — nestable thread-aware :class:`Tracer` spans over the
  train step phases, checkpoints and the elastic runner; names
  single-sourced in :class:`SpanName`;
- :mod:`.metrics` — :class:`MetricsRegistry` counters/gauges/histograms
  plus a :class:`MetricsSampler` streaming ``metrics.sample`` rows to a
  torn-line-tolerant ``metrics.jsonl`` sidecar; online MFU via
  :func:`analytic_mfu`;
- :mod:`.export` — Chrome/Perfetto ``trace_event`` JSON export of the
  collected spans and its schema check;
- :mod:`.propagate` — :func:`mint_context`, the trace root the serving
  gateway stamps on each request;
- :mod:`.config` — the validated ``"telemetry"`` config section.
"""

from .config import DeepSpeedTelemetryConfig  # noqa: F401
from .export import trace_events, validate_trace, write_trace  # noqa: F401
from .metrics import (METRIC_NAMES, Counter, Gauge, Histogram,  # noqa: F401
                      MetricName, MetricsRegistry, MetricsSampler,
                      analytic_mfu, host_rss_bytes, live_buffer_bytes,
                      lock_watch_metrics, peak_flops_per_chip,
                      read_metrics)
from .propagate import TraceContext, mint_context  # noqa: F401
from .spans import SPAN_NAMES, SpanName, SpanRecord, Tracer  # noqa: F401
