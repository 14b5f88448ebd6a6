"""The ``"telemetry"`` config section, typed: the port of the JAX
package's ``telemetry/config.py``.

.. code-block:: json

    {"telemetry": {
        "enabled": true,
        "spans": {"enabled": true, "capacity": 65536, "synced": false},
        "metrics": {"enabled": true, "path": null, "interval_steps": 1,
                    "peak_tflops": null},
        "trace": {"enabled": false, "dir": null}
    }}

``spans.synced`` is the calibration mode (``torch.cuda.synchronize`` at
both span edges — accurate, but a host sync per span); leave it false in
production.  ``metrics.path`` is the ``metrics.jsonl`` sidecar (``null``
disables the stream).  ``trace`` keeps the JAX package's keys for its
opt-in device profiler window, which the port does not have: the engine
refuses ``trace.enabled``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..runtime.config_utils import DeepSpeedConfigModel

TELEMETRY = "telemetry"


@dataclasses.dataclass
class SpansConfig(DeepSpeedConfigModel):
    """Span tracing knobs (see ``telemetry/spans.py``)."""

    enabled: bool = True
    #: raw span records kept for export (aggregates stay exact past it)
    capacity: int = 65536
    #: calibration mode: device barrier at span entry/exit — spans then
    #: measure execution instead of launch, at one host sync per edge
    synced: bool = False

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(
                f"telemetry spans.capacity must be >= 1, got "
                f"{self.capacity}")


@dataclasses.dataclass
class MetricsConfig(DeepSpeedConfigModel):
    """Metrics stream knobs (see ``telemetry/metrics.py``)."""

    enabled: bool = True
    #: the metrics.jsonl sidecar; None disables the stream
    path: Optional[str] = None
    #: sample every N optimizer steps
    interval_steps: int = 1
    #: the card's peak TFLOP/s for online MFU (None → the card table in
    #: ``telemetry/metrics.py``; unknown devices report MFU 0)
    peak_tflops: Optional[float] = None
    #: the memory census (device allocator + RSS read) refreshes at most
    #: once per this many seconds; intermediate samples carry the cached
    #: value
    memory_interval_s: float = 0.5

    def __post_init__(self):
        if self.interval_steps < 1:
            raise ValueError(
                f"telemetry metrics.interval_steps must be >= 1, got "
                f"{self.interval_steps}")
        if self.memory_interval_s < 0:
            raise ValueError(
                f"telemetry metrics.memory_interval_s must be >= 0, got "
                f"{self.memory_interval_s}")
        if self.peak_tflops is not None and self.peak_tflops <= 0:
            raise ValueError(
                f"telemetry metrics.peak_tflops must be > 0 (or null), "
                f"got {self.peak_tflops}")


@dataclasses.dataclass
class TraceConfig(DeepSpeedConfigModel):
    """The JAX package's opt-in device profiler window (not ported: the
    engine raises on ``enabled``; ``torch.profiler`` is the tool here)."""

    enabled: bool = False
    #: profiler output directory
    dir: Optional[str] = None


@dataclasses.dataclass
class DeepSpeedTelemetryConfig(DeepSpeedConfigModel):
    """Span tracing + metrics stream + trace capture, as one section."""

    enabled: bool = False
    spans: SpansConfig = dataclasses.field(default_factory=SpansConfig)
    metrics: MetricsConfig = dataclasses.field(
        default_factory=MetricsConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)

    @classmethod
    def from_dict(cls, data=None, **overrides):
        data = dict(data or {})
        data.update(overrides)
        for key, sub in (("spans", SpansConfig),
                         ("metrics", MetricsConfig),
                         ("trace", TraceConfig)):
            if isinstance(data.get(key), dict):
                data[key] = sub.from_dict(data[key])
        return super().from_dict(data)
