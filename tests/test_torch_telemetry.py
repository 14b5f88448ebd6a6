"""The port's telemetry (``telemetry/``) and the engine's spans and
metrics stream against the JAX package's.

- A trace of the port's preemptible run (``trace_events``) passes both
  packages' ``validate_trace``; ``write_trace`` journals ``trace.export``.
- A fused step records ``train.step`` with ``train.fwd``, ``train.bwd``,
  ``train.optimizer`` and ``train.host_sync`` nested in it; saves and
  loads add ``ckpt.save``, ``ckpt.commit`` and ``ckpt.load``; every name
  is one of the JAX package's.
- Spans off (the default): the tracer records nothing and the step reads
  the device once (the overflow flag); ``synced`` spans count their
  barriers as host syncs.
- ``metrics.jsonl`` rows carry ``train.tokens_per_s`` and ``train.mfu``
  under the JAX package's names and row schema, and its ``read_metrics``
  reads them; ``analytic_mfu`` equals the JAX package's on a fixture; the
  card table holds the H100 SXM and nothing else.
- ``wall_clock_breakdown`` prints the JAX package's ``time (ms) | ...``
  line.
- The ``Tracer`` itself (nesting depth, capacity, aggregates) behaves as
  the JAX package's on the same calls."""

import gc
import logging
import os
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.supervision.events import EVENT_KINDS as J_EVENTS
from deepspeed_tpu.telemetry import export as jexport
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu.telemetry import spans as jspans
from deepspeed_tpu_torch.elasticity import ElasticTrainRunner
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.data_pipeline import ResumableDataLoader
from deepspeed_tpu_torch.runtime.model import from_gpt
from deepspeed_tpu_torch.runtime.supervision.events import (EVENT_KINDS,
                                                            EventJournal)
from deepspeed_tpu_torch.telemetry import export, metrics, spans
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from tests.unit.common import TINY_GPT, RandomTokenDataset

STEP_SPANS = ["train.bwd", "train.fwd", "train.host_sync",
              "train.optimizer", "train.step"]


def _engine(**extra):
    spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, device="cpu", generator=torch.Generator().manual_seed(0),
        config={"train_micro_batch_size_per_gpu": 8, **extra})
    return engine


def _loader():
    return ResumableDataLoader(RandomTokenDataset(48, 16, seed=2), 8,
                               shuffle=True, seed=1)


def _run(engine, save, steps=4, save_interval=2, resume=False):
    return ElasticTrainRunner(engine, save, save_interval=save_interval).run(
        _loader(), max_steps=steps, resume=resume)


def test_names_are_the_jax_packages():
    assert spans.SPAN_NAMES <= jspans.SPAN_NAMES
    assert metrics.METRIC_NAMES <= jmetrics.METRIC_NAMES
    assert EVENT_KINDS <= J_EVENTS


def test_trace_validates_in_both_packages(tmp_path):
    engine = _engine(telemetry={"enabled": True})
    _run(engine, str(tmp_path / "ck"))
    _run(_engine_with(engine.tracer), str(tmp_path / "ck"), steps=2,
         resume=True)
    obj = export.trace_events(engine.tracer)
    assert export.validate_trace(obj) == []
    assert jexport.validate_trace(obj) == []
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
    assert names == set(STEP_SPANS) | {"train.data_fetch", "ckpt.save",
                                       "ckpt.commit", "ckpt.load",
                                       "elastic.resume"}
    journal = EventJournal(str(tmp_path / "events.jsonl"))
    path = str(tmp_path / "trace.json")
    written = export.write_trace(path, engine.tracer, journal=journal)
    assert os.path.exists(path) and written == obj
    ev = journal.read()
    assert [(e["kind"], e["spans"]) for e in ev] == \
        [("trace.export", len(engine.tracer.spans()))]
    bad = {"traceEvents": [{"name": "train.nope", "ph": "X", "ts": 1.5,
                            "dur": 0, "pid": 0, "tid": 0}]}
    assert export.validate_trace(bad) == jexport.validate_trace(bad)


def _engine_with(tracer):
    """A second engine whose spans land in ``tracer`` (one timeline)."""
    engine = _engine(telemetry={"enabled": True})
    engine.tracer = tracer
    return engine


def test_a_step_nests_its_phases(tmp_path):
    engine = _engine(telemetry={"enabled": True})
    batch = next(_loader())
    engine.train_batch_fused(batch)
    recs = engine.tracer.spans()
    assert sorted(r.name for r in recs) == STEP_SPANS
    step = next(r for r in recs if r.name == "train.step")
    assert step.depth == 0 and step.args == {"step": 1}
    for r in recs:
        if r is not step:
            assert r.depth == 1
            assert step.t0 <= r.t0 and r.t0 + r.dur <= step.t0 + step.dur
    host = next(r for r in recs if r.name == "train.host_sync")
    assert host.args == {"label": "step.overflow"}
    engine.forward(batch)
    engine.backward()
    engine.step()
    agg = engine.tracer.aggregates()
    assert {n: a["count"] for n, a in agg.items()} == {
        "train.bwd": 2, "train.fwd": 2, "train.host_sync": 2,
        "train.optimizer": 2, "train.step": 1}


def test_spans_off_by_default_and_synced_counts_barriers():
    engine = _engine()
    assert not engine.tracer.enabled and not engine.metrics_sampler.enabled
    for _ in range(3):
        engine.train_batch_fused(next(_loader()))
    assert engine.tracer.spans() == [] and engine.tracer.aggregates() == {}
    assert engine.host_syncs == {"step.overflow": 3}
    synced = _engine(telemetry={"enabled": True, "spans": {"synced": True}})
    synced.train_batch_fused(next(_loader()))
    assert synced.host_syncs == {"step.overflow": 1,
                                 "span.sync": 2 * len(STEP_SPANS)}


def test_metrics_rows_match_jax_schema(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    engine = _engine(telemetry={"enabled": True, "metrics": {
        "path": path, "peak_tflops": 1.0}})
    res = _run(engine, str(tmp_path / "ck"), steps=3, save_interval=100)
    rows = metrics.read_metrics(path)
    assert rows == jmetrics.read_metrics(path)
    assert [r.get("step") for r in rows] == [None, 1, 2, 3]
    for r in rows:
        assert r["kind"] == "metrics.sample"
        assert set(r) <= {"ts", "seq", "rank", "kind", "m", "step"}
        assert set(r["m"]) <= jmetrics.METRIC_NAMES
    last = rows[-1]["m"]
    assert last["train.steps"] == 3 == res["steps"]
    assert last["train.tokens_per_s"] > 0
    fpt = jmetrics.analytic_mfu(last["train.tokens_per_s"],
                                _flops_per_token(), 1e12)
    assert last["train.mfu"] == pytest.approx(fpt["mfu"], rel=1e-12)
    assert last["compile.host_syncs"] == 3
    assert last["train.step_time_s"]["count"] == 2


def _flops_per_token():
    from deepspeed_tpu.models import gpt as jgpt
    return jgpt.flops_per_token(TINY_GPT)


@pytest.mark.parametrize("args", [(1.5e5, 2.1e9, 989e12, 1),
                                  (3.2e4, 2.5e9, None, 1),
                                  (7.0e5, 1.1e9, 4.0e14, 4)])
def test_analytic_mfu_matches_jax(args):
    assert metrics.analytic_mfu(*args) == jmetrics.analytic_mfu(*args)


def test_card_table_holds_nvidia_cards_only():
    assert metrics.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("TPU v5 lite", "TPU v4", "NVIDIA A100-SXM4-80GB",
                 "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "", None):
        assert metrics.peak_flops_per_chip(name) is None
    assert metrics.live_buffer_bytes(torch.device("cpu")) == 0


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_wall_clock_breakdown_line():
    engine = _engine(wall_clock_breakdown=True, steps_per_print=2)
    assert engine.tracer.enabled
    lines = _Lines()
    port_logger.addHandler(lines)
    try:
        for _ in range(4):
            engine.train_batch_fused(next(_loader()))
    finally:
        port_logger.removeHandler(lines)
    said = [m.split("time (ms) | ", 1)[1] for m in lines.lines
            if "time (ms) | " in m]
    assert len(said) == 2
    assert [p.split(":")[0] for p in said[1].split(" | ")] == STEP_SPANS


def _drive(module):
    tr = module.Tracer(capacity=3, name="t")
    with tr.span("train.step", step=1):
        with tr.span("train.fwd"):
            pass
        with tr.span("train.bwd"):
            pass
    with tr.span("ckpt.save"):
        pass
    with pytest.raises(ValueError, match="not registered"):
        tr.span("train.nope")
    off = module.Tracer(enabled=False)
    with off.span("train.step"):
        pass
    return ([(r.name, r.depth, r.args) for r in tr.spans()], tr.dropped,
            {k: v["count"] for k, v in tr.aggregates().items()},
            tr.span_inventory(), off.spans())


def test_tracer_behaves_as_jax():
    assert _drive(spans) == _drive(jspans)


def test_registry_and_histogram_match_jax():
    outs = []
    for module in (metrics, jmetrics):
        reg = module.MetricsRegistry()
        reg.counter("elastic.rollbacks").inc(2)
        reg.gauge("train.mfu").set(0.25)
        h = reg.histogram("train.step_time_s", cap=4)
        for v in np.linspace(0.1, 0.9, 9):
            h.observe(v)
        outs.append((reg.snapshot(), h.values(), h.percentile(50)))
        with pytest.raises(ValueError, match="not registered"):
            reg.gauge("train.nope")
    assert outs[0] == outs[1]


@pytest.mark.parametrize("async_save", [False, True])
def test_engine_is_freed_without_the_cycle_collector(tmp_path, async_save):
    """An engine with spans, the metrics stream, a runner, its supervision
    and saves goes with its last reference: nothing of telemetry or the
    runner closes a reference cycle around it (on the card its buffers
    would wait for the cycle collector)."""
    engine = _engine(telemetry={"enabled": True, "spans": {"synced": True},
                                "metrics": {"path": str(tmp_path / "m")}},
                     checkpoint={"async_save": async_save})
    ElasticTrainRunner(engine, str(tmp_path / "ck"), save_interval=1,
                       supervision={"step_deadline_s": 30.0}).run(
        _loader(), max_steps=2, resume=False)
    engine.wait_for_checkpoint()
    ref = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert ref() is None, gc.get_referrers(ref())
    finally:
        gc.enable()
