"""The port's serving gateway (CPU, plain kernels) held to the JAX
gateway's own gates (``tests/unit/serving/test_serving_e2e.py`` and
``test_gateway_chaos.py``) on the tiny fp32 GPT of the session tests:
replies bitwise equal to the port's sequential sessions (with a cache in
the compute dtype and with an int8 cache), eos stops, shared prefixes,
request storms past capacity, cancellation, deadlines, admission faults,
slow clients, wedged ticks, LRU prefix eviction and priority — driven
through the ``serve.*`` fault points and read back from the journal — plus
the config keys the gateway reads and the ones that still raise."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import ServingMetrics as JaxServingMetrics
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu_torch.runtime.supervision.events import (EventJournal,
                                                            EventKind)
from deepspeed_tpu_torch.serving import (QueueFullError, RequestCancelled,
                                         RequestFailed, RequestTimedOut,
                                         ServingConfig, ServingGateway)
from deepspeed_tpu_torch.telemetry import (MetricsRegistry, MetricsSampler,
                                           read_metrics)
from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils.fault_injection import (DelaySeconds,
                                                       FailNTimes, Fault,
                                                       HangFor)
from deepspeed_tpu_torch.utils.lock_watch import assert_no_lock_cycles

from .test_torch_sessions import serving_engines

#: every ``result()`` waits at most this long
WAIT_S = 60


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    fault_injection.clear()


@pytest.fixture(scope="module")
def engines():
    """The port's CPU engines of the tiny model: KV cache in the compute
    dtype, and int8."""
    return {kv: serving_engines(kv)[1] for kv in (None, "int8")}


@pytest.fixture
def serve(engines, tmp_path):
    """``serve(kv=None, autostart=True, **config)`` → (gateway, journal);
    every gateway is shut down after the test."""
    made = []

    def make(kv=None, autostart=True, **cfg):
        base = {"slots": 2, "max_len": 64, "prefill_chunk": 8,
                "queue_capacity": 4, "idle_wait_s": 0.01}
        base.update(cfg)
        journal = EventJournal(str(tmp_path / f"events{len(made)}.jsonl"))
        gw = engines[kv].serve(config=base, journal=journal,
                               autostart=autostart)
        made.append(gw)
        return gw, journal

    yield make
    for gw in made:
        gw.shutdown(drain=False, timeout=WAIT_S)


def _prompt(rng, lo=3, hi=12):
    return rng.integers(0, 256, (int(rng.integers(lo, hi)),)).astype(
        np.int32)


def _kinds(journal):
    return [e["kind"] for e in journal.read()]


def _session_reply(engine, prompt, n, prefix_len=0, chunk=8):
    """The request alone through a session: ``append`` + ``generate``.

    With an int8 cache the prompt is appended in the gateway's prefill
    chunks (a prefix's from 0, the rest's from the prefix's end): a chunk
    after the first attends over the quantized cache, while one
    ``append`` of the whole prompt is a prefill over the fresh K/V (as
    in the JAX package), which is another function of the prompt."""
    s = engine.start_session(batch=1, max_len=64)
    if engine._kv_dtype is None:
        s.append(prompt[None])
    else:
        for start, end in ((0, prefix_len), (prefix_len, len(prompt))):
            for i in range(start, end, chunk):
                s.append(prompt[None, i:min(i + chunk, end)])
    return s.generate(max_new_tokens=n)[0].numpy()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_gateway_bitwise_vs_sequential_sessions(engines, serve, tmp_path,
                                                kv):
    """10 heterogeneous requests through 3 slots: every reply equals the
    sequential session run bit for bit; the journal tells the story; a
    metrics sampler streams the gateway's gauges meanwhile; no lock-order
    cycle and no torn journal line."""
    gw, journal = serve(kv, slots=3, queue_capacity=16,
                        journal_every_ticks=4)
    assert isinstance(gw, ServingGateway)
    sampler = MetricsSampler(MetricsRegistry("serving"),
                             str(tmp_path / "metrics.jsonl"))
    gw.attach_metrics(sampler)
    rng = np.random.default_rng(0)
    requests = []
    for _ in range(10):
        prompt = _prompt(rng, 3, 24)
        n_new = int(rng.integers(4, 14))
        requests.append((prompt, n_new,
                         gw.submit(prompt, max_new_tokens=n_new)))
        sampler.sample()
    outs = [h.result(timeout=WAIT_S) for _, _, h in requests]
    sampler.sample()
    snap = gw.snapshot()
    assert snap["completed"] == 10 and snap["slot_occupancy"] > 0.5
    assert snap["tokens_out"] == sum(n for _, n, _ in requests)
    assert "compile_counts" not in snap
    distinct = 0
    for (prompt, n_new, _), out in zip(requests, outs):
        assert out.shape == (n_new,) and out.dtype == np.int32
        np.testing.assert_array_equal(out, _session_reply(engines[kv],
                                                          prompt, n_new))
        distinct += len(set(out.tolist())) >= 3
    assert distinct >= 5
    gw.shutdown()
    kinds = _kinds(journal)
    assert kinds.count(EventKind.SERVE_REQUEST) == 10
    assert kinds.count(EventKind.SERVE_ADMIT) == 10
    assert kinds.count(EventKind.SERVE_DONE) == 10
    assert EventKind.SERVE_TICK in kinds
    assert all(len(e["trace"]["trace_id"]) == 16 for e in journal.read()
               if e["kind"] == EventKind.SERVE_REQUEST)
    rows = read_metrics(sampler.path)
    assert rows and all(set(r["m"]) <= jmetrics.METRIC_NAMES for r in rows)
    assert rows[-1]["m"]["serve.ttft_s"]["count"] == 10
    assert "concurrency.locks" in rows[-1]["m"]
    assert_no_lock_cycles()
    assert EventKind.CONCURRENCY_LOCK_CYCLE not in kinds
    with open(journal.path, encoding="utf-8") as f:
        raw_lines = [line for line in f.read().splitlines() if line]
    assert len(raw_lines) == len(kinds)
    for line in raw_lines:
        json.loads(line)


def test_snapshot_keys_are_the_jax_gateways(serve):
    """The port's snapshot is the JAX gateway's without the counters of
    the subsystems it has not ported and without ``compile_counts``."""
    gw, _ = serve()
    jax_keys = set(JaxServingMetrics().snapshot(queue_depth=0)) | {
        "active_slots", "slots", "cached_prefixes", "compile_counts"}
    assert set(gw.snapshot()) <= jax_keys - {"compile_counts"}


def test_eos_stop_frees_the_slot(engines, serve):
    """A request whose model emits its eos finishes early (output ends at
    eos) and its slot serves the backlog."""
    gw, _ = serve(slots=1)
    prompt = np.zeros((4,), np.int32)
    ref = _session_reply(engines[None], prompt, 30)
    eos = int(ref[3])      # the model's own 4th greedy token
    stop = int(np.flatnonzero(ref == eos)[0]) + 1
    out = gw.submit(prompt, max_new_tokens=30,
                    eos_token_id=eos).result(timeout=WAIT_S)
    assert out[-1] == eos and out.shape == (stop,) and stop < 30
    np.testing.assert_array_equal(out, ref[:stop])
    out2 = gw.submit(prompt, max_new_tokens=2).result(timeout=WAIT_S)
    np.testing.assert_array_equal(out2, ref[:2])


def test_config_eos_is_the_default(engines, serve):
    prompt = np.zeros((4,), np.int32)
    ref = _session_reply(engines[None], prompt, 30)
    eos = int(ref[2])
    gw, _ = serve(slots=1, eos_token_id=eos)
    out = gw.submit(prompt, max_new_tokens=30).result(timeout=WAIT_S)
    assert out[-1] == eos and out.shape[0] <= 3


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_shared_prefix_bitwise(engines, serve, kv):
    """Three conversations over one system prompt share one pooled
    prefill — and still match their flat sequential sessions bitwise."""
    gw, _ = serve(kv)
    rng = np.random.default_rng(5)
    system = rng.integers(0, 256, (11,)).astype(np.int32)
    turns = [_prompt(rng, 3, 8) for _ in range(3)]
    handles = [gw.submit(np.concatenate([system, t]), max_new_tokens=5,
                         prefix_len=len(system)) for t in turns]
    outs = [h.result(timeout=WAIT_S) for h in handles]
    snap = gw.snapshot()
    assert snap["prefix_builds"] == 1 and snap["prefix_hits"] == 2
    assert snap["cached_prefixes"] == 1
    for t, out in zip(turns, outs):
        np.testing.assert_array_equal(
            out, _session_reply(engines[kv], np.concatenate([system, t]), 5,
                                prefix_len=len(system)))


def test_sampled_requests_repeat_under_their_seed(serve):
    """Sampled replies are a function of (gateway seed, request seed):
    the same seed repeats across slots and gateways, another seed moves
    the reply, and greedy neighbours are untouched."""
    rng = np.random.default_rng(6)
    prompt, other = _prompt(rng, 6, 12), _prompt(rng, 6, 12)

    def run(seed, gw_seed=0):
        gw, _ = serve(slots=3, queue_capacity=8, seed=gw_seed, top_p=0.9)
        hs = [gw.submit(prompt, max_new_tokens=10, do_sample=True,
                        seed=seed),
              gw.submit(other, max_new_tokens=10),
              gw.submit(prompt, max_new_tokens=10, do_sample=True,
                        seed=seed)]
        return [h.result(timeout=WAIT_S) for h in hs]

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a[0], a[2])
    np.testing.assert_array_equal(a[0], b[0])
    assert (a[0] != c[0]).any()
    np.testing.assert_array_equal(a[1], c[1])
    assert (run(7, gw_seed=1)[0] != a[0]).any()


def test_request_storm_beyond_capacity(serve):
    """Storm a stopped gateway: the bounded queue rejects the overflow
    loudly; once started, everything queued completes."""
    gw, journal = serve(autostart=False, queue_capacity=4)
    rng = np.random.default_rng(0)
    handles, rejected = [], 0
    for _ in range(7):
        try:
            handles.append(gw.submit(_prompt(rng), max_new_tokens=4))
        except QueueFullError:
            rejected += 1
    assert rejected == 3 and len(handles) == 4
    gw.start()
    outs = [h.result(timeout=WAIT_S) for h in handles]
    assert all(o.shape == (4,) for o in outs)
    snap = gw.snapshot()
    assert snap["rejected"] == 3 and snap["completed"] == 4
    kinds = _kinds(journal)
    assert kinds.count(EventKind.SERVE_REJECT) == 3
    assert kinds.count(EventKind.SERVE_DONE) == 4
    gw.shutdown()
    with pytest.raises(QueueFullError, match="shut down"):
        gw.submit(_prompt(rng), max_new_tokens=4)


@pytest.mark.parametrize("where", ["mid_decode", "queued"])
def test_cancellation(serve, where):
    """Cancel mid-decode: the caller gets RequestCancelled with the
    partial tokens and the freed slot serves the next request.  Cancel
    while queued: the request never touches a slot."""
    rng = np.random.default_rng(1)
    if where == "queued":
        gw, journal = serve(autostart=False)
        h = gw.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
        assert h.cancel()
        gw.start()
        with pytest.raises(RequestCancelled):
            h.result(timeout=WAIT_S)
        ev = [e for e in journal.read()
              if e["kind"] == EventKind.SERVE_CANCEL][0]
        assert ev["slot"] is None and ev["tokens_out"] == 0
        assert gw.snapshot()["admitted"] == 0
        return
    gw, journal = serve(slots=1)
    with fault_injection.inject("serve.decode_tick",
                                DelaySeconds(0.02, n=None)):
        h = gw.submit(_prompt(rng), max_new_tokens=50)
        t0 = time.monotonic()
        while h.tokens_out < 3 and time.monotonic() - t0 < WAIT_S:
            time.sleep(0.005)
        assert gw.cancel(h)
    with pytest.raises(RequestCancelled) as ei:
        h.result(timeout=WAIT_S)
    assert 3 <= ei.value.partial.shape[0] < 50
    assert h.state == "cancelled" and not h.cancel()
    out = gw.submit(_prompt(rng), max_new_tokens=3).result(timeout=WAIT_S)
    assert out.shape == (3,)
    kinds = _kinds(journal)
    assert EventKind.SERVE_CANCEL in kinds and EventKind.SERVE_DONE in kinds


@pytest.mark.parametrize("where", ["mid_decode", "queued"])
def test_deadline_timeout(serve, where):
    """A slow decode tick (injected) blows a request's deadline: the
    caller gets RequestTimedOut with partial output, journaled with
    queued=False.  A deadline that passes before any slot frees expires
    the request from the queue, journaled with queued=True."""
    if where == "queued":
        gw, journal = serve(autostart=False)
        h = gw.submit(np.arange(4, dtype=np.int32), max_new_tokens=4,
                      deadline_s=0.05)
        time.sleep(0.1)
        gw.start()
        with pytest.raises(RequestTimedOut):
            h.result(timeout=WAIT_S)
    else:
        gw, journal = serve(slots=1)
        with fault_injection.inject("serve.decode_tick",
                                    DelaySeconds(0.15, n=None)):
            h = gw.submit(np.arange(5, dtype=np.int32), max_new_tokens=50,
                          deadline_s=0.4)
            with pytest.raises(RequestTimedOut) as ei:
                h.result(timeout=WAIT_S)
        assert 0 < ei.value.partial.shape[0] < 50
    evs = [e for e in journal.read()
           if e["kind"] == EventKind.SERVE_TIMEOUT]
    assert len(evs) == 1 and evs[0]["queued"] is (where == "queued")
    if where == "queued":
        assert evs[0]["tokens_out"] == 0
    assert gw.snapshot()["timeouts"] == 1


def test_admission_fault_fails_one_request_not_the_gateway(serve):
    """A raising fault at serve.admit fails exactly that request; the
    scheduler keeps serving the rest."""
    gw, journal = serve(slots=1)
    with fault_injection.inject("serve.admit", FailNTimes(1)):
        h1 = gw.submit(np.arange(4, dtype=np.int32), max_new_tokens=3)
        h2 = gw.submit(np.arange(6, dtype=np.int32), max_new_tokens=3)
        with pytest.raises(RequestFailed, match="admission failed"):
            h1.result(timeout=WAIT_S)
        assert h2.result(timeout=WAIT_S).shape == (3,)
    assert EventKind.SERVE_REJECT in _kinds(journal)
    assert gw.snapshot()["failed"] == 1


def test_slow_client_fault_point(serve):
    """serve.request faults fire inside submit() — a DelaySeconds there
    models a slow client and shows as raised submit latency."""
    gw, _ = serve()
    with fault_injection.inject("serve.request",
                                DelaySeconds(0.2, n=1)) as f:
        t0 = time.monotonic()
        h = gw.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
        assert time.monotonic() - t0 >= 0.2 and f.fired == 1
    assert h.result(timeout=WAIT_S).shape == (2,)


def test_wedged_tick_holds_queue_then_drains(serve):
    """HangFor at serve.decode_tick wedges the loop mid-storm; releasing
    it drains the backlog — detection and recovery, not a deadlock."""
    gw, _ = serve(slots=1, queue_capacity=8)
    rng = np.random.default_rng(3)
    with fault_injection.inject("serve.decode_tick", HangFor(30.0)) as hang:
        handles = [gw.submit(_prompt(rng), max_new_tokens=3)
                   for _ in range(4)]
        time.sleep(0.2)
        assert sum(h.done() for h in handles) == 0   # wedged
        hang.release()
        outs = [h.result(timeout=WAIT_S) for h in handles]
    assert all(o.shape == (3,) for o in outs)


def test_prefix_pool_eviction_lru(serve):
    """max_cached_prefixes=1: a second distinct prefix evicts the first
    (serve.evict journaled); re-using the first rebuilds it."""
    gw, journal = serve(max_cached_prefixes=1)
    rng = np.random.default_rng(4)
    pa = rng.integers(0, 256, (10,)).astype(np.int32)
    pb = rng.integers(0, 256, (10,)).astype(np.int32)
    turn = rng.integers(0, 256, (4,)).astype(np.int32)

    def ask(prefix):
        return gw.submit(np.concatenate([prefix, turn]), max_new_tokens=3,
                         prefix_len=10).result(timeout=WAIT_S)

    a1 = ask(pa)
    a2 = ask(pa)          # pool hit
    ask(pb)               # evicts pa
    a3 = ask(pa)          # rebuild
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(a1, a3)
    snap = gw.snapshot()
    assert snap["prefix_builds"] == 3 and snap["prefix_hits"] == 1
    assert snap["evictions"] >= 2
    ev = [e for e in journal.read() if e["kind"] == EventKind.SERVE_EVICT]
    assert ev and ev[0]["reason"] == "lru" and ev[0]["bytes"] > 0


def test_prefix_ttl_sweep(serve):
    """A pooled prefix idle past ``prefix_ttl_s`` is evicted by the
    scheduler's sweep, idle gateway included."""
    gw, journal = serve(prefix_ttl_s=0.05)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 256, (14,)).astype(np.int32)
    gw.submit(prompt, max_new_tokens=2, prefix_len=10).result(timeout=WAIT_S)
    t0 = time.monotonic()
    while gw.snapshot()["cached_prefixes"] and time.monotonic() - t0 < WAIT_S:
        time.sleep(0.01)
    ev = [e for e in journal.read() if e["kind"] == EventKind.SERVE_EVICT]
    assert [e["reason"] for e in ev] == ["ttl"]


def test_priority_over_fifo(serve):
    """Higher-priority requests admit first; FIFO breaks ties."""
    gw, _ = serve(autostart=False, slots=1, queue_capacity=8)
    rng = np.random.default_rng(5)
    low = [gw.submit(_prompt(rng), max_new_tokens=2) for _ in range(2)]
    high = gw.submit(_prompt(rng), max_new_tokens=2, priority=10)
    gw.start()
    for h in low + [high]:
        h.result(timeout=WAIT_S)
    assert high.t_admit < low[0].t_admit < low[1].t_admit


def test_concurrent_submitters_lose_no_request(serve):
    """Eight submitter threads against the scheduler thread, with the
    interpreter switching threads as often as it can: every request gets
    its own id, its reply and one serve.request and serve.done record."""
    gw, journal = serve(slots=3, queue_capacity=64)
    results = {}

    def client(k):
        rng = np.random.default_rng(100 + k)
        handles = [gw.submit(_prompt(rng), max_new_tokens=3)
                   for _ in range(4)]
        results[k] = [h.result(timeout=WAIT_S) for h in handles]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(8))
    assert all(o.shape == (3,) for outs in results.values() for o in outs)
    snap = gw.snapshot()
    assert snap["submitted"] == snap["admitted"] == snap["completed"] == 32
    events = journal.read()
    ids = [e["request_id"] for e in events
           if e["kind"] == EventKind.SERVE_REQUEST]
    assert len(set(ids)) == 32
    assert sorted(ids) == sorted(e["request_id"] for e in events
                                 if e["kind"] == EventKind.SERVE_DONE)
    assert_no_lock_cycles()


class _GradProbe(Fault):
    """Records the scheduler thread's grad mode at each tick."""

    def __init__(self):
        self.seen = []

    def fire(self, point, **ctx):
        self.seen.append(torch.is_grad_enabled())


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_scheduler_runs_without_grad_and_fails_pending_when_it_dies(serve):
    """The scheduler thread issues device calls under no_grad (grad mode
    is thread-local); if the loop dies, every pending handle fails with
    RequestFailed instead of waiting forever, and submit refuses."""
    gw, _ = serve(slots=1, queue_capacity=8)
    probe = _GradProbe()
    with fault_injection.inject("serve.decode_tick", probe):
        gw.submit(np.arange(5, dtype=np.int32),
                  max_new_tokens=3).result(timeout=WAIT_S)
    assert probe.seen and not any(probe.seen) and torch.is_grad_enabled()
    with fault_injection.inject("serve.decode_tick", FailNTimes(1)):
        handles = [gw.submit(np.arange(n, dtype=np.int32), max_new_tokens=4)
                   for n in (4, 5, 6)]
        for h in handles:
            with pytest.raises(RequestFailed, match="scheduler loop died"):
                h.result(timeout=WAIT_S)
    assert gw.snapshot()["failed"] == 3
    with pytest.raises(QueueFullError, match="shut down"):
        gw.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)


def test_submit_guards(serve):
    gw, journal = serve(default_max_new_tokens=5)
    with pytest.raises(ValueError, match="exceeds the 64-token slot"):
        gw.submit(np.zeros((60,), np.int32))
    with pytest.raises(ValueError, match="prefix_len"):
        gw.submit(np.zeros((6,), np.int32), prefix_len=6)
    with pytest.raises(ValueError, match="max_new_tokens"):
        gw.submit(np.zeros((6,), np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="prompt"):
        gw.submit(np.zeros((2, 3), np.int32))
    assert [e["reason"] for e in journal.read()
            if e["kind"] == EventKind.SERVE_REJECT] == ["too_long"]
    out = gw.submit(np.zeros((1, 6), np.int32)).result(timeout=WAIT_S)
    assert out.shape == (5,)


#: the ten keys the gateway reads, each at a value other than its default
GATEWAY_KEYS = {"queue_capacity": 5, "default_max_new_tokens": 7,
                "default_deadline_s": 3.5, "seed": 11,
                "max_cached_prefixes": 2, "prefix_ttl_s": 30.0,
                "journal_every_ticks": 3, "eos_token_id": 9,
                "idle_wait_s": 0.05, "warm_start": True}


def test_gateway_keys_round_trip_with_the_jax_defaults():
    jax_default, default = JaxServingConfig(), ServingConfig()
    for key in GATEWAY_KEYS:
        assert getattr(default, key) == getattr(jax_default, key), key
    cfg = ServingConfig.from_dict(dict(GATEWAY_KEYS, slots=3))
    assert {k: cfg.to_dict()[k] for k in GATEWAY_KEYS} == GATEWAY_KEYS
    assert ServingConfig.from_dict(cfg.to_dict()) == cfg


@pytest.mark.parametrize("key,value", [
    ("queue_capacity", 0), ("default_max_new_tokens", 0),
    ("default_deadline_s", 0.0), ("max_cached_prefixes", -1),
    ("journal_every_ticks", -1), ("idle_wait_s", 0.0)])
def test_gateway_keys_are_validated_as_in_jax(key, value):
    with pytest.raises(ValueError, match=f"serving.{key}"):
        JaxServingConfig.from_dict({key: value})
    with pytest.raises(ValueError, match=f"serving.{key}"):
        ServingConfig.from_dict({key: value})


@pytest.mark.parametrize("key", ["paging", "speculative", "overload",
                                 "transport"])
def test_unported_subsystems_raise(engines, key):
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingConfig.from_dict({key: {"enabled": True}})
    with pytest.raises(NotImplementedError, match="not ported"):
        engines[None].serve(config={key: {}}, autostart=False)


def test_serve_draft_raises(engines):
    with pytest.raises(NotImplementedError, match="Queue 1 #4.4"):
        engines[None].serve(draft=engines[None], autostart=False)


def test_warm_start_prewarms_and_leaves_no_slot_live(engines):
    gw = engines[None].serve(config={"slots": 2, "max_len": 64,
                                     "prefill_chunk": 8, "warm_start": True})
    try:
        assert gw._batcher._last is not None
        assert not gw._batcher.active.any()
        prompt = np.arange(9, dtype=np.int32)
        np.testing.assert_array_equal(
            gw.submit(prompt, max_new_tokens=4).result(timeout=WAIT_S),
            _session_reply(engines[None], prompt, 4))
    finally:
        gw.shutdown(timeout=WAIT_S)
