"""The serving gateway: an async request scheduler over the slot batcher
(the port of the JAX package's ``serving/gateway.py``, without its paging
and overload branches, whose config keys still raise).

``submit()`` is thread-safe and non-blocking: requests land in a bounded
priority queue (FIFO within a priority class) and a daemon scheduler
thread runs the serve loop:

1. expire queued requests whose deadline already passed;
2. admit while slots are free: pop the best queued request, prefill its
   prompt (through the LRU prefix pool when it declares a shared prefix)
   into a freed slot;
3. one continuous-batching decode tick for every live slot; harvest
   per-slot tokens, finish rows that hit eos / budget / deadline /
   cancellation, and free their slots for step 2 of the next iteration.
   With ``serving.speculative`` on, a tick is a draft/verify round that
   emits 1..draft_k+1 tokens a slot; a window is cut at eos or at the
   budget, and admission keeps the round's overshoot inside the slot.

The scheduler thread issues every device call, under ``torch.no_grad``
(grad mode is thread-local).  Every decision lands in the supervision
``EventJournal`` (``serve.*`` kinds) and in :class:`ServingMetrics`; the
``serve.request`` / ``serve.admit`` / ``serve.decode_tick`` fault points
make the loop a chaos surface (slow clients, failed admissions, wedged
ticks) tests drive without monkeypatching.  If the loop dies (a CUDA
error, say), every pending handle fails with :class:`RequestFailed`
instead of leaving its caller waiting.

The JAX gateway's snapshot carries ``compile_counts`` from its
``CompileWatch`` (a jit-cache gate); the eager port compiles no program,
so its snapshot has none.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..runtime.supervision.events import EventJournal, EventKind
from ..telemetry.metrics import MetricName, lock_watch_metrics
from ..telemetry.propagate import mint_context
from ..telemetry.spans import SpanName, Tracer
from ..utils import fault_injection
from ..utils.lock_watch import LockName, TrackedRLock, install_journal
from ..utils.logging import logger
from .batcher import PrefixEntry, SlotBatcher
from .config import ServingConfig
from .metrics import ServingMetrics
from .request import (QueueFullError, RequestCancelled, RequestFailed,
                      RequestHandle, RequestState, RequestTimedOut,
                      ServeRequest)


class _PooledPrefix:
    """One pooled shared prefix: the batch-1 cache the batcher built
    (admissions copy it into their slot, never extend it)."""

    def __init__(self, entry: PrefixEntry):
        self.entry = entry
        self.nbytes = sum(b.numel() * b.element_size()
                          for b in entry.cache.buffers())
        self.last_used = time.monotonic()


class ServingGateway:
    """Continuous-batching front half over one :class:`InferenceEngine`."""

    def __init__(self, engine, config=None,
                 journal: Optional[EventJournal] = None,
                 autostart: bool = True, tracer: Optional[Tracer] = None,
                 draft=None):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        #: telemetry tracer (shared with the batcher): serve.admit /
        #: serve.prefill / serve.tick spans.  Callers pass one to record;
        #: the default is a disabled no-op.
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False, name="serving")
        #: ``draft`` is the speculative proposal model, resolved and
        #: checked by the batcher (ignored while speculation is off)
        self._batcher = SlotBatcher(engine, config, tracer=self.tracer,
                                    draft=draft)
        self._journal = journal
        self.metrics = ServingMetrics()
        if config.warm_start:
            # the kernels' build and the library handles' set-up land
            # now, not in the first request's TTFT
            self._batcher.prewarm()
        # RLock: submit() rejects (journal + depth read) while already
        # holding the condition for the queue-capacity check.  Tracked at
        # SERVE_GATEWAY (outermost in LOCK_ORDER): the scheduler holds it
        # while touching request handles, metrics and the journal — the
        # lock-order watchdog proves those nestings stay acyclic.
        self._cond = threading.Condition(TrackedRLock(LockName.SERVE_GATEWAY))
        if journal is not None:
            # route concurrency.lock_cycle / .contention to this run's
            # journal (process-global: last journal-carrying gateway wins)
            install_journal(journal)
        self._queue: list = []               # heap of (sort_key, request)
        self._active: Dict[int, ServeRequest] = {}   # row -> request
        self._free_rows = list(range(config.slots))
        self._prefixes: "OrderedDict[bytes, _PooledPrefix]" = OrderedDict()
        self._seq = 0
        self._ticks = 0
        self._closed = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-gateway")
        if autostart:
            self._thread.start()

    # ------------------------------------------------------------- public

    def start(self) -> None:
        """Start the scheduler thread (for gateways built with
        ``autostart=False`` — deterministic queue-pressure tests)."""
        if not self._thread.is_alive():
            self._thread.start()

    def submit(self, tokens, *, max_new_tokens: Optional[int] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               seed: Optional[int] = None, do_sample: bool = False,
               temperature: float = 1.0,
               eos_token_id: Optional[int] = None,
               prefix_len: int = 0) -> RequestHandle:
        """Enqueue one generation request; returns immediately with a
        :class:`RequestHandle`.

        ``tokens``: the prompt [S] (or [1, S]) int32.  ``prefix_len``
        marks the leading tokens as a shared prefix (system prompt):
        requests agreeing on it share one pooled prefill.  ``seed`` pins
        the request's sampling generator; unset, the gateway derives one
        from its seed sequence — two identical sampled requests do NOT
        return identical replies unless they pin the same seed.
        """
        cfg = self.config
        seq = self._seq_next()
        rid = f"req-{seq}"
        fault_injection.fire("serve.request", request_id=rid)
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 2 and tokens.shape[0] == 1:
            tokens = tokens[0]
        if tokens.ndim != 1 or tokens.shape[0] < 1:
            raise ValueError(
                f"submit wants a [S>=1] prompt, got shape {tokens.shape}")
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else cfg.default_max_new_tokens)
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        if not 0 <= prefix_len < tokens.shape[0]:
            raise ValueError(
                f"prefix_len {prefix_len} must be in [0, prompt_len"
                f"={tokens.shape[0]})")
        handle = RequestHandle(rid)
        # every request is a trace root
        ctx = mint_context()
        # a speculative round may write draft_k positions past the last
        # emission: the whole overshoot must fit the slot
        margin = self._batcher.spec_overshoot
        if tokens.shape[0] + n_new + margin > self._batcher.max_len:
            self._reject(rid, handle, "too_long")
            raise ValueError(
                f"prompt ({tokens.shape[0]}) + max_new_tokens ({n_new})"
                + (f" + speculative overshoot ({margin})" if margin else "")
                + f" exceeds the {self._batcher.max_len}-token slot; raise "
                "serving.max_len or shorten the request")
        deadline_s = deadline_s if deadline_s is not None \
            else cfg.default_deadline_s
        req = ServeRequest(
            rid=rid, seq=seq, tokens=tokens, prefix_len=int(prefix_len),
            max_new_tokens=n_new, priority=int(priority),
            deadline=(handle.t_submit + deadline_s
                      if deadline_s is not None else None),
            # the generator is seeded at ADMISSION (scheduler thread):
            # submit never touches the device
            key=int(seed) if seed is not None else seq,
            greedy=not do_sample, temperature=float(temperature),
            eos_token_id=(eos_token_id if eos_token_id is not None
                          else cfg.eos_token_id),
            handle=handle)
        self.metrics.count("submitted")
        with self._cond:
            if self._closed:
                self._reject(rid, handle, "gateway_closed")
                raise QueueFullError(f"gateway is shut down ({rid})")
            full = len(self._queue) >= cfg.queue_capacity
            if not full:
                heapq.heappush(self._queue, (req.sort_key(), req))
                self._emit(EventKind.SERVE_REQUEST, request_id=rid,
                           prompt_len=req.prompt_len, max_new_tokens=n_new,
                           priority=req.priority,
                           queue_depth=len(self._queue),
                           t_submit=time.time(), trace=ctx.fields())
                self._cond.notify_all()
        if full:
            self._reject(rid, handle, "queue_full")
            raise QueueFullError(
                f"admission queue full ({cfg.queue_capacity}); "
                f"rejected {rid}")
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Convenience mirror of ``handle.cancel()`` (honored at the next
        tick boundary)."""
        ok = handle.cancel()
        with self._cond:
            self._cond.notify_all()
        return ok

    def snapshot(self) -> dict:
        """Metrics snapshot + live scheduler state (queue depth, active
        slots, pooled prefixes)."""
        with self._cond:
            depth, active = len(self._queue), len(self._active)
            prefixes = len(self._prefixes)
        snap = self.metrics.snapshot(queue_depth=depth)
        snap.update(active_slots=active, slots=self.config.slots,
                    cached_prefixes=prefixes)
        return snap

    def attach_metrics(self, sampler) -> None:
        """Stream this gateway's gauges through a telemetry
        :class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsSampler`:
        every sample row then carries queue depth, slot occupancy, TTFT
        percentiles and decode tokens/s.  Tracked-lock contention/hold
        stats ride along (the gateway is the most lock-dense owner)."""
        sampler.attach_source(self._metrics_source)
        sampler.attach_source(lock_watch_metrics)

    def _metrics_source(self) -> dict:
        snap = self.snapshot()
        return {
            MetricName.SERVE_QUEUE_DEPTH: snap["queue_depth"],
            MetricName.SERVE_OCCUPANCY: snap["slot_occupancy"],
            MetricName.SERVE_TOKENS_PER_S: snap["tokens_per_s"],
            MetricName.SERVE_TTFT_S: self.metrics.ttft.snapshot(),
        }

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work; optionally serve out the backlog first,
        then stop the scheduler thread.  Requests still pending after a
        non-drain shutdown fail with :class:`RequestFailed`."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            self._closed = True
            if not drain:
                self._fail_pending(RequestFailed("gateway shut down"))
            self._cond.notify_all()
        if self._thread.is_alive():
            while True:
                with self._cond:
                    idle = not self._queue and not self._active
                if idle or not drain:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            self._stopped.set()
            with self._cond:
                self._cond.notify_all()
            # bounded join: honor what is left of the caller's deadline
            # (a wedged tick must not hang shutdown forever either way)
            join_s = 30.0 if deadline is None \
                else max(0.1, deadline - time.monotonic())
            self._thread.join(timeout=join_s)
            if self._thread.is_alive():
                logger.warning("[serving] scheduler thread did not stop "
                               f"within {join_s:.1f}s")

    def __enter__(self) -> "ServingGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # ------------------------------------------------------------ internal

    def _seq_next(self) -> int:
        with self._cond:
            self._seq += 1
            return self._seq

    def _emit(self, kind: str, **fields) -> None:
        if self._journal is not None:
            self._journal.emit(kind, **fields)

    def _reject(self, rid: str, handle: RequestHandle, reason: str) -> None:
        self.metrics.count("rejected")
        with self._cond:
            depth = len(self._queue)
        self._emit(EventKind.SERVE_REJECT, request_id=rid, reason=reason,
                   queue_depth=depth)
        handle._finish(RequestState.REJECTED,
                       error=QueueFullError(f"{rid} rejected: {reason}"))

    def _fail_pending(self, error: Exception) -> None:
        """cond must be held."""
        while self._queue:
            _, req = heapq.heappop(self._queue)
            self.metrics.count("failed")
            req.handle._finish(RequestState.FAILED, error=error)
        for row, req in list(self._active.items()):
            self.metrics.count("failed")
            req.handle._finish(RequestState.FAILED, error=error)
            self._release_row(row)

    def _release_row(self, row: int) -> None:
        self._active.pop(row, None)
        self._free_rows.append(row)
        self._batcher.release(row)

    def _generator(self, req: ServeRequest) -> Optional[torch.Generator]:
        """The sampled request's generator on the engine's device, seeded
        from the gateway's seed and the request's key (greedy: None)."""
        if req.greedy:
            return None
        seed = np.random.SeedSequence(
            [int(self.config.seed) & 0xFFFFFFFF,
             req.key & 0xFFFFFFFFFFFFFFFF]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self._batcher.device).manual_seed(
            int(seed))

    # ---------------------------------------------------------- scheduler

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                while not self._stopped.is_set():
                    self._expire_queued()
                    self._admit_ready()
                    self._sweep_prefixes()
                    if self._active:
                        self._decode_tick()
                    else:
                        with self._cond:
                            if self._stopped.is_set():
                                break
                            if not self._queue:
                                self._cond.wait(self.config.idle_wait_s)
        except BaseException as e:  # the loop dying must fail loudly,
            # not leave every caller blocked on a handle forever
            logger.exception(f"[serving] scheduler loop died: {e}")
            with self._cond:
                self._closed = True
                self._fail_pending(RequestFailed(f"scheduler loop died: {e}"))
            raise

    def _expire_queued(self) -> None:
        now = time.monotonic()
        with self._cond:
            keep = []
            expired = []
            while self._queue:
                item = heapq.heappop(self._queue)
                req = item[1]
                if req.handle.cancel_requested:
                    expired.append((req, "cancel"))
                elif req.deadline is not None and now > req.deadline:
                    expired.append((req, "deadline"))
                else:
                    keep.append(item)
            for item in keep:
                heapq.heappush(self._queue, item)
        for req, why in expired:
            if why == "cancel":
                self.metrics.count("cancelled")
                self._emit(EventKind.SERVE_CANCEL, request_id=req.rid,
                           slot=None, tokens_out=0)
                req.handle._finish(
                    RequestState.CANCELLED,
                    error=RequestCancelled(f"{req.rid} cancelled in queue"))
            else:
                self.metrics.count("timeouts")
                self._emit(EventKind.SERVE_TIMEOUT, request_id=req.rid,
                           slot=None,
                           deadline_s=req.deadline - req.handle.t_submit,
                           tokens_out=0, queued=True)
                req.handle._finish(
                    RequestState.TIMEOUT,
                    error=RequestTimedOut(
                        f"{req.rid} deadline passed while queued"))

    def _admit_ready(self) -> None:
        while True:
            with self._cond:
                if not self._queue or not self._free_rows:
                    return
                _, req = heapq.heappop(self._queue)
                row = self._free_rows.pop(0)
            try:
                self._admit_one(row, req)
            except BaseException as e:
                with self._cond:
                    self._active.pop(row, None)
                    self._free_rows.append(row)
                self.metrics.count("failed")
                self._emit(EventKind.SERVE_REJECT, request_id=req.rid,
                           reason=f"admission_error: {e}", queue_depth=0)
                err = RequestFailed(f"{req.rid} admission failed: {e}")
                err.__cause__ = e
                req.handle._finish(RequestState.FAILED, error=err)
                if not isinstance(e, Exception):
                    raise

    def _admit_one(self, row: int, req: ServeRequest) -> None:
        with self.tracer.span(SpanName.SERVE_ADMIT, slot=row,
                              prompt_len=req.prompt_len):
            self._admit_one_inner(row, req)

    def _admit_one_inner(self, row: int, req: ServeRequest) -> None:
        prefix_hit = False
        prefix = None
        if req.prefix_len > 0 and self.config.max_cached_prefixes > 0:
            key = np.asarray(req.tokens[:req.prefix_len]).tobytes()
            with self._cond:
                pooled = self._prefixes.get(key)
            if pooled is not None:
                prefix_hit = True
                self.metrics.count("prefix_hits")
                pooled.last_used = time.monotonic()
                with self._cond:
                    self._prefixes.move_to_end(key)
            else:
                pooled = _PooledPrefix(
                    self._batcher.build_prefix(req.tokens[:req.prefix_len]))
                self.metrics.count("prefix_builds")
                with self._cond:
                    while len(self._prefixes) >= \
                            self.config.max_cached_prefixes:
                        self._evict_prefix(reason="lru")
                    self._prefixes[key] = pooled
            prefix = pooled.entry
        # fires between the prefix restore and the slot prefill, so chaos
        # covers the widest admission window
        fault_injection.fire("serve.admit", request_id=req.rid, slot=row)
        self._batcher.admit(row, req.tokens, self._generator(req),
                            req.greedy, req.temperature, prefix=prefix)
        req.handle.t_admit = time.monotonic()
        req.handle.state = RequestState.DECODING
        queued_ms = round((req.handle.t_admit
                           - req.handle.t_submit) * 1e3, 3)
        with self._cond:
            self._active[row] = req
        self._emit(EventKind.SERVE_ADMIT, request_id=req.rid, slot=row,
                   queued_ms=queued_ms, prefix_hit=prefix_hit)
        self.metrics.count("admitted")

    def _evict_prefix(self, reason: str) -> None:
        """cond must be held; pops the LRU entry and journals the device
        bytes it frees."""
        key, pooled = self._prefixes.popitem(last=False)
        self.metrics.count("evictions")
        self._emit(EventKind.SERVE_EVICT, prefix=key.hex()[:16],
                   session=None, reason=reason,
                   idle_s=round(time.monotonic() - pooled.last_used, 3),
                   bytes=pooled.nbytes)

    def _sweep_prefixes(self) -> None:
        """TTL sweep — runs every loop iteration (idle gateways included),
        so pooled device memory is released without waiting for the next
        admission."""
        ttl = self.config.prefix_ttl_s
        now = time.monotonic()
        with self._cond:
            stale = [k for k, p in self._prefixes.items()
                     if now - p.last_used > ttl]
            for k in stale:
                self._prefixes.move_to_end(k, last=False)
                self._evict_prefix(reason="ttl")

    def _decode_tick(self) -> None:
        fault_injection.fire("serve.decode_tick", tick=self._ticks,
                             active=len(self._active))
        # the tick's one device→host read.  Dispatch on the return type: a
        # speculative round is (window [B, k+1], counts [B]), slot b having
        # emitted window[b, :counts[b]]; a plain tick (speculation off or
        # paused) is the [B] tokens just emitted
        res = self._batcher.tick()
        tokens, counts = res if isinstance(res, tuple) else (res, None)
        self._ticks += 1
        now = time.monotonic()
        with self._cond:
            live = list(self._active.items())
        n_live = len(live)
        harvested = accepted = 0
        for row, req in live:
            h = req.handle
            if h.cancel_requested:
                self._finish_row(
                    row, req, RequestState.CANCELLED,
                    error=RequestCancelled(
                        f"{req.rid} cancelled mid-decode",
                        partial=np.asarray(req.out, np.int32)))
                continue
            if counts is None:
                toks = [int(tokens[row])]
            else:
                toks = [int(t) for t in tokens[row, :int(counts[row])]]
                accepted += max(int(counts[row]) - 1, 0)
            finished = False
            for tok in toks:
                # eos or the budget cut a speculative window short: the
                # tokens past the cut are dropped (their K/V sits past the
                # retired frontier)
                req.out.append(tok)
                harvested += 1
                h.tokens_out = len(req.out)
                if h.t_first_token is None:
                    h.t_first_token = now
                    self.metrics.record_ttft(h.ttft_s)
                if (req.eos_token_id is not None
                        and tok == req.eos_token_id) \
                        or len(req.out) >= req.max_new_tokens:
                    finished = True
                    break
            if finished:
                self._finish_row(row, req, RequestState.DONE)
            elif req.deadline is not None and now > req.deadline:
                self._finish_row(
                    row, req, RequestState.TIMEOUT,
                    error=RequestTimedOut(
                        f"{req.rid} deadline passed mid-decode",
                        partial=np.asarray(req.out, np.int32)))
        self.metrics.record_tick(active=n_live, slots=self.config.slots,
                                 tokens=harvested)
        round_k = self._batcher.round_draft_k
        spec_round = counts is not None and n_live
        if spec_round:
            proposed = n_live * max(1, round_k)
            self.metrics.record_spec_round(accepted=accepted,
                                           proposed=proposed,
                                           emitted=harvested)
        every = self.config.journal_every_ticks
        if every and self._ticks % every == 0:
            with self._cond:
                depth = len(self._queue)
            self._emit(EventKind.SERVE_TICK, tick=self._ticks,
                       active=n_live, queue_depth=depth,
                       tok_per_s=round(
                           self.metrics.snapshot()["tokens_per_s"], 3))
            if spec_round:
                self._emit(EventKind.SERVE_SPEC_ROUND, tick=self._ticks,
                           active=n_live, draft_k=round_k,
                           accepted=accepted, emitted=harvested,
                           accept_rate=round(accepted / max(1, proposed), 4))

    def _finish_row(self, row: int, req: ServeRequest, state: str,
                    error: Optional[Exception] = None) -> None:
        h = req.handle
        with self._cond:
            self._release_row(row)
            self._cond.notify_all()
        if state == RequestState.DONE:
            self.metrics.count("completed")
            dt = max(time.monotonic() - (h.t_admit or h.t_submit), 1e-9)
            self._emit(EventKind.SERVE_DONE, request_id=req.rid, slot=row,
                       tokens_out=len(req.out),
                       ttft_ms=round((h.ttft_s or 0.0) * 1e3, 3),
                       tok_per_s=round(len(req.out) / dt, 3))
            h._finish(state, tokens=np.asarray(req.out, np.int32))
        elif state == RequestState.CANCELLED:
            self.metrics.count("cancelled")
            self._emit(EventKind.SERVE_CANCEL, request_id=req.rid, slot=row,
                       tokens_out=len(req.out))
            h._finish(state, error=error)
        else:
            self.metrics.count("timeouts")
            self._emit(EventKind.SERVE_TIMEOUT, request_id=req.rid, slot=row,
                       deadline_s=(req.deadline - h.t_submit
                                   if req.deadline else None),
                       tokens_out=len(req.out), queued=False)
            h._finish(state, error=error)
