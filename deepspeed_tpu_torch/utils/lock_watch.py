"""Tracked locks + the runtime lock-order watchdog.

The port of the JAX package's ``utils/lock_watch.py``.  The checkpoint
path is concurrent: the async writer pool's chain thread and the train
loop share the pending-write list, fault injection has its install table,
and the event journal its emit lock; the serving gateway's scheduler
thread and its submitters share the admission queue, the request handles
and the serving metrics.  A lock-order inversion between any
two threads is a deadlock that only fires under load, so ordering is
observable here instead of folklore:

- :class:`LockName` / :data:`LOCK_ORDER` are the registry of the port's
  long-lived locks, each a :class:`TrackedLock`/:class:`TrackedRLock`
  named here, outermost first.
- Each acquisition records an edge ``held → acquired`` in a
  process-global order graph (the lockdep idea).  An edge that closes a
  directed cycle means two call paths acquire the same two locks in
  opposite orders — a latent deadlock even if the threads never actually
  collided.  Cycles are journaled as ``concurrency.lock_cycle`` naming
  both locks and both acquisition stacks, and
  :func:`assert_no_lock_cycles` raises for tests.
- Hold time, wait time, and contention are aggregated per lock name
  (:func:`lock_stats`).

Import discipline: ``runtime/supervision/events.py`` builds *its* lock
from this module, so this module does not import it — the journal arrives
by reference (:func:`install_journal`) and cycle kinds are emitted as
literals equal to the registered constants.
"""

from __future__ import annotations

import threading
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "LockName", "LOCK_NAMES", "LOCK_ORDER", "TrackedLock", "TrackedRLock",
    "install_journal", "lock_cycles", "assert_no_lock_cycles",
    "lock_stats", "order_graph", "reset_lock_watch",
]


class LockName:
    """Single source of truth for every tracked lock name: register a new
    name here and give it its rank in :data:`LOCK_ORDER`."""

    #: the serving gateway's scheduler condition (submit/admission/shutdown)
    SERVE_GATEWAY = "serve.gateway"
    #: one RequestHandle's terminal-state latch
    SERVE_REQUEST = "serve.request"
    #: ServingMetrics counters/reservoirs
    SERVE_METRICS = "serve.metrics"
    #: MetricsSampler emit path (holds registry + journal below it)
    TELEMETRY_SAMPLER = "telemetry.sampler"
    #: MetricsRegistry name → instrument table
    TELEMETRY_REGISTRY = "telemetry.registry"
    #: one Counter/Gauge/Histogram instance (all instances share the rank)
    TELEMETRY_METRIC = "telemetry.metric"
    #: Tracer record/aggregate state
    TELEMETRY_SPANS = "telemetry.spans"
    #: StepWatchdog arm/disarm condition
    SUPERVISION_WATCHDOG = "supervision.watchdog"
    #: HeartbeatWriter step/beat counters
    SUPERVISION_HEARTBEAT = "supervision.heartbeat"
    #: AsyncCheckpointEngine pending-future chain
    CKPT_ASYNC_PENDING = "ckpt.async_pending"
    #: fault_injection install/clear table
    FAULTS_INSTALL = "faults.install"
    #: EventJournal emit (innermost: everything journals, nothing is
    #: acquired while journaling)
    JOURNAL_EMIT = "journal.emit"


#: every registered lock name, as a frozenset of strings
LOCK_NAMES = frozenset(
    v for k, v in vars(LockName).items()
    if not k.startswith("_") and isinstance(v, str))

#: THE global acquisition order, outermost first.  A thread holding a lock
#: may only acquire locks strictly later in this tuple (same-name
#: instances share a rank and are never acquired nested).
LOCK_ORDER: Tuple[str, ...] = (
    LockName.SERVE_GATEWAY,
    LockName.SERVE_REQUEST,
    LockName.SERVE_METRICS,
    LockName.TELEMETRY_SAMPLER,
    LockName.TELEMETRY_REGISTRY,
    LockName.TELEMETRY_METRIC,
    LockName.TELEMETRY_SPANS,
    LockName.SUPERVISION_WATCHDOG,
    LockName.SUPERVISION_HEARTBEAT,
    LockName.CKPT_ASYNC_PENDING,
    LockName.FAULTS_INSTALL,
    LockName.JOURNAL_EMIT,
)

#: name → rank in :data:`LOCK_ORDER`
LOCK_RANK: Dict[str, int] = {n: i for i, n in enumerate(LOCK_ORDER)}

#: contended waits at least this long are journaled (once per name) as
#: the debug kind ``concurrency.contention``
CONTENTION_JOURNAL_THRESHOLD_S = 0.05

#: per-instance hold-time reservoir size (enough for a p99 over an e2e run)
_HOLD_RESERVOIR = 512

#: max stack frames captured per order-graph edge
_STACK_DEPTH = 12


# ------------------------------------------------------- process-global state
# Per-thread stack of lock names currently held (outermost first).
_tls = threading.local()

# Guards the order graph and the cycle list.  A plain (untracked) lock on
# purpose: leaf-level, held for dict updates only, never while acquiring
# a tracked lock or journaling.  Per-lock stats deliberately do NOT take
# it — they live on the instance and are only written by the thread that
# holds that instance, so the tracked lock itself is their guard.
_state_lock = threading.Lock()

# src name → dst name → {"count", "thread", "stack"}: "a thread holding
# src acquired dst".  The stack is the dst acquisition's.
_edges: Dict[str, Dict[str, Dict[str, Any]]] = {}

# Recorded inversions: one dict per cycle-closing edge (see _note_edge).
_cycles: List[Dict[str, Any]] = []

# Edges already recorded, read without _state_lock on the hot path (a
# benign race: worst case one redundant locked re-check).
_seen_edges: set = set()

# every live tracked lock, for lock_stats() aggregation
_instances: "weakref.WeakSet[TrackedLock]" = weakref.WeakSet()

# names already journaled as contended (one concurrency.contention per
# name per process — a slow lock must not flood the journal)
_contention_journaled: set = set()

# the journal cycles/contention are emitted to (install_journal)
_journal: Optional[Any] = None


def install_journal(journal: Optional[Any]) -> None:
    """Route ``concurrency.*`` events to ``journal`` (an ``EventJournal``;
    ``None`` disconnects).  By reference, not import: events.py builds its
    own lock from this module."""
    global _journal
    _journal = journal


def _held() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _fmt_stack() -> str:
    frames = traceback.extract_stack()[:-3]  # drop lock_watch internals
    return "".join(traceback.format_list(frames[-_STACK_DEPTH:]))


def _reaches(src: str, dst: str) -> bool:
    """DFS: is ``dst`` reachable from ``src`` in the edge graph?
    Caller holds ``_state_lock``."""
    seen = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(_edges.get(node, ()))
    return False


def _note_edge(held_name: str, acquired_name: str) -> Optional[Dict[str, Any]]:
    """Record ``held → acquired``; returns a cycle record if this edge
    closes a directed cycle (i.e. ``held`` was already reachable from
    ``acquired`` — some other path acquires them in the opposite order)."""
    key = (held_name, acquired_name)
    if key in _seen_edges:
        return None
    stack = _fmt_stack()
    thread = threading.current_thread().name
    with _state_lock:
        dsts = _edges.setdefault(held_name, {})
        if acquired_name in dsts:
            dsts[acquired_name]["count"] += 1
            _seen_edges.add(key)
            return None
        cycle = None
        if _reaches(acquired_name, held_name):
            # find the reverse edge's recorded stack for the report
            back = _edges.get(acquired_name, {}).get(held_name)
            cycle = {
                "lock_a": held_name,
                "lock_b": acquired_name,
                "thread_a": thread,
                "thread_b": back["thread"] if back else "?",
                "stack_a": stack,
                "stack_b": back["stack"] if back else
                "(reverse path is transitive; inspect order_graph())",
            }
            _cycles.append(cycle)
        dsts[acquired_name] = {"count": 1, "thread": thread, "stack": stack}
        _seen_edges.add(key)
    return cycle


def _journal_cycle(cycle: Dict[str, Any]) -> None:
    j = _journal
    if j is None:
        return
    # literal kind string == EventKind.CONCURRENCY_LOCK_CYCLE; emitting by
    # literal keeps this module import-free of events.py (which locks
    # through us)
    j.emit("concurrency.lock_cycle",
           lock_a=cycle["lock_a"], lock_b=cycle["lock_b"],
           thread_a=cycle["thread_a"], thread_b=cycle["thread_b"],
           stacks=("--- thread %s acquired %s while holding %s:\n%s\n"
                   "--- thread %s acquired %s while holding %s:\n%s"
                   % (cycle["thread_a"], cycle["lock_b"], cycle["lock_a"],
                      cycle["stack_a"], cycle["thread_b"], cycle["lock_a"],
                      cycle["lock_b"], cycle["stack_b"])))


def _journal_contention(name: str, wait_s: float) -> None:
    j = _journal
    if j is None or name in _contention_journaled:
        return
    _contention_journaled.add(name)
    # literal kind string == EventKind.CONCURRENCY_CONTENTION
    j.emit("concurrency.contention", lock=name, wait_s=round(wait_s, 4),
           thread=threading.current_thread().name)


# ----------------------------------------------------------- tracked locks
class TrackedLock:
    """A named ``threading.Lock`` that feeds the order graph and the
    hold/contention stats.  Same interface as the stdlib lock (context
    manager, ``acquire(blocking, timeout)``/``release``, ``locked``)."""

    _inner_factory = staticmethod(threading.Lock)
    reentrant = False

    def __init__(self, name: str):
        if name not in LOCK_NAMES:
            raise ValueError(
                f"lock name '{name}' is not registered in LockName "
                "(utils/lock_watch.py) — register it (and its LOCK_ORDER "
                "rank) first")
        self.name = name
        self._inner = self._inner_factory()
        # stats: written only by the holding thread (the lock itself is
        # the guard); snapshot reads race benignly under the GIL
        self._t_acquired = 0.0
        self._acquisitions = 0
        self._contentions = 0
        self._wait_s = 0.0
        self._hold_s = 0.0
        self._holds: List[float] = []
        _instances.add(self)

    # ---------------------------------------------------------- primitives
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._reentered():
            return self._inner.acquire(blocking, timeout)
        contended = False
        wait_s = 0.0
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            contended = True
            t0 = time.monotonic()
            got = self._inner.acquire(True, timeout)
            wait_s = time.monotonic() - t0
            if not got:
                return False
        self._on_acquired(contended, wait_s, time.monotonic())
        return True

    def release(self) -> None:
        if self._releases_outermost():
            self._on_release()
        self._inner.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # ----------------------------------------------------------- recursion
    def _reentered(self) -> bool:
        return False     # plain Lock: every acquire is an outermost acquire

    def _releases_outermost(self) -> bool:
        return True

    # ---------------------------------------------------------- accounting
    def _on_acquired(self, contended: bool, wait_s: float,
                     now: float) -> None:
        self._t_acquired = now
        held = _held()
        cycle = None
        for h in held:
            if h != self.name:
                c = _note_edge(h, self.name)
                cycle = cycle or c
        held.append(self.name)
        self._acquisitions += 1
        if contended:
            self._contentions += 1
            self._wait_s += wait_s
        # journal AFTER the held-stack push and with _state_lock dropped:
        # emit() acquires the journal's own tracked lock, which re-enters
        # this bookkeeping
        if cycle is not None:
            _journal_cycle(cycle)
        if contended and wait_s >= CONTENTION_JOURNAL_THRESHOLD_S:
            _journal_contention(self.name, wait_s)

    def _on_release(self) -> None:
        hold_s = time.monotonic() - self._t_acquired
        held = _held()
        # remove the innermost entry for this name (release order may not
        # mirror acquire order, e.g. hand-over-hand locking)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._hold_s += hold_s
        holds = self._holds
        if len(holds) < _HOLD_RESERVOIR:
            holds.append(hold_s)
        else:
            # keep the maxima: the p99/max of hold time is the number that
            # matters and must survive the bound
            m = min(range(len(holds)), key=holds.__getitem__)
            if hold_s > holds[m]:
                holds[m] = hold_s


class TrackedRLock(TrackedLock):
    """Reentrant tracked lock.  Re-acquisition by the owning thread is
    counted on the inner RLock only — no new order-graph edge, no second
    held-stack entry.  Compatible with ``threading.Condition`` (the
    ``_is_owned``/``_release_save``/``_acquire_restore`` protocol)."""

    _inner_factory = staticmethod(threading.RLock)
    reentrant = True

    def __init__(self, name: str):
        super().__init__(name)
        self._owner: Optional[int] = None
        self._count = 0

    def _reentered(self) -> bool:
        return self._owner == threading.get_ident()

    def _releases_outermost(self) -> bool:
        return self._count == 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._reentered():
            self._count += 1
            return self._inner.acquire(blocking, timeout)
        got = super().acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count = 1
        return got

    def release(self) -> None:
        if not self._reentered():
            raise RuntimeError(
                f"cannot release un-acquired tracked lock '{self.name}'")
        if self._count == 1:
            self._owner = None
            self._count = 0
            self._on_release()
        else:
            self._count -= 1
        self._inner.release()

    def locked(self) -> bool:
        return self._owner is not None

    # ------------------------------------------- Condition(lock) protocol
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        # cond.wait(): the lock is dropped entirely regardless of depth
        saved = (self._inner._release_save(), self._count)
        self._owner = None
        self._count = 0
        self._on_release()
        return saved

    def _acquire_restore(self, saved) -> None:
        inner_state, count = saved
        # waiting in cond.wait() holds nothing; re-taking the lock after a
        # notify is a genuine (possibly contended) acquisition.  CPython's
        # Condition.wait blocks on its waiter lock BETWEEN _release_save
        # and _acquire_restore, so this times lock re-acquisition only,
        # not the time spent waiting for the notify.
        t0 = time.monotonic()
        self._inner._acquire_restore(inner_state)
        wait_s = time.monotonic() - t0
        self._on_acquired(wait_s >= 1e-4, wait_s, time.monotonic())
        self._owner = threading.get_ident()
        self._count = count


# ------------------------------------------------------------------ queries
def lock_cycles() -> List[Dict[str, Any]]:
    """Every lock-order inversion observed this process, oldest first."""
    with _state_lock:
        return [dict(c) for c in _cycles]


def assert_no_lock_cycles() -> None:
    """Raise if any acquisition-order cycle was observed."""
    cycles = lock_cycles()
    if cycles:
        lines = [f"{len(cycles)} lock-order cycle(s) observed:"]
        for c in cycles:
            lines.append(
                f"  {c['lock_a']} -> {c['lock_b']} (thread {c['thread_a']})"
                f" vs {c['lock_b']} ~> {c['lock_a']} (thread"
                f" {c['thread_b']})")
        raise AssertionError("\n".join(lines))


def order_graph() -> Dict[str, Dict[str, int]]:
    """``src → dst → count`` of observed nested acquisitions."""
    with _state_lock:
        return {src: {dst: e["count"] for dst, e in dsts.items()}
                for src, dsts in _edges.items()}


def lock_stats() -> Dict[str, Dict[str, Any]]:
    """Per-name aggregates: acquisitions, contentions, total wait/hold
    seconds, and a bounded hold-time sample list (for p99/max).  Reads the
    per-instance counters without their locks — a torn read costs at most
    one stale sample, never a crash."""
    out: Dict[str, Dict[str, Any]] = {}
    for lk in list(_instances):
        s = out.setdefault(lk.name, {"acquisitions": 0, "contentions": 0,
                                     "wait_s": 0.0, "hold_s": 0.0,
                                     "holds": []})
        s["acquisitions"] += lk._acquisitions
        s["contentions"] += lk._contentions
        s["wait_s"] += lk._wait_s
        s["hold_s"] += lk._hold_s
        s["holds"].extend(lk._holds)
    return dict(sorted(out.items()))


def reset_lock_watch() -> None:
    """Clear the order graph, cycles, and per-lock stats (tests)."""
    global _journal
    with _state_lock:
        _edges.clear()
        _cycles.clear()
        _seen_edges.clear()
        _contention_journaled.clear()
    for lk in list(_instances):
        lk._acquisitions = 0
        lk._contentions = 0
        lk._wait_s = 0.0
        lk._hold_s = 0.0
        lk._holds = []
    _journal = None
