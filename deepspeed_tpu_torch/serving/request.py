"""Request lifecycle for the serving gateway (a copy of the JAX package's
``serving/request.py``, which is framework-free).

A submitted request is QUEUED until the scheduler packs it into a decode
slot (DECODING), then terminal: DONE, CANCELLED, TIMEOUT, REJECTED, or
FAILED.  The caller holds a :class:`RequestHandle` — a small future that
``result()``s the generated tokens or raises the matching, typed error
(partial output rides the exception, never returns silently).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from ..utils.lock_watch import LockName, TrackedLock


class RequestState:
    QUEUED = "queued"
    DECODING = "decoding"
    DONE = "done"
    CANCELLED = "cancelled"
    TIMEOUT = "timeout"
    REJECTED = "rejected"
    FAILED = "failed"


#: states a request never leaves
TERMINAL_STATES = frozenset({
    RequestState.DONE, RequestState.CANCELLED, RequestState.TIMEOUT,
    RequestState.REJECTED, RequestState.FAILED,
})


class QueueFullError(RuntimeError):
    """submit() hit the bounded admission queue (or a closed gateway)."""


class RequestShed(QueueFullError):
    """The admission controller shed this submission before it entered
    the queue (priority-class queue share exhausted, or the TTFT SLO
    estimate said the class's budget cannot be met).  Subclasses
    :class:`QueueFullError` so back-off handlers treat both alike;
    ``reason``/``cls`` carry the journaled shed decision."""

    def __init__(self, msg: str, reason: str = "", cls: str = ""):
        super().__init__(msg)
        self.reason = reason
        self.cls = cls


class RequestCancelled(RuntimeError):
    """The request was cancelled; ``partial`` holds tokens decoded so far."""

    def __init__(self, msg: str, partial: Optional[np.ndarray] = None):
        super().__init__(msg)
        self.partial = partial if partial is not None \
            else np.zeros((0,), np.int32)


class RequestTimedOut(RuntimeError):
    """The request's deadline passed; ``partial`` holds tokens so far."""

    def __init__(self, msg: str, partial: Optional[np.ndarray] = None):
        super().__init__(msg)
        self.partial = partial if partial is not None \
            else np.zeros((0,), np.int32)


class RequestFailed(RuntimeError):
    """The gateway hit an error serving this request (see ``__cause__``)."""


class RequestHandle:
    """The caller's side of a request: poll or block for the outcome."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._lock = TrackedLock(LockName.SERVE_REQUEST)
        self._tokens: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.state = RequestState.QUEUED
        # timing: wall-clock metrics stamped by the scheduler
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.tokens_out = 0

    # ------------------------------------------------------------- caller
    def cancel(self) -> bool:
        """Request cancellation; returns False if already terminal.  The
        scheduler honors it at the next tick boundary (mid-decode
        cancellation frees the slot for the queue)."""
        with self._lock:
            if self.state in TERMINAL_STATES:
                return False
            self._cancel.set()
            return True

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the generated tokens [n] int32.  Raises
        :class:`RequestCancelled` / :class:`RequestTimedOut` (both carry
        ``partial``) or :class:`RequestFailed` on the matching outcome."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s "
                f"(state={self.state})")
        if self._error is not None:
            raise self._error
        return self._tokens

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit → first generated token, seconds (None until then)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    # ---------------------------------------------------------- scheduler
    def _finish(self, state: str, tokens: Optional[np.ndarray] = None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            self.state = state
            self._tokens = tokens
            self._error = error
            self.t_done = time.monotonic()
            self._done.set()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()


@dataclasses.dataclass
class ServeRequest:
    """Scheduler-internal request record (the handle is the public half)."""

    rid: str
    seq: int                     # FIFO tiebreak within a priority class
    tokens: np.ndarray           # full prompt [S] int32 (prefix included)
    prefix_len: int              # leading tokens eligible for fork dedup
    max_new_tokens: int
    priority: int                # higher admits first
    deadline: Optional[float]    # absolute time.monotonic() bound
    key: int                     # sampling seed; the request's
                                 # torch.Generator is seeded from it at
                                 # admission (submit stays device-free)
    greedy: bool
    temperature: float
    eos_token_id: Optional[int]
    handle: RequestHandle
    out: list = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def sort_key(self):
        return (-self.priority, self.seq)
