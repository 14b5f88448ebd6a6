"""Trace context: the ``(trace_id, parent_span_id)`` pair a request
carries (the JAX package's ``telemetry/propagate.py``, of which the port
has only :func:`mint_context`).

The serving gateway stamps a fresh root context on every request's
``serve.request`` journal row (``trace=ctx.fields()``), so a journal of
the port joins the same trace tree as one of the JAX package.  The
cross-process half (spool documents, the ``DS_TRACE_CONTEXT`` env var,
clock alignment) comes with the serving fleet (ROADMAP.md Queue 1 #5).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

__all__ = ["TraceContext", "mint_context"]

_ID_HEX_LEN = 16


def _new_id() -> str:
    return os.urandom(_ID_HEX_LEN // 2).hex()


@dataclass(frozen=True)
class TraceContext:
    """Immutable ``(trace_id, parent_span_id)`` pair; ids are 16 hex chars."""

    trace_id: str
    parent_span_id: str

    def fields(self) -> Dict[str, str]:
        """The two propagated fields as a plain dict (for journal emits)."""
        return {"trace_id": self.trace_id, "parent_span_id": self.parent_span_id}


def mint_context() -> TraceContext:
    """Mint a fresh root context (new trace id, new root span id)."""
    return TraceContext(trace_id=_new_id(), parent_span_id=_new_id())
