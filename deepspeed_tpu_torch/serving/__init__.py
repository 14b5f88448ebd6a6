"""Continuous-batching serving (the port of the JAX package's
``serving/``):

- ``batcher``: ONE fixed-geometry slot batch (B slots, bucketed cache
  length); admission prefills through fixed-width chunks into slots freed
  by finished generations, every decode tick advances all live slots one
  ragged token;
- ``gateway``: the async request scheduler (stdlib ``threading``):
  bounded FIFO+priority admission queue, per-request budgets, deadlines,
  seeds and eos, cancellation, an LRU pool of shared prefixes;
- ``metrics`` + supervision ``EventJournal`` ``serve.*`` events: queue
  depth, TTFT, tokens/sec, slot occupancy.

Entry point: ``InferenceEngine.serve()`` or :class:`ServingGateway`
directly.  Paging, speculation, overload control, the transport and the
fleet are not ported yet (their config keys raise).
"""

from .batcher import PrefixEntry, SlotBatcher
from .config import ServingConfig
from .gateway import ServingGateway
from .metrics import ServingMetrics
from .request import (QueueFullError, RequestCancelled, RequestFailed,
                      RequestHandle, RequestShed, RequestState,
                      RequestTimedOut)

__all__ = [
    "ServingConfig", "ServingGateway", "ServingMetrics", "SlotBatcher",
    "PrefixEntry", "RequestHandle", "RequestState", "QueueFullError",
    "RequestShed", "RequestCancelled", "RequestFailed", "RequestTimedOut",
]
