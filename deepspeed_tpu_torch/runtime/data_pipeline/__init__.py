"""Deterministic data pipeline: the port of the JAX package's
``runtime/data_pipeline/`` (its curriculum scheduler is not ported,
ROADMAP.md Queue 1 #3).

- ``resumable``: :class:`ResumableDataLoader` — endless batching iterator
  with O(1) checkpointable position, absolute quarantine windows, and a
  bounded bad-record policy
- ``config``: the validated ``"data"`` config section
"""

from .config import DATA, DeepSpeedDataConfig  # noqa: F401
from .resumable import (BadRecordBudgetError,  # noqa: F401
                        ResumableDataLoader, STATE_VERSION)
