"""The ``"data"`` config section, typed: the port of the JAX package's
``runtime/data_pipeline/config.py``.

.. code-block:: json

    {"data": {
        "resumable": true,
        "shuffle": true,
        "seed": 1234,
        "drop_last": true,
        "max_epochs": null,
        "max_bad_records": 0,
        "checkpoint_iterator": true,
        "journal_batches": false
    }}

With ``resumable`` on, ``engine.deepspeed_io`` (and the ``training_data``
argument to ``initialize``) builds a :class:`ResumableDataLoader` — an
endless, checkpointable iterator whose position rides in every engine
checkpoint — instead of the plain per-epoch ``DeepSpeedDataLoader``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config_utils import DeepSpeedConfigModel

DATA = "data"


@dataclasses.dataclass
class DeepSpeedDataConfig(DeepSpeedConfigModel):
    """Deterministic resumable data pipeline knobs."""

    #: build ResumableDataLoader (endless, checkpointable, quarantine-aware)
    #: from deepspeed_io/training_data instead of the per-epoch loader
    resumable: bool = False
    #: per-epoch reshuffle, permutation derived from (seed, epoch)
    shuffle: bool = False
    #: base shuffle seed (persisted in the iterator state)
    seed: int = 0
    drop_last: bool = True
    #: stop after this many epochs (null = cycle forever)
    max_epochs: Optional[int] = None
    #: decode/collate failures tolerated (journal + skip) before aborting;
    #: 0 aborts on the first bad record
    max_bad_records: int = 0
    #: persist the loader position in every engine checkpoint client_state
    checkpoint_iterator: bool = True
    #: journal a data.batch fingerprint per yielded batch (one journal
    #: line per step)
    journal_batches: bool = False

    def __post_init__(self):
        if self.max_bad_records < 0:
            raise ValueError(
                f"data max_bad_records must be >= 0, got "
                f"{self.max_bad_records}")
        if self.max_epochs is not None and int(self.max_epochs) <= 0:
            raise ValueError(
                f"data max_epochs must be > 0 (or null for endless), got "
                f"{self.max_epochs}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"data seed must be an integer, got "
                             f"{self.seed!r}")
