"""Deterministic, checkpointable data loading: the port of the JAX
package's ``runtime/data_pipeline/resumable.py``, with its state schema
(``STATE_VERSION``), so a loader's ``state_dict`` saved by either package
loads in the other and continues with the same batches.

A resumed or rolled-back run continues the *same* trajectory only if its
input does; :class:`ResumableDataLoader` gives three properties:

- **O(1) position state.**  The whole iterator position is
  ``{epoch, batch_index, shuffle_seed, samples_consumed}`` — the epoch
  permutation is a pure function of ``(shuffle_seed, epoch)`` (numpy's
  ``default_rng``), so ``state_dict()`` is a handful of ints and
  ``skip_to(step)`` is index arithmetic, never a scan over skipped batches.
- **Absolute quarantine windows.**  ``quarantine(from_step, to_step)``
  marks a half-open window of *global batch steps* (``step = epoch *
  batches_per_epoch + batch_index``) the loader must never yield again.
  The supervisor journals the window on rollback; the loader enforces it on
  replay, so a retry skips the poisoned batches and nothing else.
- **Bounded bad-record policy.**  A decode/collate failure journals a
  ``data.bad_record`` event and skips the batch; past ``max_bad_records``
  the loader raises :class:`BadRecordBudgetError`.

Engine wiring: ``DeepSpeedEngine.set_data_iterator`` registers a loader so
``save_checkpoint``/``load_checkpoint`` round-trip its state through
``client_state["data_iterator"]``: any resume (elastic restart,
verified-fallback chain, divergence rollback) lands on the exact next
batch.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ...utils import fault_injection
from ...utils.logging import logger
from ..dataloader import _default_collate
from ..supervision.events import EventKind

PyTree = Any

#: bump when the state schema changes incompatibly
STATE_VERSION = 1

#: the state keys that must agree between save and load for a replay to be
#: deterministic — a changed value silently yields a different sequence
_GEOMETRY_KEYS = ("dataset_size", "batch_size", "shuffle", "drop_last")


class BadRecordBudgetError(RuntimeError):
    """More decode/collate failures than ``max_bad_records`` allows."""


class ResumableDataLoader:
    """Endless batching iterator with O(1) checkpointable position.

    Args:
      dataset: indexable dataset (``__len__`` + ``__getitem__``).
      batch_size: samples per yielded batch.
      collate_fn: stacks a list of samples into one batch (defaults to the
        numpy stacker shared with :class:`DeepSpeedDataLoader`).
      shuffle: reshuffle each epoch with a permutation derived from
        ``(seed, epoch)`` — deterministic across restarts by construction.
      seed: base shuffle seed (persisted in ``state_dict``).
      drop_last: drop the trailing partial batch of each epoch.
      max_epochs: raise ``StopIteration`` after this many epochs
        (``None`` = cycle forever).
      max_bad_records: decode/collate failures tolerated (journal + skip)
        before :class:`BadRecordBudgetError`; 0 aborts on the first.
      journal: optional ``EventJournal`` for ``data.*`` events.
      journal_batches: emit a ``data.batch`` fingerprint event per yielded
        batch (off by default — one journal line per step).
    """

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 max_epochs: Optional[int] = None, max_bad_records: int = 0,
                 journal=None, journal_batches: bool = False):
        n = len(dataset)
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if max_bad_records < 0:
            raise ValueError(
                f"max_bad_records must be >= 0, got {max_bad_records}")
        if max_epochs is not None and max_epochs <= 0:
            raise ValueError(f"max_epochs must be > 0 or None, got {max_epochs}")
        self.batches_per_epoch = n // batch_size if drop_last \
            else (n + batch_size - 1) // batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"loader would yield zero batches: batch_size ({batch_size}) "
                f"exceeds dataset size ({n}) with drop_last=True — shrink "
                f"the batch or set drop_last=False")
        self.dataset = dataset
        self.dataset_size = n
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = bool(shuffle)
        self.shuffle_seed = int(seed)
        self.drop_last = bool(drop_last)
        self.max_epochs = max_epochs
        self.max_bad_records = int(max_bad_records)
        self.journal = journal
        self.journal_batches = bool(journal_batches)
        # ------------------------------------------------- position state
        self.epoch = 0
        self.batch_index = 0
        self.samples_consumed = 0
        self.bad_records = 0
        #: sorted, merged half-open [from_step, to_step) windows
        self._quarantine: List[Tuple[int, int]] = []
        # one (epoch, permutation) cache — iteration touches one epoch at
        # a time, and recomputing on rewind is cheap and allocation-bounded
        self._order_cache: Optional[Tuple[int, np.ndarray]] = None
        self._skipping_window: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------ position
    @property
    def step(self) -> int:
        """Absolute batch step: ``epoch * batches_per_epoch + batch_index``."""
        return self.epoch * self.batches_per_epoch + self.batch_index

    def __len__(self) -> int:
        return self.batches_per_epoch

    def set_epoch(self, epoch: int) -> None:
        """Sampler-parity hook: jump to the start of ``epoch``."""
        self.skip_to(int(epoch) * self.batches_per_epoch)

    def skip_to(self, step: int) -> None:
        """Reposition to absolute batch ``step`` in O(1) index arithmetic —
        no batch is materialized, no epoch is scanned."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        self.epoch, self.batch_index = divmod(int(step), self.batches_per_epoch)
        # every batch before batch_index is full (only the epoch's LAST
        # batch can be short), so this count is exact for both drop_last
        # settings
        samples_per_epoch = self.batches_per_epoch * self.batch_size \
            if self.drop_last else self.dataset_size
        self.samples_consumed = (self.epoch * samples_per_epoch
                                 + self.batch_index * self.batch_size)

    def _advance(self, nsamples: Optional[int] = None) -> None:
        self.samples_consumed += self.batch_size if nsamples is None \
            else int(nsamples)
        self.batch_index += 1
        if self.batch_index >= self.batches_per_epoch:
            self.epoch += 1
            self.batch_index = 0

    # --------------------------------------------------------- determinism
    def _order_for(self, epoch: int) -> np.ndarray:
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.shuffle_seed + epoch)
            rng.shuffle(order)
        self._order_cache = (epoch, order)
        return order

    def batch_indices(self, step: int) -> np.ndarray:
        """Dataset indices the batch at absolute ``step`` draws — pure
        index arithmetic, nothing materialized."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        epoch, b = divmod(int(step), self.batches_per_epoch)
        order = self._order_for(epoch)
        return order[b * self.batch_size:(b + 1) * self.batch_size]

    def batch_fingerprint(self, step: int) -> str:
        """Stable short hash of the batch's dataset indices (what
        ``data.batch`` journals)."""
        idx = np.ascontiguousarray(self.batch_indices(step), dtype=np.int64)
        return hashlib.sha256(idx.tobytes()).hexdigest()[:16]

    # ----------------------------------------------------------- quarantine
    def _window_containing(self, step: int) -> Optional[Tuple[int, int]]:
        for a, b in self._quarantine:
            if a <= step < b:
                return (a, b)
            if a > step:
                break
        return None

    def quarantine(self, from_step: int, to_step: int) -> None:
        """Mark ``[from_step, to_step)`` (absolute batch steps) as poisoned:
        the loader will never yield those batches again, on this run or any
        replay of its checkpoints."""
        if not (0 <= from_step < to_step):
            raise ValueError(
                f"quarantine window must satisfy 0 <= from_step < to_step, "
                f"got [{from_step}, {to_step})")
        merged: List[Tuple[int, int]] = []
        new = (int(from_step), int(to_step))
        for win in sorted(self._quarantine + [new]):
            if merged and win[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], win[1]))
            else:
                merged.append(win)
        self._quarantine = merged

    @property
    def quarantine_windows(self) -> List[Tuple[int, int]]:
        return list(self._quarantine)

    # ------------------------------------------------------------ journal
    def _emit(self, kind: str, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.emit(kind, **fields)

    # ----------------------------------------------------------- state i/o
    def state_dict(self) -> Dict[str, Any]:
        """O(1) position + policy state (JSON-safe scalars and int lists)."""
        return {
            "version": STATE_VERSION,
            "epoch": self.epoch,
            "batch_index": self.batch_index,
            "shuffle_seed": self.shuffle_seed,
            "samples_consumed": self.samples_consumed,
            "dataset_size": self.dataset_size,
            "batch_size": self.batch_size,
            "shuffle": self.shuffle,
            "drop_last": self.drop_last,
            "bad_records": self.bad_records,
            "quarantine": [[a, b] for a, b in self._quarantine],
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore position + quarantine windows; a geometry mismatch
        (different dataset size / batch size / shuffle / drop_last) raises
        — the saved position does not name the same batches any more."""
        version = int(sd.get("version", 0))
        if version > STATE_VERSION:
            raise ValueError(
                f"data iterator state version {version} is newer than this "
                f"loader understands ({STATE_VERSION})")
        mine = self.state_dict()
        mismatched = [f"{k}: checkpoint={sd[k]!r} loader={mine[k]!r}"
                      for k in _GEOMETRY_KEYS
                      if k in sd and sd[k] != mine[k]]
        if mismatched:
            raise ValueError(
                "data iterator state does not match this loader's geometry "
                "— a deterministic replay is impossible: "
                + "; ".join(mismatched))
        self.epoch = int(sd["epoch"])
        self.batch_index = int(sd["batch_index"])
        self.shuffle_seed = int(sd.get("shuffle_seed", self.shuffle_seed))
        self.samples_consumed = int(sd.get("samples_consumed", 0))
        self.bad_records = int(sd.get("bad_records", 0))
        self._quarantine = []
        for a, b in sd.get("quarantine", []):
            self.quarantine(int(a), int(b))
        self._order_cache = None
        self._skipping_window = None
        self._emit(EventKind.DATA_ITERATOR_RESTORE, step=self.step,
                   epoch=self.epoch,
                   batch_index=self.batch_index,
                   samples_consumed=self.samples_consumed,
                   quarantine=[[a, b] for a, b in self._quarantine])

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> Iterator[PyTree]:
        return self

    def __next__(self) -> PyTree:
        while True:
            if self.max_epochs is not None and self.epoch >= self.max_epochs:
                raise StopIteration
            step = self.step
            win = self._window_containing(step)
            if win is not None:
                # journal each window once per crossing, not per batch
                if self._skipping_window != win:
                    self._skipping_window = win
                    self._emit(EventKind.DATA_QUARANTINE_SKIP, from_step=win[0],
                               to_step=win[1], at_step=step)
                    logger.info(
                        f"[data] skipping quarantined batch window "
                        f"[{win[0]}, {win[1]}) at step {step}")
                self._advance()
                continue
            self._skipping_window = None
            idx = self.batch_indices(step)
            try:
                fault_injection.fire("data.next", step=step, epoch=self.epoch)
                items = [self.dataset[int(i)] for i in idx]
                fault_injection.fire("data.collate", step=step,
                                     indices=idx.tolist())
                batch = self.collate_fn(items)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self._on_bad_record(step, e)
                self._advance(len(idx))
                continue
            self._advance(len(idx))
            if self.journal_batches:
                self._emit(EventKind.DATA_BATCH, step=step, epoch=self.epoch,
                           n=int(len(idx)), sha=self.batch_fingerprint(step))
            return batch

    # ---------------------------------------------------------- bad records
    def _on_bad_record(self, step: int, exc: Exception) -> None:
        self.bad_records += 1
        self._emit(EventKind.DATA_BAD_RECORD, step=step, epoch=self.epoch,
                   error=repr(exc), bad_records=self.bad_records,
                   max_bad_records=self.max_bad_records)
        if self.bad_records > self.max_bad_records:
            self._emit(EventKind.DATA_BAD_RECORD_ABORT, step=step,
                       bad_records=self.bad_records,
                       max_bad_records=self.max_bad_records)
            raise BadRecordBudgetError(
                f"{self.bad_records} bad record batch(es) exceeds the "
                f"max_bad_records budget ({self.max_bad_records}); last "
                f"failure at step {step}: {exc!r}") from exc
        logger.warning(
            f"[data] bad record batch at step {step} skipped "
            f"({self.bad_records}/{self.max_bad_records} budget): {exc!r}")
