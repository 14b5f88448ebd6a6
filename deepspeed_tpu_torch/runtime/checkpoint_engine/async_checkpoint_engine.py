"""Async checkpoint engine: training continues while bytes hit disk.

The port of the JAX package's ``runtime/checkpoint_engine/
async_checkpoint_engine.py`` (the reference's Nebula role).  ``save``
copies the state into host memory it owns synchronously (the only part
that must fence the train step: the next step updates the port's buffers
in place), then a writer thread serializes to ``.npz``; publication
chains behind every pending write of the tag, so a crash mid-write never
leaves a half-checkpoint advertised.  A failed write is re-raised at the
next ``wait``/``commit``/``load``.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils.lock_watch import LockName, TrackedLock
from ...utils.logging import logger
from .checkpoint_engine import CheckpointEngine
from .native_checkpoint_engine import (NativeCheckpointEngine, _ckpt_config,
                                       snapshot_host)
from .storage import atomic_write_npz

PyTree = Any


class AsyncCheckpointEngine(CheckpointEngine):
    def __init__(self, config_params=None, max_workers: Optional[int] = None):
        super().__init__(config_params)
        self.ckpt_config = _ckpt_config(config_params)
        workers = max_workers or self.ckpt_config.writers
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="ckpt-writer")
        self._pending: List[Future] = []
        self._sync = NativeCheckpointEngine(self.ckpt_config)
        # guards _pending AND _last_error (the chain writes the latter from
        # a writer thread; wait() reads-and-clears it from the train loop)
        self._lock = TrackedLock(LockName.CKPT_ASYNC_PENDING)
        self._last_error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, state_dict: PyTree, path: str) -> None:
        """Snapshot to host now; write in the background.  The write is the
        retrying atomic writer, so a transient I/O error retries inside the
        writer thread instead of permanently poisoning the pool."""
        arrays = snapshot_host(state_dict)
        retry = self.ckpt_config.retry

        def write():
            atomic_write_npz(path, arrays, retry)

        with self._lock:
            self._pending.append(self._pool.submit(write))

    def finalize_async(self, tag: str, publish) -> None:
        """Run ``publish`` after every pending write lands — WITHOUT
        blocking the caller (training overlaps the serialization; the
        latest marker still can't advertise unfinished files).

        A failed write logs loudly, skips publication, and is re-raised at
        the next ``wait()``/``commit()``/``load()`` — a tag whose bytes
        never landed must not look saved.  ``publish`` may itself decline
        (returning falsy) when the multi-host commit barrier expired and
        the tag was abandoned — that is graceful degradation, not an error:
        training continues on the previous committed tag."""
        def chain(pending):
            try:
                for f in pending:
                    f.result()
                published = publish()
                if published is False:
                    logger.warning(
                        f"[async-ckpt] tag {tag} ABANDONED by the commit "
                        "protocol (barrier expiry or vote verification "
                        "failure) — the latest marker was not moved")
                else:
                    logger.info(f"[async-ckpt] tag {tag} committed")
            except BaseException as e:  # surfaced on the next wait()
                with self._lock:
                    self._last_error = e
                logger.error(f"[async-ckpt] writing tag {tag} FAILED — the "
                             f"latest marker was NOT published: {e!r}")

        # swap + submit under ONE lock hold: a concurrent wait() must never
        # observe the window where the writes are in flight but _pending is
        # empty.  The chain takes ownership of the current pending set, so
        # _pending stays O(1) across a long run of periodic saves.
        with self._lock:
            pending, self._pending = self._pending, []
            self._pending.append(self._pool.submit(chain, pending))

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        self.wait()  # never read our own unfinished write
        return self._sync.load(path, map_location)

    # --------------------------------------------------------------- commit
    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()  # re-raise writer errors in the caller
        with self._lock:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def commit(self, tag: str) -> bool:
        self.wait()
        logger.info(f"[async-ckpt] tag {tag} committed")
        return True

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self._pool.shutdown(wait=False)
        except Exception as e:
            # a durability path never eats a failure silently — but the
            # logging machinery itself may already be torn down here
            try:
                logger.warning(
                    f"[async-ckpt] writer pool shutdown failed: {e!r}")
            except Exception:  # the logger may be gone at interpreter teardown
                pass
