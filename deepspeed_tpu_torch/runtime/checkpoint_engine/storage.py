"""Retrying, atomic, fault-injectable storage primitives.

The port of the JAX package's ``runtime/checkpoint_engine/storage.py``.
Every byte the checkpoint subsystem persists goes through here: write to
``<final>.tmp``, ``os.replace`` onto the final name (readers never observe a
half-file), with transient I/O errors retried under the configured
exponential-backoff policy.  The named fault-injection points
(``ckpt.write`` / ``ckpt.post_write``, see ``utils/fault_injection.py``) sit
inside the attempt so chaos tests exercise the same retry path production
errors take.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Dict, TypeVar

import numpy as np

from ...utils import fault_injection
from ...utils.logging import logger
from .config import CheckpointRetryConfig

T = TypeVar("T")


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def retry_io(fn: Callable[[], T], retry: CheckpointRetryConfig,
             what: str) -> T:
    """Run ``fn`` under the retry policy; the last error propagates."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            attempt += 1
            if attempt >= retry.max_attempts:
                logger.error(
                    f"[ckpt-storage] {what} FAILED after {attempt} "
                    f"attempt(s): {e!r}")
                raise
            delay = min(retry.backoff_max,
                        retry.backoff_base * (2 ** (attempt - 1)))
            delay *= 1.0 + retry.jitter * random.random()
            logger.warning(
                f"[ckpt-storage] {what} failed (attempt {attempt}/"
                f"{retry.max_attempts}): {e!r}; retrying in {delay:.3f}s")
            time.sleep(delay)


def _atomic_attempt(path: str, write_tmp: Callable[[str], None]) -> None:
    """One attempt: write ``path + '.tmp'`` via ``write_tmp``, replace onto
    ``path``; a failed attempt never leaves the tmp file behind."""
    fault_injection.fire("ckpt.write", path=path)
    tmp = path + ".tmp"
    try:
        write_tmp(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError as e:
                # the write itself already succeeded or raised; a leaked
                # tmp file is harmless but worth a trace in the log
                logger.warning(
                    f"[ckpt-storage] could not remove stale tmp {tmp}: {e}")


def _ensure_parent(path: str) -> None:
    # guard against a bare-filename path: os.makedirs("") raises
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def atomic_write_npz(path: str, arrays: Dict[str, np.ndarray],
                     retry: CheckpointRetryConfig = None) -> str:
    """Atomically persist ``arrays`` as ``<path>[.npz]``; returns the final
    path.  Retried per the policy; crash/failure mid-attempt leaves the
    previous file (if any) intact."""
    path = npz_path(path)
    _ensure_parent(path)

    def write_tmp(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    retry_io(lambda: _atomic_attempt(path, write_tmp),
             retry or CheckpointRetryConfig(), f"npz write {path}")
    fault_injection.fire("ckpt.post_write", path=path)
    return path


def atomic_write_text(path: str, text: str,
                      retry: CheckpointRetryConfig = None) -> str:
    """Atomic text-file write (manifest, client state, latest marker)."""
    _ensure_parent(path)

    def write_tmp(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(text)

    retry_io(lambda: _atomic_attempt(path, write_tmp),
             retry or CheckpointRetryConfig(), f"text write {path}")
    fault_injection.fire("ckpt.post_write", path=path)
    return path
