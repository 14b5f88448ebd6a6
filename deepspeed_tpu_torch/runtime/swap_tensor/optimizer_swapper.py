"""The optimizer state's NVMe swapper (JAX ``runtime/swap_tensor/
optimizer_swapper.py``, the counterpart of the reference's
``PartitionedOptimizerSwapper`` and ``PipelinedOptimizerSwapper``).

The fp32 master and the Adam moments live in swap files, one file per
(group, field).  A step streams one group through host memory at a time:
with ``pipeline_read`` the next group's read is started before the
current group is waited on, and with ``pipeline_write`` the write-back of
a group completes behind the following groups (``flush_writes`` at the
end of the step waits for all of them).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import torch

from .aio_config import AioConfig
from .aio_handle import AsyncIOHandle


class OptimizerStateSwapper:
    """A store of per-group dicts of flat CPU tensors, with read
    prefetch.  ``bytes_read`` and ``bytes_written`` count what moved."""

    def __init__(self, swap_dir: str, aio_config: Optional[AioConfig] = None,
                 pipeline_read: bool = True, pipeline_write: bool = True):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.handle = AsyncIOHandle(aio_config)
        self.pipeline_read = pipeline_read
        self.pipeline_write = pipeline_write
        # key -> field -> (path, shape, dtype)
        self._meta: Dict[str, Dict[str, tuple]] = {}
        # key -> field -> (request, buffer, shape)
        self._read_ahead: Dict[str, Dict[str, tuple]] = {}
        self._writes: List[int] = []
        self.bytes_read = 0
        self.bytes_written = 0

    def _path(self, key: str, field: str) -> str:
        return os.path.join(self.swap_dir,
                            f"{key.replace('/', '_')}.{field}.swp")

    def put(self, key: str, tensors: Dict[str, torch.Tensor],
            blocking: bool = False) -> None:
        """(Over)write a group's state; asynchronous unless ``blocking``
        or ``pipeline_write`` is off.  The tensors must not change until
        the write lands."""
        meta = {}
        for field, t in tensors.items():
            t = t.detach().contiguous()
            path = self._path(key, field)
            self._writes.append(self.handle.submit_write(path, t))
            self.bytes_written += t.numel() * t.element_size()
            meta[field] = (path, t.shape, t.dtype)
        self._meta[key] = meta
        if blocking or not self.pipeline_write:
            self.flush_writes()

    def flush_writes(self) -> None:
        for rid in self._writes:
            self.handle.wait(rid)
        self._writes.clear()

    def prefetch(self, key: str) -> None:
        """Start the reads of ``key`` (a no-op when they are in flight)."""
        if key in self._read_ahead or key not in self._meta:
            return
        self.flush_writes()  # never read a file whose write is queued
        fetch = {}
        for field, (path, shape, dtype) in self._meta[key].items():
            buf = torch.empty(shape.numel(), dtype=dtype)
            fetch[field] = (self.handle.submit_read(path, buf), buf, shape)
            self.bytes_read += buf.numel() * buf.element_size()
        self._read_ahead[key] = fetch

    def get(self, key: str, prefetch_next: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
        """A group's state, read (or its prefetched read waited on); arms
        the read of ``prefetch_next`` first under ``pipeline_read``."""
        if key not in self._meta:
            raise KeyError(f"no optimizer state under key {key!r}")
        if key not in self._read_ahead:
            self.prefetch(key)
        if prefetch_next is not None and self.pipeline_read:
            self.prefetch(prefetch_next)
        out = {}
        for field, (rid, buf, shape) in self._read_ahead.pop(key).items():
            self.handle.wait(rid)
            out[field] = buf.view(shape)
        return out

    def keys(self) -> Iterable[str]:
        return self._meta.keys()

    def swapped_bytes(self) -> int:
        """Bytes of state in the swap files."""
        return sum(shape.numel() * torch.empty((), dtype=dtype).element_size()
                   for meta in self._meta.values()
                   for _, shape, dtype in meta.values())

    def close(self) -> None:
        """Wait for every request, remove the swap files, stop the pool."""
        self.flush_writes()
        for key in list(self._read_ahead):
            for rid, _, _ in self._read_ahead.pop(key).values():
                self.handle.wait(rid)
        for meta in self._meta.values():
            for path, _, _ in meta.values():
                if os.path.exists(path):
                    os.unlink(path)
        self._meta.clear()
        self.handle.close()
