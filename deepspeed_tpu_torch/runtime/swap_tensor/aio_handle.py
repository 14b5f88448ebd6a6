"""The Python side of the async file I/O engine (JAX ``runtime/
swap_tensor/aio_handle.py``, the counterpart of the reference's
``deepspeed_aio_handle_t``): reads and writes of flat CPU tensors against
files, with submit/wait semantics."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ...ops.op_builder.async_io import AsyncIOBuilder
from .aio_config import AioConfig


def _check_buffer(buf: torch.Tensor) -> None:
    if buf.device.type != "cpu" or not buf.is_contiguous():
        raise ValueError(f"aio buffers are contiguous CPU tensors, got "
                         f"{buf.device} (contiguous {buf.is_contiguous()})")


class AsyncIOHandle:
    """A thread pool of file reads and writes over CPU tensors."""

    def __init__(self, config: Optional[AioConfig] = None):
        self.config = config or AioConfig()
        self._lib = AsyncIOBuilder().load()
        self._engine = self._lib.ds_aio_create(self.config.thread_count,
                                               self.config.block_size)
        self._fds: Dict[str, int] = {}
        # a request holds its buffer until it is waited on, so the engine
        # never writes through a freed pointer
        self._inflight: Dict[int, torch.Tensor] = {}

    def _fd(self, path: str, for_write: bool) -> int:
        key = f"{'w' if for_write else 'r'}:{path}"
        if key not in self._fds:
            fd = self._lib.ds_aio_open(
                path.encode(), int(for_write), int(self.config.use_o_direct))
            if fd < 0:
                raise OSError(-fd, os.strerror(-fd), path)
            self._fds[key] = fd
        return self._fds[key]

    def _submit(self, fn, path: str, buf: torch.Tensor, offset: int,
                for_write: bool) -> int:
        _check_buffer(buf)
        rid = fn(self._engine, self._fd(path, for_write), buf.data_ptr(),
                 buf.numel() * buf.element_size(), offset)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid), path)
        self._inflight[rid] = buf
        return rid

    def submit_write(self, path: str, buf: torch.Tensor,
                     offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_submit_write, path, buf, offset,
                            True)

    def submit_read(self, path: str, buf: torch.Tensor,
                    offset: int = 0) -> int:
        return self._submit(self._lib.ds_aio_submit_read, path, buf, offset,
                            False)

    def wait(self, request_id: int) -> int:
        """Block until the request lands; its bytes moved."""
        nbytes = self._lib.ds_aio_wait(self._engine, request_id)
        self._inflight.pop(request_id, None)
        if nbytes < 0:
            raise OSError(-nbytes, os.strerror(-nbytes))
        return nbytes

    def close(self) -> None:
        """Wait for every request, close the files, stop the pool."""
        errors = []
        for rid in list(self._inflight):
            try:
                self.wait(rid)
            except OSError as e:
                errors.append(e)
        for fd in self._fds.values():
            self._lib.ds_aio_close(fd)
        self._fds.clear()
        if self._engine:
            self._lib.ds_aio_destroy(self._engine)
            self._engine = 0
        if errors:
            raise errors[0]

    def __del__(self):
        # an owner that was never closed: stop the pool's threads
        if getattr(self, "_engine", 0):
            try:
                self.close()
            except OSError:
                pass
