"""Builder of the async file I/O engine of the NVMe offload path (JAX
``ops/op_builder/async_io.py``, reference ``op_builder/async_io.py``):
``csrc/aio/ds_aio.cpp``."""

from __future__ import annotations

import ctypes

from .builder import OpBuilder


class AsyncIOBuilder(OpBuilder):
    NAME = "async_io"

    def sources(self):
        return ["aio/ds_aio.cpp"]

    def _bind(self, lib: ctypes.CDLL) -> None:
        i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        for name, args, res in (
                ("ds_aio_create", [i32, i64], i64),
                ("ds_aio_destroy", [i64], None),
                ("ds_aio_open", [ctypes.c_char_p, i32, i32], i32),
                ("ds_aio_close", [i32], i32),
                ("ds_aio_submit_read", [i64, i32, vp, i64, i64], i64),
                ("ds_aio_submit_write", [i64, i32, vp, i64, i64], i64),
                ("ds_aio_wait", [i64, i64], i64),
                ("ds_aio_pending", [i64], i32),
                ("ds_aio_pread", [i32, vp, i64, i64], i64),
                ("ds_aio_pwrite", [i32, vp, i64, i64], i64)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
