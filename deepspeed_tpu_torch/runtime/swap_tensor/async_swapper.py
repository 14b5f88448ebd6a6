"""A keyed swap store (JAX ``runtime/swap_tensor/async_swapper.py``,
reference ``async_swapper.py:17`` ``AsyncTensorSwapper``): CPU tensors go
to swap files while compute continues, and are waited on only when read
back."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from .aio_config import AioConfig
from .aio_handle import AsyncIOHandle


class AsyncTensorSwapper:
    """``swap_out(key, t)`` starts an asynchronous write; ``swap_in(key)``
    waits for a pending write of that key and reads the tensor back."""

    def __init__(self, swap_dir: str, aio_config: Optional[AioConfig] = None):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.handle = AsyncIOHandle(aio_config)
        # key -> (path, shape, dtype, pending write request or None)
        self._meta: Dict[str, Tuple[str, torch.Size, torch.dtype,
                                    Optional[int]]] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key}.swp")

    def swap_out(self, key: str, t: torch.Tensor,
                 blocking: bool = False) -> None:
        t = t.detach().contiguous()
        path = self._path(key)
        rid = self.handle.submit_write(path, t)
        self._meta[key] = (path, t.shape, t.dtype, rid)
        if blocking:
            self._drain(key)

    def _drain(self, key: str) -> None:
        path, shape, dtype, rid = self._meta[key]
        if rid is not None:
            self.handle.wait(rid)
            self._meta[key] = (path, shape, dtype, None)

    def swap_in(self, key: str,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if key not in self._meta:
            raise KeyError(f"no swapped tensor under key {key!r}")
        self._drain(key)  # a write still in flight lands first
        path, shape, dtype, _ = self._meta[key]
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        self.handle.wait(self.handle.submit_read(path, out))
        return out.view(shape)

    def contains(self, key: str) -> bool:
        return key in self._meta

    def swapped_bytes(self) -> int:
        return sum(s.numel() * torch.empty((), dtype=d).element_size()
                   for _, s, d, _ in self._meta.values())

    def release(self, key: str) -> None:
        if key in self._meta:
            self._drain(key)
            path = self._meta.pop(key)[0]
            if os.path.exists(path):
                os.unlink(path)

    def close(self) -> None:
        for key in list(self._meta):
            self.release(key)
        self.handle.close()
