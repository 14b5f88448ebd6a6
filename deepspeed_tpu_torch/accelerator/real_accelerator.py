"""Device resolution, synchronisation and timing events.

Counterpart of the JAX package's ``accelerator/real_accelerator.py``,
cut to what the serving slice uses.  The port's entry points run on
``cuda`` unless the caller asks for the CPU; with no GPU and no explicit
``device="cpu"`` they raise instead of carrying on on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class CudaAccelerator:
    """The CUDA device the port runs on."""

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def device_name(self, index: int = 0) -> str:
        return torch.cuda.get_device_name(index)

    def resolve_device(self, device: Union[None, str, torch.device] = None
                       ) -> torch.device:
        """``None`` means the current CUDA device; an explicit device is
        returned as given (``"cpu"`` selects the plain kernels)."""
        if device is not None:
            dev = torch.device(device)
            if dev.type == "cuda" and not self.is_available():
                raise RuntimeError(f"device {dev} requested but CUDA is not "
                                   "available")
            return dev
        if not self.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch path on the host")
        return torch.device("cuda", torch.cuda.current_device())

    def synchronize(self, device: Optional[torch.device] = None) -> None:
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def event(self, enable_timing: bool = True) -> torch.cuda.Event:
        return torch.cuda.Event(enable_timing=enable_timing)


_accelerator = CudaAccelerator()


def get_accelerator() -> CudaAccelerator:
    return _accelerator
