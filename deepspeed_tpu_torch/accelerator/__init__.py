from .real_accelerator import CudaAccelerator, get_accelerator

__all__ = ["CudaAccelerator", "get_accelerator"]
