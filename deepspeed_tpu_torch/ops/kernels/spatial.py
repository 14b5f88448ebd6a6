"""NHWC channel-bias adds of the diffusion models: the port of
``ops/pallas/spatial.py``.

``nhwc_bias_add(x, bias)`` (``x + bias``), ``nhwc_bias_add_add(x, bias,
other)`` (``x + bias + other``) and ``nhwc_bias_add_bias_add(x, bias,
other, other_bias)`` (``x + bias + other + other_bias``) take x and other
[N, H, W, C] and the biases [C].  Each element is widened to fp32, summed
left to right and rounded once to x's dtype, as the Pallas kernels do.
On CUDA tensors they launch the one ``nhwc_bias_add`` kernel
(``csrc/spatial.cu``, replacing ``_kernel``, ``_kernel_add`` and
``_kernel_bias_bias``) for every C; on CPU tensors the plain version
:func:`nhwc_bias_add_reference` runs.  The TPU's ``C % 128`` gate is a
lane constraint of its compiler and does not carry over.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .utils import DTYPE_CODES, on_cuda


def nhwc_bias_add_reference(x: torch.Tensor, bias: torch.Tensor,
                            other: Optional[torch.Tensor] = None,
                            other_bias: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain version: fp32 sums in the kernel's order, one rounding."""
    s = x.float() + bias.float()
    if other is not None:
        s = s + other.float()
    if other_bias is not None:
        s = s + other_bias.float()
    return s.to(x.dtype)


class _SpatialKernel:
    """The ``nhwc_bias_add`` kernel's wrapper for ``x + bias``; each
    variant (a subclass) counts its own kernel launches in ``launches``
    (never plain-version calls)."""

    launches = 0
    variant = 0

    def __call__(self, x: torch.Tensor, bias: torch.Tensor,
                 other: Optional[torch.Tensor] = None,
                 other_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (and other) contiguous on CUDA, last dim C; bias (and
        other_bias) [C] → a new tensor like x."""
        if (other is not None, other_bias is not None) != \
                (self.variant >= 1, self.variant >= 2):
            raise ValueError(f"{type(self).__name__}: wrong operands for "
                             f"variant {self.variant}")
        C = x.shape[-1]
        if x.dtype not in DTYPE_CODES or bias.dtype not in DTYPE_CODES:
            raise TypeError(f"nhwc_bias_add: dtypes {x.dtype}, {bias.dtype} "
                            f"not supported (want {list(DTYPE_CODES)})")
        if not x.is_contiguous():
            raise ValueError("nhwc_bias_add: x must be contiguous [..., C]")
        biases = [bias] + ([other_bias] if other_bias is not None else [])
        for b in biases:
            if b.shape != (C,) or b.dtype != bias.dtype or \
                    not b.is_contiguous():
                raise ValueError(f"nhwc_bias_add: biases must be contiguous "
                                 f"[{C}] of one dtype, got {tuple(b.shape)} "
                                 f"{b.dtype}")
        if other is not None and (other.shape != x.shape
                                  or other.dtype != x.dtype
                                  or not other.is_contiguous()):
            raise ValueError("nhwc_bias_add: other must be contiguous and "
                             "match x in shape and dtype")
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        fn = build.function("spatial", _ARGTYPES, "nhwc_bias_add")
        status = fn(x.data_ptr(), bias.data_ptr(),
                    other.data_ptr() if other is not None else None,
                    other_bias.data_ptr() if other_bias is not None else None,
                    out.data_ptr(), DTYPE_CODES[x.dtype],
                    DTYPE_CODES[bias.dtype], self.variant, x.numel(), C,
                    torch.cuda.current_stream(x.device).cuda_stream)
        build.check_status("spatial", status)
        type(self).launches += 1
        return out


class _SpatialAddKernel(_SpatialKernel):
    """``x + bias + other``."""

    launches = 0
    variant = 1


class _SpatialBiasAddKernel(_SpatialKernel):
    """``x + bias + other + other_bias``."""

    launches = 0
    variant = 2


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
spatial_kernel = _SpatialKernel()
spatial_add_kernel = _SpatialAddKernel()
spatial_bias_add_kernel = _SpatialBiasAddKernel()


def nhwc_bias_add(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C] + bias [C]."""
    if on_cuda(x, bias):
        return spatial_kernel(x, bias)
    return nhwc_bias_add_reference(x, bias)


def nhwc_bias_add_add(x: torch.Tensor, bias: torch.Tensor,
                      other: torch.Tensor) -> torch.Tensor:
    """x + bias[C] + other (residual), all NHWC."""
    if on_cuda(x, bias, other):
        return spatial_add_kernel(x, bias, other)
    return nhwc_bias_add_reference(x, bias, other)


def nhwc_bias_add_bias_add(x: torch.Tensor, bias: torch.Tensor,
                           other: torch.Tensor,
                           other_bias: torch.Tensor) -> torch.Tensor:
    """x + bias[C] + other + other_bias[C], summed in that order."""
    if on_cuda(x, bias, other, other_bias):
        return spatial_bias_add_kernel(x, bias, other, other_bias)
    return nhwc_bias_add_reference(x, bias, other, other_bias)
