"""Fused Adam over flat buffers: the port of ``ops/pallas/fused_adam.py``.

:func:`fused_adam` runs one Adam/AdamW step in place over flat fp32
buffers: the master params ``p``, the gradient accumulator ``g`` (zeroed
by the step), the moments ``m`` and ``v``, and optionally a compute-dtype
copy of ``p``.  Its scalars stay on the device: ``hyper`` = (lr, β1, β2,
eps, weight_decay, bc1, bc2) fp32 [7], the TPU kernel's SMEM scalars; an
optional ``gscale`` [] that multiplies g first (loss-scale unscale times
the clip coefficient); an optional ``skip`` [] bool (the overflow flag)
that leaves p, m, v and the copy untouched.  CUDA tensors launch the
hand-written ``fused_adam`` kernel (``csrc/fused_adam.cu``, replacing the
TPU ``_adam_kernel``); CPU tensors run the plain version beside it.

:func:`fused_adam_step` is the functional counterpart of the JAX
``fused_adam_step``: new (params, exp_avg, exp_avg_sq) from old ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .utils import DTYPE_CODES, on_cuda


def adam_hyper_values(lr: float, beta1: float, beta2: float, eps: float,
                      weight_decay: float, step: int,
                      bias_correction: bool = True) -> list:
    """The 7 scalars of one step; ``step`` is the post-increment count (1
    on the first step).  The bias corrections are taken in fp32, as the
    JAX package takes them."""
    if bias_correction:
        bc1 = 1.0 - np.power(np.float32(beta1), np.float32(step))
        bc2 = 1.0 - np.power(np.float32(beta2), np.float32(step))
    else:
        bc1 = bc2 = 1.0
    return [lr, beta1, beta2, eps, weight_decay, float(bc1), float(bc2)]


def adam_hyper(lr: float, beta1: float, beta2: float, eps: float,
               weight_decay: float, step: int, bias_correction: bool = True,
               device=None) -> torch.Tensor:
    """:func:`adam_hyper_values` as the fp32 [7] tensor the step reads."""
    return torch.tensor(adam_hyper_values(lr, beta1, beta2, eps,
                                          weight_decay, step,
                                          bias_correction),
                        dtype=torch.float32, device=device)


def fused_adam_reference(p, g, m, v, hyper, p_compute=None, gscale=None,
                         skip=None, adam_w_mode: bool = True) -> None:
    """The plain version of :func:`fused_adam`: the same fp32 math, in
    place."""
    lr, beta1, beta2, eps, wd, bc1, bc2 = hyper.unbind()
    grad = g * gscale if gscale is not None else g
    if not adam_w_mode:
        grad = grad + wd * p
    m_new = beta1 * m + (1.0 - beta1) * grad
    v_new = beta2 * v + (1.0 - beta2) * grad * grad
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        update = update + wd * p
    p_new = p - lr * update
    if skip is not None:
        p_new = torch.where(skip, p, p_new)
        m_new = torch.where(skip, m, m_new)
        v_new = torch.where(skip, v, v_new)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    if p_compute is not None:
        p_compute.copy_(p)
    g.zero_()


class _FusedAdam:
    """The ``fused_adam`` kernel's wrapper; ``launches`` counts kernel
    launches."""

    launches = 0

    def __call__(self, p, g, m, v, hyper, p_compute=None, gscale=None,
                 skip=None, adam_w_mode: bool = True) -> None:
        n = p.numel()
        for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.numel() != n or t.data_ptr() % 16):
                raise ValueError(f"fused_adam: {name} must be a contiguous, "
                                 f"16-byte aligned fp32 buffer of {n} "
                                 f"elements (got {t.dtype}, {t.numel()})")
        if p_compute is not None and (
                p_compute.dtype not in DTYPE_CODES
                or not p_compute.is_contiguous() or p_compute.numel() != n
                or p_compute.data_ptr() % 8):
            raise ValueError("fused_adam: p_compute must be a contiguous, "
                             "8-byte aligned float buffer of the same size")
        if hyper.dtype != torch.float32 or hyper.numel() != 7:
            raise ValueError("fused_adam: hyper must be fp32 [7]")
        if gscale is not None and (gscale.dtype != torch.float32
                                   or gscale.numel() != 1):
            raise ValueError("fused_adam: gscale must be one fp32 scalar")
        if skip is not None and (skip.dtype != torch.bool
                                 or skip.numel() != 1):
            raise ValueError("fused_adam: skip must be one bool")
        fn = build.function("fused_adam", _ARGTYPES)
        status = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    None if p_compute is None else p_compute.data_ptr(),
                    DTYPE_CODES[p_compute.dtype] if p_compute is not None
                    else 0,
                    hyper.data_ptr(),
                    None if gscale is None else gscale.data_ptr(),
                    None if skip is None else skip.data_ptr(),
                    n, int(bool(adam_w_mode)),
                    torch.cuda.current_stream(p.device).cuda_stream)
        build.check_status("fused_adam", status)
        _FusedAdam.launches += 1


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
fused_adam_kernel = _FusedAdam()


def fused_adam(p, g, m, v, hyper, p_compute=None, gscale=None, skip=None,
               adam_w_mode: bool = True) -> None:
    """One Adam step in place over flat buffers (module docstring); the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    tensors = [t for t in (p, g, m, v, hyper, p_compute, gscale, skip)
               if t is not None]
    if on_cuda(*tensors):
        fused_adam_kernel(p, g, m, v, hyper, p_compute, gscale, skip,
                          adam_w_mode)
    else:
        with torch.no_grad():
            fused_adam_reference(p, g, m, v, hyper, p_compute, gscale, skip,
                                 adam_w_mode)


def fused_adam_step(params, grads, exp_avg, exp_avg_sq, step, lr,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    adam_w_mode: bool = True, bias_correction: bool = True,
                    skip: Optional[torch.Tensor] = None):
    """One Adam step on flat 1-D tensors, functional (the JAX
    ``fused_adam_step``): ``params``/``grads`` any float dtype, moments
    fp32, ``step`` the post-increment count.  Returns (new_params,
    new_exp_avg, new_exp_avg_sq); the inputs are not modified."""
    hyper = adam_hyper(lr, beta1, beta2, eps, weight_decay, step,
                       bias_correction, device=params.device)
    p32 = params.float().clone()
    g32 = grads.float().clone()
    m = exp_avg.float().clone()
    v = exp_avg_sq.float().clone()
    out = None if params.dtype == torch.float32 else torch.empty_like(params)
    if out is not None:
        out.copy_(params)          # the skipped step keeps the old params
    fused_adam(p32, g32, m, v, hyper, p_compute=out, skip=skip,
               adam_w_mode=adam_w_mode)
    return (p32 if out is None else out), m, v
