"""Fused bias + tanh-GeLU + dropout: the port of
``ops/pallas/fused_bias_gelu.py``.

``bias_gelu_dropout(x, bias, dropout_rate, seed)`` is
``dropout(gelu_tanh(x + bias))`` over x [..., C] and bias [C], with a
``torch.autograd.Function`` whose backward regenerates the dropout mask
instead of storing it.  The mask is the Pallas kernels' counter hash
(``_keep_mask``): each element's global index ``row * C + col`` (uint32,
wrapping) mixed with the int ``seed``, so the kernels, the plain versions
and the JAX kernel in interpret mode drop the same elements.  On CUDA
tensors the forward and the backward launch the ``bias_gelu_fwd`` and
``bias_gelu_bwd`` kernels (``csrc/fused_bias_gelu.cu``, replacing
``_fwd_kernel`` and ``_bwd_kernel``) for every C; on CPU tensors the plain
versions run.  The JAX package's own fallback (off the TPU, or C % 128 !=
0) draws its mask from ``jax.random.bernoulli`` instead: the port keeps
the hash for every C, so it agrees with that fallback only at rate 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .quantizer import _mul32
from .utils import DTYPE_CODES, on_cuda

BLOCK_ROWS = 256      # rows per bias-gradient partial (``_BLOCK_ROWS``)
_M32 = 0xFFFFFFFF
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


# ------------------------------------------------------------ plain versions

def _gelu(x: torch.Tensor) -> torch.Tensor:
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    x3 = 0.044715 * x * x * x
    t = torch.tanh(_SQRT_2_OVER_PI * (x + x3))
    sech2 = 1.0 - t * t
    return 0.5 * (1.0 + t) + 0.5 * x * sech2 * _SQRT_2_OVER_PI * \
        (1.0 + 3.0 * 0.044715 * x * x)


def keep_mask(rows: int, C: int, rate: float, seed: int,
              device=None) -> torch.Tensor:
    """The dropout mask of the kernels, fp32 [rows, C] of 1.0 (kept) and
    0.0 (dropped)."""
    h = torch.arange(rows * C, dtype=torch.int64, device=device) & _M32
    h = h ^ (((seed & _M32) * 0x9E3779B9) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    u = (h >> 8).float() * 2.0 ** -24
    rate32 = torch.tensor(rate, dtype=torch.float32, device=device)
    return (u >= rate32).float().view(rows, C)


def bias_gelu_forward_reference(x2: torch.Tensor, bias: torch.Tensor,
                                rate: float, seed: int) -> torch.Tensor:
    """The plain forward over x2 [rows, C]: fp32 math, one rounding."""
    y = _gelu(x2.float() + bias.float())
    if rate > 0.0:
        y = y * keep_mask(*x2.shape, rate, seed, x2.device) * _scale(rate)
    return y.to(x2.dtype)


def bias_gelu_backward_reference(x2: torch.Tensor, bias: torch.Tensor,
                                 g: torch.Tensor, rate: float, seed: int):
    """The plain backward: (dx in x2's dtype, db in bias's dtype)."""
    g = g.float()
    if rate > 0.0:
        g = g * keep_mask(*x2.shape, rate, seed, x2.device) * _scale(rate)
    dx = g * _gelu_grad(x2.float() + bias.float())
    return dx.to(x2.dtype), dx.sum(0).to(bias.dtype)


# ------------------------------------------------------------------ kernels

def _check(name, x2, bias, *rows_like):
    if x2.dtype not in DTYPE_CODES or bias.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtypes {x2.dtype}, {bias.dtype} not "
                        f"supported (want {list(DTYPE_CODES)})")
    if x2.dim() != 2 or bias.shape != (x2.shape[1],):
        raise ValueError(f"{name}: want x [rows, C] and bias [C], got "
                         f"{tuple(x2.shape)} and {tuple(bias.shape)}")
    for t in (x2, bias, *rows_like):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in rows_like:
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError(f"{name}: the gradient must match x in shape "
                             "and dtype")


class _BiasGeluFwd:
    """The ``bias_gelu_fwd`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls)."""

    launches = 0

    def __call__(self, x2, bias, rate, seed):
        _check("bias_gelu_fwd", x2, bias)
        y = torch.empty_like(x2)
        if y.numel() == 0:
            return y
        fn = build.function("fused_bias_gelu", _FWD_ARGTYPES, "bias_gelu_fwd")
        status = fn(x2.data_ptr(), bias.data_ptr(), y.data_ptr(),
                    DTYPE_CODES[x2.dtype], DTYPE_CODES[bias.dtype],
                    x2.shape[0], x2.shape[1], seed & _M32, rate,
                    _scale(rate) if rate > 0.0 else 1.0,
                    torch.cuda.current_stream(x2.device).cuda_stream)
        build.check_status("fused_bias_gelu", status)
        _BiasGeluFwd.launches += 1
        return y


class _BiasGeluBwd:
    """The ``bias_gelu_bwd`` kernel's wrapper: (dx, db); the kernel writes
    fp32 per-256-row partials of db, summed here over dim 0."""

    launches = 0

    def __call__(self, x2, bias, g, rate, seed):
        _check("bias_gelu_bwd", x2, bias, g)
        rows, C = x2.shape
        dx = torch.empty_like(x2)
        part = torch.empty(((rows + BLOCK_ROWS - 1) // BLOCK_ROWS, C),
                           dtype=torch.float32, device=x2.device)
        if dx.numel() == 0:
            return dx, torch.zeros_like(bias)
        fn = build.function("fused_bias_gelu", _BWD_ARGTYPES, "bias_gelu_bwd")
        status = fn(x2.data_ptr(), bias.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), part.data_ptr(), DTYPE_CODES[x2.dtype],
                    DTYPE_CODES[bias.dtype], rows, C, seed & _M32, rate,
                    _scale(rate) if rate > 0.0 else 1.0,
                    torch.cuda.current_stream(x2.device).cuda_stream)
        build.check_status("fused_bias_gelu", status)
        _BiasGeluBwd.launches += 1
        return dx, part.sum(0).to(bias.dtype)


_FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
bias_gelu_fwd = _BiasGeluFwd()
bias_gelu_bwd = _BiasGeluBwd()


class _BiasGeluDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, bias, rate, seed):
        ctx.save_for_backward(x2, bias)
        ctx.rate, ctx.seed = rate, seed
        if on_cuda(x2, bias):
            return bias_gelu_fwd(x2, bias, rate, seed)
        return bias_gelu_forward_reference(x2, bias, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x2, bias = ctx.saved_tensors
        g = g.contiguous()
        if on_cuda(x2, bias, g):
            dx, db = bias_gelu_bwd(x2, bias, g, ctx.rate, ctx.seed)
        else:
            dx, db = bias_gelu_backward_reference(x2, bias, g, ctx.rate,
                                                  ctx.seed)
        return dx, db, None, None


def bias_gelu_dropout(x: torch.Tensor, bias: torch.Tensor,
                      dropout_rate: float = 0.0, seed: int = 0
                      ) -> torch.Tensor:
    """``dropout(gelu_tanh(x + bias))`` fused.  x: [..., C], bias: [C];
    the int ``seed`` fixes the mask, which the backward regenerates."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    out = _BiasGeluDropout.apply(x2, bias, float(dropout_rate), int(seed))
    return out.reshape(x.shape)
