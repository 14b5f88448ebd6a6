"""Grouped int8 quantization: the port of ``ops/pallas/quantizer.py``.

``quantize(x, groups, bits, symmetric, stochastic, generator)`` splits the
flat tensor into ``groups`` equal rows ("groups") and returns ``(codes
int8 [groups, gsize], scale fp32 [groups], offset fp32 [groups])``:
symmetric mode takes an absmax scale and offset 0, asymmetric mode a
min/max scale and the midpoint as offset; ``bits`` <= 8 narrows the code
range, the codes stay int8.  On CUDA tensors it launches the ``quantizer``
kernel (``csrc/quantizer.cu``, replacing the TPU ``_quant_kernel``); on
CPU tensors the plain version :func:`_quantize_ref` runs.  The kernel
takes every group size and input dtype (fp32, fp16, bf16, widened in
registers): the TPU gates (``groups % 8``, one 4 MiB block, ``gsize <
128`` → jnp) do not carry over.

Deterministic codes, scales and offsets are bitwise equal between the
kernel, the plain version and the JAX package's ``_quantize_ref``.
Stochastic rounding adds noise in [-0.5, 0.5) from a counter hash over
(seed, element index), the seed drawn from ``generator``; the kernel and
the plain version draw the same noise, the TPU's ``prng_random_bits``
stream is not reproduced (the two agree in distribution only).

``dequantize``, ``fake_quantize`` (straight-through gradient) and the
symmetric helpers ``quantize_symmetric``/``dequantize_symmetric`` are
plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .utils import DTYPE_CODES, on_cuda

_M32 = 0xFFFFFFFF


def _qrange(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _check_bits(bits: int) -> None:
    if not 2 <= int(bits) <= 8:
        raise ValueError(f"bits must be in 2..8 (int8 codes), got {bits}")


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as a true division: PyTorch's CUDA division by a scalar
    multiplies by its reciprocal, which is not exact for 1/127."""
    return a / torch.full_like(a, c)


# ----------------------------------------------------- shared symmetric math

def quantize_symmetric(x2: torch.Tensor, bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x2 [groups, gsize]`` → ``(codes int8 [groups, gsize], scales fp32
    [groups])``: symmetric per-group absmax quantization.  All-zero groups
    take the 1e-12 scale floor, so their codes are 0 and the round trip is
    exactly 0."""
    qmax = _qrange(bits)
    x = x2.float()
    scale = _div(x.abs().amax(dim=1), qmax).clamp_min(1e-12)
    q = torch.round(x / scale[:, None]).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_symmetric(codes: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric`; fp32 [groups, gsize]."""
    return codes.float() * scales[:, None]


# ------------------------------------------------------------------ reference

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in 16-bit halves so no
    product leaves int64."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _M32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    return x ^ (x >> 16)


def sr_noise(seed: int, shape, device=None) -> torch.Tensor:
    """The stochastic-rounding noise of ``csrc/quantizer.cu`` ``sr_noise``
    for elements 0..numel-1 of ``shape`` (row-major): fp32 in [-0.5, 0.5),
    24 hashed bits of (seed, element index)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    s_lo, s_hi = seed & _M32, (seed >> 32) & _M32
    u = _lowbias32(_lowbias32((idx & _M32) ^ s_lo)
                   ^ (((idx >> 32) + s_hi) & _M32))
    return ((u >> 8).float() * 2.0 ** -24 - 0.5).view(*shape)


def _quantize_ref(x: torch.Tensor, bits: int, symmetric: bool,
                  seed: Optional[int] = None):
    """The plain version over the last dim of ``x`` [..., gsize]: (codes
    int8 [..., gsize], scale fp32 [...], offset fp32 [...]); stochastic
    when ``seed`` is given.  fp32 math in the JAX package's order."""
    qmax = _qrange(bits)
    x = x.float()
    if symmetric:
        scale = _div(x.abs().amax(dim=-1), qmax).clamp_min(1e-12)
        offset = torch.zeros_like(scale)
        scaled = x / scale[..., None]
    else:
        lo, hi = x.amin(dim=-1), x.amax(dim=-1)
        scale = _div(hi - lo, 2.0 * qmax).clamp_min(1e-12)
        offset = (hi + lo) / 2.0
        scaled = (x - offset[..., None]) / scale[..., None]
    if seed is not None:
        scaled = scaled + sr_noise(seed, x.shape, x.device)
    q = torch.round(scaled).clamp(-qmax, qmax).to(torch.int8)
    return q, scale, offset


# -------------------------------------------------------------------- kernel

class _Quantizer:
    """The ``quantizer`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls)."""

    launches = 0

    def __call__(self, x: torch.Tensor, bits: int = 8, symmetric: bool = True,
                 seed: Optional[int] = None, offsets: bool = True):
        """x [..., gsize] on CUDA, rows over up to three leading dims
        through their strides, each row contiguous → (codes int8 [...,
        gsize] contiguous, scale fp32 [...], offset fp32 [...] or None)."""
        _check_bits(bits)
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"quantizer: dtype {x.dtype} not supported "
                            f"(want one of {list(DTYPE_CODES)})")
        if not 2 <= x.dim() <= 4:
            raise ValueError(f"quantizer takes 1-3 row dims and the group "
                             f"dim, got shape {tuple(x.shape)}")
        gsize = x.shape[-1]
        if gsize < 1:
            raise ValueError("quantizer: empty groups")
        if x.stride(-1) != 1 and gsize > 1:
            raise ValueError(f"quantizer: each group must be contiguous "
                             f"(stride {x.stride(-1)})")
        lead = tuple(x.shape[:-1])
        pad = 3 - len(lead)
        dims = (1,) * pad + lead
        strides = (0,) * pad + tuple(x.stride()[:-1])
        codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty(lead, dtype=torch.float32, device=x.device)
        offset = torch.empty(lead, dtype=torch.float32, device=x.device) \
            if offsets else None
        if codes.numel() == 0:
            return codes, scale, offset
        fn = build.function("quantizer", _QUANT_ARGTYPES)
        status = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                    offset.data_ptr() if offsets else None,
                    DTYPE_CODES[x.dtype], *dims, gsize, *strides, int(bits),
                    int(bool(symmetric)), int(seed is not None),
                    int(seed or 0) & 0xFFFFFFFFFFFFFFFF,
                    torch.cuda.current_stream(x.device).cuda_stream)
        build.check_status("quantizer", status)
        _Quantizer.launches += 1
        return codes, scale, offset


_QUANT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_ulonglong, ctypes.c_void_p])
quantizer_kernel = _Quantizer()


def quantize_rows(x: torch.Tensor, bits: int = 8, symmetric: bool = True,
                  seed: Optional[int] = None, offsets: bool = True):
    """Quantize each vector along the last dim of ``x`` [..., gsize] (at
    most three leading dims, read through their strides on CUDA) →
    ``(codes int8 [..., gsize], scale fp32 [...], offset fp32 [...] or
    None)``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if on_cuda(x):
        return quantizer_kernel(x, bits, symmetric, seed, offsets)
    _check_bits(bits)
    q, scale, offset = _quantize_ref(x, bits, symmetric, seed)
    return q, scale, offset if offsets else None


def _draw_seed(generator: Optional[torch.Generator]) -> int:
    """A 62-bit seed from ``generator``; 0 without one (the JAX package's
    default key is ``PRNGKey(0)``)."""
    if generator is None:
        return 0
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def quantize(x: torch.Tensor, groups: int = 1, bits: int = 8,
             symmetric: bool = True, stochastic: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to int8 codes with per-group scale and offset.

    Returns ``(codes int8 [groups, n // groups], scale fp32 [groups],
    offset fp32 [groups])``; ``bits`` <= 8.  Stochastic rounding draws its
    seed from ``generator`` (any device)."""
    n = x.numel()
    if groups < 1 or n % groups:
        raise ValueError(f"{n} elements not divisible into {groups} groups")
    x2 = x.reshape(groups, n // groups)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    seed = _draw_seed(generator) if stochastic else None
    return quantize_rows(x2, bits, symmetric, seed)


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               offset: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: [groups, n] codes → [groups, n]
    values in ``dtype``."""
    out = codes.float() * scale[:, None]
    if offset is not None:
        out = out + offset[:, None]
    return out.to(dtype)


class _FakeQuantize(torch.autograd.Function):
    """Quantize → dequantize with the straight-through gradient (JAX
    ``fake_quantize``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, groups, bits, symmetric, stochastic, generator):
        q, s, o = quantize(x.detach(), groups, bits, symmetric, stochastic,
                           generator)
        return dequantize(q, s, None if symmetric else o,
                          dtype=x.dtype).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None, None


def fake_quantize(x: torch.Tensor, groups: int = 1, bits: int = 8,
                  symmetric: bool = True, stochastic: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Quantize-dequantize round trip (the reference's
    ``fake_quantizer.cu``) for quantize-aware training; the gradient
    passes straight through."""
    return _FakeQuantize.apply(x, groups, bits, symmetric, stochastic,
                               generator)
