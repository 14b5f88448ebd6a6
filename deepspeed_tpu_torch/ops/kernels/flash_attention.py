"""Flash attention forward: the port of ``ops/pallas/flash_attention.py``.

``flash_attention(q, k, v, causal, sm_scale)`` on [B, S, H, D] returns
``(O, lse)``: O in the input dtype, lse [B, H, Sq] fp32.  CUDA tensors go
to the hand-written ``flash_fwd`` kernel (``csrc/flash_fwd.cu``, replacing
the TPU ``_fwd_kernel``), which reads q, k, v through their strides; CPU
tensors go to the plain version beside it.  Every shape the serving path
sends takes the kernel: the TPU tiling gates (``_pick_block``,
``FLASH_MIN_SEQ``) do not carry over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build
from .utils import DTYPE_CODES, check_kernel_inputs, on_cuda


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention, the plain version [B, S, H, D]: scores in
    fp32, causal end-aligned, p rounded to the input dtype before P·V,
    rows with no visible key give zeros."""
    return flash_attention_reference(q, k, v, causal, sm_scale)[0]


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention`: (O, lse [B, H, Sq]
    fp32, -inf on rows with no visible key)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e / torch.clamp(denom, min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    lse = (m + torch.log(torch.clamp(denom, min=1e-30)))[..., 0]
    lse = torch.where(denom[..., 0] > 0, lse,
                      torch.full_like(lse, float("-inf")))
    return o.to(q.dtype), lse


class _FlashFwd:
    """The ``flash_fwd`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls)."""

    launches = 0

    def __call__(self, q, k, v, causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = check_kernel_inputs("flash_fwd", q, k, v)
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        if k.shape != (B, Sk, H, D) or v.shape != k.shape:
            raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)}")
        o = torch.empty((B, Sq, H, D), dtype=dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        fn = build.function("flash_fwd", _ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    o.stride(0), o.stride(1), o.stride(2),
                    float(scale), int(bool(causal)),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_fwd", status)
        _FlashFwd.launches += 1
        return o, lse


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
flash_fwd = _FlashFwd()


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-linear attention. q, k, v: [B, S, H, D] → (O [B, Sq, H, D],
    lse [B, H, Sq] fp32).  Causal masking is end-aligned (a query attends
    to the last ``Sq`` positions of ``Sk``)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, k, v):
        return flash_fwd(q, k, v, causal, scale)
    return flash_attention_reference(q, k, v, causal, scale)
