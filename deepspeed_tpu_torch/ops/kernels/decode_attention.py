"""KV-cache attention: the port of ``ops/pallas/decode_attention.py``.

``cached_attention(q, cache_k, cache_v, pos, sm_scale)``: q [B, Sq, H, D]
at absolute positions ``pos + i`` over a padded cache [B, S_max, H, D],
query i seeing cache slots <= pos + i; ``pos`` is an int or a per-row
int32 tensor [B] (ragged decode).  On CUDA tensors a single query
(Sq = 1) goes to the ``decode_attn`` kernel (``csrc/decode_attn.cu``,
replacing the TPU ``_decode_kernel``) and a chunk (Sq > 1) to
``chunk_attn`` (``csrc/chunk_attn.cu``, replacing ``_chunk_kernel``);
both read the cache's layer view through its strides, with no
[B*H, S_max, D] transpose copy, and take every S_max (the TPU's
``block_k in {256, 128}`` tiling gate does not carry over).  On CPU
tensors the plain version runs.

The TPU kernels' int8-cache (``k_scale``/``v_scale``), banded-window and
ALiBi options are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import build
from .utils import DTYPE_CODES, check_kernel_inputs, on_cuda

Pos = Union[int, torch.Tensor]


def cached_attention_reference(q, cache_k, cache_v, pos: Pos,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The plain version: dense softmax over the whole padded cache with
    slots past each query's position masked.  Scores and softmax in fp32;
    p rounded to the input dtype before P·V, as the JAX reference does."""
    B, Sq, H, D = q.shape
    Smax = cache_k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), cache_k.float()) * scale
    steps = torch.arange(Sq, device=q.device)
    if torch.is_tensor(pos):
        q_abs = pos.to(q.device).long().view(-1, 1) + steps      # [B, Sq]
    else:
        q_abs = (int(pos) + steps).view(1, Sq)                  # [1, Sq]
    k_pos = torch.arange(Smax, device=q.device)
    visible = k_pos.view(1, 1, Smax) <= q_abs[:, :, None]       # [B|1, Sq, Smax]
    s = s.masked_fill(~visible[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                     cache_v.float())
    return o.to(q.dtype)


def _check_pos(name: str, pos: Pos, B: int, device: torch.device,
               Sq: int, Smax: int):
    """(pos pointer, pos scalar) for the C interface."""
    if torch.is_tensor(pos):
        if pos.dtype != torch.int32 or pos.shape != (B,) or \
                pos.device != device or not pos.is_contiguous():
            raise ValueError(f"{name}: pos must be a contiguous int32 [{B}] "
                             f"tensor on {device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        return pos.data_ptr(), 0
    pos = int(pos)
    if pos < 0 or pos + Sq > Smax:
        raise ValueError(f"{name}: positions {pos}..{pos + Sq - 1} outside "
                         f"the {Smax}-slot cache")
    return None, pos


def _check_cache(name, q, cache_k, cache_v):
    dtype = check_kernel_inputs(name, q, cache_k, cache_v)
    B, _, H, D = q.shape
    if cache_k.shape[0] != B or cache_k.shape[2:] != (H, D) or \
            cache_v.shape != cache_k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    return dtype


class _DecodeAttn:
    """The ``decode_attn`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls)."""

    launches = 0

    def __call__(self, q, cache_k, cache_v, pos: Pos, scale: float):
        dtype = _check_cache("decode_attn", q, cache_k, cache_v)
        B, Sq, H, D = q.shape
        if Sq != 1:
            raise ValueError(f"decode_attn takes one query per row, got {Sq}")
        pos_ptr, pos_scalar = _check_pos("decode_attn", pos, B, q.device, 1,
                                         cache_k.shape[1])
        o = torch.empty((B, 1, H, D), dtype=dtype, device=q.device)
        fn = build.function("decode_attn", _DECODE_ARGTYPES)
        status = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                    o.data_ptr(), DTYPE_CODES[dtype], B, H, D,
                    q.stride(0), q.stride(2),
                    cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
                    cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
                    o.stride(0), o.stride(2), pos_ptr, pos_scalar,
                    float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("decode_attn", status)
        _DecodeAttn.launches += 1
        return o


class _ChunkAttn:
    """The ``chunk_attn`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls)."""

    launches = 0

    def __call__(self, q, cache_k, cache_v, pos: Pos, scale: float):
        dtype = _check_cache("chunk_attn", q, cache_k, cache_v)
        B, Sq, H, D = q.shape
        Smax = cache_k.shape[1]
        pos_ptr, pos_scalar = _check_pos("chunk_attn", pos, B, q.device, Sq,
                                         Smax)
        o = torch.empty((B, Sq, H, D), dtype=dtype, device=q.device)
        fn = build.function("chunk_attn", _CHUNK_ARGTYPES)
        status = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                    o.data_ptr(), DTYPE_CODES[dtype], B, Sq, Smax, H, D,
                    q.stride(0), q.stride(1), q.stride(2),
                    cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
                    cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
                    o.stride(0), o.stride(1), o.stride(2),
                    pos_ptr, pos_scalar, float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("chunk_attn", status)
        _ChunkAttn.launches += 1
        return o


_DECODE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 10
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p])
_CHUNK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
decode_attn = _DecodeAttn()
chunk_attn = _ChunkAttn()


def cached_attention(q, cache_k, cache_v, pos: Pos,
                     sm_scale: Optional[float] = None,
                     k_scale=None, v_scale=None, window=None, slopes=None
                     ) -> torch.Tensor:
    """q [B, Sq, H, D] over a padded cache [B, S_max, H, D], visibility
    <= pos + i; ``pos`` an int or an int32 [B] tensor on q's device."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("cached_attention: the int8 KV cache "
                                  "(k_scale/v_scale) is not ported yet")
    if window is not None:
        raise NotImplementedError("cached_attention: banded-window "
                                  "attention is not ported yet")
    if slopes is not None:
        raise NotImplementedError("cached_attention: ALiBi slopes are not "
                                  "ported yet")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, cache_k, cache_v):
        kernel = decode_attn if q.shape[1] == 1 else chunk_attn
        return kernel(q, cache_k, cache_v, pos, scale)
    return cached_attention_reference(q, cache_k, cache_v, pos, scale)
