"""KV-cache attention: the port of ``ops/pallas/decode_attention.py``.

``cached_attention(q, cache_k, cache_v, pos, sm_scale)``: q [B, Sq, H, D]
at absolute positions ``pos + i`` over a padded cache [B, S_max, H, D],
query i seeing cache slots <= pos + i; ``pos`` is an int or a per-row
int32 tensor [B] (ragged decode).  On CUDA tensors a single query
(Sq = 1) goes to the ``decode_attn`` kernel (``csrc/decode_attn.cu``,
replacing the TPU ``_decode_kernel``: each (b, h)'s keys split across a
thread-block cluster, streamed by TMA) and a chunk (Sq > 1) to
``chunk_attn`` (``csrc/chunk_attn.cu``, replacing ``_chunk_kernel``: in
bf16 and fp16 on wgmma and TMA, each chunk's keys split across a
thread-block cluster; in fp32 on FMAs); both read the cache's layer
view through its strides, with no [B*H, S_max, D] transpose copy, and
take every S_max (the TPU's ``block_k in {256, 128}`` tiling gate does not
carry over).  On CPU tensors the plain version runs.

The int8 cache: with ``k_scale``/``v_scale`` ([B, S_max, H, 1] fp32) the
cache holds int8 codes (:func:`quantize_kv`: symmetric per head vector);
on CUDA ``decode_attn_int8`` and ``chunk_attn_int8`` (the same sources'
int8 entry points, the TPU kernels' ``quantized`` option) read the int8
codes and apply the scales on the card, on the CPU the plain version dequantizes first
(:func:`dequantize_kv`) and runs the dense math, as the JAX package's
fallback does.  :func:`quantize_kv_into` writes a layer's new K and V
into such a cache: on CUDA one ``quantize_kv_append`` launch
(``csrc/quantizer.cu``) quantizes both from the qkv view and stores
codes and scales at their slots.

Both kernels, and their int8 variants, take the TPU kernels' two other
options as launch arguments: ``window`` (an int >= 1) bands query i to
the keys ``pos + i - window < j <= pos + i`` (GPT-Neo's local layers),
and the kernels start each row's walk at its band, so a banded decode
step reads O(window) cache rows, not O(pos); ``slopes`` ([H] fp32 on the
device) adds ALiBi's ``-slopes[h] * (pos + i - j)`` to the scaled score
(BLOOM).  Each wrapper counts its launches with each option apart
(``option_launches``) besides its total.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import build
from .quantizer import _quantize_ref, quantize_rows
from .utils import DTYPE_CODES, check_kernel_inputs, count_head_dim, on_cuda

Pos = Union[int, torch.Tensor]


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 codes [..., D] and per-vector scales [..., 1] → ``dtype``."""
    return (codes.float() * scale).to(dtype)


def quantize_kv(x: torch.Tensor):
    """x [..., D] → (int8 codes [..., D], fp32 scale [..., 1]): symmetric
    per-vector quantization of K or V head vectors (absmax / 127, 1e-12
    floor, round half to even, clip to ±127), the 8-bit symmetric
    deterministic branch of the quantizer.  On CUDA one ``quantizer``
    launch reads x through its strides (at most three leading dims)."""
    codes, scale, _ = quantize_rows(x, 8, True, offsets=False)
    return codes, scale.unsqueeze(-1)


def quantize_kv_into(k: torch.Tensor, v: torch.Tensor, layer, pos: Pos
                     ) -> None:
    """Quantize the new tokens' K and V ([B, Sq, H, D], as
    :func:`quantize_kv`) into an int8 cache layer ``layer = (k codes, v
    codes, k scales, v scales)`` ([B, S_max, H, D] int8, [B, S_max, H, 1]
    fp32) at slots ``pos + i``, in place; ``pos`` an int or an int32 [B]
    tensor on the cache's device.  On CUDA one ``quantize_kv_append``
    launch does it all; on the CPU the plain version
    (:func:`quantize_kv_into_reference`) runs :func:`quantize_kv`'s plain
    version and the same indexed writes."""
    if on_cuda(k, v, *layer):
        quantize_kv_append(k, v, *layer, pos)
        return
    quantize_kv_into_reference(k, v, layer, pos)


def quantize_kv_into_reference(k, v, layer, pos: Pos) -> None:
    """The plain version of :func:`quantize_kv_into` on any device: the
    quantizer's plain version per head vector, then indexed writes."""
    B, Sq = k.shape[:2]
    if torch.is_tensor(pos):
        rows = torch.arange(B, device=k.device)[:, None]
        slots = (rows, pos.to(k.device).long()[:, None]
                 + torch.arange(Sq, device=k.device))
    else:
        slots = (slice(None), slice(int(pos), int(pos) + Sq))
    kc, vc, ks, vs = layer
    for val, codes_buf, scale_buf in ((k, kc, ks), (v, vc, vs)):
        codes, scale, _ = _quantize_ref(val, 8, True)
        codes_buf[slots] = codes
        scale_buf[slots] = scale.unsqueeze(-1)


def cached_attention_reference(q, cache_k, cache_v, pos: Pos,
                               sm_scale: Optional[float] = None,
                               window: Optional[int] = None,
                               slopes: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The plain version: dense softmax over the whole padded cache with
    slots past each query's position masked, and with ``window`` those at
    a distance of ``window`` or more; ``slopes`` [H] adds ``-slope·dist``
    after the scale (JAX ``decode_attention.py:48-72``).  Scores and
    softmax in fp32; p rounded to the input dtype before P·V, as the JAX
    reference does."""
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
    dist = q_abs[:, :, None] - k_pos.view(1, 1, Smax)           # [B|1, Sq, Smax]
    visible = dist >= 0
    if window is not None:
        visible = visible & (dist < window)
    if slopes is not None:
        s = s - slopes.to(q.device, torch.float32).view(1, H, 1, 1) \
            * dist[:, None].float()
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


def _check_cache(name, q, cache_k, cache_v, scales=None):
    """q and a cache of q's dtype, or with ``scales`` (k_scale, v_scale)
    an int8 cache: codes of q's head layout with 16-byte aligned rows and
    fp32 scales of the cache's shape with a last dim of 1.  Returns q's
    dtype."""
    if scales is None:
        dtype = check_kernel_inputs(name, q, cache_k, cache_v)
    else:
        dtype = check_kernel_inputs(name, q)
        for t in (cache_k, cache_v):
            if t.dtype != torch.int8:
                raise TypeError(f"{name}: the cache must hold int8 codes, "
                                f"got {t.dtype}")
            if t.dim() != 4 or t.stride(-1) != 1 or t.data_ptr() % 16 or \
                    any(st % 16 for st in t.stride()[:-1]):
                raise ValueError(f"{name}: cache rows must be contiguous and "
                                 f"16-byte aligned (strides {t.stride()})")
        want = tuple(cache_k.shape[:-1]) + (1,)
        for t in scales:
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name}: scales must be fp32 {want}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    B, _, H, D = q.shape
    if cache_k.shape[0] != B or cache_k.shape[2:] != (H, D) or \
            cache_v.shape != cache_k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    return dtype


#: pos (pointer, scalar), window, slopes, scale, stream
_POS_TAIL = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_void_p]
_SCALES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 6


def _option_args(name: str, q, window: Optional[int],
                 slopes: Optional[torch.Tensor]) -> tuple:
    """(window, slopes pointer) for the C interface: window 0 and a null
    pointer mean none."""
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if slopes is not None:
        H = q.shape[2]
        if slopes.dtype != torch.float32 or tuple(slopes.shape) != (H,) \
                or slopes.device != q.device or not slopes.is_contiguous():
            raise ValueError(f"{name}: slopes must be contiguous fp32 "
                             f"[{H}] on {q.device}, got {slopes.dtype} "
                             f"{tuple(slopes.shape)} on {slopes.device}")
    return (0 if window is None else int(window),
            None if slopes is None else slopes.data_ptr())


class _CacheKernel:
    """Shared launch path of the cache kernels' wrappers; ``launches``
    counts kernel launches (never plain-version calls), and
    ``option_launches`` those with a window and with ALiBi slopes,
    ``dim_launches`` those at each head dim.  The
    int8 variants (``int8 = True``) take ``k_scale, v_scale`` after
    ``scale`` and hand the C entry point their pointers and (b, s, h)
    strides."""

    source = ""
    symbol = ""
    argtypes: list = []
    int8 = False

    def _scale_args(self, scales) -> tuple:
        if len(scales) != (2 if self.int8 else 0):
            raise TypeError(f"{self.symbol} takes "
                            f"{'k_scale, v_scale' if self.int8 else 'no scales'}"
                            f", got {len(scales)} scale tensors")
        if not scales:
            return ()
        k_scale, v_scale = scales
        return (k_scale.data_ptr(), v_scale.data_ptr(),
                *k_scale.stride()[:3], *v_scale.stride()[:3])

    def _launch(self, args, D: int, window=None, slopes=None) -> None:
        fn = build.function(self.source, self.argtypes, self.symbol)
        build.check_status(self.source, fn(*args))
        cls = type(self)
        cls.launches += 1
        count_head_dim(cls, D)
        if window is not None:
            cls.option_launches["window"] += 1
        if slopes is not None:
            cls.option_launches["alibi"] += 1


class _DecodeAttn(_CacheKernel):
    """The ``decode_attn`` kernel's wrapper."""

    launches = 0
    option_launches = {"window": 0, "alibi": 0}
    dim_launches: dict = {}
    source = symbol = "decode_attn"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 10 + _POS_TAIL)

    def __call__(self, q, cache_k, cache_v, pos: Pos, scale: float,
                 *scales, window: Optional[int] = None,
                 slopes: Optional[torch.Tensor] = None):
        extra = self._scale_args(scales)
        opts = _option_args(self.symbol, q, window, slopes)
        dtype = _check_cache(self.symbol, q, cache_k, cache_v,
                             scales if self.int8 else None)
        B, Sq, H, D = q.shape
        if Sq != 1:
            raise ValueError(f"{self.symbol} takes one query per row, got "
                             f"{Sq}")
        Smax = cache_k.shape[1]
        pos_ptr, pos_scalar = _check_pos(self.symbol, pos, B, q.device, 1,
                                         Smax)
        o = torch.empty((B, 1, H, D), dtype=dtype, device=q.device)
        self._launch((q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                      o.data_ptr(), DTYPE_CODES[dtype], B, Smax, H, D,
                      q.stride(0), q.stride(2),
                      cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
                      cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
                      o.stride(0), o.stride(2), *extra, pos_ptr, pos_scalar,
                      *opts, float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream),
                     D, window, slopes)
        return o


class _ChunkAttn(_CacheKernel):
    """The ``chunk_attn`` kernel's wrapper."""

    launches = 0
    option_launches = {"window": 0, "alibi": 0}
    dim_launches: dict = {}
    source = symbol = "chunk_attn"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 12 + _POS_TAIL)

    def __call__(self, q, cache_k, cache_v, pos: Pos, scale: float,
                 *scales, window: Optional[int] = None,
                 slopes: Optional[torch.Tensor] = None):
        extra = self._scale_args(scales)
        opts = _option_args(self.symbol, q, window, slopes)
        dtype = _check_cache(self.symbol, q, cache_k, cache_v,
                             scales if self.int8 else None)
        B, Sq, H, D = q.shape
        Smax = cache_k.shape[1]
        pos_ptr, pos_scalar = _check_pos(self.symbol, pos, B, q.device, Sq,
                                         Smax)
        o = torch.empty((B, Sq, H, D), dtype=dtype, device=q.device)
        self._launch((q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                      o.data_ptr(), DTYPE_CODES[dtype], B, Sq, Smax, H, D,
                      q.stride(0), q.stride(1), q.stride(2),
                      cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
                      cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
                      o.stride(0), o.stride(1), o.stride(2), *extra,
                      pos_ptr, pos_scalar, *opts, float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream),
                     D, window, slopes)
        return o


class _DecodeAttnInt8(_DecodeAttn):
    """The ``decode_attn_int8`` kernel's wrapper (``decode_attn`` over an
    int8 cache): ``(q, codes_k, codes_v, pos, scale, k_scale, v_scale)``."""

    launches = 0
    option_launches = {"window": 0, "alibi": 0}
    dim_launches: dict = {}
    symbol = "decode_attn_int8"
    argtypes = _DecodeAttn.argtypes[:-len(_POS_TAIL)] + _SCALES + _POS_TAIL
    int8 = True


class _ChunkAttnInt8(_ChunkAttn):
    """The ``chunk_attn_int8`` kernel's wrapper (``chunk_attn`` over an
    int8 cache): ``(q, codes_k, codes_v, pos, scale, k_scale, v_scale)``."""

    launches = 0
    option_launches = {"window": 0, "alibi": 0}
    dim_launches: dict = {}
    symbol = "chunk_attn_int8"
    argtypes = _ChunkAttn.argtypes[:-len(_POS_TAIL)] + _SCALES + _POS_TAIL
    int8 = True


class _QuantizeKvAppend(_CacheKernel):
    """The ``quantize_kv_append`` kernel's wrapper (``csrc/quantizer.cu``):
    ``(k, v, k_codes, v_codes, k_scale, v_scale, pos)``, the arguments of
    :func:`quantize_kv_into` with the layer's four buffers spread out."""

    launches = 0
    option_launches: dict = {}
    dim_launches: dict = {}
    source = "quantizer"
    symbol = "quantize_kv_append"
    argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 6 + [ctypes.c_void_p] * 2
                + [ctypes.c_longlong] * 6 + [ctypes.c_void_p] * 2
                + [ctypes.c_longlong] * 6
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, k, v, k_codes, v_codes, k_scale, v_scale, pos: Pos):
        name = self.symbol
        dtype = k.dtype
        if dtype not in DTYPE_CODES or v.dtype != dtype:
            raise TypeError(f"{name}: K and V must share one of "
                            f"{list(DTYPE_CODES)}, got {k.dtype}, {v.dtype}")
        if k.dim() != 4 or v.shape != k.shape or k.stride(-1) != 1 or \
                v.stride(-1) != 1:
            raise ValueError(f"{name}: K and V must be [B, Sq, H, D] with "
                             f"contiguous head vectors, got {tuple(k.shape)} "
                             f"{k.stride()} and {tuple(v.shape)} {v.stride()}")
        B, Sq, H, D = k.shape
        for t in (k_codes, v_codes):
            if t.dtype != torch.int8:
                raise TypeError(f"{name}: the cache must hold int8 codes, "
                                f"got {t.dtype}")
            if t.dim() != 4 or t.shape[0] != B or t.shape[2:] != (H, D):
                raise ValueError(f"{name}: cache {tuple(t.shape)} does not "
                                 f"take K/V {tuple(k.shape)}")
            if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                    any(st % 16 for st in t.stride()[:-1]):
                raise ValueError(f"{name}: cache rows must be contiguous and "
                                 f"16-byte aligned (strides {t.stride()})")
        if v_codes.shape != k_codes.shape:
            raise ValueError(f"{name}: K and V caches differ: "
                             f"{tuple(k_codes.shape)}, {tuple(v_codes.shape)}")
        Smax = k_codes.shape[1]
        want = (B, Smax, H, 1)
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name}: scales must be fp32 {want}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        pos_ptr, pos_scalar = _check_pos(name, pos, B, k.device, Sq, Smax)
        self._launch((k.data_ptr(), v.data_ptr(), DTYPE_CODES[dtype], B, Sq,
                      H, D, Smax, *k.stride()[:3], *v.stride()[:3],
                      k_codes.data_ptr(), v_codes.data_ptr(),
                      *k_codes.stride()[:3], *v_codes.stride()[:3],
                      k_scale.data_ptr(), v_scale.data_ptr(),
                      *k_scale.stride()[:3], *v_scale.stride()[:3],
                      pos_ptr, pos_scalar,
                      torch.cuda.current_stream(k.device).cuda_stream), D)


decode_attn = _DecodeAttn()
chunk_attn = _ChunkAttn()
decode_attn_int8 = _DecodeAttnInt8()
chunk_attn_int8 = _ChunkAttnInt8()
quantize_kv_append = _QuantizeKvAppend()


def cached_attention(q, cache_k, cache_v, pos: Pos,
                     sm_scale: Optional[float] = None,
                     k_scale=None, v_scale=None,
                     window: Optional[int] = None,
                     slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Sq, H, D] over a padded cache [B, S_max, H, D], visibility
    <= pos + i; ``pos`` an int or an int32 [B] tensor on q's device.  With
    ``k_scale``/``v_scale`` ([B, S_max, H, 1] fp32) the cache holds int8
    codes.  ``window`` (an int, clamped to >= 1 as the JAX wrapper does)
    bands visibility to ``0 <= pos + i - j < window``; ``slopes`` ([H]
    fp32, on q's device) adds ALiBi's ``-slopes[h] * (pos + i - j)``."""
    int8 = k_scale is not None or v_scale is not None
    if int8 and (k_scale is None or v_scale is None):
        raise ValueError("cached_attention: an int8 cache needs both "
                         "k_scale and v_scale")
    if window is not None:
        window = max(int(window), 1)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scales = (k_scale, v_scale) if int8 else ()
    extra = () if slopes is None else (slopes,)
    if on_cuda(q, cache_k, cache_v, *scales, *extra):
        if int8:
            kernel = decode_attn_int8 if q.shape[1] == 1 else chunk_attn_int8
        else:
            kernel = decode_attn if q.shape[1] == 1 else chunk_attn
        return kernel(q, cache_k, cache_v, pos, scale, *scales,
                      window=window, slopes=slopes)
    if int8:
        cache_k = dequantize_kv(cache_k, k_scale, q.dtype)
        cache_v = dequantize_kv(cache_v, v_scale, q.dtype)
    return cached_attention_reference(q, cache_k, cache_v, pos, scale,
                                      window, slopes)
