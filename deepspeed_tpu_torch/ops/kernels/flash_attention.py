"""Flash attention, forward and backward: the port of
``ops/pallas/flash_attention.py``.

``flash_attention(q, k, v, causal, sm_scale, kv_lens, window)`` on
[B, S, H, D] returns ``(O, lse)``: O in the input dtype, lse [B, H, Sq]
fp32.  ``kv_lens`` [B] (optional; the right-padded MLM batch) hides the
keys of row b at or past max(1, kv_lens[b]), with causal where both are
given; query rows past the length still attend to the live keys, as in
JAX (``flash_attention.py:582-637``).  ``window`` (causal only, clamped to
>= 1; GPT-Neo's local layers) hides the keys at a distance of ``window``
or more: all three kernels take it as a launch argument and never load
the tiles wholly outside a tile's band.  CUDA tensors go
to the hand-written ``flash_fwd`` kernel (``csrc/flash_fwd.cu``, replacing
the TPU ``_fwd_kernel``), which reads q, k, v through their strides: in
bf16 and fp16 with wgmma tensor-core products on tiles that TMA loads
(``csrc/hopper.cuh``), in fp32 on FMAs; CPU tensors go to the plain
version beside it.  Every shape takes the kernel:
the TPU tiling gates (``_pick_block``, ``FLASH_MIN_SEQ``) do not carry
over.

The gradient is a ``torch.autograd.Function`` (the JAX ``custom_vjp`` at
``flash_attention.py:510``) that saves q, k, v, O and lse
(:class:`AttentionFn`, shared with the block-sparse kernels).  Its backward
computes delta = rowsum(dO·O) in plain torch, as the JAX package does
outside Pallas, then takes one of the JAX package's two backward forms by
its rule (``flash_attention.py:397, 415-416``): while the keys span at
most ``MAX_FUSED_BWD_NK`` = 4 blocks of ``FUSED_BWD_BLOCK_K`` = 1024
(:func:`fused_backward`: Sk <= 4096) the fused single sweep,
``flash_bwd_fused`` (``csrc/flash_bwd_fused.cu``, replacing
``_bwd_dkv_kernel`` with ``emit_dq``: dK, dV and dQ in one pass over the
queries, the key tiles' dQ shares summed in a fixed order); past that the
two-kernel form, ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``, replacing
``_bwd_dq_kernel``) and ``flash_bwd_dkv`` (``csrc/flash_bwd_dkv.cu``,
replacing ``_bwd_dkv_kernel``).  All three run on wgmma and TMA in bf16
and fp16, as the forward, and on FMAs in fp32; a window reaches them as it
reaches the forward.  On the CPU both forms are one plain version.
:func:`flash_attention_qkv` takes the packed [B, S, 3, H, D] product of a
qkv projection and writes dq, dk and dv into one gradient of that shape.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import build
from .utils import (DTYPE_CODES, check_kernel_inputs, check_stats,
                    count_head_dim, on_cuda, softmax_scale, strides3,
                    tile_dim)


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense softmax attention, the plain version [B, S, H, D]: scores in
    fp32, causal end-aligned, keys past ``kv_lens`` hidden, p rounded to
    the input dtype before P·V, rows with no visible key give zeros."""
    return flash_attention_reference(q, k, v, causal, sm_scale, kv_lens)[0]


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              kv_lens: Optional[torch.Tensor] = None,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_attention`: (O, lse [B, H, Sq]
    fp32, -inf on rows with no visible key)."""
    scale = softmax_scale(q.shape[-1], sm_scale)
    return masked_attention_reference(
        q, k, v, _visibility(q.shape[1], k.shape[1], causal, kv_lens,
                             q.device, window), scale)


def masked_attention_reference(q, k, v, mask: Optional[torch.Tensor],
                               scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention on [B, S, H, D] under a visibility mask (bool,
    broadcast against the [B, H, Sq, Sk] scores; None = every key): scores
    in fp32, p rounded to the input dtype before P·V, rows with no visible
    key give zeros and lse = -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
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


def _causal_mask(Sq: int, Sk: int, device,
                 window: Optional[int] = None) -> torch.Tensor:
    """[Sq, Sk] end-aligned causal visibility (key j seen by query i iff
    j <= i + Sk - Sq), banded to i + Sk - Sq - j < ``window`` when given
    (JAX ``_band_lower_mask``)."""
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device).tril(Sk - Sq)
    if window is not None:
        mask = mask & ~torch.ones_like(mask).tril(Sk - Sq - window)
    return mask


def _visibility(Sq: int, Sk: int, causal: bool,
                kv_lens: Optional[torch.Tensor], device,
                window: Optional[int] = None) -> Optional[torch.Tensor]:
    """The visibility mask that broadcasts against [B, H, Sq, Sk]
    scores: causal [Sq, Sk] (banded by ``window``), and with ``kv_lens``
    [B] the keys of row b before max(1, kv_lens[b]) ([B, 1, 1 or Sq, Sk]);
    None: every key."""
    mask = _causal_mask(Sq, Sk, device, window) if causal else None
    if kv_lens is None:
        return mask
    lens = torch.clamp(kv_lens.to(device=device, dtype=torch.long), min=1)
    live = (torch.arange(Sk, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    return live if mask is None else live & mask


def flash_attention_backward_reference(q, k, v, o, lse, do, causal: bool,
                                       scale: float,
                                       kv_lens: Optional[torch.Tensor] = None,
                                       window: Optional[int] = None):
    """The plain version of the two backward kernels: (dq, dk, dv) in the
    input dtype from the saved O and lse (see
    :func:`masked_attention_backward_reference`), causal visibility banded
    by ``window`` when given."""
    return masked_attention_backward_reference(
        q, k, v, o, lse, do,
        _visibility(q.shape[1], k.shape[1], causal, kv_lens, q.device,
                    window), scale)


def masked_attention_backward_reference(q, k, v, o, lse, do,
                                        mask: Optional[torch.Tensor],
                                        scale: float):
    """(dq, dk, dv) of :func:`masked_attention_reference` from its saved O
    and lse, with the JAX kernels' rounding (``flash_attention.py:283-287,
    359-367``): scores in fp32, p = exp(s·scale − lse), dV from p rounded
    to the input dtype, and dS = round(p·(dP − delta)·scale).  Rows with no
    visible key (lse = −inf) give zero gradients."""
    dtype = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = torch.isfinite(lse)[..., None].expand_as(s)
    if mask is not None:
        vis = vis & mask
    safe_lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(vis, torch.exp(s - safe_lse[..., None]),
                    torch.zeros_like(s))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)      # [B, H, Sq]
    ds = (p * (dp - delta[..., None]) * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _lens_arg(name: str, kv_lens: Optional[torch.Tensor], B: int, device):
    """``kv_lens`` as the kernels read it: contiguous int32 [B] on the
    inputs' device (None stays None)."""
    if kv_lens is None:
        return None
    if kv_lens.shape != (B,) or kv_lens.is_floating_point():
        raise ValueError(f"{name}: kv_lens must be an integer [B] = [{B}] "
                         f"tensor, got {kv_lens.dtype} {tuple(kv_lens.shape)}")
    if kv_lens.device != device:
        raise ValueError(f"{name}: kv_lens on {kv_lens.device}, inputs on "
                         f"{device}")
    return kv_lens.to(torch.int32).contiguous()


class _FlashFwd:
    """The ``flash_fwd`` kernel's wrapper; ``launches`` counts kernel
    launches (never plain-version calls), ``option_launches`` those with
    a window, ``dim_launches`` those at each head dim."""

    launches = 0
    option_launches = {"window": 0}
    dim_launches: dict = {}

    def __call__(self, q, k, v, causal: bool, scale: float,
                 kv_lens: Optional[torch.Tensor] = None,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = check_kernel_inputs("flash_fwd", q, k, v)
        _check_window("flash_fwd", causal, window)
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        if k.shape != (B, Sk, H, D) or v.shape != k.shape:
            raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)}")
        lens = _lens_arg("flash_fwd", kv_lens, B, q.device)
        o = torch.empty((B, Sq, H, D), dtype=dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        fn = build.function("flash_fwd", _ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), None if lens is None else lens.data_ptr(),
                    DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    o.stride(0), o.stride(1), o.stride(2),
                    float(scale), int(bool(causal)), _window_code(window),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_fwd", status)
        _FlashFwd.launches += 1
        count_head_dim(_FlashFwd, D)
        if window is not None:
            _FlashFwd.option_launches["window"] += 1
        return o, lse


def _check_window(name: str, causal: bool, window: Optional[int]) -> None:
    if window is not None and (not causal or int(window) < 1):
        raise ValueError(f"{name}: window {window} needs causal attention "
                         "and a width >= 1")


def _window_code(window: Optional[int]) -> int:
    """``window`` as the kernels take it: 0 for none."""
    return 0 if window is None else int(window)


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
flash_fwd = _FlashFwd()


class _FlashBwdDq:
    """The ``flash_bwd_dq`` kernel's wrapper: writes dq (a fresh tensor, or
    the strided ``out`` view) from q, k, v, dO, lse and delta;
    ``option_launches`` counts the launches with a window."""

    launches = 0
    option_launches = {"window": 0}
    dim_launches: dict = {}

    def __call__(self, q, k, v, do, lse, delta, causal: bool, scale: float,
                 out: Optional[torch.Tensor] = None,
                 kv_lens: Optional[torch.Tensor] = None,
                 window: Optional[int] = None) -> torch.Tensor:
        dtype, (B, Sq, Sk, H, D) = _check_bwd("flash_bwd_dq", q, k, v, do,
                                              lse, delta)
        _check_window("flash_bwd_dq", causal, window)
        lens = _lens_arg("flash_bwd_dq", kv_lens, B, q.device)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
            if out is None else out
        check_kernel_inputs("flash_bwd_dq", q, dq)
        fn = build.function("flash_bwd_dq", _DQ_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    None if lens is None else lens.data_ptr(), dq.data_ptr(),
                    DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    *strides3(q, k, v, do, dq), float(scale),
                    int(bool(causal)), _window_code(window),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_bwd_dq", status)
        _FlashBwdDq.launches += 1
        count_head_dim(_FlashBwdDq, D)
        if window is not None:
            _FlashBwdDq.option_launches["window"] += 1
        return dq


class _FlashBwdDkv:
    """The ``flash_bwd_dkv`` kernel's wrapper: writes dk and dv (fresh
    tensors, or the strided ``out`` views); ``option_launches`` counts the
    launches with a window."""

    launches = 0
    option_launches = {"window": 0}
    dim_launches: dict = {}

    def __call__(self, q, k, v, do, lse, delta, causal: bool, scale: float,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 kv_lens: Optional[torch.Tensor] = None,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype, (B, Sq, Sk, H, D) = _check_bwd("flash_bwd_dkv", q, k, v, do,
                                              lse, delta)
        _check_window("flash_bwd_dkv", causal, window)
        lens = _lens_arg("flash_bwd_dkv", kv_lens, B, q.device)
        if out is None:
            dk = torch.empty_like(k, memory_format=torch.contiguous_format)
            dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        else:
            dk, dv = out
        check_kernel_inputs("flash_bwd_dkv", k, dk, dv)
        fn = build.function("flash_bwd_dkv", _DKV_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    None if lens is None else lens.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    *strides3(q, k, v, do, dk, dv), float(scale),
                    int(bool(causal)), _window_code(window),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_bwd_dkv", status)
        _FlashBwdDkv.launches += 1
        count_head_dim(_FlashBwdDkv, D)
        if window is not None:
            _FlashBwdDkv.option_launches["window"] += 1
        return dk, dv


def _check_bwd(name, q, k, v, do, lse, delta):
    dtype = check_kernel_inputs(name, q, k, v, do)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if (k.shape != (B, Sk, H, D) or v.shape != k.shape
            or do.shape != q.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, dO "
                         f"{tuple(do.shape)}")
    check_stats(name, (B, H, Sq), lse, delta)
    return dtype, (B, Sq, Sk, H, D)


#: the JAX package's backward rule (``flash_attention.py:397``,
#: ``MAX_FUSED_BWD_NK``; ``resolve_env_blocks``, :546-555, the default
#: ``block_k``): the fused single sweep while the keys span at most this
#: many blocks of ``FUSED_BWD_BLOCK_K``
MAX_FUSED_BWD_NK = 4
FUSED_BWD_BLOCK_K = 1024


def fused_backward(Sk: int) -> bool:
    """True where the backward takes the fused single sweep
    (``flash_bwd_fused``): ceil(Sk / 1024) <= 4, that is Sk <= 4096."""
    return -(-int(Sk) // FUSED_BWD_BLOCK_K) <= MAX_FUSED_BWD_NK


#: the q-tile of the fused kernels (``csrc/flash_bwd_fused.cu``): the
#: tensor-core kernel's (bf16, fp16; ``FusedCfg::BQ``) at every head dim,
#: the fp32 FMA kernel's (``FmaTile::BQ``) by its padded row
FUSED_TC_Q_TILE = 64
FUSED_FMA_Q_TILE = {32: 64, 64: 64, 128: 32}


def fused_q_tile(D: int, dtype: torch.dtype) -> int:
    """The q-tile of the fused kernel that takes ``dtype`` at head dim
    ``D``."""
    if dtype == torch.float32:
        return FUSED_FMA_Q_TILE[tile_dim(D)]
    return FUSED_TC_Q_TILE


def fused_workspace(B: int, Sq: int, H: int, D: int,
                    dtype: torch.dtype) -> Tuple[int, int]:
    """(fp32 elements of the sum, int32 counters) the fused kernel of
    ``dtype`` needs: one [q-tile, tile_dim(D)] sum and one counter per
    (b, h, q-tile)."""
    bq = fused_q_tile(D, dtype)
    tiles = B * H * -(-Sq // bq)
    return tiles * bq * tile_dim(D), tiles


#: the fused kernel's counters per device: zero before its first launch,
#: and each launch leaves them zero
_counters: dict = {}


def _fused_counters(device, n: int) -> torch.Tensor:
    have = _counters.get(device)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_bwd_fused: the counters must be "
                               "allocated before a graph capture")
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = have
    return have


class _FlashBwdFused:
    """The ``flash_bwd_fused`` kernel's wrapper: writes dq, dk and dv (fresh
    tensors, or the strided ``out`` views) in one sweep; the fp32 sum of
    the key tiles' dq shares is a transient workspace.  ``wait_cycles`` (a
    uint64-sized int64 CUDA tensor of one element) collects the cycles
    CTAs spent waiting for their turn in that sum.  ``option_launches``
    counts the launches with a window."""

    launches = 0
    option_launches = {"window": 0}
    dim_launches: dict = {}

    def __call__(self, q, k, v, do, lse, delta, causal: bool, scale: float,
                 out: Optional[Sequence[torch.Tensor]] = None,
                 kv_lens: Optional[torch.Tensor] = None,
                 window: Optional[int] = None,
                 wait_cycles: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dtype, (B, Sq, Sk, H, D) = _check_bwd("flash_bwd_fused", q, k, v, do,
                                              lse, delta)
        _check_window("flash_bwd_fused", causal, window)
        lens = _lens_arg("flash_bwd_fused", kv_lens, B, q.device)
        if out is None:
            dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                          for t in (q, k, v))
        else:
            dq, dk, dv = out
        check_kernel_inputs("flash_bwd_fused", q, dq)
        check_kernel_inputs("flash_bwd_fused", k, dk, dv)
        if wait_cycles is not None and (wait_cycles.dtype != torch.int64
                                        or wait_cycles.device != q.device):
            raise ValueError("flash_bwd_fused: wait_cycles must be an int64 "
                             "tensor on the inputs' device")
        n_acc, tiles = fused_workspace(B, Sq, H, D, q.dtype)
        acc = torch.empty(n_acc, dtype=torch.float32, device=q.device)
        counters = _fused_counters(q.device, tiles)
        fn = build.function("flash_bwd_fused", _FUSED_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    None if lens is None else lens.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), acc.data_ptr(),
                    counters.data_ptr(),
                    None if wait_cycles is None else wait_cycles.data_ptr(),
                    DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    *strides3(q, k, v, do, dq, dk, dv), float(scale),
                    int(bool(causal)), _window_code(window),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_bwd_fused", status)
        _FlashBwdFused.launches += 1
        count_head_dim(_FlashBwdFused, D)
        if window is not None:
            _FlashBwdFused.option_launches["window"] += 1
        return dq, dk, dv


_DQ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 18
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
_FUSED_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 21
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
flash_bwd_dq = _FlashBwdDq()
flash_bwd_dkv = _FlashBwdDkv()
flash_bwd_fused = _FlashBwdFused()


def _forward(q, k, v, causal, scale, kv_lens=None, window=None):
    if on_cuda(q, k, v):
        return flash_fwd(q, k, v, causal, scale, kv_lens, window)
    return flash_attention_reference(q, k, v, causal, scale, kv_lens, window)


def aligned_do_and_delta(do, o):
    """dO as the kernels take it (unit-stride head dim, 16-byte aligned
    rows; copied only when it is not) and delta = rowsum(dO·O) in fp32
    [B, H, S], computed outside the kernels as the JAX package does."""
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
            st % (16 // do.element_size()) for st in do.stride()[:-1]):
        do = do.contiguous()
    return do, (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward(q, k, v, o, lse, do, causal: bool, scale: float,
                             out: Optional[Sequence[torch.Tensor]] = None,
                             kv_lens: Optional[torch.Tensor] = None,
                             window: Optional[int] = None):
    """(dq, dk, dv) from the forward's saved O and lse.  On CUDA the
    kernels write into ``out`` (three [B, S, H, D] views) when given:
    ``flash_bwd_fused`` where :func:`fused_backward` holds for Sk, else
    ``flash_bwd_dq`` and ``flash_bwd_dkv``, at every head dim the forward
    takes.  On the CPU the plain version (the same function) runs and is
    copied into ``out``."""
    if not on_cuda(q, k, v, o, lse, do):
        grads = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal, scale, kv_lens,
                                                   window)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return tuple(out)
    do, delta = aligned_do_and_delta(do, o)
    if fused_backward(k.shape[1]):
        return flash_bwd_fused(q, k, v, do, lse, delta, causal, scale,
                               out=out, kv_lens=kv_lens, window=window)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                      out=None if out is None else out[0], kv_lens=kv_lens,
                      window=window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                           out=None if out is None else (out[1], out[2]),
                           kv_lens=kv_lens, window=window)
    return dq, dk, dv


class AttentionFn(torch.autograd.Function):
    """Attention over separate q, k, v [B, S, H, D] given its two halves:
    ``fwd(q, k, v)`` → (O, lse) and ``bwd(q, k, v, o, lse, do, out=None)``
    → (dq, dk, dv).  Saves q, k, v, O and lse; lse has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, fwd: Callable, bwd: Callable):
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ctx.bwd(q, k, v, o, lse, do), None, None)


class PackedAttentionFn(torch.autograd.Function):
    """Self-attention over the packed [B, S, 3, H, D] qkv product, halves
    as in :class:`AttentionFn`; its gradient is one tensor of that shape,
    which the backward kernels write in place through strided views.
    ``saved`` = (O, lse) from an earlier forward of the same qkv replays
    that forward without a kernel launch (the remat policy ``attn_out``)."""

    @staticmethod
    def forward(ctx, qkv, fwd: Callable, bwd: Callable, saved):
        if saved is None:
            o, lse = fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        else:
            o, lse = (t.detach() for t in saved)
        ctx.save_for_backward(qkv, o, lse)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        ctx.bwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], o, lse, do,
                out=dqkv.unbind(2))
        return dqkv, None, None, None


def _halves(causal: bool, scale: float, kv_lens=None, window=None):
    return (lambda q, k, v: _forward(q, k, v, causal, scale, kv_lens, window),
            lambda q, k, v, o, lse, do, out=None: flash_attention_backward(
                q, k, v, o, lse, do, causal, scale, out=out, kv_lens=kv_lens,
                window=window))


def _window_arg(causal: bool, window) -> Optional[int]:
    """``window`` clamped to >= 1, causal only (JAX
    ``flash_attention.py:619-621``)."""
    if window is None:
        return None
    if not causal:
        raise ValueError("window masking is defined for causal attention")
    return max(int(window), 1)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-linear attention. q, k, v: [B, S, H, D] → (O [B, Sq, H, D],
    lse [B, H, Sq] fp32).  Causal masking is end-aligned (a query attends
    to the last ``Sq`` positions of ``Sk``); ``kv_lens`` [B] hides keys at
    or past max(1, kv_lens[b]); ``window`` bands causal visibility to
    ``0 <= i + Sk - Sq - j < window``.  Differentiable in q, k, v."""
    return AttentionFn.apply(q, k, v, *_halves(
        causal, softmax_scale(q.shape[-1], sm_scale), kv_lens,
        _window_arg(causal, window)))


def flash_attention_qkv(qkv, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        saved: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        kv_lens: Optional[torch.Tensor] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention on the packed qkv [B, S, 3, H, D] → (O, lse), with
    one [B, S, 3, H, D] gradient.  ``saved`` = (O, lse) of an earlier
    forward on the same qkv skips the forward kernel (activation remat);
    ``kv_lens`` and ``window`` as in :func:`flash_attention`."""
    return PackedAttentionFn.apply(qkv, *_halves(
        causal, softmax_scale(qkv.shape[-1], sm_scale), kv_lens,
        _window_arg(causal, window)), saved)
