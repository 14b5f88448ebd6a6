"""Flash attention, forward and backward: the port of
``ops/pallas/flash_attention.py``.

``flash_attention(q, k, v, causal, sm_scale)`` on [B, S, H, D] returns
``(O, lse)``: O in the input dtype, lse [B, H, Sq] fp32.  CUDA tensors go
to the hand-written ``flash_fwd`` kernel (``csrc/flash_fwd.cu``, replacing
the TPU ``_fwd_kernel``), which reads q, k, v through their strides; CPU
tensors go to the plain version beside it.  Every shape takes the kernel:
the TPU tiling gates (``_pick_block``, ``FLASH_MIN_SEQ``) do not carry
over.

The gradient is a ``torch.autograd.Function`` (the JAX ``custom_vjp`` at
``flash_attention.py:510``) that saves q, k, v, O and lse.  Its backward
computes delta = rowsum(dO·O) in plain torch, as the JAX package does
outside Pallas, then runs the two-kernel backward: ``flash_bwd_dq``
(``csrc/flash_bwd_dq.cu``, replacing ``_bwd_dq_kernel``) and
``flash_bwd_dkv`` (``csrc/flash_bwd_dkv.cu``, replacing ``_bwd_dkv_kernel``).
:func:`flash_attention_qkv` takes the packed [B, S, 3, H, D] product of a
qkv projection and writes dq, dk and dv into one gradient of that shape.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

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
        s = s.masked_fill(~_causal_mask(Sq, Sk, q.device), float("-inf"))
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


def _causal_mask(Sq: int, Sk: int, device) -> torch.Tensor:
    """[Sq, Sk] end-aligned causal visibility (key j seen by query i iff
    j <= i + Sk - Sq)."""
    return torch.ones(Sq, Sk, dtype=torch.bool, device=device).tril(Sk - Sq)


def flash_attention_backward_reference(q, k, v, o, lse, do, causal: bool,
                                       scale: float):
    """The plain version of the two backward kernels: (dq, dk, dv) in the
    input dtype from the saved O and lse, with the JAX kernels' rounding
    (``flash_attention.py:283-287, 359-367``): scores in fp32,
    p = exp(s·scale − lse), dV from p rounded to the input dtype, and
    dS = round(p·(dP − delta)·scale).  Rows with no visible key (lse =
    −inf) give zero gradients."""
    dtype = q.dtype
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = torch.isfinite(lse)[..., None].expand_as(s)
    if causal:
        vis = vis & _causal_mask(Sq, Sk, q.device)
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


class _FlashBwdDq:
    """The ``flash_bwd_dq`` kernel's wrapper: writes dq (a fresh tensor, or
    the strided ``out`` view) from q, k, v, dO, lse and delta."""

    launches = 0

    def __call__(self, q, k, v, do, lse, delta, causal: bool, scale: float,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype, (B, Sq, Sk, H, D) = _check_bwd("flash_bwd_dq", q, k, v, do,
                                              lse, delta)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
            if out is None else out
        check_kernel_inputs("flash_bwd_dq", q, dq)
        fn = build.function("flash_bwd_dq", _DQ_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    *_strides3(q, k, v, do, dq), float(scale),
                    int(bool(causal)),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_bwd_dq", status)
        _FlashBwdDq.launches += 1
        return dq


class _FlashBwdDkv:
    """The ``flash_bwd_dkv`` kernel's wrapper: writes dk and dv (fresh
    tensors, or the strided ``out`` views)."""

    launches = 0

    def __call__(self, q, k, v, do, lse, delta, causal: bool, scale: float,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype, (B, Sq, Sk, H, D) = _check_bwd("flash_bwd_dkv", q, k, v, do,
                                              lse, delta)
        if out is None:
            dk = torch.empty_like(k, memory_format=torch.contiguous_format)
            dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        else:
            dk, dv = out
        check_kernel_inputs("flash_bwd_dkv", k, dk, dv)
        fn = build.function("flash_bwd_dkv", _DKV_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), DTYPE_CODES[dtype], B, Sq, Sk, H, D,
                    *_strides3(q, k, v, do, dk, dv), float(scale),
                    int(bool(causal)),
                    torch.cuda.current_stream(q.device).cuda_stream)
        build.check_status("flash_bwd_dkv", status)
        _FlashBwdDkv.launches += 1
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
    for t in (lse, delta):
        if (t.dtype != torch.float32 or t.shape != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 "
                             f"[B, H, Sq] = {(B, H, Sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return dtype, (B, Sq, Sk, H, D)


def _strides3(*tensors):
    """The (batch, seq, head) strides of each [B, S, H, D] tensor."""
    return [s for t in tensors for s in t.stride()[:3]]


_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 18
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
flash_bwd_dq = _FlashBwdDq()
flash_bwd_dkv = _FlashBwdDkv()


def _forward(q, k, v, causal, scale):
    if on_cuda(q, k, v):
        return flash_fwd(q, k, v, causal, scale)
    return flash_attention_reference(q, k, v, causal, scale)


def flash_attention_backward(q, k, v, o, lse, do, causal: bool, scale: float,
                             out: Optional[Sequence[torch.Tensor]] = None):
    """(dq, dk, dv) from the forward's saved O and lse.  On CUDA the two
    kernels write into ``out`` (three [B, S, H, D] views) when given;
    on the CPU the plain version runs and is copied into ``out``."""
    if not on_cuda(q, k, v, o, lse, do):
        grads = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal, scale)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return tuple(out)
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
            st % (16 // do.element_size()) for st in do.stride()[:-1]):
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                      out=None if out is None else out[0])
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                           out=None if out is None else (out[1], out[2]))
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Attention over separate q, k, v [B, S, H, D]; gradients in three
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashQKV(torch.autograd.Function):
    """Self-attention over the packed [B, S, 3, H, D] qkv product; its
    gradient is one tensor of that shape, which the backward kernels write
    in place through strided views.  ``saved`` = (O, lse) from an earlier
    forward of the same qkv replays that forward without a kernel launch
    (the remat policy ``attn_out``)."""

    @staticmethod
    def forward(ctx, qkv, causal, scale, saved):
        if saved is None:
            o, lse = _forward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal, scale)
        else:
            o, lse = (t.detach() for t in saved)
        ctx.save_for_backward(qkv, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        flash_attention_backward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 o, lse, do, ctx.causal, ctx.scale,
                                 out=dqkv.unbind(2))
        return dqkv, None, None, None


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-linear attention. q, k, v: [B, S, H, D] → (O [B, Sq, H, D],
    lse [B, H, Sq] fp32).  Causal masking is end-aligned (a query attends
    to the last ``Sq`` positions of ``Sk``).  Differentiable in q, k, v."""
    return _Flash.apply(q, k, v, causal, _scale(q.shape[-1], sm_scale))


def flash_attention_qkv(qkv, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        saved: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention on the packed qkv [B, S, 3, H, D] → (O, lse), with
    one [B, S, 3, H, D] gradient.  ``saved`` = (O, lse) of an earlier
    forward on the same qkv skips the forward kernel (activation remat)."""
    return _FlashQKV.apply(qkv, causal, _scale(qkv.shape[-1], sm_scale),
                           saved)
