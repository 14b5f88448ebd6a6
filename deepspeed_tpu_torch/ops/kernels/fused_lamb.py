"""Fused LAMB over flat buffers: the port of ``ops/pallas/fused_lamb.py``.

:func:`fused_lamb` runs one LAMB step in place over flat fp32 buffers: the
master params ``p``, the gradient accumulator ``g`` (zeroed by the step),
the moments ``m`` and ``v``, and optionally a compute-dtype copy of ``p``.
``segments`` are the tensors' (offset, numel) pairs, which must tile the
buffer; each segment takes its own trust ratio, the per-tensor
``lamb_coeff`` of the reference (the JAX package's per-leaf ratio).  The
scalars stay on the device: ``hyper`` = (lr, β1, β2, eps, weight_decay,
bc1, bc2, max_coeff, min_coeff) fp32 [9]; an optional ``gscale`` [] that
multiplies g first; an optional ``skip`` [] bool (the overflow flag) that
leaves p, m, v and the copy untouched.

CUDA tensors launch the two hand-written kernels of ``csrc/fused_lamb.cu``
(``fused_lamb_phase1`` and ``fused_lamb_phase2``, replacing the TPU
``_lamb_phase1`` and ``_lamb_phase2``) over a table of chunks that never
cross a segment (:class:`LambPlan`, built on the host once per segment
list and device); CPU tensors run the plain version beside them, the
non-Pallas branch of the JAX ``fused_lamb_step``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .fused_adam import adam_hyper_values
from .utils import DTYPE_CODES, on_cuda

#: the most elements one CTA of either phase covers (``csrc/fused_lamb.cu``)
CHUNK = 16384

Segments = Tuple[Tuple[int, int], ...]


def lamb_hyper_values(lr: float, beta1: float, beta2: float, eps: float,
                      weight_decay: float, step: int,
                      bias_correction: bool = True, max_coeff: float = 10.0,
                      min_coeff: float = 0.01) -> list:
    """The 9 scalars of one step; ``step`` is the post-increment count."""
    return adam_hyper_values(lr, beta1, beta2, eps, weight_decay, step,
                             bias_correction) + [max_coeff, min_coeff]


def lamb_hyper(lr: float, beta1: float, beta2: float, eps: float,
               weight_decay: float, step: int, bias_correction: bool = True,
               max_coeff: float = 10.0, min_coeff: float = 0.01,
               device=None) -> torch.Tensor:
    """:func:`lamb_hyper_values` as the fp32 [9] tensor the step reads."""
    return torch.tensor(lamb_hyper_values(lr, beta1, beta2, eps,
                                          weight_decay, step, bias_correction,
                                          max_coeff, min_coeff),
                        dtype=torch.float32, device=device)


def check_segments(segments: Sequence[Tuple[int, int]], n: int) -> Segments:
    """``segments`` as a tuple of (offset, numel), checked to tile
    [0, n) in order."""
    segs = tuple((int(o), int(c)) for o, c in segments)
    end = 0
    for off, numel in segs:
        if off != end or numel < 0:
            raise ValueError(f"LAMB segments must tile the buffer in order: "
                             f"({off}, {numel}) after offset {end}")
        end += numel
    if end != n:
        raise ValueError(f"LAMB segments cover {end} of {n} elements")
    return segs


def fused_lamb_reference(p, g, m, v, hyper, segments, p_compute=None,
                         gscale=None, skip=None,
                         eps_inside_sqrt: bool = False) -> None:
    """The plain version of :func:`fused_lamb`: the same fp32 math, in
    place, with each segment's norms summed by ``torch.sum``."""
    lr, beta1, beta2, eps, wd, bc1, bc2, max_coeff, min_coeff = hyper.unbind()
    grad = g * gscale if gscale is not None else g
    m_new = beta1 * m + (1.0 - beta1) * grad
    v_new = beta2 * v + (1.0 - beta2) * grad * grad
    denom = torch.sqrt(v_new / bc2 + eps) if eps_inside_sqrt \
        else torch.sqrt(v_new / bc2) + eps
    u = (m_new / bc1) / denom + wd * p
    ratio = torch.empty_like(p)
    for off, numel in segments:
        w_norm = p[off:off + numel].square().sum().sqrt()
        u_norm = u[off:off + numel].square().sum().sqrt()
        clipped = torch.minimum(torch.maximum(
            w_norm / torch.clamp(u_norm, min=1e-30), min_coeff), max_coeff)
        ratio[off:off + numel] = torch.where((w_norm > 0) & (u_norm > 0),
                                             clipped, torch.ones_like(clipped))
    p_new = p - lr * ratio * u
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


class LambPlan:
    """The chunk table of one segment list on one device, and the scratch
    the two phases share: per-chunk partial sums [n_chunks, 2] and the
    per-segment trust ratios [n_seg].  Chunks hold at most :data:`CHUNK`
    elements and never cross a segment; empty segments have none."""

    def __init__(self, segments: Segments, device):
        begin, end, seg, first = [], [], [], [0]
        for s, (off, numel) in enumerate(segments):
            starts = np.arange(off, off + numel, CHUNK, dtype=np.int64)
            begin.append(starts)
            end.append(np.minimum(starts + CHUNK, off + numel))
            seg.append(np.full(len(starts), s, dtype=np.int64))
            first.append(first[-1] + len(starts))
        self.n_chunks = first[-1]
        self.n_seg = len(segments)
        table = np.concatenate(begin + end + seg + [np.asarray(first)])
        self.table = torch.from_numpy(table).to(device)
        c = self.n_chunks
        self.begin, self.end, self.seg, self.seg_first = (
            self.table[:c], self.table[c:2 * c], self.table[2 * c:3 * c],
            self.table[3 * c:])
        self.partials = torch.empty(2 * c, dtype=torch.float32, device=device)
        self.ratio = torch.empty(self.n_seg, dtype=torch.float32,
                                 device=device)


_plans: Dict[Tuple[Segments, str], LambPlan] = {}


def lamb_plan(segments: Segments, device) -> LambPlan:
    """The cached :class:`LambPlan` of ``segments`` on ``device``: built
    once, not at every step."""
    key = (segments, str(torch.device(device)))
    if key not in _plans:
        _plans[key] = LambPlan(segments, device)
    return _plans[key]


def _check_flat(name, n, **tensors):
    for tname, t in tensors.items():
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.numel() != n or t.data_ptr() % 16):
            raise ValueError(f"{name}: {tname} must be a contiguous, 16-byte "
                             f"aligned fp32 buffer of {n} elements (got "
                             f"{t.dtype}, {t.numel()})")


def _check_scalars(name, hyper, gscale=None, skip=None):
    if hyper.dtype != torch.float32 or hyper.numel() != 9:
        raise ValueError(f"{name}: hyper must be fp32 [9]")
    if gscale is not None and (gscale.dtype != torch.float32
                               or gscale.numel() != 1):
        raise ValueError(f"{name}: gscale must be one fp32 scalar")
    if skip is not None and (skip.dtype != torch.bool or skip.numel() != 1):
        raise ValueError(f"{name}: skip must be one bool")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _FusedLambPhase1:
    """The ``fused_lamb_phase1`` kernel's wrapper: moments, zeroed
    gradient and per-chunk partial norms; ``launches`` counts launches."""

    launches = 0

    def __call__(self, p, g, m, v, hyper, plan: LambPlan, gscale=None,
                 skip=None, eps_inside_sqrt: bool = False) -> None:
        _check_flat("fused_lamb_phase1", p.numel(), p=p, g=g, m=m, v=v)
        _check_scalars("fused_lamb_phase1", hyper, gscale, skip)
        fn = build.function("fused_lamb", _PHASE1_ARGTYPES,
                            "fused_lamb_phase1")
        status = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    plan.begin.data_ptr(), plan.end.data_ptr(),
                    plan.partials.data_ptr(), plan.n_chunks,
                    hyper.data_ptr(), _ptr(gscale), _ptr(skip),
                    int(bool(eps_inside_sqrt)),
                    torch.cuda.current_stream(p.device).cuda_stream)
        build.check_status("fused_lamb", status)
        _FusedLambPhase1.launches += 1


class _FusedLambPhase2:
    """The ``fused_lamb_phase2`` kernels' wrapper: the per-segment trust
    ratios from phase 1's partials, then p -= lr·ratio·u and the compute
    copy; ``launches`` counts launches."""

    launches = 0

    def __call__(self, p, m, v, hyper, plan: LambPlan, p_compute=None,
                 skip=None, eps_inside_sqrt: bool = False) -> None:
        n = p.numel()
        _check_flat("fused_lamb_phase2", n, p=p, m=m, v=v)
        _check_scalars("fused_lamb_phase2", hyper, skip=skip)
        if p_compute is not None and (
                p_compute.dtype not in DTYPE_CODES
                or not p_compute.is_contiguous() or p_compute.numel() != n
                or p_compute.data_ptr() % (4 * p_compute.element_size())):
            raise ValueError("fused_lamb_phase2: p_compute must be a "
                             "contiguous float buffer of the same size, "
                             "aligned to 4 of its elements")
        fn = build.function("fused_lamb", _PHASE2_ARGTYPES,
                            "fused_lamb_phase2")
        status = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                    _ptr(p_compute),
                    DTYPE_CODES[p_compute.dtype] if p_compute is not None
                    else 0,
                    plan.begin.data_ptr(), plan.end.data_ptr(),
                    plan.seg.data_ptr(), plan.seg_first.data_ptr(),
                    plan.n_seg, plan.partials.data_ptr(),
                    plan.ratio.data_ptr(), plan.n_chunks, hyper.data_ptr(),
                    _ptr(skip), int(bool(eps_inside_sqrt)),
                    torch.cuda.current_stream(p.device).cuda_stream)
        build.check_status("fused_lamb", status)
        _FusedLambPhase2.launches += 1


_PHASE1_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_PHASE2_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
fused_lamb_phase1 = _FusedLambPhase1()
fused_lamb_phase2 = _FusedLambPhase2()


def fused_lamb(p, g, m, v, hyper, segments, p_compute=None, gscale=None,
               skip=None, eps_inside_sqrt: bool = False) -> None:
    """One LAMB step in place over flat buffers (module docstring); the
    two kernels on CUDA tensors, the plain version on CPU tensors."""
    segments = check_segments(segments, p.numel())
    tensors = [t for t in (p, g, m, v, hyper, p_compute, gscale, skip)
               if t is not None]
    if on_cuda(*tensors):
        plan = lamb_plan(segments, p.device)
        fused_lamb_phase1(p, g, m, v, hyper, plan, gscale, skip,
                          eps_inside_sqrt)
        fused_lamb_phase2(p, m, v, hyper, plan, p_compute, skip,
                          eps_inside_sqrt)
    else:
        with torch.no_grad():
            fused_lamb_reference(p, g, m, v, hyper, segments, p_compute,
                                 gscale, skip, eps_inside_sqrt)
