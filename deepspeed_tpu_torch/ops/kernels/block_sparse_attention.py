"""Block-sparse attention, forward and backward: the port of
``ops/pallas/block_sparse_attention.py``.

A per-head [H, n, n] 0/1 block layout (``ops/sparse_attention``) says
which (q-block, k-block) pairs attend; only those are computed.  The host
compiles the layout once into ragged tables (:func:`make_index_tables`,
exactly the JAX package's): for each (head, q-block) its live k-blocks,
and transposed, for each (head, k-block) its live q-blocks.  A
:class:`SparsePlan` holds the layout and the tables as device int32
tensors; plans are cached by the layout's bytes, block, causality and
device (``_PLANS``) and, for a model's ``SparsityConfig``, by the config
object and sequence length (:func:`config_plan`), so the tables are built
once per configuration and length, not in every layer of every step.
``plan_builds`` counts the builds.  A config mutated after its first use
keeps its first plan, as the JAX package's trace-time layout does.

CUDA tensors go to three hand-written kernels (``csrc/block_sparse_*.cu``):
``block_sparse_fwd`` (replacing ``_fwd_kernel``), ``block_sparse_bwd_dq``
(``_bwd_dq_kernel``, the row tables) and ``block_sparse_bwd_dkv``
(``_bwd_dkv_kernel``, the column tables).  They take layout blocks of 16,
32, 64 and 128 (the JAX wrapper's ``block % 128`` gate is a TPU lane rule)
and read q, k, v and dO through their strides.  In bf16 and fp16 all
three run on tensor cores over the plan's tile tables
(:func:`make_tile_tables`: the layout recompiled at 64 x 64 tiles, with
the live sub-blocks of each tile and a heaviest-first launch order); fp32
runs FMA kernels over the block tables.  CPU tensors go to the
plain versions beside them (:func:`block_sparse_attention_reference` and
its backward): masked dense attention under the expanded block mask, the
JAX ``sparse_mha_reference``.  The gradient is the flash kernels'
``torch.autograd.Function`` over these halves;
:func:`block_sparse_attention_qkv` takes the packed [B, S, 3, H, D] qkv
product and writes dq, dk and dv into one gradient of that shape, and
replays an earlier forward from ``saved`` = (O, lse) without a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
from .flash_attention import (AttentionFn, PackedAttentionFn,
                              aligned_do_and_delta,
                              masked_attention_backward_reference,
                              masked_attention_reference)
from .utils import (DTYPE_CODES, check_kernel_inputs, check_stats,
                    count_head_dim, on_cuda, softmax_scale, strides3)

#: the layout block sizes the kernels take (``csrc/block_sparse.cuh``)
BLOCKS = (16, 32, 64, 128)


# ------------------------------------------------------------- index tables

def make_index_tables(layout: np.ndarray, causal: bool, block: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compile a [H, nq, nk] 0/1 layout into ragged sweep tables.

    Returns (idx [H,nq,A], cnt [H,nq], idxT [H,nk,AT], cntT [H,nk]) where A
    is the max live k-blocks of any row (AT: columns).  Causal drops
    above-diagonal blocks here, so the kernel sweeps only what survives.
    """
    layout = np.asarray(layout, bool)
    H, nq, nk = layout.shape
    if causal:
        tri = np.tril(np.ones((nq, nk), bool))
        layout = layout & tri[None]
    cnt = layout.sum(-1).astype(np.int32)                      # [H, nq]
    cntT = layout.sum(1).astype(np.int32)                      # [H, nk]
    A = max(1, int(cnt.max()))
    AT = max(1, int(cntT.max()))
    idx = np.zeros((H, nq, A), np.int32)
    idxT = np.zeros((H, nk, AT), np.int32)
    for h in range(H):
        for qi in range(nq):
            live = np.nonzero(layout[h, qi])[0]
            idx[h, qi, :len(live)] = live
        for ki in range(nk):
            live = np.nonzero(layout[h, :, ki])[0]
            idxT[h, ki, :len(live)] = live
    return idx, cnt, idxT, cntT


#: the tensor-core kernels' tile edge: 64 queries by 64 keys, the wgmma M
#: of one warpgroup (``csrc/block_sparse.cuh``)
TILE = 64


class TileTable(NamedTuple):
    """One direction of :func:`make_tile_tables`, over nt = ceil(S / 64)
    tiles: for each (head, tile) its live tiles of the other side."""

    idx: np.ndarray      # [H, nt, W] ascending live tile ids (zero padded)
    bits: np.ndarray     # [H, nt, W] live sub-blocks of each entry
    cnt: np.ndarray      # [H, nt] live tiles
    order: np.ndarray    # [H * nt] units h * nt + tile, heaviest first

    def packed(self) -> np.ndarray:
        """The entries as the kernels read them: id | bits << 16 (int32)."""
        return (self.idx.astype(np.uint32)
                | (self.bits.astype(np.uint32) << 16)).view(np.int32)


def make_tile_tables(layout: np.ndarray, causal: bool, block: int
                     ) -> Tuple[TileTable, TileTable]:
    """Compile a [H, n, n] 0/1 layout into the tensor-core kernels' tables
    at the unit of a 64 x 64 tile: (rows, columns).  Rows: for each (head,
    64-query tile) the ascending 64-key tiles holding a live, causally
    visible pair; columns: for each 64-key tile its q-tiles.  An entry's
    bits say which (q sub-block i, k sub-block j) of the tile are live, bit
    i * sub + j with sub = 64 / min(block, 64): 16 bits at block 16, 4 at
    32, a single 1 at 64 and 128 (a block of 128 is 2 x 2 tiles, the one
    above a causal diagonal dropped).  S = n * block need not be a multiple
    of 64: sub-blocks past S have no bit.  ``order`` lists the units by
    live count, heaviest first (ties by unit)."""
    layout = np.asarray(layout, bool)
    H, n, _ = layout.shape
    if causal:
        layout = layout & np.tril(np.ones((n, n), bool))[None]
    nt = -(-n * block // TILE)
    if nt > 1 << 16:
        raise ValueError(f"S {n * block} needs {nt} tiles: the tile ids are "
                         f"16 bits")
    if block >= TILE:
        f = block // TILE
        live = np.kron(layout, np.ones((f, f), bool))
        if causal:
            live &= np.tril(np.ones((nt, nt), bool))[None]
        bits = live.astype(np.int64)
    else:
        sub = TILE // block
        padded = np.zeros((H, nt * sub, nt * sub), bool)
        padded[:, :n, :n] = layout
        blocks = padded.reshape(H, nt, sub, nt, sub).transpose(0, 1, 3, 2, 4)
        bits = (blocks.reshape(H, nt, nt, sub * sub).astype(np.int64)
                << np.arange(sub * sub)).sum(-1)
        live = bits != 0
    return (_tile_table(live, bits),
            _tile_table(live.transpose(0, 2, 1), bits.transpose(0, 2, 1)))


def _tile_table(live: np.ndarray, bits: np.ndarray) -> TileTable:
    H, nt, _ = live.shape
    cnt = live.sum(-1).astype(np.int32)
    width = max(1, int(cnt.max()))
    idx = np.zeros((H, nt, width), np.int32)
    tbits = np.zeros((H, nt, width), np.int32)
    h, t, c = np.nonzero(live)                 # row-major: c ascending
    slot = (np.cumsum(live, -1) - 1)[h, t, c]
    idx[h, t, slot] = c
    tbits[h, t, slot] = bits[h, t, c]
    order = np.argsort(-cnt.ravel(), kind="stable").astype(np.int32)
    return TileTable(idx, tbits, cnt, order)


class SparsePlan:
    """One layout at one block size, causality and device: the layout
    (numpy bool [H, n, n]), its block tables (the FMA kernels') and tile
    tables (the tensor-core kernels': ``tile_rows`` and ``tile_cols``, each
    (packed entries, count, order)) as int32 tensors on the device, the
    live (q, k) pairs per batch row, and, built at the first plain call,
    the expanded [H, S, S] mask of the plain versions."""

    def __init__(self, layout: np.ndarray, block: int, causal: bool,
                 device: torch.device):
        self.layout, self.block, self.causal = layout, block, causal
        self.heads, n = layout.shape[0], layout.shape[1]
        self.seq_len = n * block
        idx, cnt, idxT, cntT = make_index_tables(layout, causal, block)
        self.idx, self.cnt, self.idxT, self.cntT = (
            torch.from_numpy(t).to(device) for t in (idx, cnt, idxT, cntT))
        self.tile_rows, self.tile_cols = (
            tuple(torch.from_numpy(a).to(device)
                  for a in (t.packed(), t.cnt, t.order))
            for t in make_tile_tables(layout, causal, block))
        self.live_blocks = int(cnt.sum())
        self.live_pairs = live_pairs(layout, block, causal)
        self._mask: Optional[torch.Tensor] = None

    def mask(self) -> torch.Tensor:
        if self._mask is None:
            self._mask = torch.from_numpy(
                block_mask(self.layout, self.block, self.causal)).to(
                    self.idx.device)
        return self._mask


def live_pairs(layout: np.ndarray, block: int, causal: bool) -> int:
    """The (query, key) pairs a layout computes per batch row: block²
    per live block, block·(block+1)/2 per live diagonal block if causal
    (whose above-diagonal blocks are dropped)."""
    layout = np.asarray(layout, bool)
    if not causal:
        return int(layout.sum()) * block * block
    n = layout.shape[-1]
    below = int((layout & np.tril(np.ones((n, n), bool), -1)[None]).sum())
    diag = int(np.diagonal(layout, axis1=1, axis2=2).sum())
    return below * block * block + diag * block * (block + 1) // 2


def block_mask(layout: np.ndarray, block: int, causal: bool) -> np.ndarray:
    """The [H, S, S] bool visibility of a [H, n, n] layout: the blocks
    expanded, and the causal triangle (key j seen by query i iff j <= i)."""
    mask = np.kron(np.asarray(layout, bool),
                   np.ones((block, block), bool))
    if causal:
        S = mask.shape[-1]
        mask &= np.tril(np.ones((S, S), bool))[None]
    return mask


#: plans by (layout bytes digest, shape, block, causal, device)
_PLANS: Dict[tuple, SparsePlan] = {}
#: plans by (SparsityConfig object, seq_len, causal, device)
_CONFIG_PLANS: Dict[tuple, SparsePlan] = {}
#: how many plans (index tables) were built; read by the tests
plan_builds = 0


def sparse_plan(layout, block: int, causal: bool, device,
                heads: Optional[int] = None) -> SparsePlan:
    """The cached plan of ``layout`` ([H or 1, n, n], or [n, n]; a single
    head's layout is broadcast to ``heads``)."""
    global plan_builds
    layout = np.asarray(layout)
    if layout.ndim == 2:
        layout = layout[None]
    if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
        raise ValueError(f"layout must be [H, n, n], got {layout.shape}")
    if heads is not None and layout.shape[0] == 1 and heads > 1:
        layout = np.broadcast_to(layout, (heads,) + layout.shape[1:])
    layout = np.ascontiguousarray(layout, dtype=bool)
    device = torch.device(device)
    key = (hashlib.blake2b(layout.tobytes(), digest_size=16).hexdigest(),
           layout.shape, block, bool(causal), device)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = SparsePlan(layout, block, bool(causal), device)
        plan_builds += 1
    return plan


def config_plan(sparsity_config, seq_len: int, causal: bool,
                device) -> SparsePlan:
    """The plan of a ``SparsityConfig`` at ``seq_len``: its layout is made
    once per (config, seq_len) and its tables once per device."""
    key = (sparsity_config, seq_len, bool(causal), torch.device(device))
    plan = _CONFIG_PLANS.get(key)
    if plan is None:
        plan = _CONFIG_PLANS[key] = sparse_plan(
            sparsity_config.make_layout(seq_len), sparsity_config.block,
            causal, device)
    return plan


# ------------------------------------------------------------ plain versions

def block_sparse_attention_reference(q, k, v, plan: SparsePlan,
                                     scale: float
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``block_sparse_fwd``: (O, lse [B, H, S] fp32)
    of attention under the plan's expanded mask; rows with no live key
    give O = 0 and lse = -inf."""
    return masked_attention_reference(q, k, v, plan.mask(), scale)


def block_sparse_attention_backward_reference(q, k, v, o, lse, do,
                                              plan: SparsePlan, scale: float):
    """The plain version of the two backward kernels: (dq, dk, dv) from the
    saved O and lse, with the JAX kernels' rounding."""
    return masked_attention_backward_reference(q, k, v, o, lse, do,
                                               plan.mask(), scale)


# ------------------------------------------------------------------ kernels

def _check_plan(name, plan: SparsePlan, q, kernel: bool = True):
    """q [B, S, H, D] against the plan's heads, length and device; a
    kernel also needs one of :data:`BLOCKS`."""
    B, S, H, D = q.shape
    if (S, H) != (plan.seq_len, plan.heads):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"layout's {plan.heads} heads at S {plan.seq_len}")
    if kernel and plan.block not in BLOCKS:
        raise ValueError(f"{name}: block {plan.block} not supported (want "
                         f"one of {BLOCKS})")
    if plan.idx.device != q.device:
        raise ValueError(f"{name}: plan on {plan.idx.device}, q on {q.device}")
    return B, S, H, D


def _check_same(name, ref, *tensors):
    for t in tensors:
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shapes {tuple(ref.shape)} and "
                             f"{tuple(t.shape)} differ")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _tile_ptrs(table):
    """A device tile table's (entries, count, order) pointers."""
    return [t.data_ptr() for t in table]


class _BlockSparseFwd:
    """The ``block_sparse_fwd`` kernel's wrapper; ``launches`` counts
    kernel launches (never plain-version calls)."""

    launches = 0
    dim_launches: dict = {}

    def __call__(self, q, k, v, plan: SparsePlan, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = check_kernel_inputs("block_sparse_fwd", q, k, v)
        _check_same("block_sparse_fwd", q, k, v)
        B, S, H, D = _check_plan("block_sparse_fwd", plan, q)
        o = torch.empty((B, S, H, D), dtype=dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        fn = build.function("block_sparse_fwd", _FWD_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), plan.idx.data_ptr(), plan.cnt.data_ptr(),
                    *_tile_ptrs(plan.tile_rows), DTYPE_CODES[dtype], B, S, H,
                    D, plan.block, plan.idx.shape[-1],
                    plan.tile_rows[0].shape[-1], *strides3(q, k, v, o),
                    float(scale), int(plan.causal), _stream(q))
        build.check_status("block_sparse_fwd", status)
        _BlockSparseFwd.launches += 1
        count_head_dim(_BlockSparseFwd, q.shape[-1])
        return o, lse


class _BlockSparseBwdDq:
    """The ``block_sparse_bwd_dq`` kernel's wrapper: writes dq (a fresh
    tensor, or the strided ``out`` view) over the row tables (the block
    table in fp32, the tile table in bf16 and fp16)."""

    launches = 0
    dim_launches: dict = {}

    def __call__(self, q, k, v, do, lse, delta, plan: SparsePlan,
                 scale: float, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        dtype = check_kernel_inputs("block_sparse_bwd_dq", q, k, v, do)
        _check_same("block_sparse_bwd_dq", q, k, v, do)
        B, S, H, D = _check_plan("block_sparse_bwd_dq", plan, q)
        check_stats("block_sparse_bwd_dq", (B, H, S), lse, delta)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
            if out is None else out
        check_kernel_inputs("block_sparse_bwd_dq", q, dq)
        _check_same("block_sparse_bwd_dq", q, dq)
        fn = build.function("block_sparse_bwd_dq", _DQ_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    plan.idx.data_ptr(), plan.cnt.data_ptr(),
                    *_tile_ptrs(plan.tile_rows), DTYPE_CODES[dtype], B, S, H,
                    D, plan.block, plan.idx.shape[-1],
                    plan.tile_rows[0].shape[-1], *strides3(q, k, v, do, dq),
                    float(scale), int(plan.causal), _stream(q))
        build.check_status("block_sparse_bwd_dq", status)
        _BlockSparseBwdDq.launches += 1
        count_head_dim(_BlockSparseBwdDq, q.shape[-1])
        return dq


class _BlockSparseBwdDkv:
    """The ``block_sparse_bwd_dkv`` kernel's wrapper: writes dk and dv
    (fresh tensors, or the strided ``out`` views) over the column
    tables."""

    launches = 0
    dim_launches: dict = {}

    def __call__(self, q, k, v, do, lse, delta, plan: SparsePlan,
                 scale: float,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = check_kernel_inputs("block_sparse_bwd_dkv", q, k, v, do)
        _check_same("block_sparse_bwd_dkv", q, k, v, do)
        B, S, H, D = _check_plan("block_sparse_bwd_dkv", plan, q)
        check_stats("block_sparse_bwd_dkv", (B, H, S), lse, delta)
        if out is None:
            dk = torch.empty_like(k, memory_format=torch.contiguous_format)
            dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        else:
            dk, dv = out
        check_kernel_inputs("block_sparse_bwd_dkv", k, dk, dv)
        _check_same("block_sparse_bwd_dkv", k, dk, dv)
        fn = build.function("block_sparse_bwd_dkv", _DKV_ARGTYPES)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), plan.idxT.data_ptr(), plan.cntT.data_ptr(),
                    *_tile_ptrs(plan.tile_cols), DTYPE_CODES[dtype], B, S, H,
                    D, plan.block, plan.idxT.shape[-1],
                    plan.tile_cols[0].shape[-1],
                    *strides3(q, k, v, do, dk, dv), float(scale),
                    int(plan.causal), _stream(q))
        build.check_status("block_sparse_bwd_dkv", status)
        _BlockSparseBwdDkv.launches += 1
        count_head_dim(_BlockSparseBwdDkv, q.shape[-1])
        return dk, dv


_FWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                + [ctypes.c_longlong] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                 + [ctypes.c_longlong] * 18
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
block_sparse_fwd = _BlockSparseFwd()
block_sparse_bwd_dq = _BlockSparseBwdDq()
block_sparse_bwd_dkv = _BlockSparseBwdDkv()


# ----------------------------------------------------------------- autograd

def _forward(q, k, v, plan: SparsePlan, scale: float):
    if on_cuda(q, k, v):
        return block_sparse_fwd(q, k, v, plan, scale)
    _check_plan("block_sparse_attention", plan, q, kernel=False)
    return block_sparse_attention_reference(q, k, v, plan, scale)


def block_sparse_attention_backward(q, k, v, o, lse, do, plan: SparsePlan,
                                    scale: float, out=None):
    """(dq, dk, dv) from the forward's saved O and lse.  On CUDA the two
    kernels write into ``out`` (three [B, S, H, D] views) when given; on
    the CPU the plain version runs and is copied into ``out``."""
    if not on_cuda(q, k, v, o, lse, do):
        grads = block_sparse_attention_backward_reference(q, k, v, o, lse,
                                                          do, plan, scale)
        if out is None:
            return grads
        for dst, g in zip(out, grads):
            dst.copy_(g)
        return tuple(out)
    do, delta = aligned_do_and_delta(do, o)
    dq = block_sparse_bwd_dq(q, k, v, do, lse, delta, plan, scale,
                             out=None if out is None else out[0])
    dk, dv = block_sparse_bwd_dkv(q, k, v, do, lse, delta, plan, scale,
                                  out=None if out is None else out[1:])
    return dq, dk, dv


def _halves(plan: SparsePlan, scale: float):
    return (lambda q, k, v: _forward(q, k, v, plan, scale),
            lambda q, k, v, o, lse, do, out=None:
            block_sparse_attention_backward(q, k, v, o, lse, do, plan, scale,
                                            out=out))


def block_sparse_attention(q, k, v, layout, block: int, causal: bool = True,
                           sm_scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention restricted to a block layout.  q, k, v: [B, S, H, D];
    layout: [H or 1, S//block, S//block] 0/1 (numpy), or a
    :class:`SparsePlan` (whose block and causality then hold).  Returns
    (O [B, S, H, D], lse [B, H, S] fp32); differentiable in q, k, v.  Dead
    blocks cost neither FLOPs nor reads."""
    plan = layout if isinstance(layout, SparsePlan) else sparse_plan(
        layout, block, causal, q.device, heads=q.shape[2])
    return AttentionFn.apply(q, k, v, *_halves(
        plan, softmax_scale(q.shape[-1], sm_scale)))


def block_sparse_attention_qkv(qkv, plan: SparsePlan,
                               sm_scale: Optional[float] = None,
                               saved: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse self-attention on the packed qkv [B, S, 3, H, D] →
    (O, lse), with one [B, S, 3, H, D] gradient.  ``saved`` = (O, lse) of
    an earlier forward on the same qkv skips the forward kernel."""
    return PackedAttentionFn.apply(qkv, *_halves(
        plan, softmax_scale(qkv.shape[-1], sm_scale)), saved)
