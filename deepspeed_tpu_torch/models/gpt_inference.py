"""KV-cached GPT inference: the port of ``models/gpt_inference.py``.

``prefill`` runs the prompt through the model while recording K/V;
``extend`` appends a chunk (chunked prefill) and ``decode_step`` one token
against the cache; the slot ops (``write_slot``, ``reset_slot``,
``read_slot``) serve the continuous batcher.

Cache layout [L, B, S_max, H, D], as in the JAX package.  Unlike the JAX
package's functional updates, **the port writes the cache in place**:
``prefill``/``extend``/``decode_step`` store the new K/V into
``cache.k``/``cache.v``, advance ``cache.length`` and return the same
:class:`KVCache` object.  Attention over the cache reads the layer view
``cache.k[l]`` ([B, S_max, H, D]) through its strides, with no copy.

An int8 cache (``init_cache(..., kv_dtype="int8")``) holds int8 codes and
one fp32 scale per head vector (``k_scale``/``v_scale`` [L, B, S_max, H,
1]): each layer quantizes its new K and V per vector and writes codes and
scales at their slots (``quantize_kv_into``: one kernel launch on CUDA),
and extend/decode read the cache back through the kernels' int8
variants.  Prefill attends over the fresh,
unquantized K/V, as in the JAX package.

``cache.length`` is a host int (the max frontier).  Ragged calls take
per-row ``lengths`` as host integers (a list, numpy array or CPU tensor);
they are copied to the device once per call for the kernels, so a decode
loop never waits on the device to learn a frontier.

The GPT variants follow the JAX package (``gpt_inference.py:90-153``): a
banded layer (``gpt.layer_window``) hands its window to the flash kernel in
prefill and to the cache kernels in extend/decode; an ALiBi model prefills
through the dense ``gpt._alibi_attention`` and hands the cache kernels its
slopes (built once per head count and device) on every unbanded layer, at
a fixed 1/sqrt(Dh) scale.  Each step hands its token positions (``[S]`` in
prefill, ``[B, S_c]`` or ``[S_c]`` in extend, ``[B, 1]`` or ``[1]`` in
decode) to the learned embedding and, under rotary positions, to the
rotation of q and k, so the cache holds rotated K (an int8 cache its
codes); the block tail honours ``parallel_residual`` (``gpt.block_tail``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.kernels.decode_attention import (cached_attention,
                                            quantize_kv_into)
from . import gpt

Lengths = Union[Sequence[int], np.ndarray, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, S_max, H, D] (int8 codes when int8)
    v: torch.Tensor        # [L, B, S_max, H, D]
    length: int = 0        # tokens cached (max frontier)
    k_scale: Optional[torch.Tensor] = None   # [L, B, S_max, H, 1] fp32
    v_scale: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def int8(self) -> bool:
        return self.k_scale is not None

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """k, v and (int8) their scales, in that order."""
        return (self.k, self.v) + ((self.k_scale, self.v_scale)
                                   if self.int8 else ())

    def layer(self, idx: int) -> Tuple[torch.Tensor, ...]:
        """Layer ``idx``'s view of every buffer, in :meth:`buffers`'
        order."""
        return tuple(b[idx] for b in self.buffers())

    def scales(self, idx: int) -> dict:
        """Layer ``idx``'s ``k_scale``/``v_scale`` keywords for
        ``cached_attention`` (empty for a cache in the compute dtype)."""
        if not self.int8:
            return {}
        return {"k_scale": self.k_scale[idx], "v_scale": self.v_scale[idx]}


def init_cache(config: gpt.GPTConfig, batch: int, max_len: int,
               device=None, kv_dtype=None) -> KVCache:
    """A zeroed cache on ``device``: in the compute dtype, or with
    ``kv_dtype`` "int8" (or ``torch.int8``) int8 codes and fp32 scales."""
    shape = (config.n_layer, batch, max_len, config.n_head, config.head_dim)
    if kv_dtype in ("int8", torch.int8):
        scale = shape[:-1] + (1,)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(scale, dtype=torch.float32, device=device),
            v_scale=torch.zeros(scale, dtype=torch.float32, device=device))
    if kv_dtype is not None:
        raise ValueError(f"kv_dtype={kv_dtype!r} (want None or 'int8')")
    return KVCache(k=torch.zeros(shape, dtype=config.dtype, device=device),
                   v=torch.zeros(shape, dtype=config.dtype, device=device))


def _scale(config: gpt.GPTConfig) -> float:
    """The cache kernels' softmax scale: ALiBi fixes 1/sqrt(Dh), as its
    prefill (``gpt._alibi_attention``) does, whatever
    ``attn_softmax_scale`` says."""
    if config.attn_softmax_scale is not None and config.pos_embed != "alibi":
        return config.attn_softmax_scale
    return 1.0 / math.sqrt(config.head_dim)


@functools.lru_cache(maxsize=None)
def _slopes(n_head: int, device: torch.device) -> torch.Tensor:
    """The ALiBi slopes [H] on ``device``, built once."""
    return gpt.alibi_slopes(n_head, device)


def _cache_attention(q, cache: KVCache, idx: int, pos,
                     config: gpt.GPTConfig) -> torch.Tensor:
    """Layer ``idx``'s attention over the cache: banded on a windowed
    layer, biased by the ALiBi slopes on an unbanded layer of an ALiBi
    model (the window takes precedence, as in prefill)."""
    window = gpt.layer_window(config, idx)
    slopes = _slopes(config.n_head, q.device) \
        if config.pos_embed == "alibi" and window is None else None
    return cached_attention(q, cache.k[idx], cache.v[idx], pos,
                            sm_scale=_scale(config), window=window,
                            slopes=slopes, **cache.scales(idx))


def _host_lengths(lengths: Lengths) -> np.ndarray:
    if torch.is_tensor(lengths):
        if lengths.device.type != "cpu":
            raise ValueError("ragged lengths are host integers (list, numpy "
                             "or CPU tensor), got a tensor on "
                             f"{lengths.device}")
        lengths = lengths.numpy()
    return np.asarray(lengths, dtype=np.int64).reshape(-1)


def attend(x, p, cache: KVCache, idx: int, config: gpt.GPTConfig, write,
           attn, pos, tables=None):
    """One attention sublayer of a cache-filling path: q, k and v of the
    step's tokens (rotated by ``tables`` under rotary positions);
    ``write(buf, val)`` stores this step's K or V into cache layer
    ``idx`` in the compute dtype in place; an int8 cache takes them
    quantized at slots ``pos + i`` (``quantize_kv_into``); returns
    ``attn(q, k, v, idx)``, the sublayer's attention output."""
    q, k, v = gpt.qkv_proj(x, p, config, tables=tables)
    if cache.int8:
        quantize_kv_into(k, v, cache.layer(idx), pos)
    else:
        write(cache.k[idx], k)
        write(cache.v[idx], v)
    return attn(q, k, v, idx)


def _layers(x, params, cache: KVCache, config: gpt.GPTConfig, write, attn,
            pos, positions):
    """The layer loop every cache-filling path shares (:func:`attend`,
    then the block's tail), the rotary tables of ``positions`` built once
    for every layer.  A model family passes its own loop of this
    signature as ``layers`` (``gpt_moe_inference``)."""
    tables = gpt.position_tables(config, positions)
    for idx in range(config.n_layer):
        p = gpt.layer_params(params, idx)
        a = attend(x, p, cache, idx, config, write, attn, pos, tables)
        x = gpt.block_tail(x, a, p, config)
    return x


def _logits(params, x, config, logits_at):
    if logits_at is None:
        return gpt.lm_logits(params, x, config)
    rows = torch.arange(x.shape[0], device=x.device)
    return gpt.lm_logits(params, x[rows, logits_at], config)


def prefill(params, tokens: torch.Tensor, config: gpt.GPTConfig,
            cache: KVCache, logits_at: Optional[torch.Tensor] = None,
            layers=_layers) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt [B, S] through the model, filling cache[:, :, 0:S]
    (assumes an empty cache).  Returns (logits [B, S, padded_vocab] fp32,
    cache); with ``logits_at`` ([B] positions) only those rows' logits
    [B, padded_vocab] are computed.  Attention runs on the fresh, unpadded
    K/V (the flash kernel); only extend/decode read the cache back."""
    B, S = tokens.shape
    if S > cache.max_len:
        raise ValueError(f"prefill of {S} tokens overflows the cache "
                         f"(max_len {cache.max_len})")
    positions = torch.arange(S, device=tokens.device)
    x = gpt.embed(params, tokens, config, positions=positions)

    def write(buf, val):
        buf[:, :S] = val

    def attn(q, k, v, idx):
        return gpt._attention(q, k, v, config,
                              window=gpt.layer_window(config, idx))

    x = layers(x, params, cache, config, write, attn, 0, positions)
    cache.length = S
    return _logits(params, x, config, logits_at), cache


def extend(params, tokens: torch.Tensor, config: gpt.GPTConfig,
           cache: KVCache, lengths: Optional[Lengths] = None,
           logits_at: Optional[torch.Tensor] = None, layers=_layers
           ) -> Tuple[torch.Tensor, KVCache]:
    """Chunked prefill: append ``tokens`` [B, S_c] at positions
    ``cache.length .. cache.length + S_c - 1``, attending causally over the
    cached prefix and the chunk.  ``prefill(t[:, :c]); extend(t[:, c:])``
    equals one ``prefill(t)``.

    ``lengths`` [B] makes the chunk ragged: row b's chunk lands at slots
    ``lengths[b] ..`` and attends through its own live prefix;
    ``cache.length`` advances to ``max(lengths) + S_c``.  Appending past
    ``max_len`` raises (a clamped write would corrupt the prefix).

    Returns (logits [B, S_c, padded_vocab] fp32, or [B, padded_vocab] at
    ``logits_at``; cache)."""
    B, Sc = tokens.shape
    dev = tokens.device
    steps = torch.arange(Sc, device=dev)
    if lengths is not None:
        host = _host_lengths(lengths)
        top = int(host.max())
        pos = torch.as_tensor(host, dtype=torch.int32).to(dev)
        positions = pos.long()[:, None] + steps                 # [B, S_c]
        rows = torch.arange(B, device=dev)[:, None]

        def write(buf, val):
            buf[rows, positions] = val
    else:
        top = pos = cache.length
        positions = pos + steps

        def write(buf, val):
            buf[:, pos:pos + Sc] = val
    if top + Sc > cache.max_len:
        raise ValueError(
            f"extend of {Sc} tokens at length {top} overflows the cache "
            f"(max_len {cache.max_len}); the write would clamp and corrupt "
            "the cached prefix")
    x = gpt.embed(params, tokens, config, positions=positions)

    def attn(q, k, v, idx):
        return _cache_attention(q, cache, idx, pos, config)

    x = layers(x, params, cache, config, write, attn, pos, positions)
    cache.length = top + Sc
    return _logits(params, x, config, logits_at), cache


def decode_step(params, token: torch.Tensor, config: gpt.GPTConfig,
                cache: KVCache, lengths: Optional[Lengths] = None,
                layers=_layers) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: token [B] at position ``cache.length``, or with
    ``lengths`` [B] at per-row positions (ragged right-padded prompts:
    each row's token lands on its own next slot and sees only its own live
    prefix; pad-slot K/V is overwritten as rows catch up).

    Returns (logits [B, padded_vocab] fp32, cache advanced by one)."""
    B = token.shape[0]
    dev = token.device
    if lengths is not None:
        host = _host_lengths(lengths)
        top = int(host.max())
        pos = torch.as_tensor(host, dtype=torch.int32).to(dev)
        positions = pos.long()[:, None]                          # [B, 1]
        rows = torch.arange(B, device=dev)
        slots = positions[:, 0]

        def write(buf, val):
            buf[rows, slots] = val[:, 0]
    else:
        top = pos = cache.length
        positions = torch.tensor([pos], device=dev)

        def write(buf, val):
            buf[:, pos:pos + 1] = val
    if top >= cache.max_len:
        raise ValueError(f"decode at position {top} overflows the cache "
                         f"(max_len {cache.max_len})")
    x = gpt.embed(params, token[:, None], config, positions=positions)

    def attn(q, k, v, idx):
        return _cache_attention(q, cache, idx, pos, config)

    x = layers(x, params, cache, config, write, attn, pos, positions)
    cache.length = top + 1
    return gpt.lm_logits(params, x[:, 0], config), cache


# ------------------------------------------------------------- slot ops
#
# A continuous-batching server owns one fixed-geometry multi-slot cache and
# admits/retires conversations per row without touching the others.


def write_slot(cache: KVCache, row: int, src: KVCache) -> KVCache:
    """Copy a batch-1 cache (K/V and, int8, their scales) into slot
    ``row`` of a multi-slot cache, in place.  Both caches must have the
    same KV dtype and ``src.max_len`` must not exceed the slot cache's;
    ``length`` keeps max-frontier semantics (the batcher tracks per-row
    lengths)."""
    if src.batch != 1:
        raise ValueError(f"write_slot takes a batch-1 cache, got {src.batch}")
    if src.int8 != cache.int8:
        raise ValueError(f"write_slot dtype mismatch: src int8={src.int8}, "
                         f"cache int8={cache.int8}")
    if src.max_len > cache.max_len:
        raise ValueError(
            f"write_slot src max_len {src.max_len} exceeds the slot "
            f"cache's {cache.max_len}")
    n = src.max_len
    for dst, s in zip(cache.buffers(), src.buffers()):
        dst[:, row:row + 1, :n] = s
    cache.length = max(cache.length, src.length)
    return cache


def reset_slot(cache: KVCache, row: int) -> KVCache:
    """Zero slot ``row``'s K/V (and scales) in place: a retired
    conversation's K/V never bleeds into the next tenant, even through a
    masked read."""
    for buf in cache.buffers():
        buf[:, row].zero_()
    return cache


def read_slot(cache: KVCache, row: int, length: Optional[int] = None
              ) -> KVCache:
    """Slot ``row`` as a new batch-1 cache (a copy: later writes to the
    slot cache do not reach it).  ``length`` is the row's true frontier."""
    k, v, *scales = (b[:, row:row + 1].clone() for b in cache.buffers())
    return KVCache(k=k, v=v,
                   length=int(length if length is not None else cache.length),
                   k_scale=scales[0] if scales else None,
                   v_scale=scales[1] if scales else None)
