"""KV-cached inference for GPT-MoE: the port of
``models/gpt_moe_inference.py``.

The cache is the dense family's :class:`~.gpt_inference.KVCache` over the
``n_layer`` attention sublayers, interleaved: layer ``2i`` is pair i's
dense block, layer ``2i + 1`` its attention half block (the JAX package's
``dense_k``/``moe_k`` banks are ``k[0::2]`` and ``k[1::2]``).  ``prefill``,
``extend`` and ``decode_step`` are the dense family's, written in place,
int8 caches included, with this family's layer loop; the slot ops are the
dense family's unchanged.

Gating is dropless (JAX ``_moe_infer_obj``): no token is ever dropped, so
a call routes each token alone and ``prefill``, ``extend`` and
``decode_step`` agree however the tokens are chunked.  A prompt of more
than :data:`_PREFILL_CHUNK` gated tokens walks through ``extend`` chunks
of ``_PREFILL_CHUNK // B`` tokens, as the JAX package does, so one gate
call holds at most 128 tokens.  The expert layer dispatches by index
(``moe/sharded_moe.py``): a decode step's few routes on their gathered
experts, a chunk's through an [E, C, d] buffer sized to its busiest
expert.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import gpt, gpt_inference
from .gpt_inference import (KVCache, Lengths, attend, read_slot,  # noqa: F401
                            reset_slot, write_slot)
from .gpt_moe import GPTMoEConfig, moe_layer, pair_params

#: the most gated tokens one prefill call routes; longer prompts walk
#: through ``extend`` chunks
_PREFILL_CHUNK = 128


def moe_infer_layer(config: GPTMoEConfig):
    """The dropless expert layer of serving (JAX ``_moe_infer_obj``)."""
    return moe_layer(config, drop_tokens=False)


def init_cache(config: GPTMoEConfig, batch: int, max_len: int, device=None,
               kv_dtype=None) -> KVCache:
    """A zeroed cache of the ``n_layer`` interleaved sublayers (dense
    block ``2i``, attention half block ``2i + 1``)."""
    return gpt_inference.init_cache(config, batch, max_len, device=device,
                                    kv_dtype=kv_dtype)


def _pair_layers(x, params, cache, config, write, attn, pos, positions):
    """The layer loop of ``gpt_inference``'s hook signature over the
    (dense, MoE) pairs, the expert layer dropless."""
    moe = moe_infer_layer(config)
    for i in range(config.n_pairs):
        dense_p, attn_p, moe_p = pair_params(params, i)
        a = attend(x, dense_p, cache, 2 * i, config, write, attn, pos)
        x = gpt.block_tail(x, a, dense_p, config)
        a = attend(x, attn_p, cache, 2 * i + 1, config, write, attn, pos)
        x = x + gpt.attn_project(a, attn_p, config)
        h2 = gpt._layer_norm(x, attn_p["ln2_scale"], attn_p["ln2_bias"])
        x = x + moe.apply(moe_p, h2, train=False)[0]
    return x


def prefill(params, tokens: torch.Tensor, config: GPTMoEConfig,
            cache: KVCache, logits_at: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """The prompt [B, S] into an empty cache (``gpt_inference.prefill``'s
    contract).  More than :data:`_PREFILL_CHUNK` gated tokens run as
    ``extend`` chunks from position 0; with ``logits_at`` each chunk
    computes its rows' logits at their position within it, and each row
    keeps those of the chunk that holds its position."""
    B, S = tokens.shape
    if B * S <= _PREFILL_CHUNK:
        return gpt_inference.prefill(params, tokens, config, cache,
                                     logits_at=logits_at,
                                     layers=_pair_layers)
    if S > cache.max_len:
        raise ValueError(f"prefill of {S} tokens overflows the cache "
                         f"(max_len {cache.max_len})")
    step = max(_PREFILL_CHUNK // B, 1)
    cache.length = 0
    outs, last = [], None
    for s0 in range(0, S, step):
        n = min(step, S - s0)
        if logits_at is None:
            lg, cache = extend(params, tokens[:, s0:s0 + n], config, cache)
            outs.append(lg)
            continue
        at = (logits_at - s0).clamp(0, n - 1)
        lg, cache = extend(params, tokens[:, s0:s0 + n], config, cache,
                           logits_at=at)
        inside = ((logits_at >= s0) & (logits_at < s0 + n))[:, None]
        last = lg if last is None else torch.where(inside, lg, last)
    return (torch.cat(outs, dim=1) if logits_at is None else last), cache


def extend(params, tokens: torch.Tensor, config: GPTMoEConfig,
           cache: KVCache, lengths: Optional[Lengths] = None,
           logits_at: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, KVCache]:
    """``gpt_inference.extend`` (chunked prefill, ragged with
    ``lengths``) through the pairs."""
    return gpt_inference.extend(params, tokens, config, cache,
                                lengths=lengths, logits_at=logits_at,
                                layers=_pair_layers)


def decode_step(params, token: torch.Tensor, config: GPTMoEConfig,
                cache: KVCache, lengths: Optional[Lengths] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """``gpt_inference.decode_step`` (ragged with ``lengths``) through the
    pairs: each row's token routes alone, so ragged batching cannot move a
    row's routing."""
    return gpt_inference.decode_step(params, token, config, cache,
                                     lengths=lengths, layers=_pair_layers)
