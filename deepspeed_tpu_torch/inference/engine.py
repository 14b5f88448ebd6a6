"""Inference engine: the port of ``inference/engine.py``.

``InferenceEngine`` holds a GPT model's weights in the serving dtype on
one device and offers ``forward`` and ``generate``.  The model family is
dispatched on the config, as in the JAX engine: a ``GPTMoEConfig`` runs
``gpt_moe`` (``forward``: eval capacity gating) and
``gpt_moe_inference`` (dropless gating in every cache path), any other
``GPTConfig`` ``gpt`` and ``gpt_inference``; ``generate``, sessions and a
``SlotBatcher`` over the engine read ``engine._family``.  ``dtype="int8"``
serves int8 weights with bf16 compute: the weights are cast to bf16, then
the big matmul weights are quantized to int8 codes with per-vector scales
(``inference/quantization.py``, the ``quantizer`` kernel on CUDA);
``kv_cache_dtype="int8"`` gives ``generate`` (and a ``SlotBatcher`` over
the engine) int8 KV caches.  ``generate`` runs one
prefill and then a decode loop; where the JAX engine compiles the loop
into one ``lax.while_loop``, the port runs it as a Python loop that
launches the model's kernels eagerly.  The all-rows-finished early exit
under ``eos_token_id`` reads one flag from the device per token; without
an eos the loop never waits on the device until the tokens are returned.

``generate_speculative`` decodes with a draft model's proposals verified
by the target (``inference/speculative.py``).  ``start_session`` gives a
multi-turn :class:`InferenceSession` over one persistent KV cache, and
``serve`` a continuous-batching ``serving.ServingGateway`` over the
engine (with a draft: speculative rounds in its tick loop).

:class:`BertInferenceEngine` serves the BERT encoder (``models/bert.py``)
with the same dtype and weight-only int8 treatment: one full-sequence
forward, no KV cache.  Both engines write their weights with
``save_16bit_model`` in the JAX package's ``np.savez`` layout.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..models import bert, gpt, gpt_inference, gpt_moe, gpt_moe_inference
from ..utils.logging import logger
from .bucketing import (bucket_cache_len, bucket_max_new_tokens,
                        tile_cache_len)
from .config import DeepSpeedInferenceConfig
from .quantization import Int8Param, quantize_params_int8
from .sampling import filter_logits, sample


def _shard_and_quantize(params: dict, weight_int8: bool) -> dict:
    """The one-device half of the JAX engine's ``_shard_and_quantize``
    (tensor parallelism raises at config time): the int8 conversion of the
    already-cast weights."""
    if not weight_int8:
        return params
    params, n_q = quantize_params_int8(params)
    logger.info(f"[inference] int8 weight-only serving: {n_q} weights "
                "stored as int8 codes + per-vector scales")
    return params


class InferenceEngine:
    """Wraps (config, params) on one device; ``device=None`` means CUDA
    (and raises when there is none)."""

    def __init__(self, model_config: gpt.GPTConfig, params: dict,
                 config: DeepSpeedInferenceConfig, device=None):
        self.device = get_accelerator().resolve_device(device)
        self._config = config
        dtype, self._weight_int8 = config.serving_dtype()
        self._kv_dtype = "int8" if config.kv_cache_dtype == "int8" else None
        self.model_config = cfg = dataclasses.replace(model_config,
                                                      dtype=dtype)
        # model-family dispatch (JAX inference/engine.py:114-129)
        if isinstance(cfg, gpt_moe.GPTMoEConfig):
            self._family = gpt_moe_inference
            self._apply_fn = lambda p, t: gpt_moe.apply(p, t, cfg,
                                                        train=False)[0]
        else:
            self._family = gpt_inference
            self._apply_fn = lambda p, t: gpt.apply(p, t, cfg)
        # cast first, then quantize: the codes of the bf16-cast weights
        self.params = _shard_and_quantize(
            _to_device(params, self.device, dtype), self._weight_int8)
        # sampled generate() calls without a generator draw from a seed
        # sequence, so two calls differ unless the caller pins one
        self._seed_seq = 0

    def _next_generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device).manual_seed(self._seed_seq)
        self._seed_seq += 1
        return gen

    # -------------------------------------------------------------- forward

    @torch.no_grad()
    def forward(self, tokens) -> torch.Tensor:
        """Full-sequence logits [B, S, padded_vocab] fp32; tokens [B, S]."""
        return self._apply_fn(self.params, _as_long(tokens, self.device))

    __call__ = forward

    # ------------------------------------------------------------- generate

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0,
                 prompt_lens=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Autoregressive generation → [B, max_new_tokens] int64.

        tokens: [B, S] prompt.  Unequal-length prompts: right-pad to S and
        pass the true lengths as ``prompt_lens`` [B]; each row continues
        from its own last real token with per-row visibility in the decode
        kernel.  ``eos_token_id`` stops once every row has emitted it
        (finished rows keep emitting eos).  Sampling draws from
        ``generator`` (on the engine's device)."""
        cfg = self.model_config
        tokens = _as_long(tokens, self.device)
        B, S = tokens.shape
        ragged = prompt_lens is not None
        if ragged:
            lens = np.asarray(prompt_lens, dtype=np.int64)
            if lens.shape != (B,):
                raise ValueError(f"prompt_lens shape {lens.shape} != ({B},)")
            if (lens < 1).any() or (lens > S).any():
                raise ValueError(
                    f"prompt_lens must be in [1, {S}] (the padded width); "
                    f"got {lens.tolist()} — out-of-range lengths would "
                    "silently condition on the wrong tokens")
        else:
            lens = np.full((B,), S, dtype=np.int64)
        if S + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len ({cfg.max_seq_len}); decoding past it would "
                "silently overwrite the last cache slot")
        # the JAX engine's cache geometry: the reply budget's bucket, tiled
        max_len = tile_cache_len(S + bucket_max_new_tokens(max_new_tokens),
                                 cfg.max_seq_len)
        if do_sample and generator is None:
            generator = self._next_generator()
        fam = self._family
        cache = fam.init_cache(cfg, B, max_len, device=self.device,
                               kv_dtype=self._kv_dtype)
        last_pos = torch.as_tensor(lens - 1).to(self.device)
        # logits at the last prompt token predict the first new token
        last, cache = fam.prefill(self.params, tokens, cfg, cache,
                                  logits_at=last_pos)
        out = torch.full((B, max_new_tokens),
                         eos_token_id if eos_token_id is not None else 0,
                         dtype=torch.long, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        lengths = lens.copy()
        for i in range(max_new_tokens):
            lg = last[:, :cfg.vocab_size]
            if do_sample:
                nxt = sample(filter_logits(lg, temperature, top_k=top_k,
                                           top_p=top_p), generator)
            else:
                nxt = torch.argmax(lg, dim=-1)
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done |= nxt == eos_token_id
            out[:, i] = nxt
            if i == max_new_tokens - 1 or (
                    eos_token_id is not None and bool(done.all())):
                break
            last, cache = fam.decode_step(
                self.params, nxt, cfg, cache,
                lengths=lengths if ragged else None)
            lengths += 1
        return out


    # ---------------------------------------------------------- speculative

    @torch.no_grad()
    def generate_speculative(self, tokens, draft, max_new_tokens: int = 32,
                             draft_k: int = 7, temperature: float = 0.0,
                             top_k: int = 0, top_p: float = 1.0,
                             generator: Optional[torch.Generator] = None,
                             seed: Optional[int] = None, rounds=None):
        """Generation with draft-model speculation
        (``inference/speculative.py``): fewer target forwards, the same
        output semantics.  ``temperature=0`` (default) is greedy and gives
        ``generate``'s tokens; ``temperature>0`` is speculative sampling
        (the rejection rule), its tokens distributed as target sampling at
        that temperature, drawn from ``generator`` (or a generator seeded
        with ``seed``; neither: the engine's seed sequence).  ``draft`` is
        a ``(GPTConfig, params)`` pair or a dense GPT-family
        :class:`InferenceEngine` over the same vocabulary; the target may
        be dense or GPT-MoE.  Greedy speculation is batched (``tokens``
        [B, S]); sampling serves batch 1.  ``rounds``, a list, collects
        each round's accepted counts [B].  Returns ``(tokens [B, N],
        n_target_forwards)``."""
        from .speculative import (cast_floats, check_draft_config,
                                  speculative_generate)
        if temperature <= 0 and (top_k > 0 or top_p < 1.0):
            raise ValueError(
                "top_k/top_p only apply to speculative SAMPLING — set "
                "temperature > 0 (temperature=0 is greedy and would "
                "silently ignore the filters)")
        if isinstance(draft, InferenceEngine):
            if draft._family is not gpt_inference:
                raise NotImplementedError(
                    "the draft must be a dense GPT-family engine")
            dcfg, dparams = draft.model_config, draft.params
        else:
            dcfg, dparams = draft
        check_draft_config(dcfg, self.model_config)
        if not isinstance(draft, InferenceEngine):
            dparams = cast_floats(dparams, self.device, dcfg.dtype)
        if temperature > 0 and generator is None:
            generator = self._next_generator() if seed is None else \
                torch.Generator(device=self.device).manual_seed(int(seed))
        return speculative_generate(
            self.params, self.model_config, dparams, dcfg,
            _as_long(tokens, self.device), max_new_tokens, draft_k,
            kv_dtype=self._kv_dtype, temperature=temperature, top_k=top_k,
            top_p=top_p, generator=generator, rounds=rounds)

    # -------------------------------------------------------------- session

    def start_session(self, batch: int = 1,
                      max_len: Optional[int] = None) -> "InferenceSession":
        """A stateful multi-turn session over one persistent KV cache:
        ``append`` prefills/extends with each turn's tokens (the
        conversation is never re-prefilled), ``generate`` decodes a reply
        that stays in the cache.

        ``max_len`` is bucketed to a power of two (clamped to the model
        context), as in the JAX package, so sessions with nearby budgets
        share one cache geometry."""
        cap = self.model_config.max_seq_len
        return InferenceSession(self, batch,
                                bucket_cache_len(max_len or cap, cap))

    # -------------------------------------------------------------- serving

    def serve(self, config=None, journal=None, autostart: bool = True,
              tracer=None, draft=None):
        """A continuous-batching serving gateway over this engine: an
        async request scheduler packing heterogeneous prompts into one
        fixed-geometry ragged-decode slot batch (``serving/``).
        ``config`` is a :class:`~deepspeed_tpu_torch.serving.ServingConfig`
        or its dict; ``journal`` an optional supervision ``EventJournal``;
        ``tracer`` an optional telemetry ``Tracer`` recording the serve.*
        spans.  ``draft`` is the proposal model of speculative decoding
        (``serving.speculative``): a dense GPT-family engine or a
        ``(GPTConfig, params)`` pair; without one, the section's geometry
        spec builds a random-init draft."""
        from ..serving import ServingGateway
        return ServingGateway(self, config=config, journal=journal,
                              autostart=autostart, tracer=tracer,
                              draft=draft)

    # ----------------------------------------------------------- checkpoint

    def save_16bit_model(self, path: str) -> None:
        """The served weights as one ``np.savez`` file (see
        :func:`_save_16bit`)."""
        _save_16bit(self.params, self.model_config.dtype, path)


class InferenceSession:
    """One conversation's cache, advanced turn by turn.

    The KV cache persists across turns, so each turn costs only its own
    tokens (with ``kv_cache_dtype: "int8"`` at about half the cache
    bytes).  The first ``append`` prefills (the flash kernel), later ones
    extend the cache (the chunk kernel), and ``generate`` decodes one
    token a step (the decode kernel)."""

    def __init__(self, engine: InferenceEngine, batch: int, max_len: int):
        cfg = engine.model_config
        self._engine = engine
        max_len = tile_cache_len(max_len, cfg.max_seq_len)
        self.cache = engine._family.init_cache(cfg, batch, max_len,
                                               device=engine.device,
                                               kv_dtype=engine._kv_dtype)
        self._last_logits: Optional[torch.Tensor] = None
        self._key_seq = 0

    @property
    def length(self) -> int:
        return self.cache.length

    def _check_room(self, n: int) -> None:
        if self.length + n > self.cache.max_len:
            raise ValueError(
                f"session cache full: {self.length} + {n} tokens exceeds "
                f"max_len {self.cache.max_len}")

    def fork(self) -> "InferenceSession":
        """A new session continuing from this one's exact state (prefix
        caching): process a shared system prompt ONCE, then fork one
        session per conversation.  The JAX fork shares its immutable
        arrays; the port's cache is written in place, so a fork copies
        the parent's live prefix (K/V and, int8, their scales) into a
        cache of its own, and later turns of either never reach the
        other."""
        new = object.__new__(InferenceSession)
        new._engine = self._engine
        src = self.cache
        new.cache = self._engine._family.init_cache(
            self._engine.model_config, src.batch, src.max_len,
            device=self._engine.device, kv_dtype=self._engine._kv_dtype)
        n = src.length
        for dst, buf in zip(new.cache.buffers(), src.buffers()):
            dst[:, :, :n] = buf[:, :, :n]
        new.cache.length = n
        new._last_logits = None if self._last_logits is None \
            else self._last_logits.clone()
        new._key_seq = self._key_seq
        return new

    @torch.no_grad()
    def append(self, tokens) -> torch.Tensor:
        """Feed one turn's tokens [B, S]; returns its logits
        [B, S, padded_vocab] (fp32)."""
        tokens = _as_long(tokens, self._engine.device)
        if tokens.ndim != 2 or tokens.shape[0] != self.cache.batch:
            raise ValueError(f"append wants tokens [{self.cache.batch}, S], "
                             f"got {tuple(tokens.shape)}")
        self._check_room(tokens.shape[1])
        fam = self._engine._family
        run = fam.prefill if self.length == 0 else fam.extend
        logits, self.cache = run(self._engine.params, tokens,
                                 self._engine.model_config, self.cache)
        self._last_logits = logits[:, -1].clone()
        return logits

    @torch.no_grad()
    def generate(self, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Decode a reply [B, max_new_tokens] int64 (greedy, or sampled
        through the shared logit filter from ``generator``, on the
        engine's device; unset, the session's own seed sequence).  The
        reply's K/V stays in the session cache, so the next ``append``
        continues the conversation."""
        if self._last_logits is None:
            raise ValueError("append() a prompt before generate()")
        if not do_sample and (top_k > 0 or top_p < 1.0):
            raise ValueError(
                "top_k/top_p only apply with do_sample=True (greedy "
                "would silently ignore the filters)")
        eng, cfg = self._engine, self._engine.model_config
        B = self.cache.batch
        if max_new_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.long, device=eng.device)
        self._check_room(max_new_tokens)
        if do_sample and generator is None:
            generator = torch.Generator(device=eng.device).manual_seed(
                self._key_seq)
            self._key_seq += 1
        last, out = self._last_logits, []
        for _ in range(max_new_tokens):
            lg = last[:, :cfg.vocab_size]
            if do_sample:
                nxt = sample(filter_logits(lg, temperature, top_k=top_k,
                                           top_p=top_p), generator)
            else:
                nxt = torch.argmax(lg, dim=-1)
            last, self.cache = eng._family.decode_step(eng.params, nxt, cfg,
                                                       self.cache)
            out.append(nxt)
        self._last_logits = last
        return torch.stack(out, dim=1)


def _to_device(tree: dict, device: torch.device, dtype: torch.dtype) -> dict:
    """The weights on ``device``, floats cast to the serving dtype."""
    return {k: _to_device(v, device, dtype) if isinstance(v, dict)
            else v.to(device=device,
                      dtype=dtype if v.is_floating_point() else v.dtype)
            for k, v in tree.items()}


def _savez_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as the JAX package's file holds it: bf16 as its raw 2-byte
    pattern (``|V2``, what ``np.savez`` writes for an ml_dtypes
    ``bfloat16`` array), anything else as its numpy dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _save_16bit(params: dict, dtype: torch.dtype, path: str) -> None:
    """Write ``params`` to one ``np.savez`` file under the keys that
    ``jax.tree_util.keystr`` gives the JAX tree (``['wte']``,
    ``['blocks']['wqkv']``; dict keys sorted, as JAX flattens them).  A
    layer-stacked leaf held as a list of per-layer tensors is stacked to
    one [L, ...] array, and an :class:`Int8Param` is dequantized to
    ``dtype`` (a 16-bit weight per leaf under the leaf's own key), so
    either package's file reads like the other's."""
    arrays = {}

    def walk(tree, key):
        if isinstance(tree, Mapping):
            for name in sorted(tree):
                walk(tree[name], f"{key}[{name!r}]")
        else:
            if isinstance(tree, (list, tuple)):
                tree = torch.stack([w.to(dtype) if isinstance(w, Int8Param)
                                    else w for w in tree])
            elif isinstance(tree, Int8Param):
                tree = tree.to(dtype)
            arrays[key] = _savez_array(tree)

    walk(params, "")
    np.savez(path, **arrays)


class BertInferenceEngine:
    """Encoder serving: the BERT encoder's full-sequence forward on one
    device, no KV cache (JAX ``inference/engine.py`` ``BertInferenceEngine``),
    with :class:`InferenceEngine`'s dtype and weight-only int8 treatment:
    ``dtype="int8"`` stores ``wqkv``, ``wo``, ``wi`` and ``wo_mlp`` as
    :class:`Int8Param` codes of the bf16-cast weights and computes in
    bf16.  A batch without a mask, or with an all-ones ``attention_mask``,
    runs the flash kernel (non-causal); any other mask takes the dense
    masked attention of ``models/bert.py``, as the JAX engine does.
    ``device=None`` means CUDA (and raises when there is none)."""

    def __init__(self, model_config: bert.BertConfig, params: dict,
                 config: DeepSpeedInferenceConfig, device=None):
        dtype, self._weight_int8 = config.serving_dtype(
            "quant.int8_compute serves the GPT decoder families; the "
            "encoder engine uses weight-only int8 (dtype='int8')")
        if config.kv_cache_dtype != "auto":
            raise NotImplementedError(
                "kv_cache_dtype applies to autoregressive decode; the "
                "encoder engine has no KV cache")
        self.device = get_accelerator().resolve_device(device)
        self._config = config
        self.model_config = dataclasses.replace(model_config, dtype=dtype)
        self.params = _shard_and_quantize(
            _to_device(params, self.device, dtype), self._weight_int8)

    def _args(self, tokens, token_type_ids, attention_mask):
        """(tokens, type ids, mask or None) on the device; an all-ones
        mask is None, so that the unmasked path serves it."""
        tokens = _as_long(tokens, self.device)
        tt = torch.zeros_like(tokens) if token_type_ids is None \
            else _as_long(token_type_ids, self.device)
        if attention_mask is not None:
            attention_mask = _as_long(attention_mask, self.device)
            if bool(attention_mask.all()):
                attention_mask = None
        return tokens, tt, attention_mask

    @torch.no_grad()
    def forward(self, tokens, token_type_ids=None, attention_mask=None):
        """tokens [B, S] → MLM logits [B, S, padded_vocab] fp32."""
        tokens, tt, am = self._args(tokens, token_type_ids, attention_mask)
        return bert.apply(self.params, tokens, self.model_config, tt, am)

    __call__ = forward

    @torch.no_grad()
    def encode(self, tokens, token_type_ids=None, attention_mask=None):
        """tokens [B, S] → hidden states [B, S, d] in the compute dtype."""
        tokens, tt, am = self._args(tokens, token_type_ids, attention_mask)
        return bert.encode(self.params, tokens, self.model_config, tt, am)

    @torch.no_grad()
    def pooled(self, tokens, token_type_ids=None, attention_mask=None):
        """tokens [B, S] → the [CLS] pooler output [B, d]."""
        return bert.pooled_output(
            self.params, self.encode(tokens, token_type_ids, attention_mask),
            self.model_config)

    def save_16bit_model(self, path: str) -> None:
        """The served weights as one ``np.savez`` file (see
        :func:`_save_16bit`)."""
        _save_16bit(self.params, self.model_config.dtype, path)


def _as_long(x, device: torch.device) -> torch.Tensor:
    """An int array or tensor as an int64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long).to(device)
