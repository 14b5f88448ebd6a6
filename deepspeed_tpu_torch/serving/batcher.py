"""Slot-based continuous batcher: the port of ``serving/batcher.py``
(without speculation).

The batcher owns one fixed-geometry ``[L, B=slots, max_len, H, D]`` KV
cache.  Admission prefills a prompt batch-1 through fixed-width chunks
(prompts right-pad to a multiple of ``prefill_chunk``; pad K/V lands past
the row's frontier, where per-row visibility masks it) into a scratch
cache, then copies it into a free slot with ``write_slot``.  Each decode
``tick`` advances every slot one token through the ragged ``decode_step``
(per-slot frontiers, greedy or sampled per slot).  PyTorch runs eagerly,
so there are no compiled programs to register or pre-compile;
``prewarm`` still runs one throwaway admission so the first request does
not pay the kernels' build and the library handles' set-up.  A telemetry
``Tracer`` (shared with the owning gateway) records ``serve.prefill`` and
``serve.tick`` spans.

Per-slot state (frontiers, greedy/temperature flags, liveness) lives on
the host; sampled slots draw from their own ``torch.Generator``.  The
KV cache is written in place, so a shared prefix (``build_prefix``) is a
private copy that admission copies into the scratch cache before
extending it: forks never write into the prefix.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..inference.bucketing import bucket_cache_len
from ..inference.sampling import filter_logits, sample
from ..models import gpt_inference
from ..models.gpt_inference import KVCache
from ..telemetry.spans import SpanName, Tracer
from .config import ServingConfig


@dataclasses.dataclass
class PrefixEntry:
    """A shared prompt prefix held as a batch-1 cache of slot geometry
    (owned by the entry; admissions copy it, never extend it)."""

    cache: KVCache
    length: int


class SlotBatcher:
    """Continuous batching over ``config.slots`` decode slots."""

    def __init__(self, engine, config: ServingConfig,
                 tracer: Optional[Tracer] = None):
        #: telemetry tracer shared with the owning gateway (a disabled
        #: no-op when serving runs without telemetry)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False, name="serving")
        self._engine = engine
        cfg = engine.model_config
        self._cfg = cfg
        self.device = engine.device
        self.slots = config.slots
        self.max_len = bucket_cache_len(config.max_len or cfg.max_seq_len,
                                        cfg.max_seq_len)
        # a chunk wider than the slot cannot even land its first write
        self.chunk = min(int(config.prefill_chunk), self.max_len)
        #: degraded-mode prefill chunk (the overload ladder's
        #: ``chunk_widen`` rung): double width, half the chunk count
        self.chunk_wide = min(self.chunk * 2, self.max_len)
        self._wide = False
        self.top_k, self.top_p = int(config.top_k), float(config.top_p)
        B = self.slots
        # the engine's KV dtype (an int8 cache holds codes and scales)
        kv = engine._kv_dtype
        self.cache = gpt_inference.init_cache(cfg, B, self.max_len,
                                              device=self.device, kv_dtype=kv)
        self._scratch = gpt_inference.init_cache(cfg, 1, self.max_len,
                                                 device=self.device,
                                                 kv_dtype=kv)
        self.lengths = np.zeros((B,), np.int64)
        self.greedy = np.ones((B,), bool)
        self.temp = np.ones((B,), np.float32)
        self.active = np.zeros((B,), bool)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        self._last: Optional[torch.Tensor] = None   # [B, padded_vocab] fp32

    def set_chunk_wide(self, wide: bool) -> None:
        """Engage/release the ``chunk_widen`` rung: later prefills run
        ``chunk_wide``-token chunks."""
        self._wide = bool(wide) and self.chunk_wide != self.chunk

    def prewarm(self) -> None:
        """Run a throwaway prompt that crosses one chunk boundary (at both
        chunk widths) through slot 0, tick once and release it; call
        before any real admission."""
        n = min(self.chunk + 1, self.max_len)
        self.admit(0, np.zeros((n,), np.int64), None, True, 1.0)
        self.tick()
        self.release(0)
        if self.chunk_wide != self.chunk:
            self.set_chunk_wide(True)
            self.admit(0, np.zeros((min(self.chunk_wide + 1, self.max_len),),
                                   np.int64), None, True, 1.0)
            self.set_chunk_wide(False)
            self.release(0)

    # ------------------------------------------------------------- prefill

    def _chunked_prefill(self, tokens: np.ndarray,
                         prefix: Optional[PrefixEntry] = None):
        """Run ``tokens`` [S] through fixed-width chunks into the scratch
        cache, starting past ``prefix`` when given.  Returns ``(cache,
        last_vec, frontier)``: ``last_vec`` the logits at the last real
        token (chunk padding sits past the frontier, masked)."""
        cfg, params = self._cfg, self._engine.params
        C = self.chunk_wide if self._wide else self.chunk
        cache = self._scratch
        start = 0
        if prefix is not None:
            gpt_inference.write_slot(cache, 0, prefix.cache)
            start = cache.length = prefix.length
        S = int(tokens.shape[0])
        with self.tracer.span(SpanName.SERVE_PREFILL, tokens=S, start=start,
                              chunk=C):
            padded = np.zeros((-(-S // C) * C,), np.int64)
            padded[:S] = tokens
            chunks = torch.as_tensor(padded.reshape(-1, C)).to(self.device)
            idx = S - 1 - (chunks.shape[0] - 1) * C
            for i in range(chunks.shape[0]):
                pos = start + i * C
                at = torch.full((1,), idx if i == chunks.shape[0] - 1 else 0,
                                dtype=torch.long, device=self.device)
                if pos == 0:
                    lg, cache = gpt_inference.prefill(
                        params, chunks[i:i + 1], cfg, cache, logits_at=at)
                else:
                    lg, cache = gpt_inference.extend(
                        params, chunks[i:i + 1], cfg, cache, lengths=[pos],
                        logits_at=at)
        return cache, lg[0], start + S

    @torch.no_grad()
    def build_prefix(self, tokens: np.ndarray) -> PrefixEntry:
        """Prefill a shared prefix once into a cache of its own."""
        cache, _vec, frontier = self._chunked_prefill(np.asarray(tokens))
        own = gpt_inference.read_slot(cache, 0, frontier)
        return PrefixEntry(cache=own, length=frontier)

    # ----------------------------------------------------------- admission

    @torch.no_grad()
    def admit(self, row: int, tokens: np.ndarray,
              generator: Optional[torch.Generator], greedy: bool,
              temperature: float, prefix: Optional[PrefixEntry] = None
              ) -> int:
        """Prefill ``tokens`` and land them in slot ``row``; returns the
        row's frontier (the prompt length).  A sampled slot draws from
        ``generator`` (on the batcher's device).  With ``prefix``, only
        the part past ``prefix.length`` is prefilled."""
        tokens = np.asarray(tokens)
        if int(tokens.shape[0]) > self.max_len:
            raise ValueError(
                f"prompt of {int(tokens.shape[0])} tokens overflows the "
                f"{self.max_len}-token slot")
        if not greedy and generator is None:
            raise ValueError("a sampled slot needs a torch.Generator")
        if prefix is not None:
            if prefix.length >= tokens.shape[0]:
                raise ValueError(
                    f"prefix ({prefix.length} tokens) must be shorter than "
                    f"the prompt ({tokens.shape[0]})")
            cache, vec, frontier = self._chunked_prefill(
                tokens[prefix.length:], prefix)
        else:
            cache, vec, frontier = self._chunked_prefill(tokens)
        if self._last is None:
            self._last = torch.zeros((self.slots,) + vec.shape,
                                     dtype=vec.dtype, device=self.device)
        gpt_inference.write_slot(self.cache, row, cache)
        self._last[row] = vec
        self.lengths[row] = frontier
        self.greedy[row] = bool(greedy)
        self.temp[row] = float(temperature)
        self.active[row] = True
        self.generators[row] = generator
        return frontier

    def release(self, row: int) -> None:
        """Retire a slot: it stops advancing (its tick writes re-hit one
        dead cell) until the next admission overwrites the row."""
        self.lengths[row] = 0
        self.active[row] = False
        self.generators[row] = None

    # ---------------------------------------------------------------- tick

    @torch.no_grad()
    def tick(self) -> np.ndarray:
        """One decode step for every slot; returns the [B] tokens just
        emitted (junk in freed slots)."""
        if self._last is None:
            raise RuntimeError("tick() before any admission")
        with self.tracer.span(SpanName.SERVE_TICK):
            lg = self._last[:, :self._cfg.vocab_size]
            nxt = torch.argmax(lg, dim=-1)
            rows = [r for r in range(self.slots)
                    if self.active[r] and not self.greedy[r]]
            if rows:
                temp = torch.as_tensor(self.temp[rows]).to(
                    self.device)[:, None]
                filt = filter_logits(lg[rows], temp, top_k=self.top_k,
                                     top_p=self.top_p)
                for j, r in enumerate(rows):
                    nxt[r] = sample(filt[j:j + 1], self.generators[r])[0]
            self._last, self.cache = gpt_inference.decode_step(
                self._engine.params, nxt, self._cfg, self.cache,
                lengths=self.lengths)
            # only live slots advance; a freed slot re-writes its own cell
            self.lengths = np.where(self.active, self.lengths + 1,
                                    self.lengths)
            return nxt.cpu().numpy()
