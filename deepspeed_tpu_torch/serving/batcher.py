"""Slot-based continuous batcher: the port of ``serving/batcher.py``.

The batcher owns one fixed-geometry ``[L, B=slots, max_len, H, D]`` KV
cache of the engine's model family (``engine._family``: ``gpt_inference``
or, for GPT-MoE, ``gpt_moe_inference``, whose cache interleaves the
pairs' sublayers).  Admission prefills a prompt batch-1 through fixed-width chunks
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

With ``serving.speculative`` enabled the tick runs draft/verify ROUNDS
(``inference/speculative.py``): a second slot cache holds a small dense
draft model's K/V, admitted in lockstep with the target (the draft
prefills the whole prompt at every admission, prefix hits included).
Each slot carries a pending token ``cur`` (drawn at admission exactly as
a plain tick would draw it); a round runs K ragged draft decode steps
(plus the d_K feed, so the draft cache covers a full acceptance), ONE
ragged verify ``extend`` of every slot's ``[cur, d_1..d_K]`` window, and
the batched accept: greedy slots keep the longest prefix that agrees
with the target's argmax chain plus the target's own next token, sampled
slots run the rejection rule with draws from their accept stream.
Frontiers advance by ``accepted + 1``; a rejected position's K/V sits
past the frontier and is overwritten next round.  The round reads one
``[B, K+2]`` array from the device (windows and accepted counts);
drafted tokens stay on the device and the draft steps' frontiers are
host integers.  ``set_spec_level`` is the degradation ladder's handle:
level 1 shrinks rounds to ``draft_k2``, level 2 pauses speculation
(plain one-token ticks, the first one flushing the pending token).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..inference.bucketing import bucket_cache_len, bucket_draft_k
from ..inference.sampling import filter_logits, sample
from ..inference.speculative import (accept_generator, cast_floats,
                                     check_draft_config, spec_accept_batch)
from ..models import gpt, gpt_inference
from ..models.gpt_inference import KVCache
from ..runtime.config import DeepSpeedConfigError
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
                 tracer: Optional[Tracer] = None, draft=None):
        #: telemetry tracer shared with the owning gateway (a disabled
        #: no-op when serving runs without telemetry)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False, name="serving")
        self._engine = engine
        cfg = engine.model_config
        self._cfg = cfg
        self._family = fam = engine._family
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
        self.cache = fam.init_cache(cfg, B, self.max_len, device=self.device,
                                    kv_dtype=kv)
        self._scratch = fam.init_cache(cfg, 1, self.max_len,
                                       device=self.device, kv_dtype=kv)
        self.lengths = np.zeros((B,), np.int64)
        self.greedy = np.ones((B,), bool)
        self.temp = np.ones((B,), np.float32)
        self.active = np.zeros((B,), bool)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        self._last: Optional[torch.Tensor] = None   # [B, padded_vocab] fp32
        #: device-to-host reads made by ``tick`` (one a tick or round)
        self.host_reads = 0
        #: speculative state (0/None when speculation is off): the draft's
        #: slot cache, each slot's pending token (drawn, not yet written)
        #: and accept stream, and the ladder level (0 full ``draft_k``
        #: rounds, 1 ``draft_k2`` rounds, 2 paused)
        self.spec = bool(config.speculative_config.enabled)
        self.draft_k = self.draft_k2 = self.spec_level = 0
        self._paused = False
        self.draft_cache: Optional[KVCache] = None
        self.cur: Optional[torch.Tensor] = None
        self.accept_generators: List[Optional[torch.Generator]] = [None] * B
        if self.spec:
            self._init_draft(config, draft)
            self.draft_cache = gpt_inference.init_cache(
                self._dcfg, B, self.max_len, device=self.device)
            self._draft_scratch = gpt_inference.init_cache(
                self._dcfg, 1, self.max_len, device=self.device)
            self.cur = torch.zeros((B,), dtype=torch.long,
                                   device=self.device)
            self.draft_k2 = max(1, self.draft_k // 2)
        #: extra slot positions a speculative round may write past the
        #: reply budget (the gateway's admission margin)
        self.spec_overshoot = self.draft_k if self.spec else 0

    def _init_draft(self, config: ServingConfig, draft) -> None:
        """Resolve the draft: an engine or ``(GPTConfig, params)`` passed to
        ``serve(draft=...)``, or the section's geometry spec (a random-init
        dense GPT over the target's vocabulary, from a ``torch.Generator``
        on the engine's device).  The draft must be dense GPT, and it
        computes in the target's serving dtype."""
        cfg = self._cfg
        spec_cfg = config.speculative_config
        if draft is None and spec_cfg.draft is None:
            raise DeepSpeedConfigError(
                "serving.speculative.enabled needs a draft model: pass "
                "draft=(GPTConfig, params) / a dense InferenceEngine to "
                "engine.serve(), or set serving.speculative.draft to a "
                "geometry spec {n_layer, d_model, n_head[, seed]}")
        if draft is None:
            d = spec_cfg.draft
            dcfg = gpt.GPTConfig(
                vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                n_layer=int(d.get("n_layer", 2)),
                n_head=int(d.get("n_head", cfg.n_head)),
                d_model=int(d.get("d_model", max(cfg.d_model // 4,
                                                 cfg.n_head))),
                dtype=cfg.dtype, vocab_round_to=cfg.vocab_round_to)
            dparams = gpt.init(dcfg, torch.Generator(
                device=self.device).manual_seed(int(d.get("seed", 0))),
                device=self.device)
        elif hasattr(draft, "model_config") and hasattr(draft, "params"):
            if draft._family is not gpt_inference:
                raise NotImplementedError(
                    "the serving draft must be a dense GPT-family engine")
            dcfg, dparams = draft.model_config, draft.params
        else:
            dcfg, dparams = draft
        check_draft_config(dcfg, cfg)
        if dcfg.max_seq_len < self.max_len:
            raise ValueError(
                f"serving draft max_seq_len ({dcfg.max_seq_len}) is "
                f"smaller than the {self.max_len}-token slot")
        self._dcfg = dataclasses.replace(dcfg, dtype=cfg.dtype)
        self._dparams = cast_floats(dparams, self.device, cfg.dtype)
        self.draft_k = bucket_draft_k(int(spec_cfg.draft_k),
                                      cap=self.max_len)

    # ------------------------------------------------- degradation ladder

    def set_spec_level(self, level: int) -> None:
        """Engage or release the speculative rungs: 0 = full ``draft_k``
        rounds, 1 = ``draft_k2`` rounds, 2 = paused (plain one-token
        ticks).  No-op on a non-speculative batcher."""
        if level not in (0, 1, 2):
            raise ValueError(f"spec level must be 0, 1, or 2, got {level}")
        if self.spec:
            self.spec_level = int(level)

    @property
    def round_draft_k(self) -> int:
        """Proposals per round at the current ladder level (0 = plain
        one-token ticks: speculation off or paused)."""
        if not self.spec or self.spec_level >= 2:
            return 0
        return self.draft_k2 if self.spec_level == 1 else self.draft_k

    def set_chunk_wide(self, wide: bool) -> None:
        """Engage/release the ``chunk_widen`` rung: later prefills run
        ``chunk_wide``-token chunks."""
        self._wide = bool(wide) and self.chunk_wide != self.chunk

    def prewarm(self) -> None:
        """Run a throwaway prompt that crosses one chunk boundary (at both
        chunk widths) through slot 0, tick once (speculative: then once at
        every ladder level) and release it; call before any real
        admission."""
        n = min(self.chunk + 1, self.max_len)
        self.admit(0, np.zeros((n,), np.int64), None, True, 1.0)
        self.tick()
        if self.spec:
            for level in (1, 2, 0):   # shrunk round, pause flush, resume
                self.set_spec_level(level)
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
        cfg, params, fam = self._cfg, self._engine.params, self._family
        C = self.chunk_wide if self._wide else self.chunk
        cache = self._scratch
        start = 0
        if prefix is not None:
            fam.write_slot(cache, 0, prefix.cache)
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
                    lg, cache = fam.prefill(
                        params, chunks[i:i + 1], cfg, cache, logits_at=at)
                else:
                    lg, cache = fam.extend(
                        params, chunks[i:i + 1], cfg, cache, lengths=[pos],
                        logits_at=at)
        return cache, lg[0], start + S

    @torch.no_grad()
    def build_prefix(self, tokens: np.ndarray) -> PrefixEntry:
        """Prefill a shared prefix once into a cache of its own."""
        cache, _vec, frontier = self._chunked_prefill(np.asarray(tokens))
        own = self._family.read_slot(cache, 0, frontier)
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
        self._family.write_slot(self.cache, row, cache)
        self._last[row] = vec
        self.lengths[row] = frontier
        self.greedy[row] = bool(greedy)
        self.temp[row] = float(temperature)
        self.active[row] = True
        self.generators[row] = generator
        if self.spec:
            # lockstep draft admission: the draft prefills the whole
            # prompt (a prefix hit spares only target work), and the
            # slot's pending token is drawn as a plain tick would draw it
            self._draft_prefill(tokens)
            gpt_inference.write_slot(self.draft_cache, row,
                                     self._draft_scratch)
            self.cur[row] = self._pick(
                vec[None, :self._cfg.vocab_size], [row])[0]
            self.accept_generators[row] = None if greedy else \
                accept_generator(generator)
        return frontier

    def _draft_prefill(self, tokens: np.ndarray) -> None:
        """The prompt through the draft in the batcher's chunks, into the
        draft's batch-1 scratch cache (only the K/V are kept)."""
        C, dev = self.chunk, self.device
        S = int(tokens.shape[0])
        padded = np.zeros((-(-S // C) * C,), np.int64)
        padded[:S] = tokens
        chunks = torch.as_tensor(padded.reshape(-1, C)).to(dev)
        at = torch.zeros((1,), dtype=torch.long, device=dev)
        cache = self._draft_scratch
        for i in range(chunks.shape[0]):
            if i == 0:
                gpt_inference.prefill(self._dparams, chunks[:1], self._dcfg,
                                      cache, logits_at=at)
            else:
                gpt_inference.extend(self._dparams, chunks[i:i + 1],
                                     self._dcfg, cache, lengths=[i * C],
                                     logits_at=at)

    def release(self, row: int) -> None:
        """Retire a slot: it stops advancing (its tick writes re-hit one
        dead cell) until the next admission overwrites the row."""
        self.lengths[row] = 0
        self.active[row] = False
        self.generators[row] = None
        self.accept_generators[row] = None

    # ---------------------------------------------------------------- tick

    def _pick(self, lg: torch.Tensor, rows) -> torch.Tensor:
        """Next tokens of slots ``rows`` from their logits ``lg``
        [len(rows), vocab]: argmax for greedy slots, a draw from the slot's
        generator through the shared filter for sampled live ones."""
        nxt = torch.argmax(lg, dim=-1)
        idx = [i for i, r in enumerate(rows)
               if self.active[r] and not self.greedy[r]]
        if idx:
            temp = torch.as_tensor(self.temp[[rows[i] for i in idx]]).to(
                self.device)[:, None]
            filt = filter_logits(lg[idx], temp, top_k=self.top_k,
                                 top_p=self.top_p)
            for j, i in enumerate(idx):
                nxt[i] = sample(filt[j:j + 1], self.generators[rows[i]])[0]
        return nxt

    def _decode(self, nxt: torch.Tensor) -> None:
        """Write ``nxt`` [B] at every slot's frontier through one ragged
        decode step; live slots advance."""
        self._last, self.cache = self._family.decode_step(
            self._engine.params, nxt, self._cfg, self.cache,
            lengths=self.lengths)
        # only live slots advance; a freed slot re-writes its own cell
        self.lengths = np.where(self.active, self.lengths + 1, self.lengths)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """The tick's one device-to-host read."""
        self.host_reads += 1
        return t.cpu().numpy()

    @torch.no_grad()
    def tick(self):
        """One decode step for every slot; returns the [B] tokens just
        emitted (junk in freed slots).  With speculation on (and not
        paused), one draft/verify round instead: returns ``(window [B,
        K+1], counts [B])``, slot b having emitted ``window[b,
        :counts[b]]`` (0 in freed slots).  Callers dispatch on the return
        type: the pause rung switches a speculative batcher to plain
        ticks."""
        if self._last is None:
            raise RuntimeError("tick() before any admission")
        V = self._cfg.vocab_size
        if self.spec:
            if self.spec_level >= 2:
                return self._paused_tick()
            if self._paused:
                # leaving the pause: draw every pending token from the
                # frontier logits, as a plain tick would
                self.cur = self._pick(self._last[:, :V], range(self.slots))
                self._paused = False
            return self._spec_tick()
        with self.tracer.span(SpanName.SERVE_TICK):
            nxt = self._pick(self._last[:, :V], range(self.slots))
            self._decode(nxt)
            return self._read(nxt)

    def _paused_tick(self) -> np.ndarray:
        """A one-token tick under the pause rung.  The first one flushes
        the pending tokens (one decode step writes them and leaves
        ``_last`` at the frontier); later ones are plain ticks.  The draft
        cache does not advance while paused: a slot live across the pause
        has a hole in its draft history, which lowers acceptance after the
        resume and leaves the output exact."""
        with self.tracer.span(SpanName.SERVE_TICK):
            if self._paused:
                nxt = self._pick(self._last[:, :self._cfg.vocab_size],
                                 range(self.slots))
            else:
                nxt = self.cur
                self._paused = True
            self._decode(nxt)
            return self._read(nxt)

    def _spec_tick(self):
        """One speculative round for every slot (module docstring)."""
        K, B, V = self.round_draft_k, self.slots, self._cfg.vocab_size
        dparams, dcfg, dev = self._dparams, self._dcfg, self.device
        lens = self.lengths
        rows = [r for r in range(B) if self.active[r] and not self.greedy[r]]
        with self.tracer.span(SpanName.SERVE_TICK), \
                self.tracer.span(SpanName.SERVE_SPEC, draft_k=K):
            temp = torch.as_tensor(self.temp[rows]).to(dev)[:, None] \
                if rows else None
            tok, drafts, d_probs = self.cur, [], []
            for j in range(K):
                lg, self.draft_cache = gpt_inference.decode_step(
                    dparams, tok, dcfg, self.draft_cache, lengths=lens + j)
                lg = lg[:, :V]
                tok = torch.argmax(lg, dim=-1)
                if rows:
                    f = filter_logits(lg[rows], temp, top_k=self.top_k,
                                      top_p=self.top_p)
                    d_probs.append(torch.softmax(f, -1))
                    for i, r in enumerate(rows):
                        tok[r] = sample(f[i:i + 1], self.generators[r])[0]
                drafts.append(tok)
            # feed d_K too, so the draft cache covers a full acceptance
            gpt_inference.decode_step(dparams, tok, dcfg, self.draft_cache,
                                      lengths=lens + K)
            drafts = torch.stack(drafts, dim=1)                  # [B, K]
            window = torch.cat([self.cur[:, None], drafts], dim=1)
            vlg, self.cache = self._family.extend(
                self._engine.params, window, self._cfg, self.cache,
                lengths=lens)
            vlg = vlg[..., :V]
            g = torch.argmax(vlg, dim=-1)                        # [B, K+1]
            agree = (drafts == g[:, :K]).to(torch.int64)
            a = torch.cumprod(agree, dim=1).sum(1)
            nxt = g[torch.arange(B, device=dev), a]
            if rows:
                t_probs = torch.softmax(filter_logits(
                    vlg[rows], temp[:, :, None], top_k=self.top_k,
                    top_p=self.top_p), -1)
                a_s, nxt_s = spec_accept_batch(
                    [self.accept_generators[r] for r in rows], drafts[rows],
                    torch.stack(d_probs, dim=1), t_probs)
                a[rows] = a_s
                nxt[rows] = nxt_s
            host = self._read(torch.cat([window, a[:, None]], dim=1))
            counts = np.where(self.active, host[:, -1] + 1, 0)
            self.lengths = self.lengths + counts
            self.cur = nxt
            return host[:, :-1], counts
