"""Speculative decoding: the port of ``inference/speculative.py``.

A small draft model proposes ``draft_k`` tokens per round; the target
scores the whole window ``[cur, d_1..d_K]`` in ONE ragged ``extend`` (the
chunk kernel on CUDA) and keeps the longest acceptable prefix plus one
token of its own.  Greedy (``temperature == 0``) the accepted tokens are
exactly the target's own argmax chain, so the output equals plain greedy
decoding; sampled (``temperature > 0``) the rejection rule of Leviathan
et al. 2023 / Chen et al. 2023 (:func:`spec_accept_rule`) makes the
emitted tokens distributed exactly as sampling from the (filtered)
target.  Either way the draft only changes how many target forwards the
output takes.

Rollback is arithmetic: a rejected position's K/V sits past the row's
new frontier, where per-row visibility masks it and the next round's
window overwrites it.  The JAX package runs the loop as one
``lax.while_loop``; the port runs it as a Python loop over eager kernel
launches that reads one ``[B]`` vector of accepted counts from the device
per round and nothing else: drafted tokens stay on the device, and the
ragged frontiers the kernels take are host integers (``lengths + j``).

The JAX package's disjoint key domains (``SPEC_DRAFT_DOMAIN``,
``SPEC_ACCEPT_DOMAIN``) keep the accept uniforms independent of the draws
that made the proposals; reusing one stream would correlate them and
break the rule's exactness.  Here they are two ``torch.Generator``
streams per row: the row's own generator draws the pending token and the
proposals (as a plain tick would), and an accept generator seeded from
the row generator's seed under :data:`SPEC_ACCEPT_DOMAIN`
(:func:`accept_generator`) draws the rule's uniforms and residual
sample.  The draws are not the JAX package's threefry bits; the rule
itself takes its draws as arguments, so tests can feed it JAX's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import gpt, gpt_inference, gpt_moe, gpt_moe_inference
from .bucketing import tile_cache_len
from .sampling import filter_logits, sample

#: the accept/resample stream's domain (the JAX package's constant): an
#: accept generator is seeded from its row's seed under it
SPEC_ACCEPT_DOMAIN = 0x5A000000


def accept_generator(generator: torch.Generator) -> torch.Generator:
    """The accept stream of the row whose draft stream is ``generator``:
    a generator on the same device, seeded from ``generator``'s seed under
    :data:`SPEC_ACCEPT_DOMAIN` (a disjoint stream; no device read)."""
    seed = np.random.SeedSequence(
        [generator.initial_seed() & 0xFFFFFFFFFFFFFFFF,
         SPEC_ACCEPT_DOMAIN]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(seed))


def spec_draws(generator: torch.Generator, K: int, V: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's accept draws from ``generator``: ``u`` [K] uniforms and
    the residual draw, ``gumbel`` [V] Gumbel noise (the rule samples by
    Gumbel-max, as :func:`sampling.sample` and ``jax.random.categorical``
    do)."""
    u = torch.rand((K,), generator=generator, device=device,
                   dtype=torch.float32)
    g = torch.rand((V,), generator=generator, device=device,
                   dtype=torch.float32)
    return u, -torch.log(-torch.log(g.clamp(min=1e-20)))


def spec_accept_rule(u: torch.Tensor, gumbel: torch.Tensor,
                     d_tokens: torch.Tensor, d_probs: torch.Tensor,
                     t_probs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The speculative-sampling acceptance rule over a batch of rows, its
    draws given: ``u`` [B, K] uniforms, ``gumbel`` [B, V] residual noise,
    ``d_tokens`` [B, K] the proposals, ``d_probs`` [B, K, V] the draft
    distributions they came from, ``t_probs`` [B, K+1, V] the target's
    over the same positions (+1 = the bonus position).

    Draft token i is accepted while ``u_i < min(1, p_t(x_i) / p_d(x_i))``;
    at the first rejection the next token comes from the residual
    ``norm(max(p_t - p_d, 0))``, after a fully accepted round from
    ``t_probs[K]``.  Returns ``(a [B], next_token [B], probs [B, V])``:
    the accepted count (0..K), the one extra emitted token and the
    distribution it was drawn from."""
    K = d_tokens.shape[-1]
    rows = torch.arange(d_tokens.shape[0], device=d_tokens.device)
    idx = d_tokens[..., None]
    p_t = torch.gather(t_probs[:, :K], -1, idx)[..., 0]
    p_d = torch.gather(d_probs, -1, idx)[..., 0]
    accept = u < torch.clamp(p_t / torch.clamp(p_d, min=1e-20), max=1.0)
    a = torch.cumprod(accept.to(torch.int64), dim=-1).sum(-1)
    t_a = t_probs[rows, a]
    d_a = torch.where((a < K)[:, None], d_probs[rows, a % K],
                      torch.zeros_like(t_a))
    resid = torch.clamp(t_a - d_a, min=0.0)
    s = resid.sum(-1, keepdim=True)
    # a fully overlapping residual (sum 0) falls back to the target row
    probs = torch.where(s > 1e-20, resid / torch.clamp(s, min=1e-20), t_a)
    nxt = torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel,
                       dim=-1)
    return a, nxt, probs


def spec_accept(generator: torch.Generator, d_tokens: torch.Tensor,
                d_probs: torch.Tensor, t_probs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`spec_accept_rule` for one row (``d_tokens`` [K], ``d_probs``
    [K, V], ``t_probs`` [K+1, V]) with its draws from ``generator`` (the
    row's accept stream).  Returns ``(a, next_token)``, 0-d tensors."""
    K, V = d_probs.shape
    u, g = spec_draws(generator, K, V, d_probs.device)
    a, nxt, _ = spec_accept_rule(u[None], g[None], d_tokens[None],
                                 d_probs[None], t_probs[None])
    return a[0], nxt[0]


def spec_accept_batch(generators: Sequence[torch.Generator],
                      d_tokens: torch.Tensor, d_probs: torch.Tensor,
                      t_probs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One independent rule per row (``d_tokens`` [B, K], ``d_probs``
    [B, K, V], ``t_probs`` [B, K+1, V]), row b's draws from
    ``generators[b]``.  Returns ``(a [B], next_token [B])``."""
    K, V = d_probs.shape[1:]
    draws = [spec_draws(g, K, V, d_probs.device) for g in generators]
    u = torch.stack([d[0] for d in draws])
    g = torch.stack([d[1] for d in draws])
    a, nxt, _ = spec_accept_rule(u, g, d_tokens, d_probs, t_probs)
    return a, nxt


def cast_floats(tree: dict, device, dtype) -> dict:
    """A draft's weights on ``device`` with its floating tensors in
    ``dtype`` (quantized leaves kept as they are)."""
    return {k: cast_floats(v, device, dtype) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype)
            if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in tree.items()}


def target_family(config: gpt.GPTConfig):
    """The cache family that serves ``config`` (GPT-MoE or dense)."""
    if isinstance(config, gpt_moe.GPTMoEConfig):
        return gpt_moe_inference
    return gpt_inference


def check_draft_config(draft_cfg, target_cfg) -> None:
    """The draft must be a dense GPT over the target's vocabulary."""
    if not isinstance(draft_cfg, gpt.GPTConfig) or \
            isinstance(draft_cfg, gpt_moe.GPTMoEConfig):
        raise TypeError(
            "draft must be (gpt.GPTConfig, params) or a dense GPT-family "
            f"InferenceEngine (got config {type(draft_cfg)})")
    if draft_cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary "
                         f"({draft_cfg.vocab_size} vs "
                         f"{target_cfg.vocab_size})")


@torch.no_grad()
def speculative_generate(target_params, target_cfg: gpt.GPTConfig,
                         draft_params, draft_cfg: gpt.GPTConfig,
                         prompt: torch.Tensor, max_new_tokens: int,
                         draft_k: int = 7, kv_dtype=None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0,
                         generator: Optional[torch.Generator] = None,
                         rounds: Optional[List[np.ndarray]] = None
                         ) -> Tuple[torch.Tensor, int]:
    """Speculative decode.  ``prompt`` [B, S] (on the weights' device) →
    ``(tokens [B, N] int64, n_target_forwards)``, the forwards being the
    verify rounds plus the prefill (plain decode needs N).

    Greedy (``temperature == 0``) is batched and ragged: rows accept
    different counts, so each keeps its own frontier and every draft step
    and verify chunk after the first round runs at per-row positions; a
    finished row keeps computing with its frontier clamped in bounds.
    Sampling (``temperature > 0``, with ``top_k``/``top_p`` applied to
    draft and target alike) serves batch 1: ``generator`` draws the
    pending token and the proposals, :func:`accept_generator` of it the
    accept draws.  The
    target may be dense GPT or GPT-MoE (its ``extend`` is dropless, so a
    verify of K+1 tokens equals K+1 decode steps); the draft is dense.
    ``kv_dtype`` "int8" gives the target an int8 cache.  ``rounds``, when
    given, collects each round's accepted counts [B] (the host copy the
    round reads anyway)."""
    B, S = prompt.shape
    sampled = float(temperature) > 0.0
    if sampled and B != 1:
        raise NotImplementedError(
            "speculative SAMPLING serves batch 1 (per-row rejection "
            "resampling); batched speculation is greedy")
    check_draft_config(draft_cfg, target_cfg)
    tfam = target_family(target_cfg)
    N, K = int(max_new_tokens), int(draft_k)
    V = target_cfg.vocab_size
    # the last verify round can write up to K positions past the final
    # emission, so the whole overshoot must fit the context
    need = S + N + K + 1
    ctx = min(target_cfg.max_seq_len, draft_cfg.max_seq_len)
    if need > ctx:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({N}) + speculative overshoot "
            f"({K + 1}) exceeds max_seq_len ({ctx}); reduce draft_k or the "
            "token budget")
    dev = prompt.device
    max_len = tile_cache_len(need, ctx)
    tcache = tfam.init_cache(target_cfg, B, max_len, device=dev,
                             kv_dtype=kv_dtype)
    dcache = gpt_inference.init_cache(draft_cfg, B, max_len, device=dev)
    if sampled:
        dgen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        agen = accept_generator(dgen)

    def flt(lg):
        return filter_logits(lg, temperature, top_k=top_k, top_p=top_p)

    at = torch.full((B,), S - 1, dtype=torch.long, device=dev)
    last, tcache = tfam.prefill(target_params, prompt, target_cfg, tcache,
                                logits_at=at)
    gpt_inference.prefill(draft_params, prompt, draft_cfg, dcache,
                          logits_at=at)
    last = last[:, :V]
    cur = sample(flt(last), dgen) if sampled else torch.argmax(last, -1)

    lens = np.full((B,), S, np.int64)     # per-row emitted-prefix frontier
    done = np.zeros((B,), np.int64)
    windows, advances = [], []
    fwds = 1
    while (done < N).any():
        # a finished row's frontier is clamped to the highest an active
        # row can hold, so its writes stay inside the cache
        l_eff = np.minimum(lens, S + N - 1)
        tok, drafts, d_probs = cur, [], []
        for j in range(K):
            lg, dcache = gpt_inference.decode_step(
                draft_params, tok, draft_cfg, dcache, lengths=l_eff + j)
            lg = lg[:, :V]
            if sampled:
                f = flt(lg)
                d_probs.append(torch.softmax(f, -1)[0])
                tok = sample(f, dgen)
            else:
                tok = torch.argmax(lg, -1)
            drafts.append(tok)
        # feed d_K too, so the draft cache covers a full acceptance
        gpt_inference.decode_step(draft_params, tok, draft_cfg, dcache,
                                  lengths=l_eff + K)
        drafts = torch.stack(drafts, dim=1)                     # [B, K]
        window = torch.cat([cur[:, None], drafts], dim=1)       # [B, K+1]
        vlg, tcache = tfam.extend(target_params, window, target_cfg, tcache,
                                  lengths=l_eff)
        vlg = vlg[..., :V]
        fwds += 1
        if sampled:
            a, nxt = spec_accept(agen, drafts[0],
                                 torch.stack(d_probs), torch.softmax(
                                     flt(vlg[0]), -1))
            a, nxt = a[None], nxt[None]
        else:
            # accepted drafts are exactly the target's own greedy tokens
            g = torch.argmax(vlg, -1)                           # [B, K+1]
            agree = (drafts == g[:, :K]).to(torch.int64)
            a = torch.cumprod(agree, dim=1).sum(1)
            nxt = g[torch.arange(B, device=dev), a]
        a_host = a.cpu().numpy()           # the round's one device read
        if rounds is not None:
            rounds.append(a_host.copy())
        adv = np.where(done < N, a_host + 1, 0)
        windows.append(window)
        advances.append(adv)
        lens += adv
        done += adv
        cur = nxt
    # every window reaches the host in one read at the end
    win = torch.cat(windows, dim=1).cpu().numpy().reshape(B, -1, K + 1)
    out = np.zeros((B, N + K + 1), np.int64)
    col = np.zeros((B,), np.int64)
    for r, adv in enumerate(advances):
        for b in range(B):
            out[b, col[b]:col[b] + adv[b]] = win[b, r, :adv[b]]
        col += adv
    return torch.as_tensor(out[:, :N]).to(dev), fwds
