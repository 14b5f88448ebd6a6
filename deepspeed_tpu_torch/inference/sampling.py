"""Logit filtering and sampling shared by ``generate`` and the serving
tick: temperature, then top-k, then top-p (the reference/HF order).

Sampling draws from explicit ``torch.Generator``s, one per call or per
serving slot, so a seeded run is reproducible.  The draws are not the
JAX package's bits: parity with it is held on :func:`filter_logits` and
on greedy output.
"""

from __future__ import annotations

import torch


def filter_logits(lg: torch.Tensor, temperature, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """lg [..., V] → temperature-scaled logits with everything outside
    the top-k / nucleus set at -inf.  ``temperature`` is a float or a
    tensor broadcastable against ``lg``."""
    if torch.is_tensor(temperature):
        lg = lg / torch.clamp(temperature, min=1e-6)
    else:
        lg = lg / max(float(temperature), 1e-6)
    neg_inf = torch.tensor(float("-inf"), dtype=lg.dtype, device=lg.device)
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, neg_inf, lg)
    if top_p < 1.0:
        # nucleus: keep everything strictly inside the smallest top-p mass
        # set plus the first token that crosses p
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        # at top_p <= 0 the keep-count would be 0; the most restrictive
        # nucleus keeps exactly the top token
        cutoff = torch.clamp(keep_sorted.sum(dim=-1, keepdim=True), min=1)
        kth = torch.gather(sorted_lg, -1, cutoff - 1)
        lg = torch.where(lg < kth, neg_inf, lg)
    return lg


def sample(lg: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of filtered logits ``lg`` [B, V]
    (Gumbel-max: argmax of logits plus Gumbel noise drawn from
    ``generator``, which must live on ``lg``'s device)."""
    u = torch.rand(lg.shape, generator=generator, device=lg.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(lg.float() + gumbel, dim=-1)
