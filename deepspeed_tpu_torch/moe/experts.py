"""Expert FFN stacks: the port of ``moe/experts.py``.

Every expert's weights live in one stacked tree, ``wi`` [E, d, F], ``bi``
[E, F], ``wo`` [E, F, d], ``bo`` [E, d]; an expert is bias, tanh-GeLU,
bias.  :func:`experts_apply` runs all of them on a dispatched [E, C, d]
buffer (two batched matmuls, as the JAX package's two einsums);
:func:`experts_apply_routed` runs each of R routes on its own expert's
weights, gathered by index (an ``Int8Param`` is indexed before it is
dequantized, so only the routed experts are).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def experts_init(generator: torch.Generator, num_experts: int, d_model: int,
                 d_ff: int, dtype=torch.float32, device=None
                 ) -> Dict[str, torch.Tensor]:
    """Normal(0.02) matrices, zero biases (JAX ``experts_init``'s stds)."""
    def normal(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    return {
        "wi": normal((num_experts, d_model, d_ff)),
        "bi": torch.zeros((num_experts, d_ff), dtype=dtype, device=device),
        "wo": normal((num_experts, d_ff, d_model)),
        "bo": torch.zeros((num_experts, d_model), dtype=dtype, device=device),
    }


def experts_apply(params: Dict, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [E, C, d] → [E, C, d]; per-expert FFN, batched over the expert
    dim."""
    cdt = compute_dtype or x.dtype
    h = torch.bmm(x.to(cdt), params["wi"].to(cdt)) + \
        params["bi"].to(cdt)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["wo"].to(cdt)) + \
        params["bo"].to(cdt)[:, None, :]


def experts_apply_routed(params: Dict, x: torch.Tensor, experts: torch.Tensor,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """x: [R, d] routes, ``experts`` [R] their experts → [R, d]: route r
    through expert ``experts[r]``'s weights, gathered."""
    cdt = compute_dtype or x.dtype
    h = torch.bmm(x.to(cdt)[:, None, :], params["wi"][experts].to(cdt))[:, 0] \
        + params["bi"][experts].to(cdt)
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h[:, None, :], params["wo"][experts].to(cdt))[:, 0] + \
        params["bo"][experts].to(cdt)
