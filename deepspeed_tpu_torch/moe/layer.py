"""The public MoE layer: the port of ``moe/layer.py``.

``MoE`` holds the gate and expert configuration; its parameters are a
tree ``{"gate": {"wg"}, "experts": {...}}`` and, with ``use_residual``
(Residual-MoE), ``residual_mlp`` (a dense tanh-GeLU MLP) and
``coefficient`` [d, 2], whose softmax mixes the expert output with the
MLP's per token.  Expert parallelism (``ep_size`` > 1) is not ported
(ROADMAP.md Queue 1 #7): every expert lives on the one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .experts import experts_init
from .sharded_moe import Routing, TopKGate, moe_layer_forward


class MoE:
    """Mixture of Experts layer (functional ``init``/``apply``, the JAX
    package's ``MoE`` surface)."""

    def __init__(self, hidden_size: int, num_experts: int = 1, ep_size: int = 1,
                 k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 expert_intermediate_size: Optional[int] = None):
        if num_experts % ep_size:
            raise ValueError(f"number of experts ({num_experts}) must be "
                             f"divisible by ep_size ({ep_size})")
        if ep_size != 1:
            raise NotImplementedError(
                f"MoE ep_size={ep_size}: expert parallelism is not ported "
                "yet (ROADMAP.md Queue 1 #7)")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.num_local_experts = num_experts // ep_size
        self.use_residual = use_residual
        self.d_ff = expert_intermediate_size or 4 * hidden_size
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens, use_rts)

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> dict:
        """The gate's ``wg`` in fp32, the experts (and the residual MLP and
        coefficient) in ``dtype``."""
        params = {
            "gate": self.gate.init(generator, device),
            "experts": experts_init(generator, self.num_experts,
                                    self.hidden_size, self.d_ff, dtype, device),
        }
        if self.use_residual:
            d, f = self.hidden_size, self.d_ff

            def normal(shape):
                return (torch.randn(shape, generator=generator, device=device)
                        * 0.02).to(dtype)

            params["residual_mlp"] = {
                "wi": normal((d, f)),
                "bi": torch.zeros((f,), dtype=dtype, device=device),
                "wo": normal((f, d)),
                "bo": torch.zeros((d,), dtype=dtype, device=device),
            }
            params["coefficient"] = normal((d, 2))
        return params

    # -- forward -----------------------------------------------------------
    def forward_routed(self, params, x, train: bool = True,
                       generator: Optional[torch.Generator] = None,
                       routing: Optional[Routing] = None):
        """:meth:`apply` that also returns the call's :class:`Routing` and
        takes a given one (a remat replay's)."""
        out, l_aux, exp_counts, routing = moe_layer_forward(
            self.gate, params["gate"], params["experts"], x, train=train,
            generator=generator, routing=routing)
        if self.use_residual:
            r = params["residual_mlp"]
            cdt = x.dtype
            h = F.gelu(x @ r["wi"].to(cdt) + r["bi"].to(cdt),
                       approximate="tanh")
            mlp_out = h @ r["wo"].to(cdt) + r["bo"].to(cdt)
            coef = torch.softmax(
                (x @ params["coefficient"].to(cdt)).float(), dim=-1).to(cdt)
            out = out * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return out, l_aux, exp_counts, routing

    def apply(self, params, x, train: bool = True,
              generator: Optional[torch.Generator] = None):
        """x: [B, S, d] → (out [B, S, d], l_aux, exp_counts)."""
        return self.forward_routed(params, x, train, generator)[:3]
