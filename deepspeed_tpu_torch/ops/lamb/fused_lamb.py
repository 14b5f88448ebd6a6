"""Fused LAMB.

The port of the JAX package's ``ops/lamb/fused_lamb.py`` (the counterpart
of the reference's ``deepspeed/ops/lamb/fused_lamb.py``, backed by
``csrc/lamb/fused_lamb_cuda_kernel.cu``).  ``FusedLamb`` steps the
engine's one flat fp32 master buffer with the two ``fused_lamb`` kernels
(``ops/kernels/fused_lamb.py``), with the scalars on the device.  The
trust ratio is taken per segment the engine hands ``init``: one per
parameter leaf, as the JAX optimizer takes one per pytree leaf, so a
layer-stacked leaf such as ``blocks/wqkv`` has one ratio over all its
layers.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.fused_lamb import check_segments, fused_lamb, lamb_hyper_values
from ..optimizer import DeviceScalars, TpuOptimizer, register_optimizer


@register_optimizer("lamb", "fusedlamb")
class FusedLamb(TpuOptimizer):
    """LAMB with the reference constructor surface (max/min_coeff clamp)."""

    def __init__(self, params=None, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8, eps_inside_sqrt: bool = False,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 max_coeff: float = 10.0, min_coeff: float = 0.01,
                 amsgrad: bool = False, **kwargs):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad variant")
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.bias_correction = bias_correction
        self._scalars = DeviceScalars()

    def init(self, master: torch.Tensor, segments=None) -> Dict[str, Any]:
        n = master.numel()
        return {"step": 0, "exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros_like(master),
                "segments": check_segments(segments or ((0, n),), n)}

    def step_flat(self, master, grad, state, hyper, *, compute=None,
                  grad_scale=None, skip=None) -> None:
        values = lamb_hyper_values(
            hyper["lr"], self.betas[0], self.betas[1], self.eps,
            hyper.get("weight_decay", 0.0), state["step"] + 1,
            self.bias_correction, self.max_coeff, self.min_coeff)
        fused_lamb(master, grad, state["exp_avg"], state["exp_avg_sq"],
                   self._scalars(values, master.device), state["segments"],
                   p_compute=compute, gscale=grad_scale, skip=skip,
                   eps_inside_sqrt=self.eps_inside_sqrt)
