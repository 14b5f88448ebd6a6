"""Fused Adam/AdamW, and plain SGD.

The port of the JAX package's ``ops/adam/fused_adam.py`` (the counterpart
of the reference's ``deepspeed/ops/adam/fused_adam.py``, backed by
``csrc/adam/multi_tensor_adam.cu``).  ``FusedAdam`` steps the engine's one
flat fp32 master buffer with the ``fused_adam`` kernel
(``ops/kernels/fused_adam.py``): one launch over every parameter, with the
scalars on the device.  ``adam_w_mode`` selects decoupled weight decay
exactly as the reference flag does.  ``SGD`` has no TPU kernel and stays
plain torch over the same flat buffers.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..kernels.fused_adam import adam_hyper_values, fused_adam
from ..optimizer import DeviceScalars, TpuOptimizer, register_optimizer


@register_optimizer("adam", "adamw", "fusedadam")
class FusedAdam(TpuOptimizer):
    """Adam/AdamW with the reference constructor surface (ops/adam/fused_adam.py)."""

    def __init__(self, params=None, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 set_grad_none: bool = True, **kwargs):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant "
                               "(matches reference ops/adam/fused_adam.py)")
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self._scalars = DeviceScalars()

    def init(self, master: torch.Tensor, segments=None) -> Dict[str, Any]:
        return {"step": 0, "exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros_like(master)}

    def step_flat(self, master, grad, state, hyper, *, compute=None,
                  grad_scale=None, skip=None) -> None:
        values = adam_hyper_values(
            hyper["lr"], self.betas[0], self.betas[1], self.eps,
            hyper.get("weight_decay", 0.0), state["step"] + 1,
            self.bias_correction)
        fused_adam(master, grad, state["exp_avg"], state["exp_avg_sq"],
                   self._scalars(values, master.device), p_compute=compute,
                   gscale=grad_scale, skip=skip, adam_w_mode=self.adam_w_mode)


@register_optimizer("sgd")
class SGD(TpuOptimizer):
    """Plain/momentum SGD (the reference delegates to torch.optim.SGD)."""

    def __init__(self, params=None, lr: float = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False, **kwargs):
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, master: torch.Tensor, segments=None) -> Dict[str, Any]:
        state: Dict[str, Any] = {"step": 0}
        if self.momentum != 0.0:
            state["momentum"] = torch.zeros_like(master)
        return state

    @torch.no_grad()
    def step_flat(self, master, grad, state, hyper, *, compute=None,
                  grad_scale=None, skip=None) -> None:
        lr, wd = hyper["lr"], hyper.get("weight_decay", 0.0)
        g = grad * grad_scale if grad_scale is not None else grad
        g = g + wd * master
        if self.momentum != 0.0:
            buf = self.momentum * state["momentum"] + g
            d = g + self.momentum * buf if self.nesterov else buf
            if skip is not None:
                buf = torch.where(skip, state["momentum"], buf)
            state["momentum"].copy_(buf)
        else:
            d = g
        new = master - lr * d
        master.copy_(new if skip is None else torch.where(skip, master, new))
        if compute is not None:
            compute.copy_(master)
        grad.zero_()
