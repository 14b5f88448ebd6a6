"""Optimizer protocol of the port.

The port of the JAX package's ``ops/optimizer.py``: a registry by name, and
``TpuOptimizer``, the base with torch-like ``param_groups`` on the host
(which the LR schedules mutate) and ``current_hyperparams``.  Where the
JAX optimizer is a pure ``update`` over pytrees, the port's steps one flat
fp32 master buffer in place: ``init(master)`` builds the state buffers and
``step_flat`` runs one step, reading its scalars from device tensors so a
skipped step never needs the host (Adam's bias corrections:
``kernels.fused_adam.adam_hyper_values``).  ``resolve_param_groups`` (per-leaf
groups) is not ported: the engine keeps one group (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

# Registry: name (lowercase) -> optimizer class
_OPTIMIZER_REGISTRY: Dict[str, type] = {}


def register_optimizer(*names: str):
    def deco(cls):
        for n in names:
            _OPTIMIZER_REGISTRY[n.lower()] = cls
        return cls
    return deco


def get_optimizer_class(name: str) -> type:
    key = name.lower()
    if key not in _OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer {name!r}; known: {sorted(_OPTIMIZER_REGISTRY)}")
    return _OPTIMIZER_REGISTRY[key]


class TpuOptimizer:
    """Base optimizer over a flat fp32 master buffer, with torch-like
    ``param_groups`` on the host."""

    #: hyperparameters read from ``param_groups`` at every step
    TRACED_HYPERPARAMS = ("lr", "weight_decay")

    def __init__(self, params: Optional[Any] = None, lr: float = 1e-3,
                 weight_decay: float = 0.0, **kwargs):
        self.defaults = dict(lr=lr, weight_decay=weight_decay, **kwargs)
        self.param_groups: List[Dict[str, Any]] = [dict(self.defaults)]

    def init(self, master: torch.Tensor) -> Dict[str, Any]:
        """The optimizer state for the flat fp32 ``master`` buffer; its
        ``step`` counts the steps taken (skipped steps excluded)."""
        raise NotImplementedError

    def step_flat(self, master: torch.Tensor, grad: torch.Tensor,
                  state: Dict[str, Any], hyper: Dict[str, float], *,
                  compute: Optional[torch.Tensor] = None,
                  grad_scale: Optional[torch.Tensor] = None,
                  skip: Optional[torch.Tensor] = None) -> None:
        """One step in place: ``master`` updated from ``grad`` (times
        ``grad_scale``), ``compute`` (the compute-dtype copy, when there is
        one) refreshed, ``grad`` zeroed.  With ``skip`` set on the device,
        nothing but ``grad`` changes."""
        raise NotImplementedError

    # -- host-side helpers -------------------------------------------------
    def current_hyperparams(self) -> Dict[str, float]:
        """Scalars for this step, read from param_groups (scheduler-mutable)."""
        group = self.param_groups[0]
        return {k: group.get(k, self.defaults.get(k, 0.0)) for k in self.TRACED_HYPERPARAMS}
