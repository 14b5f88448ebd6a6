"""Optimizer protocol of the port.

The port of the JAX package's ``ops/optimizer.py``: a registry by name, and
``TpuOptimizer``, the base with torch-like ``param_groups`` on the host
(which the LR schedules mutate) and ``current_hyperparams``.  Where the
JAX optimizer is a pure ``update`` over pytrees, the port's steps one flat
fp32 master buffer in place: ``init(master)`` builds the state buffers and
``step_flat`` runs one step, reading its scalars from device tensors so a
skipped step never needs the host (Adam's bias corrections:
``kernels.fused_adam.adam_hyper_values``; :class:`DeviceScalars` stages
them).  ``init`` also takes the buffer's tensor segments, for per-tensor
math (LAMB's trust ratio).  ``resolve_param_groups`` (per-leaf
groups) is not ported: the engine keeps one group (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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


class DeviceScalars:
    """Scalars copied to the device without a host synchronisation: a
    pinned staging buffer and an asynchronous copy on the current stream.
    The engine reads its overflow flag at the end of every step, so the
    previous step's copy has finished before the staging buffer is
    rewritten."""

    def __init__(self):
        self._host: Optional[torch.Tensor] = None
        self._dev: Optional[torch.Tensor] = None

    def __call__(self, values: List[float], device: torch.device) -> torch.Tensor:
        if device.type != "cuda":
            return torch.tensor(values, dtype=torch.float32, device=device)
        if self._dev is None or self._dev.device != device \
                or self._dev.numel() != len(values):
            self._host = torch.empty(len(values), dtype=torch.float32,
                                     pin_memory=True)
            self._dev = torch.empty(len(values), dtype=torch.float32,
                                    device=device)
        self._host.copy_(torch.tensor(values, dtype=torch.float32))
        self._dev.copy_(self._host, non_blocking=True)
        return self._dev


class TpuOptimizer:
    """Base optimizer over a flat fp32 master buffer, with torch-like
    ``param_groups`` on the host."""

    #: hyperparameters read from ``param_groups`` at every step
    TRACED_HYPERPARAMS = ("lr", "weight_decay")

    def __init__(self, params: Optional[Any] = None, lr: float = 1e-3,
                 weight_decay: float = 0.0, **kwargs):
        self.defaults = dict(lr=lr, weight_decay=weight_decay, **kwargs)
        self.param_groups: List[Dict[str, Any]] = [dict(self.defaults)]

    def init(self, master: torch.Tensor,
             segments: Optional[Sequence[Tuple[int, int]]] = None
             ) -> Dict[str, Any]:
        """The optimizer state for the flat fp32 ``master`` buffer; its
        ``step`` counts the steps taken (skipped steps excluded).
        ``segments`` are the (offset, numel) of each parameter tensor in
        the buffer (the engine's leaves, in order; None: one tensor), for
        optimizers with per-tensor math such as LAMB's trust ratio."""
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
