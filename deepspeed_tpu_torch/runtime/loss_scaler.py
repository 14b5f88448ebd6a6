"""Static and dynamic loss scaling on device tensors.

The port of the JAX package's ``runtime/loss_scaler.py`` (the counterpart
of the reference's ``deepspeed/runtime/fp16/loss_scaler.py``).  The scaler
state is three device scalars updated with ``torch.where``, so the
overflow flag never has to reach the host for the scale to move: initial
scale 2^power, growth after ``scale_window`` good steps, halving with
hysteresis on overflow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch


@dataclasses.dataclass(frozen=True)
class LossScalerConfig:
    enabled: bool = False            # False → scale pinned at 1 (bf16/fp32)
    static_scale: float = 0.0        # >0 → static scaling, no dynamics
    init_scale: float = 2.0 ** 16
    scale_window: int = 1000
    scale_factor: float = 2.0
    min_scale: float = 1.0
    delayed_shift: int = 2           # hysteresis

    @classmethod
    def from_ds_config(cls, ds_config) -> "LossScalerConfig":
        if not ds_config.fp16_enabled:
            return cls(enabled=False)
        return cls(
            enabled=True,
            static_scale=float(ds_config.loss_scale),
            init_scale=2.0 ** ds_config.initial_scale_power,
            scale_window=ds_config.loss_scale_window,
            min_scale=ds_config.min_loss_scale,
            delayed_shift=ds_config.hysteresis,
        )

    @property
    def dynamic(self) -> bool:
        return self.enabled and self.static_scale == 0


def init_state(config: LossScalerConfig, device=None) -> Dict[str, torch.Tensor]:
    scale = config.init_scale if config.dynamic else (
        config.static_scale if config.enabled else 1.0)
    return {
        "loss_scale": torch.tensor(scale, dtype=torch.float32, device=device),
        "good_steps": torch.zeros((), dtype=torch.int32, device=device),
        "hysteresis": torch.tensor(config.delayed_shift, dtype=torch.int32,
                                   device=device),
    }


def update_state(state: Dict[str, torch.Tensor],
                 overflow: Union[bool, torch.Tensor],
                 config: LossScalerConfig) -> Dict[str, torch.Tensor]:
    """Advance the scaler state given this step's overflow flag (a device
    bool, or a host bool); the JAX ``update_state`` step for step."""
    if not config.dynamic:
        return {**state, "good_steps": state["good_steps"] + 1}
    scale, good, hyst = state["loss_scale"], state["good_steps"], state["hysteresis"]
    overflow = torch.as_tensor(overflow, dtype=torch.bool, device=scale.device)
    shift = torch.full_like(hyst, config.delayed_shift)

    hyst_after = torch.where(overflow, torch.clamp(hyst - 1, min=0), hyst)
    drop = overflow & (hyst_after <= 0)
    scale_down = torch.clamp(scale / config.scale_factor, min=config.min_scale)

    window_full = good + 1 >= config.scale_window
    grow = ~overflow & window_full
    scale_up = scale * config.scale_factor

    new_scale = torch.where(drop, scale_down, torch.where(grow, scale_up, scale))
    new_good = torch.where(overflow | grow, torch.zeros_like(good), good + 1)
    new_hyst = torch.where(overflow, torch.where(drop, shift, hyst_after), shift)
    return {"loss_scale": new_scale, "good_steps": new_good,
            "hysteresis": new_hyst}


class LossScaler:
    """Host-facing wrapper for API parity (``cur_scale`` etc.)."""

    def __init__(self, config: LossScalerConfig, device=None):
        self.config = config
        self.state = init_state(config, device)

    @property
    def cur_scale(self) -> float:
        return float(self.state["loss_scale"])

    @property
    def dynamic(self) -> bool:
        return self.config.dynamic
