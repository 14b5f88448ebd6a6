"""Learning-rate schedules.

A copy of the JAX package's ``runtime/lr_schedules.py`` (the counterpart
of the reference's ``deepspeed/runtime/lr_schedules.py``: ``LRRangeTest``
:308, ``OneCycle`` :415, ``WarmupLR`` :704, ``WarmupDecayLR`` :800), kept
in the port so that it imports nothing of the JAX package.  Schedulers are
host-side objects that produce scalar learning rates per step; the engine
writes the current value into the optimizer step's device scalars, so a
schedule never adds a host round-trip.

Each scheduler exposes ``step() / get_lr() / get_last_lr() /
state_dict() / load_state_dict()`` exactly like the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _to_list(x) -> List[float]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class _OptimizerLike:
    """Protocol shim: engine optimizers expose ``param_groups`` dicts with an
    ``lr`` key, mirroring torch optimizers so schedule code is identical."""


class _BaseSchedule:
    def __init__(self, optimizer, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    # -- lr plumbing -------------------------------------------------------
    def _update_optimizer_lrs(self, lrs: List[float]) -> None:
        if self.optimizer is None:
            self._last_lr = lrs
            return
        groups = self.optimizer.param_groups
        if len(lrs) == 1:
            lrs = lrs * len(groups)
        for group, lr in zip(groups, lrs):
            group["lr"] = lr
        self._last_lr = lrs

    def get_lr(self) -> List[float]:  # pragma: no cover - abstract
        raise NotImplementedError

    def get_last_lr(self) -> List[float]:
        assert getattr(self, "_last_lr", None) is not None, "called get_last_lr() before scheduler has stepped"
        return self._last_lr

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._update_optimizer_lrs(self.get_lr())

    def state_dict(self) -> Dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_BaseSchedule):
    """LR range test (reference lr_schedules.py:308): linear or staircase ramp."""

    def __init__(self, optimizer, lr_range_test_min_lr: Union[float, List[float]] = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = _to_list(lr_range_test_min_lr)
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            self._update_optimizer_lrs(self.min_lr)

    def _get_increase(self) -> float:
        count = (self.last_batch_iteration + 1) / self.step_size
        if self.staircase:
            count = math.floor(count)
        return 1.0 + self.step_rate * count

    def get_lr(self) -> List[float]:
        inc = self._get_increase()
        return [lr * inc for lr in self.min_lr]


class OneCycle(_BaseSchedule):
    """1-cycle policy over lr and (optionally) momentum (reference :415)."""

    def __init__(self, optimizer, cycle_min_lr: float, cycle_max_lr: float,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8, cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_step_size = cycle_first_step_size
        self.second_step_size = cycle_second_step_size or cycle_first_step_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size
        self.total_cycle_size = self.first_step_size + self.second_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        if last_batch_iteration == -1:
            self._update_optimizer_lrs([cycle_min_lr])

    def _cycle_lr(self, iteration: int) -> float:
        if iteration < self.first_step_size:
            frac = iteration / self.first_step_size
            if self.first_stair_count:
                frac = math.floor(frac * self.first_stair_count) / self.first_stair_count
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
        it2 = iteration - self.first_step_size
        frac = it2 / self.second_step_size
        if self.second_stair_count:
            frac = math.floor(frac * self.second_stair_count) / self.second_stair_count
        return self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * frac

    def _decay_lr(self, iteration: int) -> float:
        decay_iter = iteration - self.total_cycle_size
        if self.decay_step_size:
            decay_iter = math.floor(decay_iter / self.decay_step_size) * self.decay_step_size
        return self.cycle_min_lr / (1.0 + decay_iter * self.decay_lr_rate)

    def get_lr(self) -> List[float]:
        it = self.last_batch_iteration + 1
        if it <= self.total_cycle_size:
            return [self._cycle_lr(it)]
        return [self._decay_lr(it)]

    def get_mom(self) -> List[float]:
        if not self.cycle_momentum:
            return []
        it = self.last_batch_iteration + 1
        if it <= self.total_cycle_size:
            if it < self.first_step_size:
                frac = it / self.first_step_size
                return [self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * frac]
            frac = (it - self.first_step_size) / self.second_step_size
            return [self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * frac]
        decay_iter = it - self.total_cycle_size
        return [self.cycle_max_mom * (1.0 + decay_iter * self.decay_mom_rate)]


class WarmupLR(_BaseSchedule):
    """Linear/log warmup then constant (reference :704)."""

    def __init__(self, optimizer, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = WARMUP_LOG_RATE,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = _to_list(warmup_min_lr)
        self.max_lrs = _to_list(warmup_max_lr)
        self.delta_lrs = [m - n for m, n in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            warmup_type = WARMUP_LOG_RATE
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        if last_batch_iteration == -1:
            self._update_optimizer_lrs(self.get_lr())

    def _get_gamma(self) -> float:
        it = self.last_batch_iteration + 1
        if it < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(it + 1)
            return it / self.warmup_num_steps
        return 1.0

    def get_lr(self) -> List[float]:
        gamma = self._get_gamma()
        return [mn + d * gamma for mn, d in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Warmup then inverse-sqrt-style linear decay to 0 (reference :800)."""

    def __init__(self, optimizer, total_num_steps: int, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE, last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _get_gamma(self) -> float:
        it = self.last_batch_iteration + 1
        if it < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(it + 1)
            return it / self.warmup_num_steps
        return max(
            0.0,
            (self.total_num_steps - it) / max(1, self.total_num_steps - self.warmup_num_steps))


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule_class(name: str):
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name]


def add_tuning_arguments(parser):
    """Add the convergence-tuning CLI group (reference
    ``runtime/lr_schedules.py:55``): one flag per knob of the four
    schedules, so launcher scripts can sweep LR policy from the command
    line and feed the parsed values into the scheduler config."""
    group = parser.add_argument_group(
        "Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # LRRangeTest
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    # type=bool would parse any explicit value (even "False") as True —
    # the reference inherits that argparse footgun; accept real booleans
    group.add_argument("--lr_range_test_staircase",
                       type=lambda v: str(v).lower() in ("1", "true", "yes"),
                       default=False)
    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    # Warmup
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    group.add_argument("--warmup_type", type=str, default="log")
    return parser
