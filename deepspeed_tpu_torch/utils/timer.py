"""Wall-clock and throughput timers.

The port of the JAX package's ``utils/timer.py`` (the counterpart of the
reference's ``deepspeed/utils/timer.py``: ``SynchronizedWallClockTimer``,
``ThroughputTimer``).  CUDA calls return at launch, so a default timer
measures host time between its edges with no device round-trip.  The
device synchronisation is opt-in per timer (``synced=True``): each edge
then waits for the device, and the host interval is the device's.  On a
CUDA device a timer also records a CUDA event at each edge;
``Timer.device_elapsed`` reads the device time between the last start and
stop, waiting only for the stop event, when it is asked for.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _device_synchronize() -> None:
    if _cuda_in_use():
        torch.cuda.synchronize()


class Timer:
    """A named timer with start/stop/elapsed accumulation.  ``synced=True``
    synchronises the device at each edge; the default measures host time."""

    def __init__(self, name: str, synced: bool = False):
        self.name_ = name
        self.synced = bool(synced)
        self.started_ = False
        self.elapsed_ = 0.0
        self.start_time = 0.0
        self._events = None

    def _edge(self) -> Optional[torch.cuda.Event]:
        if self.synced:
            _device_synchronize()
        if not _cuda_in_use():
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self) -> None:
        assert not self.started_, f"{self.name_} timer has already been started"
        self._events = [self._edge(), None]
        self.start_time = time.time()
        self.started_ = True

    def stop(self, reset: bool = False) -> None:
        assert self.started_, f"{self.name_} timer is not started"
        self._events[1] = self._edge()
        delta = time.time() - self.start_time
        self.elapsed_ = delta if reset else self.elapsed_ + delta
        self.started_ = False

    def device_elapsed(self) -> Optional[float]:
        """Device seconds between the last start and stop (CUDA events),
        or None off CUDA."""
        if not self._events or None in self._events:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1]) / 1e3

    def elapsed(self, reset: bool = True) -> float:
        """Accumulated host seconds."""
        started = self.started_
        if started:
            self.stop()
        elapsed = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed

    def reset(self) -> None:
        self.started_ = False
        self.elapsed_ = 0.0

    def mean(self) -> float:
        return self.elapsed(reset=False)


class SynchronizedWallClockTimer:
    """Group of named timers (reference ``utils/timer.py``); the device
    sync is opt-in per timer: ``timers("fwd", synced=True)``."""

    def __init__(self):
        self.timers: Dict[str, Timer] = {}

    def __call__(self, name: str, synced: bool = False) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name, synced=synced)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        if not _cuda_in_use():
            return "mem: n/a"
        return (f"device mem allocated: "
                f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GB, max "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GB")

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None) -> None:
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += f" | {self.memory_usage()}"
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0,
                 reset: bool = True) -> Dict[str, float]:
        assert normalizer > 0.0
        return {name: self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                for name in names if name in self.timers}


class ThroughputTimer:
    """Samples/s across steps (reference ``ThroughputTimer``); host time by
    default, ``synced=True`` synchronises the device at both edges."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: Optional[int] = None,
                 monitor_memory: bool = False, logging_fn=None,
                 synced: bool = False):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False
        self.synced = bool(synced)

    def _sync(self) -> None:
        if self.synced:
            _device_synchronize()

    def update_epoch_count(self) -> None:
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self) -> None:
        self.initialized = True
        self.started = True
        if self.global_step_count >= self.start_step:
            self._sync()
            self.start_time = time.time()

    def stop(self, global_step: bool = False, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            self._sync()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and report_speed and self.steps_per_output and \
                    self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                    f"global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.6g}, "
                    f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.6g}")
            if global_step:
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return -1.0
