"""The training engine: the port of the JAX package's ``runtime/engine.py``
main path (``DeepSpeedEngine``: forward / backward / step at the
gradient-accumulation boundary, ``train_batch_fused``, ``eval_loss``).

State lives in flat buffers on one device:

- ``master``: fp32 master params, one contiguous buffer;
- ``params``: the compute-dtype params the loss reads.  With mixed
  precision or ZeRO stage ≥ 1 (``engine.py:525``) it is a second buffer,
  else the master itself;
- ``grad_acc``: the fp32 gradient accumulator, one buffer;
- the optimizer's state over the master (Adam and LAMB: two fp32 moment
  buffers).  The optimizer also gets each parameter leaf's (offset,
  numel): LAMB takes one trust ratio per leaf, whole layer stacks
  included, as the JAX optimizer takes one per pytree leaf.

The trees in ``engine.state`` are views of those buffers in the model's
layout.  The loss differentiates with respect to views of ``params``:
one autograd leaf per parameter, and per layer for the subtrees the model
stacks by layer (``ModelSpec.meta["layer_stacked"]``), so a layer's
gradient lands once in its own slice.

A micro-step (``forward``) runs the loss and its backward at once, as the
JAX engine's fused micro step does: the gradient of loss·scale/gas, in
the compute dtype, is added to the fp32 accumulator (``engine.py:1080-
1088``); ``backward`` is bookkeeping.  At the boundary (``apply_core``,
``engine.py:1200-1233``): the global norm of the unscaled accumulator, the
overflow flag (a non-finite norm, when the fp16 scaler is on), the clip
coefficient, then one optimizer step over the flat buffers (the
``fused_adam`` kernel for Adam, the two ``fused_lamb`` kernels for LAMB)
that multiplies the gradient by coefficient / scale, skips on overflow
without touching any state, refreshes the compute copy and zeroes the
accumulator.  The loss scale
then moves on the device, and the host reads the overflow flag once per
step, to count a skipped step and to step the LR schedule only when the
step was taken (``engine.py:1884-1901``).

Checkpoints (``save_checkpoint``/``load_checkpoint``, JAX ``engine.py:
1996-2235``) are written in the JAX package's layout
(``checkpoint_engine/``): the flat buffers are saved as trees of per-leaf
views, the optimizer's state as ``opt_state/{step, exp_avg, exp_avg_sq}``
with an int32 ``step``, and a load copies into the flat buffers in place,
so the autograd leaves and the accumulator views keep training the loaded
state.

The data loader (``deepspeed_io``, JAX ``engine.py:1347-1373``) yields
numpy batches; a registered iterator (``set_data_iterator``) rides in
every checkpoint's ``client_state["data_iterator"]`` and is restored by
every load before it returns.  Telemetry (JAX ``engine.py:338-466``):
``engine.tracer`` records ``train.step`` around a fused step, and inside
it ``train.fwd`` (a micro-batch's loss), ``train.bwd`` (its backward and
accumulation), ``train.optimizer`` (the boundary update) and
``train.host_sync`` (the overflow read), plus ``ckpt.save``/``ckpt.load``
and, through the commit context, ``ckpt.commit``; ``engine.metrics`` and
its sampler stream ``metrics.jsonl``, and ``wall_clock_breakdown`` prints
the ``time (ms) | ...`` line from the span aggregates.  Spans are off
unless the config asks: then the step adds no device call.

Left out (ROADMAP.md Queue 1): PLD, curriculum, compression, the
monitor, the gradient-collapse modes (and their ``train.grad_sync`` and
``comm.reduce`` spans), offload and ZeRO ≥ 2, and with them their
checkpoint branches.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..ops import adam as _adam  # noqa: F401 — registers adam/adamw/sgd
from ..ops import lamb as _lamb  # noqa: F401 — registers lamb/fusedlamb
from ..ops.optimizer import TpuOptimizer, get_optimizer_class
from ..telemetry.metrics import (MetricName, MetricsRegistry, MetricsSampler,
                                 analytic_mfu, host_rss_bytes,
                                 live_buffer_bytes, peak_flops_per_chip)
from ..telemetry.spans import SpanName, Tracer
from ..utils.logging import log_dist, logger
from ..utils.timer import ThroughputTimer
from . import loss_scaler as ls
from .checkpoint_engine.async_checkpoint_engine import AsyncCheckpointEngine
from .checkpoint_engine.commit import (CollectiveConsensusChannel,
                                       CommitContext, process_world_size)
from .checkpoint_engine.native_checkpoint_engine import (
    load_engine_checkpoint, save_engine_checkpoint)
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader
from .lr_schedules import get_lr_schedule_class
from .model import ModelSpec
from .utils import clip_coefficient, global_grad_norm

Path = Tuple[str, ...]


def _dtype_of(cfg: DeepSpeedConfig) -> torch.dtype:
    if cfg.fp16_enabled:
        return torch.float16
    if cfg.bfloat16_enabled:
        return torch.bfloat16
    return torch.float32


def _flatten(tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, prefix + (k,))]
    return [(prefix, tree)]


def _set(tree: dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class HostSyncs(dict):
    """Sanctioned device→host syncs by label (the JAX engine's
    ``CompiledProgramRegistry.note_host_sync`` count); the tracer reports
    its synced spans' barriers here, not to the engine, so the engine and
    its buffers are freed when the last reference goes."""

    def note_host_sync(self, label: str) -> None:
        self[label] = self.get(label, 0) + 1


class DeepSpeedEngine:
    """DeepSpeed-style training engine over flat parameter buffers."""

    def __init__(self, model: Optional[ModelSpec] = None,
                 config: Union[str, Dict, None] = None,
                 optimizer: Optional[TpuOptimizer] = None,
                 lr_scheduler=None, device=None,
                 generator: Optional[torch.Generator] = None,
                 training_data=None, collate_fn=None):
        assert model is not None, "deepspeed_tpu_torch.initialize requires a ModelSpec"
        self.device = get_accelerator().resolve_device(device)
        self._config = DeepSpeedConfig(config)
        self.module = model
        self.collate_fn = collate_fn
        #: the stateful iterator whose position rides in checkpoints
        self.data_iterator = None
        self.host_syncs = HostSyncs()

        # counters (reference engine.py attribute names)
        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0

        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print())

        self.compute_dtype = _dtype_of(self._config)
        self.scaler_config = ls.LossScalerConfig.from_ds_config(self._config)
        self._configure_optimizer(optimizer)
        self._configure_lr_scheduler(lr_scheduler)
        self._init_state(generator)

        self._pending: Optional[torch.Tensor] = None
        self._training = True

        # checkpoint backend: async_save runs writers in the background,
        # committing before the latest marker publishes
        self._checkpoint_engine = AsyncCheckpointEngine(
            self._config.checkpoint_config) \
            if self._config.checkpoint_config.async_save else None
        # commit/consensus context: attached by the caller, else built at
        # the first save or load (_commit_context)
        self._commit_ctx: Optional[CommitContext] = None
        self._configure_telemetry()
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None
        log_dist(f"DeepSpeedEngine configured: ZeRO stage "
                 f"{self.zero_optimization_stage()} on {self.device}; "
                 f"dtype={self.compute_dtype}, "
                 f"gas={self.gradient_accumulation_steps()}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"train_batch={self.train_batch_size()}", ranks=[0])

    # ------------------------------------------------------------------ config accessors (reference API)
    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def gradient_clipping(self) -> float:
        return self._config.gradient_clipping

    def zero_optimization_stage(self) -> int:
        return self._config.zero_optimization_stage

    def zero_optimization(self) -> bool:
        return self._config.zero_enabled

    def fp16_enabled(self) -> bool:
        return self._config.fp16_enabled

    def bfloat16_enabled(self) -> bool:
        return self._config.bfloat16_enabled

    def steps_per_print(self) -> int:
        return self._config.steps_per_print

    def wall_clock_breakdown(self) -> bool:
        return self._config.wall_clock_breakdown

    @property
    def dp_world_size(self) -> int:
        return 1

    @property
    def global_rank(self) -> int:
        return 0

    @property
    def cur_scale(self) -> float:
        return float(self.state["scale"]["loss_scale"])

    @property
    def lr_scheduler(self):
        return self._lr_scheduler

    def get_lr(self) -> List[float]:
        return [g["lr"] for g in self.optimizer.param_groups]

    def get_global_grad_norm(self) -> Optional[float]:
        """The last boundary step's global norm of the unscaled gradients
        (before clipping); read from the device when asked."""
        norm = self._last_global_norm
        return None if norm is None else float(norm)

    def reset_loss_scale(self) -> None:
        """Reinitialize the dynamic loss-scale state on the device (scale,
        good-step counter, hysteresis; JAX ``engine.py:330-335``).  Used
        by the supervision rollback policy: the carried scaler trajectory
        belongs to the diverged run."""
        self.state["scale"] = ls.init_state(self.scaler_config, self.device)

    def note_host_sync(self, label: str) -> None:
        """Count one sanctioned device→host sync (the step's overflow
        read, a synced span's barrier)."""
        self.host_syncs.note_host_sync(label)

    # ------------------------------------------------------------------ telemetry
    def _configure_telemetry(self) -> None:
        """The tracer and the metrics stream from the ``telemetry``
        section (JAX ``engine.py:338-392``).  ``wall_clock_breakdown``
        alone also turns spans on: its log line is made from their
        aggregates."""
        tcfg = self._config.telemetry_config
        spans_on = (tcfg.enabled and tcfg.spans.enabled) or \
            self.wall_clock_breakdown()
        self.tracer = Tracer(enabled=spans_on, capacity=tcfg.spans.capacity,
                             synced=tcfg.spans.synced,
                             sync_registry=self.host_syncs,
                             name="engine", device=self.device)
        self.metrics = MetricsRegistry("engine")
        self._mem_interval_s = float(tcfg.metrics.memory_interval_s)
        self._mem_cache = (0.0, 0, 0)  # (refreshed_at, rss, device bytes)
        path = tcfg.metrics.path if (tcfg.enabled and tcfg.metrics.enabled) \
            else None
        self.metrics_sampler = MetricsSampler(
            self.metrics, path, rank=self.global_rank,
            interval_steps=tcfg.metrics.interval_steps)
        if self.metrics_sampler.enabled:
            self.metrics_sampler.attach_source(self._metrics_source)
            self.metrics_sampler.start()
        # online MFU: analytic FLOPs/token of a GPT, the card's peak from
        # the config or the card table
        self._flops_per_token = None
        cfg = self.module.meta.get("config")
        if "flops_per_token" in self.module.meta:
            self._flops_per_token = float(self.module.meta["flops_per_token"])
        elif cfg is not None and hasattr(cfg, "d_model"):
            from ..models import gpt as _gpt
            try:
                self._flops_per_token = float(_gpt.flops_per_token(cfg))
            except AttributeError:      # no GPT-shaped config: MFU 0
                self._flops_per_token = None
        if tcfg.metrics.peak_tflops is not None:
            self._peak_flops = float(tcfg.metrics.peak_tflops) * 1e12
        elif self.device.type == "cuda":
            self._peak_flops = peak_flops_per_chip(
                torch.cuda.get_device_name(self.device))
        else:
            self._peak_flops = None
        self._step_t_last: Optional[float] = None
        self._tokens_since_sample = 0
        self._wall_since_sample = 0.0
        self._breakdown_base: Dict[str, Any] = {}

    def _metrics_source(self) -> Dict[str, Any]:
        """Engine-owned gauges pulled at every sample; the memory census
        refreshes at most once per ``metrics.memory_interval_s``."""
        t_mem, rss, dev = self._mem_cache
        now = time.monotonic()
        if t_mem == 0.0 or now - t_mem >= self._mem_interval_s:
            rss, dev = host_rss_bytes(), live_buffer_bytes(self.device)
            self._mem_cache = (now, rss, dev)
        return {
            MetricName.STEPS: self.global_steps,
            MetricName.SKIPPED_STEPS: self.skipped_steps,
            MetricName.HOST_RSS_BYTES: rss,
            MetricName.HBM_LIVE_BYTES: dev,
            MetricName.HOST_SYNCS: sum(self.host_syncs.values()),
        }

    def _count_batch_tokens(self, batch) -> None:
        """Trained tokens for the throughput gauges (GPT-style batches:
        rows × (seq − 1) next-token targets; other batches count rows)."""
        if not self.metrics_sampler.enabled:
            return
        toks = batch.get("tokens") if isinstance(batch, dict) else None
        shape = tuple(toks.shape) if toks is not None else None
        if shape and len(shape) >= 2:
            self._tokens_since_sample += int(np.prod(shape[:-1])) \
                * max(1, shape[-1] - 1)
        elif shape:
            self._tokens_since_sample += int(shape[0])

    def _note_step_telemetry(self) -> None:
        """Boundary-step bookkeeping (JAX ``engine.py:420-450``): the
        step-time histogram, and at the sample cadence tokens/s, online
        MFU and memory streamed to metrics.jsonl; the
        ``wall_clock_breakdown`` line every ``steps_per_print`` steps."""
        now = time.monotonic()
        if self._step_t_last is not None:
            dt = now - self._step_t_last
            self._wall_since_sample += dt
            if self.metrics_sampler.enabled:
                self.metrics.histogram(MetricName.STEP_TIME_S).observe(dt)
        self._step_t_last = now
        if self.metrics_sampler.should_sample(self.global_steps):
            if self._wall_since_sample > 0:
                tok_s = self._tokens_since_sample / self._wall_since_sample
                self.metrics.gauge(MetricName.TOKENS_PER_S).set(tok_s)
                if self._flops_per_token:
                    m = analytic_mfu(tok_s, self._flops_per_token,
                                     self._peak_flops,
                                     n_chips=self.dp_world_size)
                    self.metrics.gauge(MetricName.MFU).set(m["mfu"])
                    self.metrics.gauge(MetricName.TFLOPS).set(m["tflops"])
            self.metrics_sampler.sample(step=self.global_steps)
            self._tokens_since_sample = 0
            self._wall_since_sample = 0.0
        if self.wall_clock_breakdown() and \
                self.global_steps % self.steps_per_print() == 0:
            self._log_breakdown()

    def _log_breakdown(self) -> None:
        """The ``wall_clock_breakdown`` line, from span aggregates: mean ms
        per span name since the previous line."""
        agg = self.tracer.aggregates()
        parts = []
        for name, cur in agg.items():
            base = self._breakdown_base.get(name, {"count": 0,
                                                   "total_s": 0.0})
            dc = cur["count"] - base["count"]
            if dc <= 0:
                continue
            dt_ms = (cur["total_s"] - base["total_s"]) * 1e3 / dc
            parts.append(f"{name}: {dt_ms:.2f}")
        self._breakdown_base = agg
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=[0])

    # ------------------------------------------------------------------ setup
    def _configure_optimizer(self, client_optimizer) -> None:
        if client_optimizer is not None:
            self.optimizer = client_optimizer
            return
        name = self._config.optimizer_name or "adam"
        params = dict(self._config.optimizer_params or {})
        if params.get("betas") is not None:
            params["betas"] = tuple(params["betas"])
        self.optimizer = get_optimizer_class(name)(**params)

    def _configure_lr_scheduler(self, client_scheduler) -> None:
        if client_scheduler is not None:
            self._lr_scheduler = client_scheduler
        elif self._config.scheduler_name is not None:
            cls = get_lr_schedule_class(self._config.scheduler_name)
            self._lr_scheduler = cls(self.optimizer,
                                     **(self._config.scheduler_params or {}))
        else:
            self._lr_scheduler = None

    def _init_state(self, generator: Optional[torch.Generator]) -> None:
        """The flat buffers, the trees of views over them, and the
        per-parameter autograd leaves."""
        dev = self.device
        if self.module.params is not None:
            tree = self.module.params
        else:
            assert self.module.init_fn is not None, "ModelSpec needs params or init_fn"
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            tree = self.module.init_fn(generator)
        leaves = _flatten(tree)
        self._layout: List[Tuple[Path, torch.Size, int]] = []
        offset = 0
        for path, t in leaves:
            self._layout.append((path, t.shape, offset))
            offset += t.numel()
        n = offset
        master = torch.empty(n, dtype=torch.float32, device=dev)
        for (path, shape, off), (_, t) in zip(self._layout, leaves):
            master[off:off + t.numel()].copy_(t.reshape(-1))
        del tree, leaves
        self._separate_master = (self.compute_dtype != torch.float32
                                 or self.zero_optimization_stage() >= 1)
        params = master.to(self.compute_dtype, copy=True) \
            if self._separate_master else master
        grad_acc = torch.zeros(n, dtype=torch.float32, device=dev)
        self._flat = {"master": master, "params": params, "grad_acc": grad_acc}
        self.state: Dict[str, Any] = {
            "params": self._tree(params), "master": self._tree(master),
            "opt_state": self.optimizer.init(
                master, [(off, shape.numel()) for _, shape, off in self._layout]),
            "grad_acc": self._tree(grad_acc),
            "scale": ls.init_state(self.scaler_config, dev),
        }
        self._train_params, self._leaves = self._autograd_tree(params)
        _, self._acc_views = self._autograd_tree(grad_acc, leaf=False)
        self._last_global_norm: Optional[torch.Tensor] = None

    def _tree(self, flat: torch.Tensor) -> dict:
        """The parameter tree as views of ``flat``."""
        tree: dict = {}
        for path, shape, off in self._layout:
            _set(tree, path, flat[off:off + shape.numel()].view(shape))
        return tree

    def _autograd_tree(self, flat: torch.Tensor, leaf: bool = True):
        """The tree the loss reads, whose tensors are views of ``flat``
        (per layer under the model's ``layer_stacked`` subtrees), and
        the flat list of those views, each an autograd leaf if ``leaf``."""
        stacked = tuple(self.module.meta.get("layer_stacked", ()))
        tree: dict = {}
        views: List[torch.Tensor] = []
        for path, shape, off in self._layout:
            whole = flat[off:off + shape.numel()].view(shape)
            if path[0] in stacked:
                value = list(whole.unbind(0))
                views.extend(value)
            else:
                value = whole
                views.append(whole)
            _set(tree, path, value)
        if leaf:
            for v in views:
                v.requires_grad_(True)
        return tree, views

    # ------------------------------------------------------------------ data
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A loader over ``dataset`` at the global batch (JAX
        ``engine.py:1347-1366``): with ``data.resumable`` a
        :class:`ResumableDataLoader`, registered as the engine's data
        iterator under ``data.checkpoint_iterator``; else the per-epoch
        :class:`DeepSpeedDataLoader`.  Both yield numpy batches."""
        bs = batch_size or \
            self.train_micro_batch_size_per_gpu() * self.dp_world_size
        cf = collate_fn or self.collate_fn
        dc = self._config.data_config
        if dc.resumable:
            from .data_pipeline.resumable import ResumableDataLoader
            loader = ResumableDataLoader(
                dataset, batch_size=bs, collate_fn=cf, shuffle=dc.shuffle,
                seed=dc.seed, drop_last=dc.drop_last,
                max_epochs=dc.max_epochs,
                max_bad_records=dc.max_bad_records,
                journal_batches=dc.journal_batches)
            if dc.checkpoint_iterator:
                self.set_data_iterator(loader)
            return loader
        return DeepSpeedDataLoader(dataset, batch_size=bs, collate_fn=cf)

    def set_data_iterator(self, iterator) -> None:
        """Register a stateful data iterator (``state_dict``/
        ``load_state_dict``): its position is saved in every checkpoint
        and restored by every load, so a resume lands on the exact next
        batch."""
        self.data_iterator = iterator

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        def put(x):
            t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
            if not t.is_floating_point():
                t = t.long()
            return t.to(self.device, non_blocking=True)
        return {k: put(v) for k, v in batch.items()}

    # ------------------------------------------------------------------ train
    def _micro(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One micro-batch: the loss, its backward, and the accumulation of
        the gradient of loss·scale/gas into the fp32 buffer."""
        scale = self.state["scale"]["loss_scale"]
        with self.tracer.span(SpanName.TRAIN_FWD):
            loss = self.module.loss_fn(self._train_params, batch)
            scaled = loss * scale / self.gradient_accumulation_steps()
        with self.tracer.span(SpanName.TRAIN_BWD):
            grads = torch.autograd.grad(scaled, self._leaves,
                                        allow_unused=True)
            with torch.no_grad():
                for acc, g in zip(self._acc_views, grads):
                    if g is not None:
                        acc.add_(g)
        return loss.detach()

    def forward(self, batch, **kwargs):
        """Loss (and, fused, the accumulated gradients) of one micro-batch."""
        if not self._training:
            # a validation forward must not touch the accumulator
            loss = self.eval_loss(batch)
            self._pending = loss
            return loss
        self.tput_timer.start()
        self._count_batch_tokens(batch)
        loss = self._micro(self._to_device(batch))
        self._pending = loss
        return loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients: bool = True,
                 release_loss: bool = False):
        """Accumulation bookkeeping (the gradients came with forward)."""
        assert self._pending is not None, "backward() called before forward()"
        loss, self._pending = self._pending, None
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        """Reference engine.py:1902 semantics."""
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None) -> None:
        """Apply the optimizer at the gas boundary; otherwise just count."""
        boundary = self.is_gradient_accumulation_boundary()
        overflow = self._boundary_update() if boundary else False
        self.tput_timer.stop(global_step=boundary)
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.dp_world_size
        if boundary:
            self._finish_model_step(overflow, lr_kwargs)

    def _boundary_update(self) -> bool:
        """The boundary update (``train.optimizer``), then the one read of
        its overflow flag (``train.host_sync``); returns the flag."""
        with self.tracer.span(SpanName.TRAIN_OPTIMIZER):
            overflow = self._apply_step()
        self.note_host_sync("step.overflow")
        with self.tracer.span(SpanName.TRAIN_HOST_SYNC,
                              label="step.overflow"):
            # the step/skip decision is host control flow: one scalar read
            overflow_host = bool(overflow)
        if not overflow_host:
            self.state["opt_state"]["step"] += 1
        return overflow_host

    def _apply_step(self) -> torch.Tensor:
        """The boundary update on the device (module docstring); returns
        the overflow flag on the device."""
        acc = self._flat["grad_acc"]
        scale = self.state["scale"]["loss_scale"]
        norm = global_grad_norm(acc) / scale
        enabled = self.scaler_config.enabled
        overflow = ~torch.isfinite(norm) if enabled else \
            torch.zeros((), dtype=torch.bool, device=self.device)
        clip = self.gradient_clipping()
        if clip > 0:
            gscale = clip_coefficient(norm, clip) / scale
        elif enabled:
            gscale = 1.0 / scale
        else:
            gscale = None
        self.optimizer.step_flat(
            self._flat["master"], acc, self.state["opt_state"],
            self.optimizer.current_hyperparams(),
            compute=self._flat["params"] if self._separate_master else None,
            grad_scale=gscale, skip=overflow if enabled else None)
        self.state["scale"] = ls.update_state(self.state["scale"], overflow,
                                              self.scaler_config)
        self._last_global_norm = norm
        return overflow

    def _finish_model_step(self, overflow: bool, lr_kwargs=None) -> None:
        """Post-step bookkeeping: counters, scheduler, periodic log."""
        self.global_steps += 1
        if overflow:
            self.skipped_steps += 1
            log_dist(f"[deepspeed_tpu_torch] OVERFLOW! skipping step, "
                     f"reducing loss scale to {self.cur_scale}", ranks=[0])
        elif self._lr_scheduler is not None:
            self._lr_scheduler.step(**(lr_kwargs or {}))
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}, loss_scale={self.cur_scale}", ranks=[0])
        self._note_step_telemetry()

    def train_batch_fused(self, batches):
        """A whole train batch ([gas × micro, ...] on dim 0): the gas
        micro-steps and the boundary step, eagerly; the same result as
        forward/backward/step.  Returns the mean micro-batch loss."""
        with self.tracer.span(SpanName.TRAIN_STEP,
                              step=self.global_steps + 1):
            return self._train_batch_fused_inner(batches)

    def _train_batch_fused_inner(self, batches):
        gas = self.gradient_accumulation_steps()
        self._count_batch_tokens(batches)
        batches = {k: v.reshape((gas, -1) + tuple(v.shape[1:]))
                   for k, v in self._to_device(batches).items()}
        self.tput_timer.start()
        losses = [self._micro({k: v[i] for k, v in batches.items()})
                  for i in range(gas)]
        overflow = self._boundary_update()
        self.tput_timer.stop(global_step=True)
        self.micro_steps += gas
        self.global_samples += self.train_batch_size()
        self._finish_model_step(overflow)
        return torch.stack(losses).mean()

    # ------------------------------------------------------------------ eval
    def eval_loss(self, batch) -> torch.Tensor:
        """The loss on ``batch`` with the current params; no gradient, the
        accumulator untouched."""
        with torch.no_grad():
            return self.module.loss_fn(self._train_params,
                                       self._to_device(batch))

    def train(self, mode: bool = True) -> "DeepSpeedEngine":
        self._training = bool(mode)
        return self

    def eval(self) -> "DeepSpeedEngine":
        return self.train(False)

    # ------------------------------------------------------------------ checkpoint
    def set_commit_context(self, ctx: Optional[CommitContext]) -> None:
        """Attach a :class:`~.checkpoint_engine.commit.CommitContext`
        (journal, heartbeat monitor) for the saves' two-phase commit; its
        ``ckpt.commit`` spans land in this engine's tracer."""
        if ctx is not None and getattr(ctx, "tracer", None) is None:
            ctx.tracer = self.tracer
        self._commit_ctx = ctx

    def _commit_context(self) -> Optional[CommitContext]:
        """The commit context for this save/load: the attached one, else a
        default over the process world (one rank, no channel; a world of
        more than one process raises in ``CollectiveConsensusChannel``).
        ``None`` when the protocol is disabled in config."""
        cfg = self._config.checkpoint_config.commit_config
        if not cfg.enabled:
            return None
        if self._commit_ctx is None:
            world = process_world_size()
            self._commit_ctx = CommitContext(
                world_size=world, rank=self.global_rank, config=cfg,
                channel=CollectiveConsensusChannel(world_size=world)
                if world > 1 else None, tracer=self.tracer)
        return self._commit_ctx

    def _checkpoint_state(self) -> Dict[str, Any]:
        """The engine state in the JAX engine's tree layout, every tensor
        a view of the flat buffers (the optimizer's ``step`` a fresh int32
        scalar): what a save writes and a load copies into.  Optimizer
        entries that are not a buffer over the master (LAMB's segments)
        follow from the model's layout and are not state."""
        n = self._flat["master"].numel()
        opt: Dict[str, Any] = {}
        for key, value in self.state["opt_state"].items():
            if key == "step":
                opt[key] = torch.tensor(value, dtype=torch.int32)
            elif torch.is_tensor(value) and value.numel() == n:
                opt[key] = self._tree(value)
        return {"params": self.state["params"], "master": self.state["master"],
                "opt_state": opt, "grad_acc": self.state["grad_acc"],
                "scale": self.state["scale"]}

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True) -> bool:
        """Write ``<save_dir>/<tag>`` (default ``global_step<N>``) in the
        JAX package's layout, run the commit protocol and move ``latest``;
        with ``async_save`` the files are written in the background from a
        host copy taken before this returns."""
        tag = tag or f"global_step{self.global_steps}"
        with self.tracer.span(SpanName.CKPT_SAVE, tag=tag):
            return self._save_checkpoint_inner(save_dir, tag, client_state,
                                               save_latest)

    def _save_checkpoint_inner(self, save_dir, tag, client_state,
                               save_latest) -> bool:
        client_state = dict(client_state or {})
        client_state.update({
            "micro_steps": self.micro_steps,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
        })
        if self._lr_scheduler is not None:
            client_state["lr_scheduler"] = self._lr_scheduler.state_dict()
        client_state["optimizer_param_groups"] = self.optimizer.param_groups
        if self.data_iterator is not None and \
                hasattr(self.data_iterator, "state_dict"):
            client_state["data_iterator"] = self.data_iterator.state_dict()
        save_engine_checkpoint(save_dir, tag, self._checkpoint_state(),
                               client_state,
                               separate_master=self._separate_master,
                               save_latest=save_latest,
                               engine=self._checkpoint_engine,
                               config=self._config.checkpoint_config,
                               manifest_meta={
                                   "world_size": self.dp_world_size,
                                   "writer": {"rank": self.global_rank},
                               },
                               commit_ctx=self._commit_context())
        self._copy_recovery_script(save_dir)
        return True

    def _copy_recovery_script(self, save_dir: str) -> None:
        """Drop a fp32-recovery shim next to the checkpoints (the
        reference's ``engine.py:3249``), atomically and once."""
        if self.global_rank != 0:
            return
        path = os.path.join(save_dir, "zero_to_fp32.py")
        if os.path.exists(path):
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(
                "#!/usr/bin/env python3\n"
                '"""Recover a consolidated fp32 state dict from this '
                'checkpoint dir.\nUsage: python zero_to_fp32.py . out.npz '
                '[tag]\n"""\n'
                "import sys\n"
                "from deepspeed_tpu_torch.utils.zero_to_fp32 import main\n"
                "sys.exit(main())\n")
        os.replace(tmp, path)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False):
        """Load ``tag`` (default: ``latest``, falling back past corrupt
        tags to the newest that verifies) into the engine's buffers in
        place; returns ``(load_dir, client_state)``, or ``(None, {})``
        when nothing was loaded.  A registered data iterator is restored
        before this returns."""
        with self.tracer.span(SpanName.CKPT_LOAD, tag=tag or ""):
            return self._load_checkpoint_inner(
                load_dir, tag, load_optimizer_states,
                load_lr_scheduler_states, load_module_only)

    def wait_for_checkpoint(self) -> None:
        """Block until every async save's bytes have landed and its tag is
        published (re-raises a background write failure); a no-op for
        sync saves."""
        if self._checkpoint_engine is not None:
            self._checkpoint_engine.wait()

    def _load_checkpoint_inner(self, load_dir, tag, load_optimizer_states,
                               load_lr_scheduler_states, load_module_only):
        if self._checkpoint_engine is not None:
            # never read our own in-flight async writes (also re-raises a
            # background write failure here instead of losing it)
            self._checkpoint_engine.wait()
        # a world of more than one process would need the resume consensus
        # of the JAX engine: building its context raises (Queue 1 #7)
        self._commit_context()
        load_optimizer_states = load_optimizer_states and not load_module_only
        view = self._checkpoint_state()
        state, client_state = load_engine_checkpoint(
            load_dir, tag, view, load_optimizer_states=load_optimizer_states,
            separate_master=self._separate_master,
            config=self._config.checkpoint_config)
        if state is None:
            return None, {}
        client_state.pop("_ckpt_tag", None)
        if load_optimizer_states and "step" in view["opt_state"]:
            self.state["opt_state"]["step"] = int(view["opt_state"]["step"])
        self.micro_steps = client_state.get("micro_steps", 0)
        self.global_steps = client_state.get("global_steps", 0)
        self.global_samples = client_state.get("global_samples", 0)
        self.skipped_steps = client_state.get("skipped_steps", 0)
        if load_lr_scheduler_states and self._lr_scheduler is not None and \
                "lr_scheduler" in client_state:
            self._lr_scheduler.load_state_dict(client_state["lr_scheduler"])
        if "optimizer_param_groups" in client_state and load_optimizer_states:
            restored = client_state["optimizer_param_groups"]
            if len(restored) == len(self.optimizer.param_groups):
                self.optimizer.param_groups = restored
            else:
                log_dist(
                    f"checkpoint has {len(restored)} param groups but the "
                    f"optimizer was constructed with "
                    f"{len(self.optimizer.param_groups)}; keeping the "
                    "constructed groups (hyperparams from the checkpoint "
                    "are NOT restored)", ranks=[0], level=logging.WARNING)
        if self.data_iterator is not None and \
                hasattr(self.data_iterator, "load_state_dict") and \
                "data_iterator" in client_state:
            try:
                self.data_iterator.load_state_dict(
                    client_state["data_iterator"])
            except ValueError as e:
                # geometry changed between save and load: the saved position
                # no longer names the same batches — keep the live position
                # and say so
                logger.warning(
                    f"data iterator state in checkpoint NOT restored: {e}")
        return load_dir, client_state
