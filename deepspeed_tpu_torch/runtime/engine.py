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

Left out (ROADMAP.md Queue 1): the data loader, PLD, curriculum,
compression, telemetry, the monitor, the gradient-collapse modes, offload
and ZeRO ≥ 2, and with them their checkpoint branches.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..ops import adam as _adam  # noqa: F401 — registers adam/adamw/sgd
from ..ops import lamb as _lamb  # noqa: F401 — registers lamb/fusedlamb
from ..ops.optimizer import TpuOptimizer, get_optimizer_class
from ..utils.logging import log_dist
from ..utils.timer import ThroughputTimer
from . import loss_scaler as ls
from .checkpoint_engine.async_checkpoint_engine import AsyncCheckpointEngine
from .checkpoint_engine.commit import (CollectiveConsensusChannel,
                                       CommitContext, process_world_size)
from .checkpoint_engine.native_checkpoint_engine import (
    load_engine_checkpoint, save_engine_checkpoint)
from .config import DeepSpeedConfig
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


class DeepSpeedEngine:
    """DeepSpeed-style training engine over flat parameter buffers."""

    def __init__(self, model: Optional[ModelSpec] = None,
                 config: Union[str, Dict, None] = None,
                 optimizer: Optional[TpuOptimizer] = None,
                 lr_scheduler=None, device=None,
                 generator: Optional[torch.Generator] = None):
        assert model is not None, "deepspeed_tpu_torch.initialize requires a ModelSpec"
        self.device = get_accelerator().resolve_device(device)
        self._config = DeepSpeedConfig(config)
        self.module = model

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
        loss = self.module.loss_fn(self._train_params, batch)
        scaled = loss * scale / self.gradient_accumulation_steps()
        grads = torch.autograd.grad(scaled, self._leaves, allow_unused=True)
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
        overflow = self._apply_step() if boundary else False
        self.tput_timer.stop(global_step=boundary)
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.dp_world_size
        if boundary:
            self._finish_model_step(overflow, lr_kwargs)

    def _apply_step(self) -> bool:
        """The boundary update on the device (module docstring); returns
        the overflow flag, read from the device once."""
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
        # the step/skip decision is host control flow: one scalar read
        overflow_host = bool(overflow)
        if not overflow_host:
            self.state["opt_state"]["step"] += 1
        return overflow_host

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

    def train_batch_fused(self, batches):
        """A whole train batch ([gas × micro, ...] on dim 0): the gas
        micro-steps and the boundary step, eagerly; the same result as
        forward/backward/step.  Returns the mean micro-batch loss."""
        gas = self.gradient_accumulation_steps()
        batches = {k: v.reshape((gas, -1) + tuple(v.shape[1:]))
                   for k, v in self._to_device(batches).items()}
        self.tput_timer.start()
        losses = [self._micro({k: v[i] for k, v in batches.items()})
                  for i in range(gas)]
        overflow = self._apply_step()
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
        (journal, heartbeat monitor) for the saves' two-phase commit."""
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
                if world > 1 else None)
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
        when nothing was loaded."""
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
        return load_dir, client_state
