"""The DeepSpeed-style JSON config, cut to the training slice.

The port of the JAX package's ``runtime/config.py`` (the counterpart of
the reference's ``deepspeed/runtime/config.py``: ``DeepSpeedConfig`` :717,
the batch algebra ``_set_batch_related_parameters`` :954).  It reads the
sections the training path runs: the batch triple, ``optimizer``,
``scheduler``, ``fp16``/``bf16``, ``gradient_clipping``,
``steps_per_print``, ``zero_optimization`` (stage 0 or 1),
``sparse_attention`` (kept raw, as the JAX package keeps it),
``checkpoint`` (the typed durability section,
``checkpoint_engine/config.py``), ``data`` (the resumable loader,
``data_pipeline/config.py``), ``supervision`` (watchdog, heartbeats,
rollback, ``supervision/config.py``), ``telemetry`` (spans and the metrics
stream, ``telemetry/config.py``), ``elasticity`` (kept raw, read by the
elastic runner's admission check) and ``wall_clock_breakdown``.  Any
other top-level section raises
:class:`DeepSpeedConfigError`: a config that asks for telemetry or another
unported feature must not train silently without it.  HF-style ``"auto"``
values resolve as in the JAX package, except that a fully automatic batch
triple takes micro-batch 1 (the memory-model sizing is not ported).

The data-parallel world size of the batch algebra is ``world_size`` (1 on
the one device the port trains on).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Union

from . import constants as C
from ..telemetry.config import DeepSpeedTelemetryConfig
from .checkpoint_engine.config import DeepSpeedCheckpointConfig
from .data_pipeline.config import DeepSpeedDataConfig
from .supervision.config import DeepSpeedSupervisionConfig
from .zero.config import ZERO_OPTIMIZATION, DeepSpeedZeroConfig


class DeepSpeedConfigError(Exception):
    pass


#: "auto" (HF integration sentinel, reference config.py)
AUTO = "auto"

#: top-level sections the port reads; every other one raises
PORTED_SECTIONS = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.STEPS_PER_PRINT, C.GRADIENT_CLIPPING,
    C.FP16, C.BFLOAT16, C.BFLOAT16_OLD, C.OPTIMIZER, C.SCHEDULER,
    C.SPARSE_ATTENTION, C.CHECKPOINT, ZERO_OPTIMIZATION, C.DATA,
    C.SUPERVISION, C.TELEMETRY, C.ELASTICITY, C.WALL_CLOCK_BREAKDOWN})
_FP16_KEYS = frozenset({C.FP16_ENABLED, C.FP16_AUTO_CAST, C.FP16_LOSS_SCALE,
                        C.FP16_INITIAL_SCALE_POWER, C.FP16_LOSS_SCALE_WINDOW,
                        C.FP16_HYSTERESIS, C.FP16_MIN_LOSS_SCALE,
                        C.FP16_MASTER_WEIGHTS_AND_GRADS})
_SECTION_KEYS = {C.FP16: _FP16_KEYS,
                 C.BFLOAT16: frozenset({C.BFLOAT16_ENABLED}),
                 C.BFLOAT16_OLD: frozenset({C.BFLOAT16_ENABLED}),
                 C.OPTIMIZER: frozenset({C.TYPE, C.OPTIMIZER_PARAMS,
                                         C.LEGACY_FUSION}),
                 C.SCHEDULER: frozenset({C.TYPE, C.SCHEDULER_PARAMS})}


class DeepSpeedConfig:
    """Parse and validate a DeepSpeed JSON config (path or dict)."""

    def __init__(self, config: Union[str, os.PathLike, Dict],
                 world_size: int = 1):
        if isinstance(config, (str, os.PathLike)):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"Expected a string path to an existing DeepSpeed config, got {config}")
            with open(config, "r") as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            # "auto" resolution edits nested sections: never the caller's dict
            self._param_dict = copy.deepcopy(config)
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path or dict, got {type(config)}")
        self.world_size = world_size
        self._check_sections(self._param_dict)
        self._resolve_auto(self._param_dict)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    @staticmethod
    def _check_sections(pd: Dict[str, Any]) -> None:
        unported = sorted(k for k in pd if k not in PORTED_SECTIONS)
        if unported:
            raise DeepSpeedConfigError(
                f"config sections {unported} are not ported yet (the port "
                f"reads {sorted(PORTED_SECTIONS)}; see ROADMAP.md Queue 1)")
        for section, known in _SECTION_KEYS.items():
            sub = pd.get(section)
            if sub is None:
                continue
            if not isinstance(sub, dict):
                raise DeepSpeedConfigError(f"'{section}' must be a dict")
            unknown = sorted(k for k in sub if k not in known)
            if unknown:
                raise DeepSpeedConfigError(
                    f"unknown keys {unknown} in '{section}' (known: "
                    f"{sorted(known)})")

    # ------------------------------------------------------------------ "auto"
    @staticmethod
    def _resolve_auto(pd: Dict[str, Any]) -> None:
        """HF-style ``"auto"``: the batch triple resolves through the batch
        algebra (a fully-auto triple takes micro-batch 1), gradient
        clipping takes HF's max_grad_norm default (1.0), and every other
        ``"auto"`` falls back to the field's default."""
        triple = (C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                  C.GRADIENT_ACCUMULATION_STEPS)
        had_auto_triple = any(pd.get(k) == AUTO for k in triple)
        for k in triple:
            if pd.get(k) == AUTO:
                pd[k] = None
        if pd.get(C.GRADIENT_CLIPPING) == AUTO:
            pd[C.GRADIENT_CLIPPING] = 1.0

        def strip(d: Dict[str, Any]) -> None:
            for k in list(d):
                if d[k] == AUTO:
                    del d[k]
                elif isinstance(d[k], dict):
                    strip(d[k])

        for k in list(pd):
            if isinstance(pd[k], dict):
                strip(pd[k])
            elif pd[k] == AUTO:
                del pd[k]
        if had_auto_triple and pd.get(C.TRAIN_BATCH_SIZE) is None and \
                pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU) is None:
            pd[C.TRAIN_MICRO_BATCH_SIZE_PER_GPU] = 1

    # ------------------------------------------------------------------ params
    def _initialize_params(self, pd: Dict[str, Any]) -> None:
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        fp16 = pd.get(C.FP16, {})
        self.fp16_enabled = fp16.get(C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.fp16_master_weights_and_gradients = fp16.get(
            C.FP16_MASTER_WEIGHTS_AND_GRADS, C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT)
        self.loss_scale = fp16.get(C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = fp16.get(
            C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = fp16.get(
            C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = fp16.get(C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = fp16.get(C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT)

        bf16 = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {}))
        self.bfloat16_enabled = bf16.get(C.BFLOAT16_ENABLED, C.BFLOAT16_ENABLED_DEFAULT)
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot both be enabled")

        opt = pd.get(C.OPTIMIZER)
        self.optimizer_name = opt[C.TYPE].lower() if opt and opt.get(C.TYPE) else None
        self.optimizer_params = dict(opt.get(C.OPTIMIZER_PARAMS, {})) if opt else None
        sched = pd.get(C.SCHEDULER)
        self.scheduler_name = sched.get(C.TYPE) if sched else None
        self.scheduler_params = dict(sched.get(C.SCHEDULER_PARAMS, {})) if sched else None

        # kept raw, as the JAX package does (its config.py:343); the model
        # takes its SparsityConfig from GPTConfig.sparse_attention
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION, None)

        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get(ZERO_OPTIMIZATION, {}))
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        self._initialize_checkpoint(pd.get(C.CHECKPOINT, {}))

        # the run-loop sections (JAX runtime/config.py:258-286): typed, a
        # bad value raises here, not in the middle of a run
        self.wall_clock_breakdown = bool(pd.get(
            C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT))
        for attr, key, model in (
                ("supervision_config", C.SUPERVISION,
                 DeepSpeedSupervisionConfig),
                ("data_config", C.DATA, DeepSpeedDataConfig),
                ("telemetry_config", C.TELEMETRY, DeepSpeedTelemetryConfig)):
            section = pd.get(key, {})
            if not isinstance(section, dict):
                raise DeepSpeedConfigError(f"'{key}' must be a dict")
            try:
                setattr(self, attr, model.from_dict(section))
            except (TypeError, ValueError) as e:
                raise DeepSpeedConfigError(
                    f"invalid '{key}' section: {e}") from e
        if self.telemetry_config.trace.enabled:
            raise NotImplementedError(
                "telemetry.trace: the JAX package's device profiler window "
                "is not ported (use torch.profiler around the steps)")
        self.elasticity_config_dict = pd.get(C.ELASTICITY, {})
        if not isinstance(self.elasticity_config_dict, dict):
            raise DeepSpeedConfigError(f"'{C.ELASTICITY}' must be a dict")

    def _initialize_checkpoint(self, ckpt_dict: Dict[str, Any]) -> None:
        """The ``checkpoint`` section (JAX ``runtime/config.py:243-256``):
        the typed durability config, tag validation and the universal
        checkpoint switch, read under its typed name and under the JAX
        package's ``load_universal`` key."""
        if not isinstance(ckpt_dict, dict):
            raise DeepSpeedConfigError(f"'{C.CHECKPOINT}' must be a dict")
        typed = {k: v for k, v in ckpt_dict.items()
                 if k != C.LOAD_UNIVERSAL_CHECKPOINT}
        try:
            self.checkpoint_config = DeepSpeedCheckpointConfig.from_dict(typed)
        except (TypeError, ValueError) as e:
            raise DeepSpeedConfigError(f"invalid 'checkpoint' section: {e}") from e
        self.checkpoint_tag_validation_mode = str(ckpt_dict.get(
            C.CHECKPOINT_TAG_VALIDATION,
            C.CHECKPOINT_TAG_VALIDATION_DEFAULT)).lower().capitalize()
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_tag_validation_mode != "Ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_tag_validation_mode == "Fail"
        self.load_universal_checkpoint = bool(ckpt_dict.get(
            C.LOAD_UNIVERSAL_CHECKPOINT,
            C.LOAD_UNIVERSAL_CHECKPOINT_DEFAULT)) or \
            self.checkpoint_config.load_universal_checkpoint
        if self.load_universal_checkpoint:
            raise NotImplementedError(
                "checkpoint.load_universal_checkpoint: universal checkpoints "
                "(deepspeed_tpu/checkpoint/) are not ported yet (ROADMAP.md "
                "Queue 1 #8)")

    # ------------------------------------------------------------- batch math
    def _batch_assertion(self) -> None:
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per gpu: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            f"Check batch related parameters. train_batch_size is not equal to "
            f"micro_batch_per_gpu * gradient_acc_step * world_size "
            f"{train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self) -> None:
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            return
        if train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs "
                "to be provided")

    def _configure_train_batch_size(self) -> None:
        self._set_batch_related_parameters()
        self._batch_assertion()

    # ---------------------------------------------------------------- checks
    def _do_sanity_check(self) -> None:
        if self.fp16_enabled and self.fp16_master_weights_and_gradients:
            raise DeepSpeedConfigError(
                "fp16_master_weights_and_grads requires ZeRO stage 1/2 with "
                "cpu offload (reference engine.py constraint)")
        if self.optimizer_name is None and self.optimizer_params is not None:
            raise DeepSpeedConfigError("optimizer params given without optimizer type")
