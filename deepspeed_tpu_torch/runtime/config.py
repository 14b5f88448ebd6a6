"""The DeepSpeed-style JSON config, cut to the training slice.

The port of the JAX package's ``runtime/config.py`` (the counterpart of
the reference's ``deepspeed/runtime/config.py``: ``DeepSpeedConfig`` :717,
the batch algebra ``_set_batch_related_parameters`` :954).  It reads the
sections the training path runs: the batch triple, ``optimizer``,
``scheduler``, ``fp16``/``bf16``, ``gradient_clipping``,
``steps_per_print``, ``zero_optimization`` (stage 0 or 1, and the
optimizer-state offload), ``data_types`` (``grad_accum_dtype``), ``aio``
(the NVMe offload's file I/O engine),
``sparse_attention`` (kept raw, as the JAX package keeps it),
``checkpoint`` (the typed durability section,
``checkpoint_engine/config.py``), ``data`` (the resumable loader,
``data_pipeline/config.py``), ``supervision`` (watchdog, heartbeats,
rollback, ``supervision/config.py``), ``moe`` (``ep_size``: 1, the one
device's expert layout; above 1 raises), ``telemetry`` (spans and the metrics
stream, ``telemetry/config.py``), ``elasticity`` (kept raw, read by the
elastic runner's admission check) and ``wall_clock_breakdown``.  Any
other top-level section raises
:class:`DeepSpeedConfigError`: a config that asks for telemetry or another
unported feature must not train silently without it.  HF-style ``"auto"``
values resolve as in the JAX package: a fully automatic batch triple takes
the largest power-of-two micro-batch whose ZeRO state and activations fit
the device's budget (``memory_model.py``), 1 without a model or a card.

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
from ..utils.logging import logger
from .supervision.config import DeepSpeedSupervisionConfig
from .swap_tensor.aio_config import AIO, AioConfig
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
    C.SUPERVISION, C.TELEMETRY, C.ELASTICITY, C.WALL_CLOCK_BREAKDOWN,
    C.DATA_TYPES, AIO, C.MOE})
_FP16_KEYS = frozenset({C.FP16_ENABLED, C.FP16_AUTO_CAST, C.FP16_LOSS_SCALE,
                        C.FP16_INITIAL_SCALE_POWER, C.FP16_LOSS_SCALE_WINDOW,
                        C.FP16_HYSTERESIS, C.FP16_MIN_LOSS_SCALE,
                        C.FP16_MASTER_WEIGHTS_AND_GRADS})
_SECTION_KEYS = {C.FP16: _FP16_KEYS,
                 C.BFLOAT16: frozenset({C.BFLOAT16_ENABLED}),
                 C.BFLOAT16_OLD: frozenset({C.BFLOAT16_ENABLED}),
                 C.OPTIMIZER: frozenset({C.TYPE, C.OPTIMIZER_PARAMS,
                                         C.LEGACY_FUSION}),
                 C.SCHEDULER: frozenset({C.TYPE, C.SCHEDULER_PARAMS}),
                 C.DATA_TYPES: frozenset({C.GRAD_ACCUM_DTYPE}),
                 C.MOE: frozenset({C.MOE_EP_SIZE})}

#: ``data_types.grad_accum_dtype`` names (JAX ``engine.py:780-784``)
GRAD_ACCUM_DTYPES = {"fp32": "float32", "float32": "float32",
                     "float": "float32", "fp16": "float16",
                     "float16": "float16", "half": "float16",
                     "bf16": "bfloat16", "bfloat16": "bfloat16"}


class DeepSpeedConfig:
    """Parse and validate a DeepSpeed JSON config (path or dict)."""

    def __init__(self, config: Union[str, os.PathLike, Dict],
                 world_size: int = 1, model=None):
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
        self._resolve_auto(self._param_dict, model)
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
    def _resolve_auto(self, pd: Dict[str, Any], model=None) -> None:
        """HF-style ``"auto"``: the batch triple resolves through the batch
        algebra (a fully-auto triple sizes the micro-batch with the memory
        model: ``_auto_micro_batch``), gradient clipping takes HF's
        max_grad_norm default (1.0), and every other ``"auto"`` falls back
        to the field's default."""
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
        # sizing runs after the strip, so the estimate reads the resolved
        # precision and offload values
        if had_auto_triple and pd.get(C.TRAIN_BATCH_SIZE) is None and \
                pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU) is None:
            pd[C.TRAIN_MICRO_BATCH_SIZE_PER_GPU] = \
                self._auto_micro_batch(pd, model)

    def _auto_micro_batch(self, pd: Dict[str, Any], model) -> int:
        """The largest power-of-two micro-batch whose ZeRO state and
        activation bytes fit the device's budget (JAX ``runtime/
        config.py:126-165``); 1 without a model, a budget (the CPU) or a
        parameter count."""
        if model is None:
            return 1
        from . import memory_model
        budget = memory_model.device_budget()
        if budget is None:
            return 1
        n = model.num_params()
        if n is None:
            logger.warning("auto micro-batch: the model's parameters "
                           "cannot be counted; using 1")
            return 1
        zero = pd.get(ZERO_OPTIMIZATION, {})
        stage = int(zero.get("stage", 0))
        mixed = any(bool(pd.get(k, {}).get(C.FP16_ENABLED if k == C.FP16
                                           else C.BFLOAT16_ENABLED))
                    for k in (C.FP16, C.BFLOAT16, C.BFLOAT16_OLD))
        off = zero.get("offload_optimizer", zero.get("cpu_offload"))
        offload = bool(off) and (not isinstance(off, dict)
                                 or off.get("device", "cpu") != "none")
        free = budget - memory_model.zero_state_bytes(
            n, self.world_size, stage, mixed, offload)
        cfg = model.meta.get("config")
        dims = [getattr(cfg, k, None) for k in ("max_seq_len", "d_model",
                                                "n_layer")]
        if free <= 0 or None in dims:
            return 1
        # remat-era activation estimate: ~4 bytes x S x d per layer
        act_per_sample = 4 * dims[0] * dims[1] * dims[2]
        micro = max(1, free // max(1, act_per_sample))
        return 1 << (int(micro).bit_length() - 1)

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

        data_types = pd.get(C.DATA_TYPES, {})
        if not isinstance(data_types, dict):
            raise DeepSpeedConfigError(f"'{C.DATA_TYPES}' must be a dict")
        self.grad_accum_dtype = data_types.get(C.GRAD_ACCUM_DTYPE,
                                               C.GRAD_ACCUM_DTYPE_DEFAULT)
        if self.grad_accum_dtype is not None and str(
                self.grad_accum_dtype).lower().replace("torch.", "") \
                not in GRAD_ACCUM_DTYPES:
            raise DeepSpeedConfigError(
                f"data_types.grad_accum_dtype={self.grad_accum_dtype!r} "
                f"(want one of {sorted(GRAD_ACCUM_DTYPES)})")
        # the JAX package's initialize reads moe.ep_size raw into its mesh
        # (deepspeed_tpu/__init__.py:111-112); one device holds every expert
        self.moe_ep_size = int(pd.get(C.MOE, {}).get(
            C.MOE_EP_SIZE, C.MOE_EP_SIZE_DEFAULT))
        if self.moe_ep_size < 1:
            raise DeepSpeedConfigError(
                f"moe.ep_size must be >= 1, got {self.moe_ep_size}")
        if self.moe_ep_size != 1:
            raise NotImplementedError(
                f"moe.ep_size={self.moe_ep_size}: expert parallelism is not "
                "ported yet (ROADMAP.md Queue 1 #7)")
        aio = pd.get(AIO, {})
        if not isinstance(aio, dict):
            raise DeepSpeedConfigError(f"'{AIO}' must be a dict")
        try:
            self.aio_config = AioConfig.from_dict(aio)
        except (TypeError, ValueError) as e:
            raise DeepSpeedConfigError(f"invalid '{AIO}' section: {e}") from e

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
