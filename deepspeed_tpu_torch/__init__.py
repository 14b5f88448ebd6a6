"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module
names and runs on one NVIDIA H100 through kernels written by hand for
Hopper (``ops/kernels``, sources in ``csrc/``).  It imports ``torch`` and
never JAX or ``deepspeed_tpu``.

Ported so far: the serving path of GPT-2, GPT-Neo (banded local layers)
and BLOOM (ALiBi) — ``init_inference`` (from a ``(GPTConfig, params)``
tuple or a ``transformers`` model) → ``InferenceEngine.generate``, and the
continuous-batching ``SlotBatcher`` (``serving``), in bf16/fp16/fp32 or
with int8 weights and an int8 KV cache; text-to-image serving of
Stable-Diffusion-shaped models — ``init_inference(model=<diffusers state
dict>)`` → ``DSUNet``/``DSVAE``
→ ``inference.diffusion_pipeline.DiffusionPipeline`` (guided DDIM, VAE
decode); and the training path: ``initialize`` →
``DeepSpeedEngine`` forward / backward / step and ``train_batch_fused``
(``runtime``), for GPT-2 (dense or block-sparse attention, Adam) and for
BERT masked-LM pre-training (right-padded batches through the flash
kernels' per-row key lengths, Adam or LAMB); checkpoints in the JAX
package's layout; and the preemptible run around the step:
``initialize(training_data=...)`` → ``engine.training_dataloader`` (a
``ResumableDataLoader`` under ``data.resumable``) →
``elasticity.ElasticTrainRunner(engine, save_dir, ...).run(loader,
max_steps)``, with run supervision (``runtime/supervision``: watchdog,
heartbeats, rollback) and telemetry (``telemetry``: spans, the metrics
stream, trace export).
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch

from .accelerator import get_accelerator
from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import InferenceEngine
from .models import gpt
from .runtime.engine import DeepSpeedEngine
from .runtime.model import ModelSpec, from_bert, from_gpt

__version__ = "0.1.0"


def init_inference(model=None, config=None, device=None, **kwargs):
    """Build an :class:`InferenceEngine`, or a served UNet or VAE
    (reference ``deepspeed/__init__.py`` ``init_inference``).

    ``model`` is a ``(GPTConfig, params)`` tuple of the port's GPT (params
    from ``models.gpt.init`` or ``models.convert.from_jax_params``); a
    ``transformers`` decoder (a module with ``config`` and
    ``state_dict()``) that a ``module_inject.POLICIES`` entry matches
    (GPT-2, GPT-Neo, BLOOM; OPT, GPT-NeoX and GPT-J raise), converted and
    served as a GPT; or a diffusers state dict (or a module with
    ``state_dict()``) that ``module_inject.UNetPolicy`` or ``VAEPolicy``
    matches, which returns a ``DSUNet`` or ``DSVAE`` on the device.
    ``config`` is a ``DeepSpeedInferenceConfig`` dict, with remaining
    kwargs merged into it: ``dtype`` is the compute dtype; ``dtype="int8"`` serves a GPT's
    int8 weights (codes and per-vector scales of the bf16-cast weights)
    with bf16 compute and a UNet or VAE in bf16; ``kv_cache_dtype="int8"``
    caches K/V as int8 codes and per-vector scales; ``n_head`` and
    ``groups`` (default 8 and 32, SD 1.x) set what a diffusers state dict
    cannot tell.  ``device=None`` runs on CUDA and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path."""
    cfg_dict = dict(config or {})
    cfg_dict.update(kwargs)
    extra = {k: cfg_dict.pop(k) for k in ("n_head", "groups")
             if k in cfg_dict}
    inf_config = DeepSpeedInferenceConfig.from_dict(cfg_dict)
    if isinstance(model, tuple) and len(model) == 2 \
            and isinstance(model[0], gpt.GPTConfig):
        model_config, params = model
        return InferenceEngine(model_config, params, inf_config,
                               device=device)
    sd = model if isinstance(model, Mapping) else (
        model.state_dict() if hasattr(model, "state_dict") else None)
    if sd is not None:
        from .module_inject import (GENERIC_POLICIES, convert_hf_model,
                                    match_decoder)
        dtype = inf_config.torch_dtype
        if dtype == torch.int8:     # weight-only int8 is GPT-only
            dtype = torch.bfloat16
        for policy in GENERIC_POLICIES:
            if policy.match(sd):
                return policy.apply(
                    sd, dtype=dtype,
                    enable_cuda_graph=inf_config.enable_cuda_graph,
                    device=get_accelerator().resolve_device(device), **extra)
        if hasattr(model, "config") and match_decoder(sd) is not None:
            model_config, params = convert_hf_model(model, dtype=dtype)
            return InferenceEngine(model_config, params, inf_config,
                                   device=device)
    raise TypeError("init_inference takes model=(GPTConfig, params) of "
                    "deepspeed_tpu_torch.models.gpt, a transformers GPT-2, "
                    "GPT-Neo or BLOOM model, or a diffusers UNet or VAE "
                    "state dict")


def initialize(args=None, model: ModelSpec = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               config=None, config_params=None, device=None,
               generator=None, collate_fn=None):
    """Build a :class:`DeepSpeedEngine` (reference
    ``deepspeed/__init__.py`` ``initialize``); returns ``(engine,
    optimizer, training_dataloader, lr_scheduler)``.

    ``model`` is a ``ModelSpec`` (``runtime.model.from_gpt`` or
    ``from_bert``); ``config`` a DeepSpeed config dict or path, whose
    ``optimizer`` section may name Adam/AdamW, LAMB or SGD.  The params come from
    ``model.params`` or ``model.init_fn(generator)`` (default: a
    generator on the device seeded with 0).  ``device=None`` runs on CUDA
    and raises when there is none; pass ``device="cpu"`` for the plain
    PyTorch path.  ``training_data`` (an indexable dataset) gives
    ``engine.training_dataloader`` through ``engine.deepspeed_io`` (with
    ``collate_fn``, default: numpy stacking): a ``ResumableDataLoader``
    registered as the engine's data iterator under ``data.resumable``,
    else a per-epoch ``DeepSpeedDataLoader``; it yields numpy batches.
    The autotuner, the pipeline engine and ``model_parameters`` are not
    ported and raise ``NotImplementedError``."""
    if config is None and args is not None and \
            getattr(args, "deepspeed_config", None) is not None:
        config = args.deepspeed_config
    config = config if config is not None else config_params
    if not isinstance(model, ModelSpec):
        raise TypeError("initialize takes model=ModelSpec "
                        "(deepspeed_tpu_torch.runtime.model.from_gpt or "
                        "from_bert)")
    at = config.get("autotuning", {}) if isinstance(config, dict) else {}
    if (isinstance(at, dict) and at.get("enabled")) or \
            os.environ.get("DS_AUTOTUNING", "").strip():
        raise NotImplementedError("the autotuner is not ported yet "
                                  "(ROADMAP.md Queue 1)")
    if model.meta.get("pipeline"):
        raise NotImplementedError("the pipeline engine is not ported yet "
                                  "(ROADMAP.md Queue 1)")
    if model_parameters is not None:
        raise NotImplementedError("model_parameters is not ported: the "
                                  "params come through the ModelSpec")
    engine = DeepSpeedEngine(model=model, config=config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, device=device,
                             generator=generator, training_data=training_data,
                             collate_fn=collate_fn)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler


__all__ = ["DeepSpeedEngine", "DeepSpeedInferenceConfig", "InferenceEngine",
           "ModelSpec", "from_bert", "from_gpt", "init_inference",
           "initialize"]
