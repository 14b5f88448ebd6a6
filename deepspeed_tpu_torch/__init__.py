"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module
names and runs on one NVIDIA H100 through kernels written by hand for
Hopper (``ops/kernels``, sources in ``csrc/``).  It imports ``torch`` and
never JAX or ``deepspeed_tpu``.

Ported so far: the serving path of GPT-2, GPT-Neo (banded local layers),
OPT (offset positions, relu), BLOOM (ALiBi), GPT-NeoX and GPT-J (rotary
positions, parallel residual, untied heads) and GPT-MoE (``models/
gpt_moe``: dense blocks and expert layers in pairs, top-1 or top-2
gating, dropless in serving; ``moe/``) — ``init_inference`` (from a
``(GPTConfig, params)`` or ``(GPTMoEConfig, params)`` tuple or a
``transformers`` model) → ``InferenceEngine.generate``, and the
continuous-batching ``SlotBatcher`` (``serving``), in bf16/fp16/fp32 or
with int8 weights and an int8 KV cache; text-to-image serving of
Stable-Diffusion-shaped models — ``init_inference(model=<diffusers state
dict>)`` → ``DSUNet``/``DSVAE``
→ ``inference.diffusion_pipeline.DiffusionPipeline`` (guided DDIM, VAE
decode); and the training path: ``initialize`` →
``DeepSpeedEngine`` forward / backward / step and ``train_batch_fused``
(``runtime``), for the GPT family (dense or block-sparse attention, Adam),
GPT-MoE (``from_gpt_moe``, the ``moe`` section at ``ep_size`` 1)
and for BERT masked-LM pre-training (right-padded batches through the flash
kernels' per-row key lengths, Adam or LAMB); checkpoints in the JAX
package's layout; and the preemptible run around the step:
``initialize(training_data=...)`` → ``engine.training_dataloader`` (a
``ResumableDataLoader`` under ``data.resumable``) →
``elasticity.ElasticTrainRunner(engine, save_dir, ...).run(loader,
max_steps)``, with run supervision (``runtime/supervision``: watchdog,
heartbeats, rollback) and telemetry (``telemetry``: spans, the metrics
stream, trace export).  The encoders: BERT served by
``BertInferenceEngine`` (``init_inference`` on a ``(BertConfig, params)``
tuple, a BERT ``ModelSpec`` or a ``transformers`` BERT: MLM logits,
hidden states, the pooler; int8 weights), the CLIP text tower
(``module_inject.convert_hf_clip_text`` → ``models.gpt.encode``), sharded
checkpoint loading and ``module_quantize`` (``module_inject``), and the
standalone encoder block ``DeepSpeedTransformerLayer`` (``ops/
transformer``, an ``nn.Module``, both LayerNorm orders).
"""

from __future__ import annotations

import os
from collections.abc import Mapping

from .accelerator import get_accelerator
from .inference.config import DeepSpeedInferenceConfig
from .inference.engine import BertInferenceEngine, InferenceEngine
from .models import bert, gpt
from .ops.transformer import (DeepSpeedTransformerConfig,
                              DeepSpeedTransformerLayer)
from .runtime.engine import DeepSpeedEngine
from .runtime.model import ModelSpec, from_bert, from_gpt, from_gpt_moe

__version__ = "0.1.0"


def init_inference(model=None, config=None, device=None, **kwargs):
    """Build an :class:`InferenceEngine`, a :class:`BertInferenceEngine`,
    or a served UNet or VAE (reference ``deepspeed/__init__.py``
    ``init_inference``).

    ``model`` is a ``(GPTConfig, params)`` tuple of the port's GPT (params
    from ``models.gpt.init`` or ``models.convert.from_jax_params``), a
    ``(GPTMoEConfig, params)`` tuple of its GPT-MoE (``models.gpt_moe``;
    the config's ``moe`` section, if any, at ``ep_size`` 1) or a
    ``(BertConfig, params)`` tuple of its BERT (``models.bert``, served
    by the encoder engine); a ``ModelSpec`` with materialized ``params``,
    dispatched on ``meta["config"]`` the same way; a ``transformers``
    BERT (``BertForMaskedLM`` or ``BertModel``: a module with ``config``
    and ``state_dict()``, converted by ``module_inject.HFBertLayerPolicy``
    and served by the encoder engine; task heads are not converted); a
    ``transformers`` decoder that a ``module_inject.POLICIES`` entry
    matches (GPT-2, GPT-Neo, OPT, BLOOM, GPT-NeoX, GPT-J), converted and
    served as a GPT; or a diffusers state dict (or a module with
    ``state_dict()``) that ``module_inject.UNetPolicy`` or ``VAEPolicy``
    matches, which returns a ``DSUNet`` or ``DSVAE`` on the device.
    ``config`` is a ``DeepSpeedInferenceConfig`` dict, with remaining
    kwargs merged into it: ``dtype`` is the compute dtype; ``dtype="int8"`` serves a GPT's
    or BERT's int8 weights (codes and per-vector scales of the bf16-cast
    weights) with bf16 compute and a UNet or VAE in bf16;
    ``kv_cache_dtype="int8"`` caches a GPT's K/V as int8 codes and
    per-vector scales; ``n_head`` and
    ``groups`` (default 8 and 32, SD 1.x) set what a diffusers state dict
    cannot tell.  ``device=None`` runs on CUDA and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch path."""
    cfg_dict = dict(config or {})
    cfg_dict.update(kwargs)
    extra = {k: cfg_dict.pop(k) for k in ("n_head", "groups")
             if k in cfg_dict}
    inf_config = DeepSpeedInferenceConfig.from_dict(cfg_dict)
    if isinstance(model, ModelSpec):
        if model.params is None:
            raise AssertionError(
                "init_inference(ModelSpec) needs materialized params")
        model = (model.meta.get("config"), model.params)
    if isinstance(model, tuple) and len(model) == 2:
        model_config, params = model
        if isinstance(model_config, bert.BertConfig):
            return BertInferenceEngine(model_config, params, inf_config,
                                       device=device)
        if isinstance(model_config, gpt.GPTConfig):
            return InferenceEngine(model_config, params, inf_config,
                                   device=device)
    sd = model if isinstance(model, Mapping) else (
        model.state_dict() if hasattr(model, "state_dict") else None)
    if sd is not None:
        from .module_inject import (GENERIC_POLICIES, convert_hf_bert,
                                    convert_hf_model, match_decoder)
        from .module_inject.replace_policy import convertible_bert
        for policy in GENERIC_POLICIES:
            if policy.match(sd):
                # a UNet or VAE has no int8 weights: dtype="int8" is bf16
                return policy.apply(
                    sd, dtype=inf_config.serving_dtype()[0],
                    enable_cuda_graph=inf_config.enable_cuda_graph,
                    device=get_accelerator().resolve_device(device), **extra)
        # the converters give fp32 params; each engine casts them to its
        # serving dtype and refuses what it does not serve
        if convertible_bert(model, sd):
            return BertInferenceEngine(*convert_hf_bert(model), inf_config,
                                       device=device)
        if hasattr(model, "config") and match_decoder(sd) is not None:
            return InferenceEngine(*convert_hf_model(model), inf_config,
                                   device=device)
    raise TypeError("init_inference takes model=(GPTConfig, params) or "
                    "(BertConfig, params) of deepspeed_tpu_torch.models, a "
                    "ModelSpec with params, a transformers BERT (masked LM "
                    "or bare encoder), GPT-2, GPT-Neo, OPT, BLOOM, GPT-NeoX "
                    "or GPT-J model, or a diffusers UNet or VAE state dict")


def initialize(args=None, model: ModelSpec = None, optimizer=None,
               model_parameters=None, training_data=None, lr_scheduler=None,
               config=None, config_params=None, device=None,
               generator=None, collate_fn=None):
    """Build a :class:`DeepSpeedEngine` (reference
    ``deepspeed/__init__.py`` ``initialize``); returns ``(engine,
    optimizer, training_dataloader, lr_scheduler)``.

    ``model`` is a ``ModelSpec`` (``runtime.model.from_gpt``,
    ``from_gpt_moe`` or ``from_bert``); ``config`` a DeepSpeed config dict
    or path, whose ``optimizer`` section may name Adam/AdamW, LAMB or SGD
    and whose ``moe`` section takes ``ep_size`` 1 (above 1 raises: expert
    parallelism is ROADMAP.md Queue 1 #7).  The params come from
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
                        "(deepspeed_tpu_torch.runtime.model.from_gpt, "
                        "from_gpt_moe or from_bert)")
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


__all__ = ["BertInferenceEngine", "DeepSpeedEngine",
           "DeepSpeedInferenceConfig", "DeepSpeedTransformerConfig",
           "DeepSpeedTransformerLayer", "InferenceEngine", "ModelSpec",
           "from_bert", "from_gpt", "from_gpt_moe", "init_inference",
           "initialize"]
