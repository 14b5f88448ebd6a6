"""``deepspeed_tpu_torch`` imports with JAX blocked and pulls in neither
``jax``, ``deepspeed_tpu`` nor ``ml_dtypes``; its entry points refuse to
run on the host unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import deepspeed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("deepspeed_tpu", "jaxlib", "ml_dtypes")
                or (m.split(".")[0] == "jax" and sys.modules[m] is not None))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # 24 modules of the serving slice, 14 of the training slice (runtime,
    # optimizers, timers, the fused-Adam kernel), 4 of block-sparse
    # attention (ops/sparse_attention and its kernel module), 4 of BERT
    # under LAMB (models/bert, ops/lamb and the fused-LAMB kernel module),
    # 2 of int8 serving (the quantizer kernel module, inference/quantization),
    # 10 of diffusion serving (the spatial and bias-GeLU kernel modules,
    # models/diffusion, inference/diffusion_pipeline, model_implementations
    # and its diffusers unet/vae, module_inject and its policies), 14 of
    # checkpointing (runtime/checkpoint_engine and its seven modules,
    # runtime/supervision and its events, utils/{jsonl, lock_watch,
    # fault_injection, zero_to_fp32}), 18 of the preemptible run
    # (runtime/dataloader, runtime/data_pipeline and its two modules,
    # runtime/supervision/{config, heartbeat, supervisor, watchdog},
    # telemetry and its four modules, elasticity and its four modules), 4
    # of the serving front end (serving/{request, metrics, gateway},
    # telemetry/propagate), 12 of ZeRO-Offload (ops/op_builder and its
    # three modules, ops/adam/cpu_adam, runtime/swap_tensor and its four
    # modules, runtime/zero/offload_engine, runtime/memory_model), 7 of
    # MoE (moe and its four modules, models/gpt_moe, gpt_moe_inference), 3
    # of the encoders (module_inject/load_checkpoint, ops/transformer and
    # its module)
    assert int(res.stdout.strip().splitlines()[-1]) >= 116


def test_bert_and_lamb_modules_are_importable():
    from deepspeed_tpu_torch import from_bert
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import FusedLamb
    from deepspeed_tpu_torch.ops.kernels import KERNELS
    assert callable(from_bert) and bert.BERT_LARGE.n_layer == 24
    assert FusedLamb.__module__ == "deepspeed_tpu_torch.ops.lamb.fused_lamb"
    assert {"fused_lamb_phase1", "fused_lamb_phase2"} <= set(KERNELS)


def test_int8_serving_modules_are_importable():
    from deepspeed_tpu_torch.inference.quantization import (
        QUANTIZE_LEAVES, Int8Param, quantize_params_int8)
    from deepspeed_tpu_torch.ops.kernels import KERNELS, quantize, quantize_kv
    assert {"quantizer", "decode_attn_int8", "chunk_attn_int8"} <= \
        set(KERNELS)
    assert QUANTIZE_LEAVES >= {"wqkv", "wo", "wi", "wo_mlp"}
    assert callable(quantize) and callable(quantize_kv)
    assert callable(quantize_params_int8) and Int8Param.__module__ == \
        "deepspeed_tpu_torch.inference.quantization"


def test_checkpoint_modules_are_importable():
    from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
    from deepspeed_tpu_torch.runtime.checkpoint_engine.async_checkpoint_engine \
        import AsyncCheckpointEngine
    from deepspeed_tpu_torch.runtime.supervision.events import EventKind
    from deepspeed_tpu_torch.utils import fault_injection, zero_to_fp32
    assert {"save_engine_checkpoint", "load_engine_checkpoint", "verify_tag",
            "CommitContext", "DeepSpeedCheckpointConfig"} <= set(dir(ce))
    assert issubclass(AsyncCheckpointEngine, ce.CheckpointEngine)
    assert EventKind.CKPT_COMMITTED == "ckpt.committed"
    assert "ckpt.publish_commit" in fault_injection.FAULT_POINTS
    assert callable(zero_to_fp32.main)


def test_offload_modules_are_importable():
    from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, cpu_adam_step
    from deepspeed_tpu_torch.ops.op_builder import (AsyncIOBuilder,
                                                    CPUAdamBuilder)
    from deepspeed_tpu_torch.runtime import memory_model
    from deepspeed_tpu_torch.runtime.swap_tensor import (
        AioConfig, AsyncIOHandle, AsyncTensorSwapper, OptimizerStateSwapper)
    from deepspeed_tpu_torch.runtime.zero.offload_engine import \
        HostOffloadOptimizer
    assert CPUAdamBuilder().sources() == ["adam/cpu_adam.cpp"]
    assert AsyncIOBuilder().sources() == ["aio/ds_aio.cpp"]
    assert memory_model.offload_peak_bytes(10, 4) == 10 * 6 + 2 * 4 * 2
    assert callable(cpu_adam_step) and AioConfig().thread_count == 4
    for cls in (DeepSpeedCPUAdam, AsyncIOHandle, AsyncTensorSwapper,
                OptimizerStateSwapper, HostOffloadOptimizer):
        assert cls.__module__.startswith("deepspeed_tpu_torch.")


def test_run_loop_modules_are_importable():
    from deepspeed_tpu_torch.elasticity import (ElasticTrainRunner,
                                                compute_elastic_config)
    from deepspeed_tpu_torch.runtime.data_pipeline import (
        STATE_VERSION, DeepSpeedDataConfig, ResumableDataLoader)
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    from deepspeed_tpu_torch.runtime.supervision import (
        HeartbeatWriter, RunSupervisor, StepWatchdog, comm_guard)
    from deepspeed_tpu_torch.telemetry import (SPAN_NAMES, MetricsSampler,
                                               Tracer, validate_trace)
    from deepspeed_tpu_torch.utils import fault_injection
    assert STATE_VERSION == 1 and callable(compute_elastic_config)
    assert {"train.step", "train.fwd", "train.bwd", "train.optimizer",
            "train.host_sync", "ckpt.save", "ckpt.load",
            "ckpt.commit"} <= SPAN_NAMES
    assert {"train.step_begin", "train.loss", "train.step", "data.next",
            "data.collate"} <= fault_injection.FAULT_POINTS
    for cls in (ElasticTrainRunner, DeepSpeedDataConfig, ResumableDataLoader,
                DeepSpeedDataLoader, HeartbeatWriter, RunSupervisor,
                StepWatchdog, MetricsSampler, Tracer):
        assert cls.__module__.startswith("deepspeed_tpu_torch.")
    assert callable(comm_guard) and callable(validate_trace)


def test_serving_front_end_modules_are_importable():
    from deepspeed_tpu_torch.inference import InferenceEngine, InferenceSession
    from deepspeed_tpu_torch.runtime.supervision.events import EventKind
    from deepspeed_tpu_torch.serving import (RequestHandle, ServingGateway,
                                             ServingMetrics)
    from deepspeed_tpu_torch.telemetry import SPAN_NAMES, mint_context
    from deepspeed_tpu_torch.utils import fault_injection
    from deepspeed_tpu_torch.utils.lock_watch import LOCK_ORDER
    assert callable(InferenceEngine.serve) and callable(
        InferenceEngine.start_session)
    assert {"append", "generate", "fork"} <= set(dir(InferenceSession))
    assert EventKind.SERVE_DONE == "serve.done"
    assert {"serve.tick", "serve.admit", "serve.prefill"} <= SPAN_NAMES
    assert {"serve.request", "serve.admit", "serve.decode_tick"} <= \
        fault_injection.FAULT_POINTS
    assert LOCK_ORDER[:3] == ("serve.gateway", "serve.request",
                              "serve.metrics")
    assert len(mint_context().fields()["trace_id"]) == 16
    for cls in (RequestHandle, ServingGateway, ServingMetrics):
        assert cls.__module__.startswith("deepspeed_tpu_torch.serving.")


def test_moe_modules_are_importable():
    from deepspeed_tpu_torch import from_gpt_moe
    from deepspeed_tpu_torch.models import gpt_moe, gpt_moe_inference
    from deepspeed_tpu_torch.models.convert import moe_config_from_jax
    from deepspeed_tpu_torch.moe import (MoE, TopKGate, has_moe_layers,
                                         split_moe_param_tree, top1gating,
                                         top2gating)
    cfg = gpt_moe.GPT_MOE_350M_64E
    assert (cfg.n_layer, cfg.d_model, cfg.num_experts, cfg.moe_top_k) == \
        (24, 1024, 64, 1)
    assert from_gpt_moe(cfg).meta["layer_stacked"] == (
        "dense_blocks", "moe_attn_blocks", "moe_blocks")
    assert gpt_moe_inference._PREFILL_CHUNK == 128
    for obj in (MoE, TopKGate, has_moe_layers, split_moe_param_tree,
                top1gating, top2gating, moe_config_from_jax):
        assert obj.__module__.startswith("deepspeed_tpu_torch.")


def test_encoder_modules_are_importable():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.engine import BertInferenceEngine
    from deepspeed_tpu_torch.models.gpt import encode
    from deepspeed_tpu_torch.module_inject import (
        HFBertLayerPolicy, HFCLIPLayerPolicy, convert_hf_bert,
        convert_hf_clip_text, load_sharded_state_dict, module_quantize)
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    assert deepspeed_tpu_torch.DeepSpeedTransformerLayer is \
        DeepSpeedTransformerLayer
    assert deepspeed_tpu_torch.BertInferenceEngine is BertInferenceEngine
    assert issubclass(DeepSpeedTransformerLayer, torch.nn.Module)
    assert DeepSpeedTransformerConfig().ffn == 3072
    for obj in (HFBertLayerPolicy, HFCLIPLayerPolicy, convert_hf_bert,
                convert_hf_clip_text, load_sharded_state_dict,
                module_quantize, encode):
        assert obj.__module__.startswith("deepspeed_tpu_torch.")


def test_encoder_entry_points_without_cuda_raise(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = bert.BertConfig(vocab_size=64, max_seq_len=16, n_layer=1,
                          n_head=2, d_model=32, dtype=torch.float32)
    params = bert.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model=(cfg, params))
    eng = deepspeed_tpu_torch.init_inference(model=(cfg, params),
                                             device="cpu")
    assert eng.device.type == "cpu"
    lcfg = deepspeed_tpu_torch.DeepSpeedTransformerConfig(hidden_size=32,
                                                          heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.DeepSpeedTransformerLayer(lcfg)
    layer = deepspeed_tpu_torch.DeepSpeedTransformerLayer(lcfg, device="cpu")
    assert layer.wqkv.device.type == "cpu"


def test_moe_entry_points_without_cuda_raise(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt_moe
    from deepspeed_tpu_torch.runtime.model import from_gpt_moe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt_moe.GPTMoEConfig(vocab_size=64, max_seq_len=16, n_layer=2,
                               n_head=2, d_model=32, num_experts=4,
                               dtype=torch.float32)
    params = gpt_moe.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model=(cfg, params),
                                           config={"dtype": "float32"})
    eng = deepspeed_tpu_torch.init_inference(
        model=(cfg, params), config={"dtype": "float32"}, device="cpu")
    assert eng.device.type == "cpu"
    config = {"train_micro_batch_size_per_gpu": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=from_gpt_moe(cfg), config=config)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt_moe(cfg), config=config, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert engine.state["master"]["moe_blocks"]["experts"]["wi"].shape == \
        (1, 4, 32, 128)


def test_diffusion_modules_are_importable():
    from deepspeed_tpu_torch.inference import DiffusionPipeline
    from deepspeed_tpu_torch.model_implementations.diffusers import (DSUNet,
                                                                     DSVAE)
    from deepspeed_tpu_torch.models import diffusion
    from deepspeed_tpu_torch.module_inject import (GENERIC_POLICIES,
                                                   UNetPolicy, VAEPolicy)
    from deepspeed_tpu_torch.ops.kernels import (KERNELS, bias_gelu_dropout,
                                                 nhwc_bias_add)
    assert {"nhwc_bias_add", "nhwc_bias_add_add", "nhwc_bias_add_bias_add",
            "bias_gelu_fwd", "bias_gelu_bwd"} <= set(KERNELS)
    assert GENERIC_POLICIES == [UNetPolicy, VAEPolicy]
    assert diffusion.SD15_UNET.block_channels == (320, 640, 1280, 1280)
    assert callable(DiffusionPipeline) and callable(DSUNet)
    assert callable(DSVAE) and callable(bias_gelu_dropout)
    assert callable(nhwc_bias_add)


def test_diffusion_entry_without_cuda_raises(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import diffusion
    from tests.torch_diffusers_export import export_vae_sd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = diffusion.VAEConfig(block_channels=(8, 16), groups=4)
    sd = export_vae_sd(diffusion.vae_init(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model=sd, groups=4)
    vae = deepspeed_tpu_torch.init_inference(model=sd, groups=4,
                                             device="cpu")
    assert vae.device.type == "cpu"


def test_init_inference_without_cuda_raises(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.GPTConfig(vocab_size=64, max_seq_len=16, n_layer=1, n_head=2,
                        d_model=32, dtype=torch.float32)
    params = gpt.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model=(cfg, params),
                                           config={"dtype": "float32"})
    eng = deepspeed_tpu_torch.init_inference(
        model=(cfg, params), config={"dtype": "float32"}, device="cpu")
    assert eng.device.type == "cpu"


def test_cuda_only_paths_refuse_mixed_devices():
    from deepspeed_tpu_torch.ops.kernels.utils import on_cuda
    a = torch.zeros(2)
    assert on_cuda(a, a) is False
    with pytest.raises(ValueError, match="no kernel or plain path"):
        on_cuda(torch.zeros(2, device="meta"))


def test_initialize_without_cuda_raises(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.runtime.model import from_gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.GPTConfig(vocab_size=64, max_seq_len=16, n_layer=1, n_head=2,
                        d_model=32, dtype=torch.float32)
    config = {"train_micro_batch_size_per_gpu": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=from_gpt(cfg), config=config)
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg), config=config, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert engine.device.type == "cpu" and loader is None and sched is None
    assert engine.state["master"]["wte"].device.type == "cpu"
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.runtime.model import from_bert
    bcfg = bert.BertConfig(vocab_size=64, max_seq_len=16, n_layer=1,
                           n_head=2, d_model=32, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=from_bert(bcfg), config=config)
    with pytest.raises(TypeError, match="from_bert"):
        deepspeed_tpu_torch.initialize(model=bcfg, config=config)
    with pytest.raises(NotImplementedError, match="model_parameters"):
        deepspeed_tpu_torch.initialize(model=from_gpt(cfg), device="cpu",
                                       config=config, model_parameters=[])
    with pytest.raises(NotImplementedError, match="autotuner"):
        deepspeed_tpu_torch.initialize(
            model=from_gpt(cfg), device="cpu",
            config={**config, "autotuning": {"enabled": True}})
