"""The port's config, LR schedules, loss scaler and gradient utilities
against the JAX package's.  The config cases are those of
``tests/unit/runtime/test_config.py`` at the same dp world size (8): the
same batch triple, and ``DeepSpeedConfigError`` with the same message.
LR schedules: equal value for value over 200 steps (the same float
arithmetic).  Loss scaler: ``update_state`` on device tensors equal to the
JAX one, step for step, over a seeded overflow sequence.  Gradient norm
and clipping: fp32, tolerance 1e-6 (summation order differs)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JError
from deepspeed_tpu_torch.runtime import loss_scaler as pls
from deepspeed_tpu_torch.runtime import lr_schedules as plr
from deepspeed_tpu_torch.runtime import utils as putils
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from tests.unit.common import make_mesh

BATCH_CASES = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2},
    {"train_batch_size": 32},
    {"train_micro_batch_size_per_gpu": 3},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": "auto",
     "gradient_accumulation_steps": "auto"},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": "auto",
     "gradient_accumulation_steps": 4},
    {"train_batch_size": 64, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": "auto"},
    {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 4},
]


def _triple(c):
    return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps)


@pytest.mark.parametrize("d", BATCH_CASES)
def test_batch_triple_matches_jax(d):
    want = JConfig(d, mesh_manager=make_mesh(dp=8))
    assert _triple(DeepSpeedConfig(d, world_size=8)) == _triple(want)


def test_inconsistent_triple_asserts_like_jax():
    d = {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2,
         "gradient_accumulation_steps": 4}
    with pytest.raises(AssertionError) as want:
        JConfig(d, mesh_manager=make_mesh(dp=8))
    with pytest.raises(AssertionError) as got:
        DeepSpeedConfig(d, world_size=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [
    {},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "optimizer": {"params": {"lr": 1.0}}},
], ids=["no_batch", "fp16_and_bf16", "params_without_type"])
def test_config_errors_match_jax(d):
    with pytest.raises(JError) as want:
        JConfig(d, mesh_manager=make_mesh(dp=8))
    with pytest.raises(DeepSpeedConfigError) as got:
        DeepSpeedConfig(d, world_size=8)
    assert str(got.value) == str(want.value)


def test_sections_parse_like_jax():
    d = {"train_batch_size": 8, "gradient_clipping": "auto",
         "steps_per_print": "auto",
         "optimizer": {"type": "AdamW", "params": {"lr": 2e-4}},
         "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
         "fp16": {"enabled": True, "initial_scale_power": 8,
                  "loss_scale_window": 100},
         "zero_optimization": {"stage": 1}}
    want = JConfig(d, mesh_manager=make_mesh(dp=8))
    got = DeepSpeedConfig(d, world_size=8)
    for name in ("optimizer_name", "optimizer_params", "scheduler_name",
                 "scheduler_params", "fp16_enabled", "initial_scale_power",
                 "loss_scale_window", "hysteresis", "gradient_clipping",
                 "steps_per_print", "zero_optimization_stage"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("section", [
    {"mode": "fixed", "block": 16, "num_local_blocks": 4}, None])
def test_sparse_attention_section_kept_raw_like_jax(section):
    """The top-level ``sparse_attention`` section is read and kept as it
    is (JAX ``runtime/config.py:343``), absent as None."""
    d = {"train_batch_size": 8}
    if section is not None:
        d["sparse_attention"] = section
    want = JConfig(d, mesh_manager=make_mesh(dp=8))
    got = DeepSpeedConfig(d, world_size=8)
    assert got.sparse_attention == want.sparse_attention == section


@pytest.mark.parametrize("d,exc,match", [
    ({"train_batch_size": 8, "progressive_layer_drop": {}},
     DeepSpeedConfigError, "not ported"),
    ({"train_batch_size": 8, "fp16": {"enabled": True, "loss_scal": 1}},
     DeepSpeedConfigError, "unknown keys"),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 2}},
     NotImplementedError, "Multi-GPU"),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 3}},
     NotImplementedError, "Multi-GPU"),
    ({"train_batch_size": 8,
      "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
     NotImplementedError, "offload_optimizer"),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 1,
                                                   "cpu_offload": True}},
     NotImplementedError, "offload_optimizer"),
    ({"train_batch_size": 8,
      "zero_optimization": {"offload_param": {"device": "nvme"}}},
     NotImplementedError, "offload_param"),
], ids=["unported_section", "unknown_fp16_key", "zero2", "zero3",
        "offload_optimizer", "cpu_offload_alias", "offload_param"])
def test_unported_features_raise(d, exc, match):
    with pytest.raises(exc, match=match):
        DeepSpeedConfig(d)


@pytest.mark.parametrize("section", [
    {}, {"async_save": True, "keep_last": 2, "tag_validation": "Fail"},
    {"tag_validation": "ignore", "retries": {"max_attempts": 5},
     "commit": {"barrier_deadline_s": 10.0}}])
def test_checkpoint_section_parses_like_jax(section):
    """The ``checkpoint`` section is ported (JAX ``runtime/config.py:
    243-256``): the typed config and the tag-validation flags as the JAX
    package reads them."""
    d = {"train_batch_size": 8, "checkpoint": section}
    want = JConfig(d, mesh_manager=make_mesh(dp=8))
    got = DeepSpeedConfig(d, world_size=8)
    def fields(d):     # the JAX models carry a `_deprecated_fields` field
        return {k: fields(v) if isinstance(v, dict) else v
                for k, v in d.items() if k != "_deprecated_fields"}

    assert got.checkpoint_config.to_dict() == \
        fields(want.checkpoint_config.to_dict())
    for name in ("checkpoint_tag_validation_mode",
                 "checkpoint_tag_validation_enabled",
                 "checkpoint_tag_validation_fail",
                 "load_universal_checkpoint"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("key", ["load_universal_checkpoint",
                                 "load_universal"])
def test_universal_checkpoint_raises(key):
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        DeepSpeedConfig({"train_batch_size": 8, "checkpoint": {key: True}})


def test_unknown_section_still_raises_beside_checkpoint():
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        DeepSpeedConfig({"train_batch_size": 8, "checkpoint": {},
                         "telemetry": {}, "flops_profiler": {}})


RUN_LOOP_SECTIONS = [
    {},
    {"data": {"resumable": True, "shuffle": True, "seed": 1234,
              "max_bad_records": 2, "journal_batches": True},
     "supervision": {"step_deadline_s": 30.0, "preempt_save_deadline_s": 60,
                     "heartbeat": {"enabled": True, "interval_s": 1.0,
                                   "gap_s": 5.0},
                     "rollback": {"max_rollbacks": 3, "lr_factor": 0.5,
                                  "skip_batches": 1}},
     "telemetry": {"enabled": True,
                   "spans": {"capacity": 128, "synced": True},
                   "metrics": {"path": "m.jsonl", "interval_steps": 2,
                               "peak_tflops": 100.0}},
     "elasticity": {"enabled": True, "micro_batch_sizes": [2, 4]},
     "wall_clock_breakdown": True},
]


@pytest.mark.parametrize("extra", RUN_LOOP_SECTIONS,
                         ids=["defaults", "every_section"])
def test_run_loop_sections_parse_like_jax(extra):
    """The ``data``, ``supervision``, ``telemetry``, ``elasticity`` and
    ``wall_clock_breakdown`` sections are ported (JAX ``runtime/config.py:
    177, 258-286, 336``): the typed configs as the JAX package reads
    them, the elasticity section kept raw."""
    d = {"train_batch_size": 8, **extra}
    want = JConfig(d, mesh_manager=make_mesh(dp=8))
    got = DeepSpeedConfig(d, world_size=8)

    def fields(d):     # the JAX models carry a `_deprecated_fields` field
        return {k: fields(v) if isinstance(v, dict) else v
                for k, v in d.items() if k != "_deprecated_fields"}

    for name in ("data_config", "supervision_config", "telemetry_config"):
        assert getattr(got, name).to_dict() == \
            fields(getattr(want, name).to_dict()), name
    assert got.elasticity_config_dict == want.elasticity_config_dict
    assert got.wall_clock_breakdown == want.wall_clock_breakdown


@pytest.mark.parametrize("d,exc,match", [
    ({"data": {"max_bad_records": -1}}, DeepSpeedConfigError,
     "invalid 'data' section"),
    ({"supervision": {"rollback": {"lr_factor": 0.0}}},
     DeepSpeedConfigError, "invalid 'supervision' section"),
    ({"telemetry": {"metrics": {"interval_steps": 0}}},
     DeepSpeedConfigError, "invalid 'telemetry' section"),
    ({"telemetry": {"spans": {"capacty": 1}}}, DeepSpeedConfigError,
     "unknown config keys"),
    ({"telemetry": {"trace": {"enabled": True}}}, NotImplementedError,
     "torch.profiler"),
    ({"elasticity": [1]}, DeepSpeedConfigError, "must be a dict"),
], ids=["data", "supervision", "telemetry", "telemetry_typo", "trace",
        "elasticity"])
def test_run_loop_section_errors(d, exc, match):
    with pytest.raises(exc, match=match):
        DeepSpeedConfig({"train_batch_size": 8, **d})


SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=30,
                        lr_range_test_step_rate=2.0,
                        lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, decay_lr_rate=0.1,
                     cycle_first_step_size=50, cycle_second_step_size=70,
                     decay_step_size=10),
    "WarmupLR": dict(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                     warmup_num_steps=60),
    "WarmupDecayLR": dict(total_num_steps=180, warmup_min_lr=1e-5,
                          warmup_max_lr=1e-3, warmup_num_steps=40,
                          warmup_type="linear"),
}


class _Opt:
    def __init__(self):
        self.param_groups = [{"lr": 0.0}]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_jax_over_200_steps(name):
    jo, po = _Opt(), _Opt()
    js = jlr.get_lr_schedule_class(name)(jo, **SCHEDULES[name])
    ps = plr.get_lr_schedule_class(name)(po, **SCHEDULES[name])
    series = []
    for _ in range(200):
        js.step()
        ps.step()
        assert po.param_groups[0]["lr"] == jo.param_groups[0]["lr"]
        series.append(po.param_groups[0]["lr"])
    assert len(set(series)) > 2                 # the schedule moved
    if name == "OneCycle":
        assert ps.get_mom() == js.get_mom()


@pytest.mark.parametrize("hysteresis,window", [(1, 3), (2, 5), (3, 2)])
def test_loss_scaler_matches_jax(hysteresis, window):
    config = dict(enabled=True, init_scale=2.0 ** 10, scale_window=window,
                  min_scale=4.0, delayed_shift=hysteresis)
    jc, pc = jls.LossScalerConfig(**config), pls.LossScalerConfig(**config)
    js, ps = jls.init_state(jc), pls.init_state(pc)
    # an overflow-heavy stretch (drops to the floor), then a clean one
    # (growth after each window)
    rng = np.random.default_rng(hysteresis)
    overflows = np.concatenate([rng.random(60) < 0.9, rng.random(60) < 0.05])
    scales = []
    for of in overflows:
        js = jls.update_state(js, jnp.asarray(of), jc)
        ps = pls.update_state(ps, torch.tensor(bool(of)), pc)
        for key in ("loss_scale", "good_steps", "hysteresis"):
            assert ps[key].item() == np.asarray(js[key]).item(), key
        scales.append(ps["loss_scale"].item())
    steps = list(zip(scales, scales[1:]))
    assert min(scales) == 4.0                              # the floor holds
    assert any(b > a for a, b in steps)                    # and it grew


def test_static_and_disabled_scaler():
    for config in (pls.LossScalerConfig(enabled=False),
                   pls.LossScalerConfig(enabled=True, static_scale=128.0)):
        state = pls.init_state(config)
        state = pls.update_state(state, torch.tensor(True), config)
        assert state["good_steps"].item() == 1
        assert state["loss_scale"].item() == (128.0 if config.enabled else 1.0)


def _grad_tree(seed, poison=None):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32) * 3}}
    if poison is not None:
        tree["b"]["c"][2] = poison
    return tree


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_grad_norm_and_clip_match_jax(max_norm):
    tree = _grad_tree(1)
    jt, pt = _to(tree, jnp.asarray), _to(tree, torch.from_numpy)
    for norm_type in (2.0, float("inf")):
        np.testing.assert_allclose(
            putils.global_grad_norm(pt, norm_type).item(),
            float(jutils.global_grad_norm(jt, norm_type)), rtol=1e-6)
    pc, pn = putils.clip_grads_by_global_norm(pt, max_norm)
    jc, jn = jutils.clip_grads_by_global_norm(jt, max_norm)
    np.testing.assert_allclose(pn.item(), float(jn), rtol=1e-6)
    for key in ("a",):
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pc["b"]["c"].numpy(), np.asarray(jc["b"]["c"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_has_overflow_matches_jax(poison):
    tree = _grad_tree(2, poison)
    assert bool(putils.has_overflow(_to(tree, torch.from_numpy))) == \
        bool(jutils.has_overflow(_to(tree, jnp.asarray)))


def test_timers_measure_host_time():
    """Default timers measure host time with no device round-trip; off
    CUDA there is no device time."""
    timers = SynchronizedWallClockTimer()
    t = timers("fwd")
    t.start()
    sum(range(10000))
    t.stop()
    assert t.elapsed(reset=False) > 0 and t.device_elapsed() is None
    assert set(timers.get_mean(["fwd", "absent"])) == {"fwd"}
    tput = ThroughputTimer(batch_size=4, start_step=1)
    for _ in range(3):
        tput.start()
        sum(range(10000))
        tput.stop(global_step=True)
    assert tput.global_step_count == 3 and tput.avg_samples_per_sec() > 0
