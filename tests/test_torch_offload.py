"""ZeRO-Offload in the port (``zero_optimization.offload_optimizer``,
``runtime/zero/offload_engine.py``, ``runtime/swap_tensor``,
``data_types.grad_accum_dtype``, ``runtime/memory_model.py``) against
the JAX package's and against the port's own device-Adam engine, on
TINY_GPT (2 layers, d 64, vocab 256, seq 16).

- The port's offloaded engine (micro 8) and the JAX package's (ZeRO 1 on
  the 8-device CPU mesh, micro 1 x dp 8) from the same numpy params on
  the same batches: losses at rtol 2e-4 (JAX ``test_offload.py:65-73``)
  and the final masters at 1e-5.  A JAX offload tag resumes in the port
  and a port offload tag in the JAX engine, both continuing the JAX run
  at the same tolerances; the host state (``offload_optimizer_rank0.npz``)
  carries the step and the moments exactly.
- Port against port: offload tracks the device Adam (2e-4); ``nvme``
  equals ``cpu``, pipelined equals unpipelined, a save/load resumes
  bitwise; the bf16 accumulator keeps its dtype and tracks fp32
  accumulation at 1e-4; an overflowed fp16 step moves nothing but the
  scale; a failure mid-step leaves consistent params and a tag that
  saves and loads; ``load_module_state_dict`` keeps the moments.
- The memory model equals the JAX package's numbers on the 2.7B shapes,
  and a fully automatic batch triple sizes the same micro-batch as the
  JAX config under one fixed budget.

One JAX engine trains and saves (module fixture ``jax_runs``), a second
resumes the port's tag there.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import memory_model as jmm
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.model import from_gpt as jax_from_gpt
from deepspeed_tpu.runtime.zero.offload_engine import \
    HostOffloadOptimizer as JaxHostOffload
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime import memory_model as mm
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.model import from_gpt
from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncTensorSwapper,
                                                     OptimizerStateSwapper)
from deepspeed_tpu_torch.runtime.zero.offload_engine import \
    HostOffloadOptimizer
from tests.unit.common import TINY_GPT, base_config, make_mesh, tiny_model

LOSS_TOL = 2e-4
MASTER_TOL = 1e-5
SEQ = 16
STEPS = 4
SAVE_AT = 2
OPTIMIZER = {"optimizer": {"type": "Adam",
                           "params": {"lr": 1e-4, "weight_decay": 0.01}}}


def _repeated(n=STEPS):
    """One batch ``n`` times: its loss falls step by step."""
    return _batches(1) * n


def _batches(n=STEPS, seed=1):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        out.append({"tokens": rng.integers(0, 256, (8, SEQ + 1))
                    .astype(np.int32)})
    return out


def _config(micro, offload="cpu", extra=None, **precision):
    cfg = base_config(micro_batch=micro, gas=1, stage=1,
                      extra={**OPTIMIZER, **(extra or {})}, **precision)
    if offload:
        cfg["zero_optimization"]["offload_optimizer"] = \
            offload if isinstance(offload, dict) else {"device": offload}
    return cfg


def _port_engine(offload="cpu", params_np=None, seed=7, dtype=torch.float32,
                 extra=None, **precision):
    spec = from_gpt(convert.config_from_jax(TINY_GPT, dtype=dtype))
    if params_np is not None:
        spec = dataclasses.replace(
            spec, params=convert.from_jax_params(params_np))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=_config(8, offload, extra, **precision),
        device="cpu", generator=torch.Generator().manual_seed(seed))
    return engine


def _jax_engine(seed=42):
    engine, *_ = deepspeed_tpu.initialize(
        model=tiny_model(), config=_config(1), mesh_manager=make_mesh(dp=8),
        rng=jax.random.PRNGKey(seed))
    return engine


def _step(engine, batch):
    loss = engine.forward(batch)
    engine.backward(loss)
    engine.step()
    return float(loss)


def _host_state(engine):
    """The host optimizer's step and (master, m, v) per leaf, copied."""
    sd = engine._offload_opt.state_dict()
    return sd["step"], [np.array(np.asarray(x), np.float32).reshape(-1)
                        for k in ("master", "m", "v") for x in sd[k]]


def _assert_host_equal(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def _masters_by_path(engine):
    """The port's host masters keyed like ``convert.to_numpy_params``."""
    out = {}
    for k, i in enumerate(engine._host_order):
        path = engine._layout[i][0]
        out["/".join(path)] = engine._offload_opt.masters()[k].numpy()
    return out


def _jax_masters_by_path(engine):
    leaves = jax.tree_util.tree_leaves_with_path(engine.state["params"])
    return {"/".join(p.key for p in path): np.asarray(m)
            for (path, _), m in zip(leaves, engine._offload_opt.masters())}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX offloaded engine's 4 steps, saving after step 2: its init
    params, losses, final masters and host state, and its tag; then a
    port run of 2 steps from the same params saved as a tag, and a second
    JAX engine that resumes that tag for steps 3-4."""
    jdir = str(tmp_path_factory.mktemp("jax_tag"))
    engine = _jax_engine()
    init = jax.device_get(engine.state["params"])
    losses = []
    for i, b in enumerate(_batches()):
        if i == SAVE_AT:
            engine.save_checkpoint(jdir)
        losses.append(_step(engine, b))
    out = dict(dir=jdir, init=init, losses=losses,
               masters=_jax_masters_by_path(engine),
               host_step=engine._offload_opt.step_count)
    pdir = str(tmp_path_factory.mktemp("port_tag"))
    port = _port_engine(params_np=init)
    out["port_losses"] = [_step(port, b) for b in _batches()[:SAVE_AT]]
    port.save_checkpoint(pdir)
    out["port_dir"] = pdir
    resumed = _jax_engine(seed=9)
    resumed.load_checkpoint(pdir)
    out["jax_from_port_losses"] = [_step(resumed, b)
                                   for b in _batches()[SAVE_AT:]]
    out["jax_from_port_masters"] = _jax_masters_by_path(resumed)
    out["jax_from_port_step"] = resumed._offload_opt.step_count
    return out


def _assert_masters(got, want, tol=MASTER_TOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].reshape(want[k].shape), want[k],
                                   rtol=tol, atol=tol, err_msg=k)


def test_offload_tracks_jax_offload(jax_runs):
    engine = _port_engine(params_np=jax_runs["init"])
    losses = [_step(engine, b) for b in _batches()]
    np.testing.assert_allclose(losses, jax_runs["losses"], rtol=LOSS_TOL)
    _assert_masters(_masters_by_path(engine), jax_runs["masters"])
    assert engine._offload_opt.step_count == jax_runs["host_step"] == STEPS


def test_jax_offload_tag_resumes_in_port(jax_runs):
    engine = _port_engine(seed=11)
    _, client = engine.load_checkpoint(jax_runs["dir"])
    assert client["global_steps"] == SAVE_AT
    assert engine._offload_opt.step_count == SAVE_AT
    losses = [_step(engine, b) for b in _batches()[SAVE_AT:]]
    np.testing.assert_allclose(losses, jax_runs["losses"][SAVE_AT:],
                               rtol=LOSS_TOL)
    _assert_masters(_masters_by_path(engine), jax_runs["masters"])


def test_port_offload_tag_resumes_in_jax(jax_runs):
    np.testing.assert_allclose(jax_runs["port_losses"],
                               jax_runs["losses"][:SAVE_AT], rtol=LOSS_TOL)
    tag = os.path.join(jax_runs["port_dir"], f"global_step{SAVE_AT}")
    with np.load(os.path.join(tag, "offload_optimizer_rank0.npz")) as z:
        assert int(z["step"]) == SAVE_AT
        assert len(z.files) == 1 + 3 * len(jax_runs["masters"])
    np.testing.assert_allclose(jax_runs["jax_from_port_losses"],
                               jax_runs["losses"][SAVE_AT:], rtol=LOSS_TOL)
    _assert_masters(jax_runs["jax_from_port_masters"], jax_runs["masters"])
    assert jax_runs["jax_from_port_step"] == STEPS


def test_host_optimizer_bitwise_equal_to_jax(tmp_path):
    """The host optimizers alone, on the same leaves and gradients: the
    same bits, in host memory and through swap files."""
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((70_001,), (3, 17), (5,))]
    grads = [[rng.standard_normal(l.size).astype(np.float32) for l in leaves]
             for _ in range(3)]
    port = HostOffloadOptimizer([torch.from_numpy(l.copy()) for l in leaves],
                                weight_decay=0.01)
    nvme = HostOffloadOptimizer([torch.from_numpy(l.copy()) for l in leaves],
                                device="nvme", nvme_path=str(tmp_path / "s"),
                                weight_decay=0.01)
    ref = JaxHostOffload([l.copy() for l in leaves], weight_decay=0.01)
    for gs in grads:
        port.step([torch.from_numpy(g) for g in gs], lr=1e-3)
        nvme.step([torch.from_numpy(g) for g in gs], lr=1e-3)
        ref.step(gs, lr=1e-3, bf16_out=False)
    want = ref.state_dict()
    for got in (port.state_dict(), nvme.state_dict()):
        assert got["step"] == want["step"] == 3
        for k in ("master", "m", "v"):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a.numpy(), b.reshape(-1))
    assert nvme.swapper.swapped_bytes() == 3 * 4 * sum(l.size for l in leaves)
    nvme.close()
    assert not os.listdir(tmp_path / "s")


def test_offload_tracks_device_adam():
    dev = _port_engine(offload=None, seed=3)
    off = _port_engine(seed=3)
    a = [_step(dev, b) for b in _repeated()]
    b = [_step(off, b) for b in _repeated()]
    np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert b[-1] < b[0]


def test_nvme_bitwise_equal_to_cpu(tmp_path):
    cpu = _port_engine(seed=3)
    nvme = _port_engine(offload={"device": "nvme",
                                 "nvme_path": str(tmp_path / "swap"),
                                 "pipeline_read": True,
                                 "pipeline_write": True}, seed=3)
    assert [_step(cpu, b) for b in _batches()] == \
        [_step(nvme, b) for b in _batches()]
    _assert_host_equal(_host_state(nvme), _host_state(cpu))
    assert nvme._offload_opt.swapper.bytes_read > 0
    nvme.close()


def test_pipelined_bitwise_equal_to_unpipelined():
    on = _port_engine(seed=3)
    off = _port_engine(offload={"device": "cpu",
                                "pipeline_transfers": False}, seed=3)
    assert on._offload_pipeline and not off._offload_pipeline
    assert [_step(on, b) for b in _batches()] == \
        [_step(off, b) for b in _batches()]
    _assert_host_equal(_host_state(on), _host_state(off))
    assert torch.equal(on._flat["params"], off._flat["params"])


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_save_load_roundtrip_bitwise(tmp_path, device):
    def offload(name):
        return {"device": "nvme", "nvme_path": str(tmp_path / name)} \
            if device == "nvme" else "cpu"

    engine = _port_engine(offload=offload("a"), seed=3)
    for b in _batches()[:SAVE_AT]:
        _step(engine, b)
    engine.save_checkpoint(str(tmp_path / "ckpt"))
    expect = [_step(engine, b) for b in _batches()[SAVE_AT:]]
    resumed = _port_engine(offload=offload("b"), seed=99)
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    assert [_step(resumed, b) for b in _batches()[SAVE_AT:]] == expect
    _assert_host_equal(_host_state(resumed), _host_state(engine))
    assert torch.equal(resumed._flat["params"], engine._flat["params"])
    for e in (engine, resumed):
        e.close()


def test_bf16_accumulator_tracks_fp32_accumulation():
    """JAX ``test_offload.py:445-510``: at gas 1 the bf16 accumulator
    holds the bf16 backward's gradients; only the fp32 accumulator's
    rounding differs."""
    def run(accum):
        extra = {"data_types": {"grad_accum_dtype": accum}} if accum else {}
        engine = _port_engine(seed=3, dtype=torch.bfloat16, extra=extra,
                              bf16={"enabled": True})
        return engine, [_step(engine, b) for b in _repeated()]

    eng16, l16 = run("bf16")
    assert eng16._flat["grad_acc"].dtype == torch.bfloat16
    assert eng16._flat["params"].dtype == torch.bfloat16
    eng32, l32 = run(None)
    assert eng32._flat["grad_acc"].dtype == torch.float32
    assert l16[-1] < l16[0]
    np.testing.assert_allclose(l16, l32, rtol=1e-4)


def test_fp16_overflow_skips_and_backs_off():
    """An fp16 step whose scaled gradients overflow moves no bytes: the
    master, the moments and the step stay, the accumulator is zeroed and
    the scale halves; the following steps train."""
    engine = _port_engine(seed=3, dtype=torch.float16,
                          fp16={"enabled": True, "initial_scale_power": 20,
                                "loss_scale_window": 4, "hysteresis": 1})
    before = _host_state(engine)
    scale = engine.cur_scale
    _step(engine, _batches()[0])
    assert engine.skipped_steps == 1 and engine.cur_scale == scale / 2
    assert engine._offload_last["stats_s"] >= 0
    assert "copies" not in engine._offload_last
    _assert_host_equal(_host_state(engine), before)
    assert not engine._flat["grad_acc"].any()
    losses = [_step(engine, b) for b in _batches(12, seed=1)[:12]]
    assert np.isfinite(engine.cur_scale) and engine.cur_scale >= 1.0
    assert 0 < engine._offload_opt.step_count == 13 - engine.skipped_steps
    assert np.isfinite(losses).all()
    assert engine._flat["params"].dtype == torch.float16


def test_step_failure_leaves_engine_checkpointable(monkeypatch, tmp_path):
    """JAX ``test_offload.py:742``: the host optimizer dies on the third
    leaf mid-pipeline; the step raises, every param leaf matches its host
    master, the accumulator is zeroed, and a rescue tag saves and loads."""
    engine = _port_engine(seed=3, dtype=torch.bfloat16,
                          bf16={"enabled": True})
    _step(engine, _batches()[0])
    calls = {"n": 0}
    real = HostOffloadOptimizer.step_one

    def dying(self, i, g, lr, bf16_out=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected nvme read error")
        return real(self, i, g, lr, bf16_out=bf16_out)

    monkeypatch.setattr(HostOffloadOptimizer, "step_one", dying)
    with pytest.raises(RuntimeError, match="injected nvme read error"):
        _step(engine, _batches()[1])
    monkeypatch.setattr(HostOffloadOptimizer, "step_one", real)
    masters = engine._offload_opt.masters()
    for k, i in enumerate(engine._host_order):
        _, shape, off = engine._layout[i]
        assert torch.equal(
            engine._flat["params"][off:off + shape.numel()],
            masters[k].reshape(-1).to(torch.bfloat16)), engine._layout[i][0]
    assert not engine._flat["grad_acc"].any()
    assert engine.save_checkpoint(str(tmp_path), tag="rescue")
    other = _port_engine(seed=5, dtype=torch.bfloat16, bf16={"enabled": True})
    other.load_checkpoint(str(tmp_path), tag="rescue")
    assert torch.equal(other._flat["params"], engine._flat["params"])
    _assert_host_equal(_host_state(other), _host_state(engine))


def test_load_module_state_dict_keeps_moments():
    """JAX ``test_offload.py:135-186``: a weight swap keeps the host
    moments and step; the master takes the fp32 source bit for bit (not
    its bf16 rounding), the device params its rounding."""
    engine = _port_engine(seed=3, dtype=torch.bfloat16, bf16={"enabled": True})
    for b in _batches()[:2]:
        _step(engine, b)
    step, before = _host_state(engine)
    n = len(before) // 3
    rng = np.random.default_rng(3)

    def fresh(tree):
        # fp32 values whose low mantissa bits a bf16 round trip would lose
        return {k: fresh(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * (1 + 1e-5)).astype(np.float32)
                for k, v in tree.items()}

    src = fresh(convert.to_numpy_params(engine.module_state_dict()))
    engine.load_module_state_dict(src)
    after_step, after = _host_state(engine)
    assert after_step == step == 2
    for x, y in zip(after[n:], before[n:]):
        np.testing.assert_array_equal(x, y)
    got = _masters_by_path(engine)
    want = {"/".join(p): np.asarray(v) for p, v in _paths(src)}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    params = {"/".join(p): t for p, t in _paths(engine.module_state_dict())}
    for k in want:
        assert torch.equal(params[k], torch.from_numpy(want[k])
                           .to(torch.bfloat16)), k
    with pytest.raises(ValueError, match="missing leaf"):
        engine.load_module_state_dict({"wte": src["wte"]})


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_load_without_host_state_reseeds_master(tmp_path):
    """A tag without the host npz (a run without offload) reseeds the
    host master from the loaded params, with fresh moments."""
    dev = _port_engine(offload=None, seed=3)
    for b in _batches()[:2]:
        _step(dev, b)
    dev.save_checkpoint(str(tmp_path))
    engine = _port_engine(seed=99)
    engine.load_checkpoint(str(tmp_path))
    step, state = _host_state(engine)
    n = len(state) // 3
    assert step == 0 and not any(x.any() for x in state[n:])
    assert torch.equal(engine._flat["params"], dev._flat["params"])
    for k, i in enumerate(engine._host_order):
        _, shape, off = engine._layout[i]
        np.testing.assert_array_equal(
            state[k], dev._flat["master"][off:off + shape.numel()].numpy())
    _step(engine, _batches()[2])


def test_swappers_roundtrip(tmp_path):
    sw = AsyncTensorSwapper(str(tmp_path / "t"))
    t = torch.arange(1000, dtype=torch.float32).reshape(10, 100)
    sw.swap_out("a", t)
    assert sw.contains("a") and sw.swapped_bytes() == 4000
    assert torch.equal(sw.swap_in("a"), t)
    sw.close()
    assert not os.listdir(tmp_path / "t")
    opt = OptimizerStateSwapper(str(tmp_path / "o"))
    opt.put("g0", {"x": t.reshape(-1)})
    opt.put("g1", {"x": t.reshape(-1) * 2})
    assert torch.equal(opt.get("g0", prefetch_next="g1")["x"], t.reshape(-1))
    assert torch.equal(opt.get("g1")["x"], t.reshape(-1) * 2)
    assert opt.bytes_written == opt.bytes_read == 8000
    with pytest.raises(KeyError):
        opt.get("g2")
    opt.close()


# ---------------------------------------------------------- memory model

def _jax_sizes(cfg):
    shapes = jax_from_gpt(cfg).param_shapes()
    return [int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes)]


@pytest.mark.parametrize("accum,pipelined", [(4, True), (2, True),
                                              (2, False)])
def test_memory_model_matches_jax_at_2p7b(accum, pipelined):
    port = from_gpt(gpt.GPT2_2_7B)
    sizes = _jax_sizes(jgpt.GPT2_2_7B)
    n = sum(sizes)
    assert port.num_params() == n and n >= 2.6e9
    assert mm.offload_peak_bytes(
        n, max(sizes), grad_accum_bytes=accum,
        pipeline_transfers=pipelined) == jmm.offload_peak_bytes(
        n, max(sizes), grad_accum_bytes=accum, pipeline_transfers=pipelined)
    for stage in (0, 1):
        for offload in (False, True):
            assert mm.zero_state_bytes(n, 1, stage, True, offload) == \
                jmm.zero_state_bytes(n, 1, stage, True, offload)
    assert mm.device_budget(device_memory_bytes=80 << 30) == \
        jmm.device_budget(device_memory_bytes=80 << 30)
    assert mm.device_budget() is None   # no card here


AUTO = {"train_batch_size": "auto", "train_micro_batch_size_per_gpu": "auto",
        "gradient_accumulation_steps": "auto"}


@pytest.mark.parametrize("budget_gib", [16, 80])
@pytest.mark.parametrize("model", ["tiny", "2.7b"])
@pytest.mark.parametrize("zero", [
    {"stage": 0}, {"stage": 1}, {"stage": 1, "offload_optimizer":
                                 {"device": "cpu"}}],
    ids=["stage0", "stage1", "stage1_offload"])
def test_auto_micro_batch_matches_jax(monkeypatch, model, zero, budget_gib):
    budget = int((budget_gib << 30) * 0.85)
    monkeypatch.setattr(mm, "device_budget", lambda **kw: budget)
    monkeypatch.setattr(jmm, "device_budget", lambda **kw: budget)
    jcfg, pcfg = (TINY_GPT, convert.config_from_jax(TINY_GPT)) \
        if model == "tiny" else (
            dataclasses.replace(jgpt.GPT2_2_7B, max_seq_len=1024),
            dataclasses.replace(gpt.GPT2_2_7B, max_seq_len=1024))
    d = {**AUTO, "bf16": {"enabled": True}, "zero_optimization": zero}
    want = JaxConfig(d, mesh_manager=make_mesh(dp=8), model=jax_from_gpt(jcfg))
    got = DeepSpeedConfig(d, world_size=8, model=from_gpt(pcfg))
    assert got.train_micro_batch_size_per_gpu == \
        want.train_micro_batch_size_per_gpu
    assert got.train_batch_size == want.train_batch_size
    if model == "tiny":
        assert got.train_micro_batch_size_per_gpu > 1


def test_auto_micro_batch_is_one_without_a_budget():
    got = DeepSpeedConfig(AUTO, model=from_gpt(convert.config_from_jax(
        TINY_GPT)))
    assert got.train_micro_batch_size_per_gpu == 1


def test_pipeline_auto_disables_on_tight_budget(monkeypatch):
    """JAX ``test_offload.py:825``: the second in-flight leaf is dropped
    where it does not fit the budget."""
    monkeypatch.setattr(mm, "device_budget", lambda **kw: 1024)
    assert _port_engine()._offload_pipeline is False
    monkeypatch.setattr(mm, "device_budget", lambda **kw: 1 << 40)
    assert _port_engine()._offload_pipeline is True


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("extra,exc,match", [
    ({"data_types": {"grad_accum_dtype": "int8"}}, DeepSpeedConfigError,
     "grad_accum_dtype"),
    ({"data_types": {"grad_accum": "bf16"}}, DeepSpeedConfigError,
     "unknown keys"),
    ({"aio": {"thread_count": 2, "depth": 3}}, DeepSpeedConfigError, "aio"),
], ids=["bad_dtype", "unknown_data_types_key", "unknown_aio_key"])
def test_config_refusals(extra, exc, match):
    with pytest.raises(exc, match=match):
        DeepSpeedConfig({"train_batch_size": 8, **extra})


def test_sixteen_bit_accumulator_needs_offload():
    with pytest.raises(NotImplementedError, match="grad_accum_dtype"):
        _port_engine(offload=None, extra={"data_types": {
            "grad_accum_dtype": "bf16"}})


def test_offload_refuses_other_optimizers_and_missing_path():
    with pytest.raises(NotImplementedError, match="host"):
        _port_engine(extra={"optimizer": {"type": "Lamb",
                                          "params": {"lr": 1e-3}}})
    with pytest.raises(ValueError, match="nvme_path"):
        _port_engine(offload={"device": "nvme"})


def test_offload_sections_parse():
    c = DeepSpeedConfig({"train_batch_size": 8,
                         "data_types": {"grad_accum_dtype": "torch.bfloat16"},
                         "aio": {"thread_count": 2, "block_size": 4096},
                         "zero_optimization": {
                             "stage": 1, "offload_optimizer": {
                                 "device": "nvme", "nvme_path": "/x",
                                 "buffer_count": 5,
                                 "pipeline_transfers": False}}})
    assert c.grad_accum_dtype == "torch.bfloat16"
    assert c.aio_config.thread_count == 2 and c.aio_config.block_size == 4096
    oc = c.zero_config.offload_optimizer_config
    assert (oc.device, oc.nvme_path, oc.buffer_count,
            oc.pipeline_transfers) == ("nvme", "/x", 5, False)
