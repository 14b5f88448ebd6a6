"""The port's training path (``initialize`` → forward / backward / step,
``train_batch_fused``) against the JAX package's engine on its 8-device CPU
mesh, from the same fp32 params (``convert.from_jax_params``) and the same
batches.  The JAX engine's global batch (micro 1 × dp 8) is the port's
micro-batch of 8.  Tolerances: losses and final master params 1e-5
(relative and absolute), gradients 1e-5; counters and the fp16 scaler's
scale exactly.  Each JAX trajectory is built once per module.  The ``neo`` cases train
TINY_GPT with GPT-Neo's banded local layers (window 4).

The optimizer is bench.py's (Adam, lr 1e-4, weight decay 0.01).  Adam
moves an element with a near-zero gradient by up to lr·Δg/eps, so the
~1e-10 summation-order noise between two fp32 backends bounds the params'
agreement by about lr·1e-2: 1e-6 at this lr, 1e-5 at lr 1e-3."""

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import convert, gpt
from deepspeed_tpu_torch.runtime.model import from_gpt
from tests.unit.common import (TINY_GPT, base_config, make_mesh,
                               random_tokens, tiny_model)

#: the module (``ops.kernels`` exports a function of the same name)
port_flash = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.flash_attention")

TOL = 1e-5
SEQ = 16
STEPS = 3
#: the tiny GPT-Neo: TINY_GPT with GPT-Neo's attention (global and local
#: layers in turn, window 4 < SEQ, unscaled softmax)
NEO = {"local_attention_window": 4, "local_attention_alternating": True,
       "attn_softmax_scale": 1.0}

#: name -> (stage, gas, extra config, use train_batch_fused)
CASES = {
    "stage0": (0, 1, None, False),
    "stage1": (1, 1, None, False),
    "gas2": (0, 2, None, False),
    "clip_warmup": (1, 1, {"gradient_clipping": 0.05,
                           "scheduler": {"type": "WarmupLR", "params": {
                               "warmup_num_steps": 4, "warmup_max_lr": 1e-4,
                               "warmup_type": "linear"}}}, False),
    "fused_gas2": (0, 2, None, True),
    "neo_fused": (1, 1, None, True),
}
#: the cases that train another model than TINY_GPT: its config fields
CASE_MODEL = {"neo_fused": NEO}


def _batches(gas, seed=1):
    return [random_tokens(8, SEQ, seed=seed + i) for i in range(STEPS * gas)]


OPTIMIZER = {"optimizer": {"type": "Adam",
                           "params": {"lr": 1e-4, "weight_decay": 0.01}}}


def _config(micro_batch, gas, stage, extra, **precision):
    return base_config(micro_batch=micro_batch, gas=gas, stage=stage,
                       extra={**OPTIMIZER, **(extra or {})}, **precision)


def _jax_engine(stage, gas, extra=None, dtype=jnp.float32, model_fields=None,
                **precision):
    model = tiny_model(dtype=dtype, **(model_fields or {}))
    cfg = _config(1, gas, stage, extra, **precision)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, config=cfg, mesh_manager=make_mesh(dp=8),
        rng=jax.random.PRNGKey(42))
    return engine


def _port_engine(master_np, stage, gas, extra=None, dtype=torch.float32,
                 model_fields=None, **precision):
    cfg = convert.config_from_jax(
        dataclasses.replace(TINY_GPT, **(model_fields or {})), dtype=dtype)
    spec = dataclasses.replace(
        from_gpt(cfg), params=convert.from_jax_params(master_np))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=_config(8, gas, stage, extra, **precision),
        device="cpu")
    return engine


def _run(engine, batches, gas, fused):
    losses = []
    if fused:
        for i in range(0, len(batches), gas):
            stacked = {"tokens": np.concatenate(
                [b["tokens"] for b in batches[i:i + gas]])}
            losses.append(float(engine.train_batch_fused(stacked)))
        return losses
    for b in batches:
        loss = engine.forward(b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def trajectories():
    """Per case: the JAX engine's initial master params, its losses, final
    master params, counters and lr, built once."""
    out = {}
    for name, (stage, gas, extra, fused) in CASES.items():
        engine = _jax_engine(stage, gas, extra,
                             model_fields=CASE_MODEL.get(name))
        init = jax.device_get(engine.state["master"])
        losses = _run(engine, _batches(gas), gas, fused)
        out[name] = dict(init=init, losses=losses,
                         master=jax.device_get(engine.state["master"]),
                         counters=(engine.micro_steps, engine.global_steps,
                                   engine.global_samples,
                                   engine.skipped_steps),
                         lr=engine.get_lr(),
                         norm=float(engine.get_global_grad_norm()))
    return out


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax_engine(trajectories, case):
    stage, gas, extra, fused = CASES[case]
    ref = trajectories[case]
    engine = _port_engine(ref["init"], stage, gas, extra,
                          model_fields=CASE_MODEL.get(case))
    losses = _run(engine, _batches(gas), gas, fused)
    np.testing.assert_allclose(losses, ref["losses"], rtol=TOL, atol=TOL)
    _assert_tree_close(convert.to_numpy_params(engine.state["master"]),
                       ref["master"], TOL)
    assert (engine.micro_steps, engine.global_steps, engine.global_samples,
            engine.skipped_steps) == ref["counters"]
    np.testing.assert_allclose(engine.get_lr(), ref["lr"], rtol=1e-12)
    np.testing.assert_allclose(engine.get_global_grad_norm(), ref["norm"],
                               rtol=TOL, atol=TOL)


def test_fp16_overflow_skip_matches_jax_engine():
    """An inf in the accumulated gradients: the step is skipped, the
    dynamic scale halves (hysteresis 1), the params stay bitwise, and the
    counters move as in the JAX engine; a clean step then proceeds."""
    fp16 = {"enabled": True, "initial_scale_power": 4,
            "loss_scale_window": 2, "hysteresis": 1}
    jeng = _jax_engine(0, 1, dtype=jnp.float16, fp16=fp16)
    peng = _port_engine(jax.device_get(jeng.state["master"]), 0, 1,
                        dtype=torch.float16, fp16=fp16)
    assert peng.cur_scale == jeng.cur_scale == 16.0

    acc = jeng.state["grad_acc"]
    acc["wte"] = acc["wte"].at[0, 0].set(jnp.inf)
    jeng.state["grad_acc"] = acc
    peng.state["grad_acc"]["wte"][0, 0] = float("inf")
    before = peng.state["params"]["wte"].clone()
    jeng.step()
    peng.step()
    assert torch.equal(peng.state["params"]["wte"], before)
    assert not peng.state["grad_acc"]["wte"].any()

    batch = random_tokens(8, SEQ, seed=0)
    jl = jeng.forward(batch); jeng.backward(jl); jeng.step()
    pl = peng.forward(batch); peng.backward(pl); peng.step()
    for eng in (jeng, peng):
        assert (eng.skipped_steps, eng.global_steps, eng.micro_steps) == (1, 2, 2)
    assert peng.cur_scale == jeng.cur_scale == 8.0
    # fp16 activations: both sides round, in different places
    np.testing.assert_allclose(float(pl), float(jl), rtol=2e-3)


def _port_grads(cfg, master_np, batch, **overrides):
    cfg = dataclasses.replace(cfg, **overrides)
    params = convert.from_jax_params(master_np)
    leaves = [p for p in jax.tree_util.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tokens = {"tokens": torch.from_numpy(batch["tokens"]).long()}
    loss = gpt.loss_fn(params, tokens, cfg)
    loss.backward()
    return float(loss.detach()), convert.to_numpy_params(
        jax.tree_util.tree_map(lambda p: p.grad, params))


@pytest.fixture(scope="module")
def jax_grads():
    """``get(model)``: the JAX ``loss_fn``'s params, batch, loss and
    gradients of TINY_GPT (``"gpt2"``) or the tiny GPT-Neo (``"neo"``),
    each built once."""
    cache = {}

    def get(model):
        if model not in cache:
            cfg = dataclasses.replace(TINY_GPT,
                                      **(NEO if model == "neo" else {}))
            params = jgpt.init(cfg, jax.random.PRNGKey(3))
            batch = random_tokens(4, SEQ, seed=9)
            loss, grads = jax.value_and_grad(
                lambda p: jgpt.loss_fn(
                    p, jax.tree_util.tree_map(jnp.asarray, batch), cfg))(
                        params)
            cache[model] = (cfg, jax.device_get(params), batch, float(loss),
                            jax.device_get(grads))
        return cache[model]
    return get


@pytest.mark.parametrize("model,overrides", [
    ("gpt2", {}), ("gpt2", {"remat": True, "remat_policy": "nothing"}),
    ("gpt2", {"remat": True, "remat_policy": "attn_out"}),
    ("gpt2", {"loss_chunk": 4}), ("gpt2", {"loss_chunk": 5}),
    ("gpt2", {"remat": True, "remat_policy": "attn_out", "loss_chunk": 8}),
    ("neo", {}), ("neo", {"remat": True, "remat_policy": "attn_out"})],
    ids=["plain", "remat_nothing", "remat_attn_out", "chunk4",
         "chunk5_uneven", "remat_chunk8", "neo", "neo_remat_attn_out"])
def test_loss_and_grads_match_jax(jax_grads, model, overrides):
    """Remat on or off and the chunked head give the loss and gradients of
    the JAX ``loss_fn`` (full logits, no remat); the tiny GPT-Neo's banded
    layers take the window option of the flash backward."""
    jcfg, master, batch, jloss, jgrads = jax_grads(model)
    cfg = convert.config_from_jax(jcfg, dtype=torch.float32)
    loss, grads = _port_grads(cfg, master, batch, **overrides)
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    _assert_tree_close(grads, jgrads, TOL)


@pytest.mark.parametrize("policy,per_step,fields", [
    pytest.param("nothing", 2, {}, id="nothing-2"),
    pytest.param("attn_out", 1, {}, id="attn_out-1"),
    pytest.param("attn_out", 1, NEO, id="neo-attn_out-1")])
def test_remat_policy_forward_kernel_count(monkeypatch, policy, per_step,
                                           fields):
    """``attn_out`` keeps O and lse, so the backward never re-runs the
    attention forward: n_layer forward calls per step, 2 × n_layer under
    ``nothing``; for GPT-Neo its banded layers included."""
    calls = []
    real = port_flash._forward
    monkeypatch.setattr(port_flash, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    cfg = dataclasses.replace(
        convert.config_from_jax(dataclasses.replace(TINY_GPT, **fields),
                                torch.float32),
        remat=True, remat_policy=policy)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg), config=base_config(micro_batch=4),
        device="cpu", generator=torch.Generator().manual_seed(0))
    engine.train_batch_fused(random_tokens(4, SEQ, seed=2))
    assert len(calls) == per_step * cfg.n_layer


def test_eval_loss_leaves_accumulator_and_matches_jax(trajectories):
    ref = trajectories["stage0"]
    jeng = _jax_engine(0, 1)
    peng = _port_engine(ref["init"], 0, 1)
    probe = random_tokens(8, SEQ, seed=7)
    np.testing.assert_allclose(float(peng.eval_loss(probe)),
                               float(jeng.eval_loss(probe)), rtol=TOL,
                               atol=TOL)
    assert not peng.state["grad_acc"]["wte"].any()
    peng.eval()
    peng.forward(probe)
    assert not peng.state["grad_acc"]["wte"].any()


def test_convert_round_trip_and_training_fields():
    """``to_numpy_params`` inverts ``from_jax_params``, and
    ``config_from_jax`` carries the training fields."""
    tree = jax.device_get(jgpt.init(TINY_GPT, jax.random.PRNGKey(0)))
    back = convert.to_numpy_params(convert.from_jax_params(tree))
    _assert_tree_close(back, tree, 0.0)
    jcfg = dataclasses.replace(TINY_GPT, remat=True, remat_policy="attn_out",
                               loss_chunk=8)
    cfg = convert.config_from_jax(jcfg)
    assert (cfg.remat, cfg.remat_policy, cfg.loss_chunk, cfg.dropout) == \
        (True, "attn_out", 8, 0.0)
    with pytest.raises(NotImplementedError, match="dropout"):
        convert.config_from_jax(dataclasses.replace(TINY_GPT, dropout=0.1))
