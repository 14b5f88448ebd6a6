"""The port's training path for BERT masked-LM pre-training under LAMB
(``initialize(model=from_bert(...))`` → forward / backward / step and
``train_batch_fused``) against the JAX package's engine on its 8-device CPU
mesh, from the same fp32 params and the same right-padded MLM batches
(``seq_lens`` in the batch, so both sides take the per-row key-length
attention).  The JAX engine's global batch (micro 1 × dp 8) is the port's
micro-batch of 8.  Tolerances: losses and final master params 1e-5
(relative and absolute); counters and the fp16 scaler's scale exactly.
Each JAX trajectory is built once per module.

The optimizer section is the BERT tutorial's seq-128 LAMB (DeepSpeedExamples
``bing_bert/deepspeed_bsz64k_lamb_config_seq128.json``: weight decay 0.01,
no bias correction, trust ratio clamped to [0.01, 0.3], gradient clipping
1.0) with the lr lowered from 11e-3 to 1e-4: without bias correction the
first update is about ±3.16 per element wherever |g| ≫ eps, so, as with
Adam (``test_torch_training.py``), lr·Δg/eps of the ~1e-10
summation-order noise between two fp32 backends bounds the agreement."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.model import from_bert
from chip_smoke import mlm_batch
from tests.unit.common import base_config, make_mesh

JCFG = jbert.BertConfig(vocab_size=256, max_seq_len=32, type_vocab_size=2,
                        n_layer=2, n_head=4, d_model=64, dtype=jnp.float32,
                        vocab_round_to=128)
TOL = 1e-5
STEPS = 3
LAMB = {"optimizer": {"type": "Lamb", "params": {
            "lr": 1e-4, "weight_decay": 0.01, "bias_correction": False,
            "max_coeff": 0.3, "min_coeff": 0.01}},
        "gradient_clipping": 1.0}

#: name -> (stage, gas, use train_batch_fused)
CASES = {"stage0": (0, 1, False), "stage1": (1, 1, False),
         "gas2": (0, 2, False), "fused_gas2": (1, 2, True)}


def _batches(gas, seed=1):
    return [mlm_batch(8, JCFG.max_seq_len, JCFG.vocab_size,
                      np.random.default_rng(seed + i), short_prob=0.25)
            for i in range(STEPS * gas)]


def _config(micro_batch, gas, stage, **precision):
    return base_config(micro_batch=micro_batch, gas=gas, stage=stage,
                       extra=LAMB, **precision)


def _jax_engine(stage, gas, dtype=jnp.float32, **precision):
    cfg = dataclasses.replace(JCFG, dtype=dtype)
    engine, *_ = deepspeed_tpu.initialize(
        model=jbert.model_spec(cfg), config=_config(1, gas, stage, **precision),
        mesh_manager=make_mesh(dp=8), rng=jax.random.PRNGKey(42))
    return engine


def _port_engine(master_np, stage, gas, dtype=torch.float32, **precision):
    cfg = convert.bert_config_from_jax(JCFG, dtype=dtype)
    spec = dataclasses.replace(from_bert(cfg),
                               params=convert.from_jax_params(master_np))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config=_config(8, gas, stage, **precision), device="cpu")
    return engine


def _run(engine, batches, gas, fused):
    losses = []
    if fused:
        for i in range(0, len(batches), gas):
            stacked = {k: np.concatenate([b[k] for b in batches[i:i + gas]])
                       for k in batches[0]}
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
    master params and counters, built once."""
    out = {}
    for name, (stage, gas, fused) in CASES.items():
        engine = _jax_engine(stage, gas)
        init = jax.device_get(engine.state["master"])
        losses = _run(engine, _batches(gas), gas, fused)
        out[name] = dict(init=init, losses=losses,
                         master=jax.device_get(engine.state["master"]),
                         counters=(engine.micro_steps, engine.global_steps,
                                   engine.global_samples,
                                   engine.skipped_steps))
    return out


def _assert_tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", list(CASES))
def test_lamb_trajectory_matches_jax_engine(trajectories, case):
    stage, gas, fused = CASES[case]
    ref = trajectories[case]
    engine = _port_engine(ref["init"], stage, gas)
    losses = _run(engine, _batches(gas), gas, fused)
    np.testing.assert_allclose(losses, ref["losses"], rtol=TOL, atol=TOL)
    _assert_tree_close(convert.to_numpy_params(engine.state["master"]),
                       ref["master"], TOL)
    assert (engine.micro_steps, engine.global_steps, engine.global_samples,
            engine.skipped_steps) == ref["counters"]
    # the pooler gets no gradient from the MLM loss: only the weight decay
    # (through the clamped trust ratio) moved it, on both sides
    assert not np.array_equal(ref["master"]["pool_w"], ref["init"]["pool_w"])


def test_fp16_overflow_skip_matches_jax_engine():
    """An inf in the accumulated gradients: the step is skipped, the
    dynamic scale halves (hysteresis 1), the params and LAMB moments stay
    bitwise, and the counters move as in the JAX engine; a clean step then
    proceeds."""
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
    before = [peng.state["params"]["wte"].clone(),
              peng.state["opt_state"]["exp_avg"].clone()]
    jeng.step()
    peng.step()
    assert torch.equal(peng.state["params"]["wte"], before[0])
    assert torch.equal(peng.state["opt_state"]["exp_avg"], before[1])
    assert not peng.state["grad_acc"]["wte"].any()

    batch = _batches(1)[0]
    jl = jeng.forward(batch); jeng.backward(jl); jeng.step()
    pl = peng.forward(batch); peng.backward(pl); peng.step()
    for eng in (jeng, peng):
        assert (eng.skipped_steps, eng.global_steps, eng.micro_steps) == (1, 2, 2)
    assert peng.cur_scale == jeng.cur_scale == 8.0
    # fp16 activations: both sides round, in different places
    np.testing.assert_allclose(float(pl), float(jl), rtol=2e-3)
