"""The port's training path under block-sparse attention against the JAX
package's: a tiny GPT (``TINY_GPT`` at seq 64, Fixed layout with block 16,
as ``tests/unit/ops/test_sparse_attention.py`` trains it) from the same
fp32 params and batches.  Loss and gradients against the JAX ``loss_fn``
with and without remat, and a 3-step ``train_batch_fused`` trajectory
against the JAX engine on its 8-device CPU mesh (micro 1 × dp 8 = the
port's micro-batch 8), at 1e-5; and the forward-kernel count per remat
policy."""

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
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu.runtime.model import from_gpt as jfrom_gpt
from deepspeed_tpu_torch.models import convert, gpt
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config
from deepspeed_tpu_torch.runtime.model import from_gpt
from tests.unit.common import TINY_GPT, base_config, make_mesh, random_tokens

#: the module (``ops.kernels`` exports a function of the same name)
port_sparse = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.block_sparse_attention")

TOL = 1e-5
SEQ = 64
STEPS = 3
JCFG = dataclasses.replace(
    TINY_GPT, max_seq_len=SEQ,
    sparse_attention=FixedSparsityConfig(
        num_heads=TINY_GPT.n_head, block=16, num_local_blocks=2,
        different_layout_per_head=True, num_different_global_patterns=2,
        attention="unidirectional"))
CONFIG = base_config(extra={"optimizer": {
    "type": "Adam", "params": {"lr": 1e-4, "weight_decay": 0.01}}})


def _tree_close(got, want, tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_config_from_jax_maps_the_sparsity_config():
    cfg = convert.config_from_jax(JCFG)
    sp = cfg.sparse_attention
    assert type(sp) is sparsity_config.FixedSparsityConfig
    assert vars(sp) == vars(JCFG.sparse_attention)
    np.testing.assert_array_equal(sp.make_layout(SEQ),
                                  JCFG.sparse_attention.make_layout(SEQ))
    assert convert.config_from_jax(TINY_GPT).sparse_attention is None

    class Unknown(FixedSparsityConfig):
        pass

    with pytest.raises(TypeError, match="no port of Unknown"):
        convert.sparsity_from_jax(Unknown(num_heads=4))
    with pytest.raises(TypeError, match="SparsityConfig"):
        gpt.GPTConfig(sparse_attention=JCFG.sparse_attention)


@pytest.fixture(scope="module")
def jax_grads():
    params = jgpt.init(JCFG, jax.random.PRNGKey(3))
    batch = random_tokens(4, SEQ, seed=9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jgpt.loss_fn(p, b, JCFG)))(
            params, jax.tree_util.tree_map(jnp.asarray, batch))
    return jax.device_get(params), batch, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("overrides", [
    {}, {"remat": True, "remat_policy": "nothing"},
    {"remat": True, "remat_policy": "attn_out"}],
    ids=["plain", "remat_nothing", "remat_attn_out"])
def test_loss_and_grads_match_jax(jax_grads, overrides):
    master, batch, jloss, jgrads = jax_grads
    cfg = dataclasses.replace(convert.config_from_jax(JCFG, torch.float32),
                              **overrides)
    params = convert.from_jax_params(master)
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    loss = gpt.loss_fn(params, {"tokens": torch.from_numpy(
        batch["tokens"]).long()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=TOL,
                               atol=TOL)
    _tree_close(convert.to_numpy_params(
        jax.tree_util.tree_map(lambda p: p.grad, params)), jgrads, TOL)


def test_fused_trajectory_matches_jax_engine():
    """3 steps of ``train_batch_fused`` (ZeRO 1, Adam) from the JAX
    engine's initial params: losses and final master params at 1e-5."""
    config = {**CONFIG, "zero_optimization": {"stage": 1}}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jfrom_gpt(JCFG), config={**config,
                                       "train_micro_batch_size_per_gpu": 1},
        mesh_manager=make_mesh(dp=8), rng=jax.random.PRNGKey(42))
    init = jax.device_get(jeng.state["master"])
    batches = [random_tokens(8, SEQ, seed=20 + i) for i in range(STEPS)]
    jlosses = [float(jeng.train_batch_fused(b)) for b in batches]

    spec = dataclasses.replace(
        from_gpt(convert.config_from_jax(JCFG, torch.float32)),
        params=convert.from_jax_params(init))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=spec, config={**config, "train_micro_batch_size_per_gpu": 8},
        device="cpu")
    plosses = [float(peng.train_batch_fused(b)) for b in batches]
    np.testing.assert_allclose(plosses, jlosses, rtol=TOL, atol=TOL)
    assert plosses[-1] < plosses[0]
    _tree_close(convert.to_numpy_params(peng.state["master"]),
                jax.device_get(jeng.state["master"]), TOL)


@pytest.mark.parametrize("policy,per_step", [("nothing", 2), ("attn_out", 1)])
def test_remat_policy_sparse_forward_count(monkeypatch, policy, per_step):
    """Under ``attn_out`` the backward replays each block's attention from
    its saved O and lse: n_layer sparse forwards per step, 2 × n_layer
    under ``nothing``; and no dense flash forward at all."""
    calls = []
    real = port_sparse._forward
    monkeypatch.setattr(port_sparse, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    flash = importlib.import_module(
        "deepspeed_tpu_torch.ops.kernels.flash_attention")
    monkeypatch.setattr(flash, "_forward", lambda *a: pytest.fail("flash"))
    cfg = dataclasses.replace(convert.config_from_jax(JCFG, torch.float32),
                              remat=True, remat_policy=policy)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg), config=base_config(micro_batch=2),
        device="cpu", generator=torch.Generator().manual_seed(0))
    builds = port_sparse.plan_builds
    engine.train_batch_fused(random_tokens(2, SEQ, seed=2))
    engine.train_batch_fused(random_tokens(2, SEQ, seed=3))
    assert len(calls) == 2 * per_step * cfg.n_layer
    # one plan for the config and length, built before these steps or in
    # the first of them, never again
    assert port_sparse.plan_builds - builds <= 1
