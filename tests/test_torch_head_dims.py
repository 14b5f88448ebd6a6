"""Head dims 80 and 96 (GPT-2 2.7B and 760M): the port held against the
JAX package on tiny GPT-2s whose heads are that wide, and the attention
wrappers' head dims held against the ``switch (D)`` of their sources.

Tiny models: 2 layers, 2 heads, d_model 192 (D 96) and 160 (D 80), seq
128, fp32, weights carried through ``models/convert.py``.  Logits to
1e-5, greedy tokens equal, the loss and gradients of ``loss_fn``, and
the losses of three Adam steps of the training path, at the trajectory
tolerance of ``test_torch_training.py``.  The kernels' plain versions run here; on
the card ``chip_smoke.py`` holds the D 80 and 96 kernels against them."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu.runtime.utils import global_grad_norm as jax_grad_norm
from deepspeed_tpu_torch.models import convert, gpt
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels.utils import (HEAD_DIMS,
                                                   KERNEL_HEAD_DIMS, tile_dim)
from deepspeed_tpu_torch.runtime.utils import global_grad_norm

from tests.unit.common import random_tokens

from .test_torch_gpt_inference import tiny_params
from .test_torch_training import (STEPS, TOL, _assert_tree_close, _jax_engine,
                                  _port_engine, _run)

CSRC = Path(__file__).resolve().parents[1] / "deepspeed_tpu_torch" / "csrc"
SEQ = 128
#: head dim -> the tiny model's fields: 2 heads of D, 2 layers
MODELS = {96: {"d_model": 192, "n_head": 2, "n_layer": 2},
          80: {"d_model": 160, "n_head": 2, "n_layer": 2}}


def _jax_config(D):
    return jgpt.GPTConfig(vocab_size=512, max_seq_len=SEQ, dtype=jnp.float32,
                          **MODELS[D])


@pytest.fixture(scope="module", params=sorted(MODELS), ids=lambda D: f"D{D}")
def model(request):
    """(D, JAX config, JAX params, port config, port params) of the tiny
    GPT-2 with heads of D, from numpy weights drawn from a seed."""
    D = request.param
    jcfg = _jax_config(D)
    assert jcfg.head_dim == D
    tree = tiny_params(jcfg, seed=D)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return D, jcfg, jparams, convert.config_from_jax(jcfg), \
        convert.from_jax_params(tree)


def _batches():
    """The trajectory's batches: micro-batch 8 (the JAX engine's 8 CPU
    devices, 1 each) at seq 128, one per step."""
    return [random_tokens(8, SEQ, seed=1 + i) for i in range(STEPS)]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("D", sorted(MODELS), ids=lambda D: f"D{D}")
def test_logits_match_jax(D):
    """Full-sequence logits from ``gpt.init``'s weights (std 0.02, as the
    model is initialised; ``tiny_params``' wider weights put the logits
    near 5, where fp32 summation order alone moves them by 2e-4)."""
    jcfg = _jax_config(D)
    tree = jax.device_get(jgpt.init(jcfg, jax.random.PRNGKey(D)))
    toks = _tokens(2, SEQ, D)
    ref = np.asarray(jgpt.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(toks), jcfg))
    out = gpt.apply(convert.from_jax_params(tree),
                    torch.as_tensor(toks, dtype=torch.long),
                    convert.config_from_jax(jcfg))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_greedy_generate_equals_jax(model):
    """Ragged prompts through ``init_inference`` → ``generate`` on both
    sides: the prefill (flash), the decode steps (decode kernel's plain
    version) and the KV cache at D."""
    D, jcfg, jp, tcfg, tp = model
    jeng = deepspeed_tpu.init_inference(model=(jcfg, jp),
                                        config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(model=(tcfg, tp),
                                              config={"dtype": "float32"},
                                              device="cpu")
    toks = _tokens(3, 16, D + 1)
    lens = [16, 9, 4]
    ref = np.asarray(jeng.generate(toks, max_new_tokens=10, prompt_lens=lens))
    out = teng.generate(toks, max_new_tokens=10, prompt_lens=lens).numpy()
    np.testing.assert_array_equal(out, ref)
    assert all(len(set(row.tolist())) >= 3 for row in out)


@pytest.fixture(scope="module", params=sorted(MODELS), ids=lambda D: f"D{D}")
def trajectory(request):
    """The JAX engine's 3-step Adam trajectory (ZeRO 1, the fused step) of
    the tiny model with heads of D at seq 128, built once per D."""
    D = request.param
    fields = {**MODELS[D], "max_seq_len": SEQ}
    engine = _jax_engine(1, 1, model_fields=fields)
    init = jax.device_get(engine.state["master"])
    losses = _run(engine, _batches(), 1, True)
    return dict(D=D, fields=fields, init=init, losses=losses,
                norm=float(engine.get_global_grad_norm()))


def test_training_trajectory_matches_jax(trajectory):
    """The three steps' losses, at 1e-5, and the last global gradient
    norm, at 1e-6 (the sum-of-powers form on both sides,
    ``test_global_grad_norm_matches_jax``).  The final master params are
    not held at 1e-5 at this size: Adam moves an element whose gradient
    is near eps by up to lr times its relative gradient noise (one of
    294,912 ``wo_mlp`` elements ends 2.8e-5 apart at D 96); each step's
    loss and gradients agree to 1e-6 (``test_loss_and_grads_match_jax``)."""
    ref = trajectory
    engine = _port_engine(ref["init"], 1, 1, model_fields=ref["fields"])
    losses = _run(engine, _batches(), 1, True)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, ref["losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(engine.get_global_grad_norm(), ref["norm"],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("D", sorted(MODELS), ids=lambda D: f"D{D}")
def test_loss_and_grads_match_jax(D):
    """The loss and every gradient of ``loss_fn`` at seq 128 (the flash
    forward and its fused backward's plain version at D) against
    ``jax.value_and_grad`` of the JAX ``loss_fn``, at 1e-5."""
    jcfg = dataclasses.replace(_jax_config(D), vocab_size=256)
    params = jgpt.init(jcfg, jax.random.PRNGKey(3))
    batch = random_tokens(4, SEQ, seed=9)
    jloss, jgrads = jax.value_and_grad(lambda p: jgpt.loss_fn(
        p, jax.tree_util.tree_map(jnp.asarray, batch), jcfg))(params)
    tparams = convert.from_jax_params(jax.device_get(params))
    for p in jax.tree_util.tree_leaves(tparams):
        p.requires_grad_(True)
    loss = gpt.loss_fn(tparams, {"tokens": torch.from_numpy(
        batch["tokens"]).long()}, convert.config_from_jax(jcfg, torch.float32))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    _assert_tree_close(convert.to_numpy_params(jax.tree_util.tree_map(
        lambda p: p.grad, tparams)), jax.device_get(jgrads), TOL)


# ------------------------------------------------ block-sparse attention

#: the sparse training slice's layout kind at the tiny model's size:
#: Fixed, block 16 (8 blocks at seq 128), a layout per head
SPARSE = FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                             different_layout_per_head=True,
                             num_different_global_patterns=2,
                             attention="unidirectional")


@pytest.mark.parametrize("D", sorted(MODELS), ids=lambda D: f"D{D}")
def test_sparse_loss_and_grads_match_jax(D):
    """The loss and every gradient of ``loss_fn`` at seq 128 under the
    Fixed layout (the block-sparse trio's plain versions at D, remat
    ``attn_out`` as the training path runs it) against
    ``jax.value_and_grad`` of the JAX ``loss_fn``, at 1e-5."""
    jcfg = dataclasses.replace(_jax_config(D), vocab_size=256,
                               sparse_attention=SPARSE)
    params = jgpt.init(jcfg, jax.random.PRNGKey(5))
    batch = random_tokens(4, SEQ, seed=11)
    jloss, jgrads = jax.value_and_grad(lambda p: jgpt.loss_fn(
        p, jax.tree_util.tree_map(jnp.asarray, batch), jcfg))(params)
    tcfg = dataclasses.replace(convert.config_from_jax(jcfg, torch.float32),
                               remat=True, remat_policy="attn_out")
    assert tcfg.sparse_attention is not None and tcfg.head_dim == D
    tparams = convert.from_jax_params(jax.device_get(params))
    for p in jax.tree_util.tree_leaves(tparams):
        p.requires_grad_(True)
    loss = gpt.loss_fn(tparams, {"tokens": torch.from_numpy(
        batch["tokens"]).long()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    _assert_tree_close(convert.to_numpy_params(jax.tree_util.tree_map(
        lambda p: p.grad, tparams)), jax.device_get(jgrads), TOL)


def test_sparse_training_trajectory_matches_jax():
    """Three Adam steps (ZeRO 1, the fused step) of the tiny D 96 model
    under the Fixed layout, from the JAX engine's initial params: the
    losses at 1e-5, falling."""
    fields = {**MODELS[96], "max_seq_len": SEQ, "sparse_attention": SPARSE}
    jeng = _jax_engine(1, 1, model_fields=fields)
    init = jax.device_get(jeng.state["master"])
    jlosses = _run(jeng, _batches(), 1, True)
    peng = _port_engine(init, 1, 1, model_fields=fields)
    assert peng.module.meta["config"].sparse_attention is not None
    plosses = _run(peng, _batches(), 1, True)
    np.testing.assert_allclose(plosses, jlosses, rtol=TOL, atol=TOL)
    assert plosses[-1] < plosses[0]


# ------------------------------------------------- the global gradient norm

@pytest.mark.parametrize("norm_type", [2.0, float("inf")], ids=["l2", "inf"])
def test_global_grad_norm_matches_jax(norm_type):
    """The port's ``global_grad_norm`` (a tree's leaves, and the one flat
    buffer the engine holds them in) against the JAX package's (the root
    of the leaves' summed powers, or their largest |g|) on one gradient
    tree: step 1's gradients of the tiny D 96 model, at 1e-6 relative.
    A single fp32 ``vector_norm`` over the flat buffer, summed lane by
    lane on the host, was 4.6e-5 off here."""
    jcfg = _jax_config(96)
    params = jgpt.init(jcfg, jax.random.PRNGKey(96))
    batch = _batches()[0]
    grads = jax.device_get(jax.grad(lambda p: jgpt.loss_fn(
        p, jax.tree_util.tree_map(jnp.asarray, batch), jcfg))(params))
    want = float(jax_grad_norm(grads, norm_type))
    tree = convert.from_jax_params(grads)
    flat = torch.cat([t.reshape(-1) for t in jax.tree_util.tree_leaves(tree)])
    assert flat.numel() == sum(np.size(g) for g in
                               jax.tree_util.tree_leaves(grads))
    for got in (global_grad_norm(tree, norm_type),
                global_grad_norm(flat, norm_type)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


# --------------------------------------------- the wrappers and the sources

#: each kernel's source and the dispatch that holds its head dims: the
#: switch of its tensor-core path (and of the FMA path beside it)
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd_fused": "flash_bwd_fused.cu",
           "decode_attn": "decode_attn.cu", "decode_attn_int8": "decode_attn.cu",
           "chunk_attn": "chunk_attn.cu", "chunk_attn_int8": "chunk_attn.cu",
           "flash_bwd_dq": "flash_bwd_dq.cu", "flash_bwd_dkv": "flash_bwd_dkv.cu",
           "block_sparse_fwd": "block_sparse_fwd.cu",
           "block_sparse_bwd_dq": "block_sparse_bwd_dq.cu",
           "block_sparse_bwd_dkv": "block_sparse_bwd_dkv.cu"}


def _switch_cases(text):
    """The case labels of every ``switch (D)`` of a source, one set per
    switch."""
    found = []
    for m in re.finditer(r"switch \(D\) \{(.*?)default:", text, re.S):
        found.append({int(c) for c in re.findall(r"case (\d+):", m.group(1))})
    return found


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_wrapper_dims_are_the_instantiated_dims(name):
    """Every ``switch (D)`` of the kernel's source (and of the FMA tile or
    block-sparse dispatch it sends its fp32 inputs to) lists exactly the
    wrapper's dims."""
    text = (CSRC / SOURCES[name]).read_text()
    if name in ("flash_fwd", "chunk_attn", "chunk_attn_int8"):
        text += (CSRC / "flash_tile.cuh").read_text()
    if name.startswith("block_sparse"):
        text += (CSRC / "block_sparse.cuh").read_text()
    switches = _switch_cases(text)
    assert switches, f"no switch (D) in {SOURCES[name]}"
    for cases in switches:
        assert cases == set(KERNEL_HEAD_DIMS[name]), (name, cases)


def test_head_dim_tuples():
    """Every attention kernel takes every head dim of the repo's GPT-2
    presets, 80 and 96 in the tile of 128."""
    assert KERNEL_HEAD_DIMS.keys() == SOURCES.keys()
    assert all(dims == HEAD_DIMS for dims in KERNEL_HEAD_DIMS.values())
    assert HEAD_DIMS == (32, 64, 80, 96, 128)
    assert {D: tile_dim(D) for D in HEAD_DIMS} == {32: 32, 64: 64, 80: 128,
                                                   96: 128, 128: 128}


def _c_int(expr, **names):
    """A C integer expression of names, comparisons and ``?:`` (one level
    a branch) as Python evaluates it."""
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr.strip())
    if m:
        return _c_int(m[2], **names) if _c_int(m[1], **names) else \
            _c_int(m[3], **names)
    return int(eval(expr, {}, names))


def _struct_q_tile(name, D):
    """``BQ`` of ``csrc/flash_bwd_fused.cu``'s ``struct name`` at head dim
    ``D`` (its tile ``tile_dim(D)``), from the source's expression."""
    text = (CSRC / "flash_bwd_fused.cu").read_text()
    body = re.search(r"struct " + name + r"\b[^{]*\{(.*?)\n\};", text, re.S)
    assert body, f"no struct {name} in flash_bwd_fused.cu"
    expr = re.search(r"static constexpr int BQ = ([^;]+);", body.group(1))
    assert expr, f"no BQ in struct {name}"
    return _c_int(expr.group(1), D=D, DT=tile_dim(D))


#: the fused backward's kernel for each dtype: the tensor-core kernel's
#: q-tile struct for bf16 and fp16, the FMA kernel's for fp32
FUSED_TILE_STRUCTS = {torch.bfloat16: "FusedCfg", torch.float16: "FusedCfg",
                      torch.float32: "FmaTile"}


@pytest.mark.parametrize("dtype", sorted(FUSED_TILE_STRUCTS, key=str),
                         ids=str)
def test_fused_q_tile_is_the_sources(dtype):
    """``fused_q_tile`` (the wrapper's workspace) gives the q-tile of the
    kernel the dtype runs, at every head dim: ``FusedCfg::BQ`` (64 at
    every D since the tensor-core kernel's redesign) for bf16 and fp16,
    ``FmaTile::BQ`` (32 in the tile of 128) for fp32."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import fused_q_tile
    got = {D: fused_q_tile(D, dtype) for D in KERNEL_HEAD_DIMS["flash_bwd_fused"]}
    want = {D: _struct_q_tile(FUSED_TILE_STRUCTS[dtype], D) for D in got}
    assert got == want
    if dtype != torch.float32:
        assert set(got.values()) == {64}


@pytest.mark.parametrize("Sq", [1, 63, 64, 65, 2048])
def test_fused_workspace_covers_the_kernels_tiles(Sq):
    """The sum and the counters ``_FlashBwdFused`` allocates
    (``fused_workspace``) cover every q-tile of the kernel each dtype runs:
    one fp32 [BQ, tile_dim(D)] sum and one counter per (b, h, q-tile), BQ
    the source's, at every head dim and at q-tile edges."""
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        fused_workspace
    B, H = 3, 5
    for dtype, struct in FUSED_TILE_STRUCTS.items():
        for D in KERNEL_HEAD_DIMS["flash_bwd_fused"]:
            bq = _struct_q_tile(struct, D)
            tiles = B * H * -(-Sq // bq)
            n_acc, n_counters = fused_workspace(B, Sq, H, D, dtype)
            assert n_acc >= tiles * bq * tile_dim(D), (dtype, D, Sq)
            assert n_counters >= tiles, (dtype, D, Sq)


def _bwd_args(D, S=8):
    q, k, v, do = (torch.zeros(1, S, 2, D) for _ in range(4))
    stats = torch.zeros(1, 2, S)
    return q, k, v, do, stats, stats.clone(), True, 0.1


@pytest.mark.parametrize("D", [48, 80, 96])
@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv",
                                  "block_sparse_fwd", "block_sparse_bwd_dq",
                                  "block_sparse_bwd_dkv"])
def test_pair_and_block_sparse_refuse_padded_dims(name, D):
    """The two-kernel backward and the block-sparse trio take D 80 and 96
    (GPT-2 2.7B and 760M, in the tile of 128) and refuse D 48 before any
    launch, naming the kernel and its dims (checked on CPU tensors; the
    checks are plain Python)."""
    from deepspeed_tpu_torch.ops.kernels.utils import check_kernel_inputs
    if D in HEAD_DIMS:
        assert check_kernel_inputs(name, *_bwd_args(D)[:4]) == torch.float32
        return
    with pytest.raises(ValueError, match=rf"{name}: head dim {D} not "
                       rf"supported \(the kernel is instantiated for "
                       rf"\(32, 64, 80, 96, 128\)\)"):
        check_kernel_inputs(name, *_bwd_args(D)[:4])
    if name.startswith("flash"):
        with pytest.raises(ValueError, match=rf"{name}: head dim {D}"):
            getattr(kernels, name)(*_bwd_args(D))


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_fused",
                                  "decode_attn", "decode_attn_int8",
                                  "chunk_attn", "chunk_attn_int8"])
def test_serving_and_training_kernels_take_80_and_96_refuse_48(name):
    from deepspeed_tpu_torch.ops.kernels.utils import check_kernel_inputs
    for D in (80, 96):
        assert check_kernel_inputs(name, torch.zeros(2, 4, 2, D),
                                   torch.zeros(2, 8, 2, D)) == torch.float32
    with pytest.raises(ValueError, match=rf"{name}: head dim 48 not "
                       rf"supported \(the kernel is instantiated for "
                       rf"\(32, 64, 80, 96, 128\)\)"):
        check_kernel_inputs(name, torch.zeros(2, 4, 2, 48))
