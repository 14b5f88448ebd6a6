"""The port's fused LAMB (plain path, CPU) against the JAX package's
``fused_lamb_step`` (the two Pallas kernels in interpret mode) and its
per-leaf ``FusedLamb.update``, from seeded numpy trees whose leaves have
odd sizes, so the flat buffer's segments start at offsets that are
multiples of nothing.  Tolerance 1e-6 (relative and absolute), the JAX
tests' own for this kernel.  A skipped step leaves every state bitwise
unchanged; the engine hands the optimizer one segment per parameter leaf,
whole layer stacks included (the reference's per-leaf trust ratio)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deepspeed_tpu_torch.models import bert
from deepspeed_tpu_torch.ops import FusedLamb
from deepspeed_tpu_torch.ops.kernels import fused_lamb
from deepspeed_tpu_torch.ops.kernels.fused_lamb import (check_segments,
                                                         lamb_hyper)
from deepspeed_tpu_torch.ops.optimizer import get_optimizer_class
from deepspeed_tpu_torch.runtime.model import from_bert

TOL = 1e-6
#: the tutorial's clamp (bing_bert deepspeed_bsz64k_lamb_config_seq128.json)
MAX_COEFF, MIN_COEFF = 0.3, 0.01


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _jax_case(seed=7):
    """The JAX package's own case (tests/unit/ops/test_pallas_kernels.py:
    238-270): three tensors of very different norms, one all zero."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal(300).astype(np.float32) * 5.0,
              "b": {"w": rng.standard_normal((64, 17)).astype(np.float32) * 0.1,
                    "bias": np.zeros(5, np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    return params, grads


def _clamp_case(seed=11):
    """Leaves whose trust ratio clamps at max_coeff, at min_coeff, lies in
    between, and a leaf with no gradient (only weight decay moves it)."""
    rng = np.random.default_rng(seed)
    sizes = {"high": 301, "low": 77, "mid": (13, 11), "nograd": 9}
    scales = {"high": 5.0, "low": 1e-4, "mid": 0.1, "nograd": 1.0}
    params = {k: rng.standard_normal(s).astype(np.float32) * scales[k]
              for k, s in sizes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in sizes.items()}
    grads["nograd"][:] = 0.0
    return params, grads


def _zeros(tree):
    return jax.tree_util.tree_map(lambda p: np.zeros_like(p), tree)


def _port_step(params, grads, lr, weight_decay, bias_correction,
               eps_inside_sqrt, **clamp):
    """One step of the port's flat LAMB over numpy trees packed leaf by
    leaf (one segment each, odd offsets); returns (params, exp_avg,
    exp_avg_sq) trees."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    segments, off = [], 0
    for leaf in leaves:
        segments.append((off, leaf.size))
        off += leaf.size
    flat = lambda tree: torch.from_numpy(np.concatenate(
        [x.reshape(-1) for x in jax.tree_util.tree_leaves(tree)]))
    p, g = flat(params), flat(grads)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    fused_lamb(p, g, m, v, lamb_hyper(lr, 0.9, 0.999, 1e-8, weight_decay, 1,
                                      bias_correction, **clamp),
               segments, eps_inside_sqrt=eps_inside_sqrt)
    return tuple(jax.tree_util.tree_unflatten(
        treedef, [t[o:o + n].numpy().reshape(x.shape)
                  for (o, n), x in zip(segments, leaves)]) for t in (p, m, v))


def _assert_trees(got, want, tol=TOL):
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(want[path]),
                                   rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _numpy_trust(p, g, wd, bias_correction, eps_inside_sqrt, eps=1e-8):
    """The first step's trust ratio before the clamp, in float64."""
    p, g = p.astype(np.float64), g.astype(np.float64)
    m, v = 0.1 * g, 0.001 * g * g
    bc1, bc2 = (0.1, 0.001) if bias_correction else (1.0, 1.0)
    denom = np.sqrt(v / bc2 + eps) if eps_inside_sqrt else np.sqrt(v / bc2) + eps
    u = (m / bc1) / denom + wd * p
    return np.linalg.norm(p) / np.linalg.norm(u)


@pytest.mark.parametrize("case", ["jax_case", "clamp_case"])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
def test_fused_lamb_step_matches_jax(pallas_interpret, case, bias_correction,
                                     eps_inside_sqrt):
    """One step, three ways: the port's flat step, the JAX flat Pallas
    step, the JAX per-leaf optimizer."""
    from deepspeed_tpu.ops.pallas import fused_lamb_step as jstep
    params, grads = _jax_case() if case == "jax_case" else _clamp_case()
    clamp = {} if case == "jax_case" else {"max_coeff": MAX_COEFF,
                                           "min_coeff": MIN_COEFF}
    kw = dict(lr=1e-2, weight_decay=0.01, bias_correction=bias_correction,
              eps_inside_sqrt=eps_inside_sqrt, **clamp)
    if case == "clamp_case":
        ratio = {k: _numpy_trust(params[k], grads[k], 0.01, bias_correction,
                                 eps_inside_sqrt) for k in params}
        assert ratio["high"] > MAX_COEFF and ratio["nograd"] > MAX_COEFF
        assert ratio["low"] < MIN_COEFF
        assert MIN_COEFF < ratio["mid"] < MAX_COEFF
    got = _port_step(params, grads, **kw)
    jgot = jstep(params, grads, _zeros(params), _zeros(params), step=1, **kw)
    for g, j in zip(got, jgot):
        _assert_trees(g, j)

    opt = JFusedLamb(lr=1e-2, weight_decay=0.01,
                     bias_correction=bias_correction,
                     eps_inside_sqrt=eps_inside_sqrt, **clamp)
    state = opt.init(params)
    ref_p, ref_state = opt.update(grads, state, params,
                                  {"lr": jnp.float32(1e-2),
                                   "weight_decay": jnp.float32(0.01)})
    _assert_trees(got[0], ref_p)
    _assert_trees(got[1], ref_state["exp_avg"])
    _assert_trees(got[2], ref_state["exp_avg_sq"])


def test_optimizer_steps_flat_buffer_with_grad_scale():
    """``FusedLamb.step_flat`` over one flat buffer with the leaves'
    segments == the JAX per-leaf optimizer over three steps, the
    accumulator scaled ×4 and unscaled by ``grad_scale``."""
    params, _ = _clamp_case(3)
    rng = np.random.default_rng(5)
    leaves = jax.tree_util.tree_leaves(params)
    segments, off = [], 0
    for leaf in leaves:
        segments.append((off, leaf.size))
        off += leaf.size
    opt = FusedLamb(lr=1e-2, weight_decay=0.01, max_coeff=MAX_COEFF,
                    min_coeff=MIN_COEFF, bias_correction=False)
    master = torch.from_numpy(np.concatenate([x.reshape(-1) for x in leaves]))
    state = opt.init(master, segments)
    jopt = JFusedLamb(lr=1e-2, weight_decay=0.01, max_coeff=MAX_COEFF,
                      min_coeff=MIN_COEFF, bias_correction=False)
    jparams, jstate = params, jopt.init(params)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        acc = torch.from_numpy(np.concatenate(
            [x.reshape(-1) for x in jax.tree_util.tree_leaves(grads)]) * 4.0)
        opt.step_flat(master, acc, state, opt.current_hyperparams(),
                      grad_scale=torch.tensor(0.25))
        state["step"] += 1
        assert not acc.any()                        # zeroed by the step
        jparams, jstate = jopt.update(grads, jstate, jparams,
                                      {"lr": 1e-2, "weight_decay": 0.01})
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree_util.tree_leaves(jparams)])
    np.testing.assert_allclose(master.numpy(), want, rtol=TOL, atol=TOL)


def test_skip_leaves_state_bitwise_unchanged():
    rng = np.random.default_rng(9)
    n = 1001
    p, g, m = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               for _ in range(3))
    v = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    compute = p.to(torch.bfloat16)
    before = [t.clone() for t in (p, m, v, compute)]
    segments = [(0, 500), (500, 0), (500, 501)]
    hyper = lamb_hyper(1e-2, 0.9, 0.999, 1e-8, 0.01, 5, max_coeff=MAX_COEFF,
                       min_coeff=MIN_COEFF)
    fused_lamb(p, g, m, v, hyper, segments, p_compute=compute,
               skip=torch.tensor(True))
    for got, want in zip((p, m, v, compute), before):
        assert torch.equal(got, want)
    assert not g.any()
    fused_lamb(p, torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
               m, v, hyper, segments, p_compute=compute,
               skip=torch.tensor(False))
    assert not torch.equal(p, before[0])
    assert torch.equal(compute, p.to(torch.bfloat16))


def test_segments_must_tile_the_buffer():
    assert check_segments([(0, 3), (3, 0), (3, 4)], 7) == ((0, 3), (3, 0),
                                                          (3, 4))
    with pytest.raises(ValueError, match="tile"):
        check_segments([(0, 3), (4, 3)], 7)
    with pytest.raises(ValueError, match="cover 6 of 7"):
        check_segments([(0, 3), (3, 3)], 7)


def test_registry_and_amsgrad_refusal():
    assert get_optimizer_class("Lamb") is FusedLamb
    assert get_optimizer_class("fusedlamb") is FusedLamb
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLamb(amsgrad=True)


def test_engine_segments_are_whole_leaves():
    """The engine's segments are its ``_layout`` leaves: a layer-stacked
    leaf such as ``blocks/wqkv`` [L, d, 3, H, Dh] is one segment, so its
    trust ratio spans every layer, as the JAX optimizer's does."""
    cfg = bert.BertConfig(vocab_size=64, max_seq_len=16, n_layer=3, n_head=2,
                          d_model=32, dtype=torch.float32)
    engine, opt, *_ = deepspeed_tpu_torch.initialize(
        model=from_bert(cfg), device="cpu",
        generator=torch.Generator().manual_seed(0),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}})
    assert isinstance(opt, FusedLamb)
    segments = engine.state["opt_state"]["segments"]
    assert segments == tuple((off, shape.numel())
                             for _, shape, off in engine._layout)
    assert len(segments) == 24                     # BERT's leaves
    wqkv = [s for (path, _, _), s in zip(engine._layout, segments)
            if path == ("blocks", "wqkv")]
    assert wqkv[0][1] == cfg.n_layer * cfg.d_model * 3 * cfg.d_model
