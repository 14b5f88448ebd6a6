"""The port's flash-attention backward (plain path, CPU) against
``jax.grad`` of the JAX package's ``flash_attention`` run in Pallas
interpret mode, on both of its backward paths: the fused single sweep
(nk <= ``MAX_FUSED_BWD_NK``: S 256, block 128, nk 2) and the two-kernel
sweep that ``flash_bwd_dq``/``flash_bwd_dkv`` port (S 640, block 128,
nk 5).  The port runs both through its plain backward and through
``torch.autograd`` of its ``flash_attention``.  fp32, tolerance 1e-5."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops.kernels import (flash_attention,
                                             flash_attention_backward,
                                             flash_attention_qkv,
                                             flash_attention_reference)

TOL = 1e-5
#: low-precision gradients against fp32 JAX gradients of the same rounded
#: inputs (times max(1, |ref|)): p, dS and the outputs are rounded to the
#: input dtype in the plain version (chip_smoke.py's kernel tolerances)
LOW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _inputs(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D),
                          (B, Sq, H, D))]


def _jax_grads(q, k, v, do, causal, **kw):
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jfa

    def f(q, k, v):
        return jnp.sum(jfa(q, k, v, causal=causal, **kw) * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, do, causal):
    """(dq, dk, dv) from the plain backward and from autograd."""
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash_attention_reference(*t[:3], causal, scale)
    plain = flash_attention_backward(*t[:3], o, lse, t[3], causal, scale)
    leaves = [x.clone().requires_grad_(True) for x in t[:3]]
    out, _ = flash_attention(*leaves, causal=causal)
    auto = torch.autograd.grad(out, leaves, t[3])
    return [g.numpy() for g in plain], [g.numpy() for g in auto]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,path", [(256, "fused"), (640, "two_kernel")])
def test_backward_matches_jax_pallas(pallas_interpret, S, path, causal):
    from deepspeed_tpu.ops.pallas.flash_attention import MAX_FUSED_BWD_NK
    assert (S // 128 <= MAX_FUSED_BWD_NK) == (path == "fused")
    q, k, v, do = _inputs(1, S, S, 2, 32, seed=S + causal)
    ref = _jax_grads(q, k, v, do, causal, block_q=128, block_k=128)
    for grads in _port_grads(q, k, v, do, causal):
        for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, r, atol=TOL, rtol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("Sq,Sk,causal", [
    (16, 16, True), (8, 24, True), (24, 8, True), (16, 16, False),
    (8, 24, False), (63, 63, True), (64, 64, True), (65, 65, True),
    (127, 127, False), (129, 129, True), (65, 129, True), (129, 63, True),
    (63, 129, False)])
def test_backward_matches_jax_reference_cross_length(Sq, Sk, causal):
    """Cross-length shapes (the JAX wrapper's dense path): end-aligned
    causal, including Sq > Sk, whose first Sq - Sk rows see no key and get
    zero gradients."""
    q, k, v, do = _inputs(2, Sq, Sk, 3, 32, seed=Sq * 100 + Sk)
    ref = _jax_grads(q, k, v, do, causal)
    for grads in _port_grads(q, k, v, do, causal):
        for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, r, atol=TOL, rtol=TOL,
                                       err_msg=name)
            assert np.isfinite(g).all()
        if Sq > Sk:
            assert not grads[0][:, :Sq - Sk].any()


def test_packed_qkv_gradient_is_one_buffer():
    """``flash_attention_qkv`` on [B, S, 3, H, D]: one gradient of that
    shape equal to the three separate gradients; ``saved`` (O, lse)
    replays the forward with the same gradient."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3, 2, 32))
                           .astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 32, 2, 32))
                          .astype(np.float32))
    leaf = qkv.clone().requires_grad_(True)
    o, lse = flash_attention_qkv(leaf)
    (dqkv,) = torch.autograd.grad(o, leaf, do)
    sep = [qkv[:, :, i].clone().requires_grad_(True) for i in range(3)]
    o2, _ = flash_attention(*sep)
    want = torch.stack(torch.autograd.grad(o2, sep, do), dim=2)
    assert dqkv.shape == qkv.shape
    torch.testing.assert_close(dqkv, want, atol=TOL, rtol=TOL)
    replay = qkv.clone().requires_grad_(True)
    o3, _ = flash_attention_qkv(replay, saved=(o.detach(), lse))
    assert torch.equal(o3, o.detach())
    torch.testing.assert_close(torch.autograd.grad(o3, replay, do)[0], dqkv,
                               atol=0, rtol=0)


@pytest.mark.parametrize("Sq,Sk,causal", [
    (63, 63, True), (65, 65, False), (129, 129, True), (127, 65, False),
    (129, 63, True), (65, 129, True)])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_tile_edges_low_precision(dtype, D, Sq, Sk, causal):
    """bf16 and fp16 through the plain backward (what ``chip_smoke.py``
    holds ``flash_bwd_dq`` and ``flash_bwd_dkv`` against) at the kernels'
    tile edges, at every head dim the kernels take, against
    fp32 JAX gradients of the same rounded inputs; finite everywhere, and
    zero dq on causal rows with no key."""
    raw = _inputs(1, Sq, Sk, 2, D, seed=Sq * 1000 + Sk + D)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in raw)
    scale = 1.0 / math.sqrt(D)
    o, lse = flash_attention_reference(q, k, v, causal, scale)
    grads = flash_attention_backward(q, k, v, o, lse, do, causal, scale)
    ref = _jax_grads(*(x.float().numpy() for x in (q, k, v, do)), causal)
    for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        assert g.dtype == dtype
        g = g.float().numpy()
        assert np.isfinite(g).all(), name
        err = np.abs(g - r).max() / max(1.0, np.abs(r).max())
        assert err <= LOW_TOL[dtype], (name, err)
    if Sq > Sk and causal:
        assert not grads[0][:, :Sq - Sk].float().any()
