"""The port's fused bias + tanh-GeLU + dropout (plain path, CPU, through
its ``torch.autograd.Function``) against the JAX package's
``ops/pallas/fused_bias_gelu.py`` in Pallas interpret mode: forward and
both gradients at [512, 256] fp32 (atol 2e-6 and 3e-5, the JAX package's
own tolerances against ``jax.nn.gelu``), the rate-0.4 dropout mask
bitwise equal to the Pallas kernel's, the backward regenerating it, and
rate 0 at C = 100 against the JAX fallback."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import fused_bias_gelu as jbg
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import fused_bias_gelu as tbg

RATE = 0.4


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _xbw(rows=512, C=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, C)).astype(np.float32),
            rng.standard_normal(C).astype(np.float32),
            rng.standard_normal((rows, C)).astype(np.float32))


def _port(x, b, w, rate=0.0, seed=0, dtype=torch.float32):
    """(y, dx, db) of sum(bias_gelu_dropout(x, b) * w) through autograd."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    bt = torch.from_numpy(b).to(dtype).requires_grad_(True)
    y = tbg.bias_gelu_dropout(xt, bt, rate, seed)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return y.detach(), xt.grad, bt.grad


def _jax(x, b, w, rate=0.0, seed=0):
    def f(x, b):
        y = jbg.bias_gelu_dropout(x, b, dropout_rate=rate, seed=seed)
        return jnp.sum(y * w), y

    (_, y), (dx, db) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(b))
    return np.asarray(y), np.asarray(dx), np.asarray(db)


def _jax_mask(rows, C, rate, seed):
    """The Pallas kernels' ``_keep_mask``, block by block of 256 rows."""
    blocks = [np.asarray(jbg._keep_mask(
        (min(jbg._BLOCK_ROWS, rows - r), C), rate, jnp.int32(seed),
        r // jbg._BLOCK_ROWS, jbg._BLOCK_ROWS))
        for r in range(0, rows, jbg._BLOCK_ROWS)]
    return np.concatenate(blocks)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_forward_and_grads_match_pallas_kernel(pallas_interpret, rate):
    x, b, w = _xbw()
    y, dx, db = _port(x, b, w, rate, seed=7)
    jy, jdx, jdb = _jax(x, b, w, rate, seed=7)
    # a kept-vs-dropped disagreement would be off by |y| / (1 - rate)
    np.testing.assert_allclose(y.numpy(), jy, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(db.numpy(), jdb, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("shape", [(512, 256), (300, 128)])
def test_keep_mask_bitwise_equal_to_pallas(shape):
    """Across 256-row blocks, and a ragged last block, the port's mask is
    the JAX kernel's; about ``rate`` of it is dropped."""
    mask = tbg.keep_mask(*shape, RATE, 7).numpy()
    np.testing.assert_array_equal(mask, _jax_mask(*shape, RATE, 7))
    assert abs((mask == 0.0).mean() - RATE) < 0.05


def test_same_seed_same_mask_other_seed_differs_and_dx_follows():
    x, b, w = _xbw(seed=2)
    y, dx, _ = _port(x, b, np.ones_like(w), RATE, seed=7)
    y2, _, _ = _port(x, b, np.ones_like(w), RATE, seed=7)
    y3, _, _ = _port(x, b, np.ones_like(w), RATE, seed=8)
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    dropped = (y == 0.0).numpy()
    assert abs(dropped.mean() - RATE) < 0.05
    assert (dx.numpy()[dropped] == 0.0).all()
    assert (dx.numpy()[~dropped] != 0.0).mean() > 0.99


def test_rate0_at_c100_matches_jax_fallback():
    """C % 128 != 0: the JAX package takes its plain-XLA path; at rate 0
    the two agree (its fallback's dropout draws another stream)."""
    x, b, w = _xbw(rows=64, C=100, seed=3)
    y, dx, db = _port(x, b, w)
    jy, jdx, jdb = _jax(x, b, w)
    np.testing.assert_allclose(y.numpy(), jy, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(db.numpy(), jdb, atol=3e-5, rtol=3e-5)


def test_bf16_close_to_fp32_and_launches_nothing():
    """bf16 x and bias: fp32 math, one rounding of y and dx; db in bf16.
    On CPU tensors no kernel launches."""
    x, b, w = _xbw(rows=300, C=64, seed=4)
    before = kernels.launch_counts()
    y, dx, db = _port(x, b, w, RATE, seed=3, dtype=torch.bfloat16)
    assert kernels.launch_counts() == before
    assert (y.dtype, dx.dtype, db.dtype) == (torch.bfloat16,) * 3
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    bb = torch.from_numpy(b).bfloat16().float().numpy()
    ry, rdx, rdb = _port(xb, bb, w, RATE, seed=3)
    for got, ref in ((y, ry), (dx, rdx), (db, rdb)):
        tol = 1e-2 * max(1.0, ref.abs().max().item())
        assert (got.float() - ref).abs().max().item() <= tol
