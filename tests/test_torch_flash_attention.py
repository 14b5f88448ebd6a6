"""The port's flash attention (plain path, CPU) against the JAX package's
``flash_attention``: the Pallas kernel in interpret mode where it tiles,
``mha_reference`` at short lengths.  fp32, tolerance 1e-5."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops.kernels import flash_attention as port_flash

TOL = 1e-5


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _qkv(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


def _lse_reference(q, k, causal):
    """logsumexp of the masked fp32 scores, [B, H, Sq]."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if causal:
        mask = jnp.tril(jnp.ones((Sq, Sk), bool), k=Sk - Sq)
        s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


def _port(q, k, v, causal):
    o, lse = port_flash(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 256])
def test_flash_matches_jax_pallas_kernel(pallas_interpret, S, causal):
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention
    q, k, v = _qkv(1, S, S, 2, 64, seed=S + causal)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=128, block_k=128)
    o, lse = _port(q, k, v, causal)
    np.testing.assert_allclose(o, np.asarray(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse, _lse_reference(q, k, causal), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(8, 8), (16, 16), (8, 16)])
def test_flash_matches_jax_reference_short(Sq, Sk, causal):
    from deepspeed_tpu.ops.pallas.flash_attention import mha_reference
    q, k, v = _qkv(2, Sq, Sk, 3, 32, seed=Sq * 100 + Sk)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
    o, lse = _port(q, k, v, causal)
    np.testing.assert_allclose(o, np.asarray(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse, _lse_reference(q, k, causal), atol=TOL,
                               rtol=TOL)


def test_flash_rows_without_keys_are_zero():
    """Causal Sq > Sk: the first Sq - Sk queries see no key; O is 0 and
    lse is -inf there, as in the JAX reference."""
    from deepspeed_tpu.ops.pallas.flash_attention import mha_reference
    q, k, v = _qkv(1, 12, 8, 2, 32, seed=3)
    o, lse = _port(q, k, v, causal=True)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    np.testing.assert_allclose(o, np.asarray(ref), atol=TOL, rtol=TOL)
    assert not o[:, :4].any()
    assert np.isneginf(lse[:, :, :4]).all() and np.isfinite(lse[:, :, 4:]).all()
