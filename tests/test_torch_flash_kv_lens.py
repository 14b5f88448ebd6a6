"""Per-row key lengths (``kv_lens``) in the port's flash attention (plain
path, CPU) against the JAX package: forward O and dq/dk/dv against JAX
``flash_attention(..., causal=False, kv_lens=..., block_q=128,
block_k=128)`` with its Pallas kernels in interpret mode at S 256 (explicit
blocks: on auto blocks the JAX function takes its dense path below
``FLASH_MIN_SEQ``), the lse against the masked logsumexp, and short odd
shapes, causal or not, against JAX's dense path (``mha_reference`` with
the lengths clamped to at least 1).  Lengths include 0 (clamped to 1), 1,
a partial tile, a tile edge and S.  Tolerances: 2e-5 forward, 3e-5
gradients (relative and absolute), as ``tests/unit/models/test_bert.py``
holds the JAX kernels to the JAX reference."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

#: the module (``ops.kernels`` exports a function of the same name)
port_flash = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 3e-5


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _inputs(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, w


def _port(q, k, v, w, causal, lens):
    """(O, lse, (dq, dk, dv)) of the port's differentiable flash op on
    loss = sum(O * w)."""
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = port_flash.flash_attention(*t, causal=causal,
                                        kv_lens=torch.from_numpy(lens))
    (o * torch.from_numpy(w)).sum().backward()
    return (o.detach().numpy(), lse.numpy(),
            tuple(x.grad.numpy() for x in t))


def _jax(fn, q, k, v, w):
    out = fn(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def _masked_lse(q, k, lens, causal):
    """logsumexp of the visible scaled scores, [B, H, Sq] (float64)."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(D)
    vis = np.arange(Sk)[None, :] < np.maximum(lens, 1)[:, None]     # [B, Sk]
    vis = np.broadcast_to(vis[:, None, None, :], s.shape)
    if causal:
        vis = vis & np.tril(np.ones((Sq, Sk), bool), Sk - Sq)
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def test_kv_lens_matches_jax_flash_kernels(pallas_interpret):
    """S 256, blocks 128: lengths 0, 1, 100 (a partial tile), 128 (a tile
    edge), 256; query rows past a row's length still attend its live
    keys, and padding keys get exactly zero dk and dv."""
    from deepspeed_tpu.ops.pallas import flash_attention
    B, S, H, D = 5, 256, 2, 32
    lens = np.asarray([0, 1, 100, 128, 256], np.int32)
    q, k, v, w = _inputs(B, S, S, H, D, seed=0)
    o, lse, grads = _port(q, k, v, w, False, lens)
    jo, jgrads = _jax(lambda a, b, c: flash_attention(
        a, b, c, causal=False, kv_lens=jnp.asarray(lens), block_q=128,
        block_k=128), q, k, v, w)
    np.testing.assert_allclose(o, jo, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse, _masked_lse(q, k, lens, False),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    for b, n in enumerate(np.maximum(lens, 1)):
        assert not grads[1][b, n:].any() and not grads[2][b, n:].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk", [(37, 37), (21, 45)])
def test_kv_lens_matches_jax_dense_path(causal, Sq, Sk):
    """Short odd shapes, causal end-aligned or not, against the JAX dense
    path (auto blocks, no Pallas), which clamps the lengths to >= 1."""
    from deepspeed_tpu.ops.pallas import flash_attention
    B, H, D = 4, 3, 16
    lens = np.asarray([0, 1, Sk // 2, Sk], np.int32)
    q, k, v, w = _inputs(B, Sq, Sk, H, D, seed=Sq + Sk)
    o, lse, grads = _port(q, k, v, w, causal, lens)
    jo, jgrads = _jax(lambda a, b, c: flash_attention(
        a, b, c, causal=causal, kv_lens=jnp.asarray(lens)), q, k, v, w)
    np.testing.assert_allclose(o, jo, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse, _masked_lse(q, k, lens, causal),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


#: the low-precision cases' tolerance against fp32 JAX on the same rounded
#: inputs (times max(1, |ref|)): outputs, p and dS rounded to the dtype
LOW_TOL = {torch.float32: GRAD_TOL, torch.bfloat16: 1e-2,
           torch.float16: 2e-3}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kv_lens_tile_edges(dtype, D, causal):
    """Key lengths 0, 1, 63 and 65 (both sides of a 64-key tile edge) at
    S 129, the plain versions in fp32, bf16 and fp16 against the JAX
    dense path in fp32 on the same rounded inputs; padding keys get
    exactly zero dk and dv."""
    from deepspeed_tpu.ops.pallas import flash_attention
    B, S, H = 4, 129, 2
    lens = np.asarray([0, 1, 63, 65], np.int32)
    raw = _inputs(B, S, S, H, D, seed=D + causal)
    q, k, v, w = (torch.from_numpy(x).to(dtype).float().numpy()
                  for x in raw)
    t = [torch.from_numpy(x).to(dtype).requires_grad_(True)
         for x in (q, k, v)]
    o, lse = port_flash.flash_attention(*t, causal=causal,
                                        kv_lens=torch.from_numpy(lens))
    (o.float() * torch.from_numpy(w)).sum().backward()
    jo, jgrads = _jax(lambda a, b, c: flash_attention(
        a, b, c, causal=causal, kv_lens=jnp.asarray(lens)), q, k, v, w)
    tol = LOW_TOL[dtype]
    for got, want, name in zip((o, *(x.grad for x in t)), (jo, *jgrads),
                               ("o", "dq", "dk", "dv")):
        assert got.dtype == dtype
        err = (np.abs(got.detach().float().numpy() - want).max()
               / max(1.0, np.abs(want).max()))
        assert err <= tol, (name, err)
    np.testing.assert_allclose(lse.numpy(), _masked_lse(q, k, lens, causal),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for b, n in enumerate(np.maximum(lens, 1)):
        assert not t[1].grad[b, n:].any() and not t[2].grad[b, n:].any()


def test_packed_qkv_with_kv_lens_equals_separate():
    """``flash_attention_qkv`` on the packed [B, S, 3, H, D] product gives
    the O and the gradients of ``flash_attention`` on its three views."""
    rng = np.random.default_rng(4)
    B, S, H, D = 3, 40, 2, 16
    qkv_np = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    lens = torch.tensor([3, 40, 17])
    packed = torch.from_numpy(qkv_np).requires_grad_(True)
    o1 = port_flash.flash_attention_qkv(packed, causal=False, kv_lens=lens)[0]
    (o1 * w).sum().backward()
    sep = torch.from_numpy(qkv_np).requires_grad_(True)
    o2 = port_flash.flash_attention(sep[:, :, 0], sep[:, :, 1], sep[:, :, 2],
                                    causal=False, kv_lens=lens)[0]
    (o2 * w).sum().backward()
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(packed.grad, sep.grad, rtol=0, atol=0)


def test_no_kv_lens_is_unchanged():
    """``kv_lens`` of S everywhere gives what no ``kv_lens`` gives."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 33, 33, 2, 16, 5))
    full = port_flash.flash_attention_reference(
        q, k, v, False, None, torch.tensor([33, 33]))
    none = port_flash.flash_attention_reference(q, k, v, False)
    for a, b in zip(full, none):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
