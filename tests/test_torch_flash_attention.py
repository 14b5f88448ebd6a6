"""The port's flash attention (plain path, CPU) against the JAX package's
``flash_attention``: the Pallas kernel in interpret mode where it tiles,
``mha_reference`` at short lengths.  fp32, tolerance 1e-5."""

import importlib
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops import kernels as port_kernels
from deepspeed_tpu_torch.ops.kernels import flash_attention as port_flash
from deepspeed_tpu_torch.ops.kernels import (
    flash_attention_backward_reference, flash_attention_reference)

port_module = importlib.import_module(
    "deepspeed_tpu_torch.ops.kernels.flash_attention")

TOL = 1e-5
#: low-precision inputs against the fp32 JAX reference on the same values
#: (times max(1, |ref|)): the plain version rounds p and O to the input
#: dtype, a few half-ulps of O (chip_smoke.py's kernel tolerances)
LOW_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}
#: (Sq, Sk) at the edges of the tensor-core kernels' 64-key and
#: 128-query tiles; (129, 63): causal rows with no key for over one tile
EDGES = [(63, 63), (64, 64), (65, 65), (127, 127), (129, 129), (65, 129),
         (129, 63)]


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
@pytest.mark.parametrize("Sq,Sk", [(8, 8), (16, 16), (8, 16), (63, 63),
                                   (64, 64), (65, 65), (127, 127),
                                   (129, 129), (65, 127), (129, 63)])
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", EDGES)
@pytest.mark.parametrize("D", [32, 64, 80, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tile_edges_low_precision(dtype, D, Sq, Sk, causal):
    """bf16 and fp16 through the plain version (what ``chip_smoke.py``
    holds the kernel against) at the tile edges, at the head dims the
    kernel computes in tiles of their own (32, 64) and in the tile of 128
    (80, 96: GPT-2 2.7B, 760M), against the JAX
    reference in fp32 on the same rounded inputs; lse within 1e-5 of the
    masked logsumexp (it is fp32 in both), -inf on rows with no key."""
    from deepspeed_tpu.ops.pallas.flash_attention import mha_reference
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(1, Sq, Sk, 2, D, seed=Sq * 1000 + Sk + D))
    o, lse = port_flash(q, k, v, causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    q32, k32, v32 = (x.float().numpy() for x in (q, k, v))
    ref = np.asarray(mha_reference(jnp.asarray(q32), jnp.asarray(k32),
                                   jnp.asarray(v32), causal=causal))
    err = np.abs(o.float().numpy() - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= LOW_TOL[dtype], err
    want = _lse_reference(q32, k32, causal)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL, rtol=TOL)
    if causal and Sq > Sk:
        assert not o[:, :Sq - Sk].float().any()


def _band_lse_reference(q, k, window):
    """logsumexp of the banded-causal fp32 scores, [B, H, Sq]."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    dist = np.arange(Sq)[:, None] + Sk - Sq - np.arange(Sk)[None]
    s = jnp.where((dist >= 0) & (dist < window), s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("window", [1, 100, 128, 300])
@pytest.mark.parametrize("Sq", [128, 256])
def test_flash_window_matches_jax_pallas_kernel(pallas_interpret, Sq,
                                                window):
    """``window`` through the plain version against the JAX Pallas forward
    with ``window`` in interpret mode (128-wide tiles over S_k 256: tiles
    wholly below the band skipped, crossing tiles masked; window 300 >= S
    is plain causal); lse against the banded logsumexp.  fp32, 1e-5."""
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention
    q, k, v = _qkv(2, Sq, 256, 2, 64, seed=Sq + window)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, block_q=128, block_k=128,
                          window=window)
    o, lse = port_flash(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), _band_lse_reference(q, k, window),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [1, 100, 128, 300])
@pytest.mark.parametrize("Sq", [128, 256])
def test_flash_window_gradients_match_jax_pallas_kernel(pallas_interpret, Sq,
                                                        window):
    """dq, dk and dv of ``flash_attention(window=)`` through the plain
    backward against ``jax.vjp`` of the JAX Pallas ``flash_attention`` with
    ``window`` in interpret mode: 128-wide tiles over S_k 256 (nk 2), so
    JAX takes its fused single-sweep backward (``_bwd_dkv_kernel`` with
    ``emit_dq``), skipping the tiles below the band and masking the
    crossing ones.  fp32, 1e-5."""
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention
    q, k, v = _qkv(2, Sq, 256, 2, 64, seed=10 * Sq + window)
    do = np.random.default_rng(window).standard_normal(q.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_attention(
        q_, k_, v_, causal=True, block_q=128, block_k=128, window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, _ = port_flash(*leaves, causal=True, window=window)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("window", [1, 7, 64, 200])
@pytest.mark.parametrize("Sq,Sk", [(64, 64), (40, 100), (100, 40)])
def test_flash_window_backward_reference_matches_autograd(Sq, Sk, window):
    """The plain backward with ``window`` (what the kernels are held
    against on the card) against autograd of the plain banded forward,
    cross-length included (Sq > Sk: rows with no key get zero dq)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(2, Sq, Sk, 3, 32, seed=Sq * 7 + Sk + window))
    do = torch.from_numpy(np.random.default_rng(Sk).standard_normal(
        (2, Sq, 3, 32)).astype(np.float32))
    scale = 1.0 / math.sqrt(32)
    o, lse = flash_attention_reference(q, k, v, True, scale, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        True, scale, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL, msg=name)
    if Sq > Sk:
        assert not got[0][:, :Sq - Sk].any()


def test_flash_window_refusals():
    """Causal only; a window below 1 is clamped to the diagonal, as JAX
    clamps it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 32, seed=1))
    with pytest.raises(ValueError, match="causal"):
        port_flash(q, k, v, causal=False, window=4)
    o0, _ = port_flash(q, k, v, window=0)
    o1, _ = port_flash(q, k, v, window=1)
    torch.testing.assert_close(o0, o1, atol=0, rtol=0)
    torch.testing.assert_close(o1, v, atol=1e-6, rtol=1e-6)


# ------------------------------------------------- the fused backward's route


@pytest.mark.parametrize("Sk,fused", [(1024, True), (2048, True), (3072, True),
                                      (4096, True), (5120, False),
                                      (8192, False)])
def test_fused_backward_rule_matches_jax(Sk, fused):
    """``fused_backward`` takes the fused single sweep exactly where the
    JAX package does at its default key block: ``Sk // block_k <=
    MAX_FUSED_BWD_NK`` (``flash_attention.py:415-416``)."""
    from deepspeed_tpu.ops.pallas.flash_attention import (MAX_FUSED_BWD_NK,
                                                          resolve_env_blocks)
    block_k = resolve_env_blocks()[1]
    assert (Sk // block_k <= MAX_FUSED_BWD_NK) == fused
    assert port_kernels.fused_backward(Sk) == fused


def test_fused_backward_constants_match_jax():
    from deepspeed_tpu.ops.pallas.flash_attention import (MAX_FUSED_BWD_NK,
                                                          resolve_env_blocks)
    assert port_module.MAX_FUSED_BWD_NK == MAX_FUSED_BWD_NK
    assert port_module.FUSED_BWD_BLOCK_K == resolve_env_blocks()[1]


#: the gradient cases held against both JAX backward forms: (causal,
#: kv_lens, window)
GRAD_MODES = {"causal": (True, False, None), "non-causal": (False, False, None),
              "kv_lens": (False, True, None), "window": (True, False, 100)}


@pytest.mark.parametrize("mode", sorted(GRAD_MODES))
@pytest.mark.parametrize("Sk,jax_form,D", [
    pytest.param(512, "fused", 32, id="512-fused"),
    pytest.param(640, "two_kernel", 32, id="640-two_kernel"),
    pytest.param(512, "fused", 80, id="512-fused-D80"),
    pytest.param(512, "fused", 96, id="512-fused-D96"),
    pytest.param(640, "two_kernel", 80, id="640-two_kernel-D80"),
    pytest.param(640, "two_kernel", 96, id="640-two_kernel-D96")])
def test_backward_forms_match_jax_pallas_kernel(pallas_interpret, Sk, jax_form,
                                                D, mode):
    """dq, dk and dv of the port's ``flash_attention`` (its plain backward
    here, the function both CUDA forms compute) against ``jax.vjp`` of the
    Pallas ``flash_attention`` in interpret mode at 128-wide blocks: Sk 512
    is nk 4, JAX's fused single sweep (``_bwd_dkv_kernel`` with
    ``emit_dq``), Sk 640 nk 5, its two-kernel backward; causal, non-causal,
    ragged ``kv_lens`` and a window of 100.  Head dims 32, 80 and 96 in
    both forms.  fp32, 1e-5."""
    from deepspeed_tpu.ops.pallas.flash_attention import (MAX_FUSED_BWD_NK,
                                                          flash_attention)
    assert (Sk // 128 <= MAX_FUSED_BWD_NK) == (jax_form == "fused")
    causal, ragged, window = GRAD_MODES[mode]
    q, k, v = _qkv(2, Sk, Sk, 2, D, seed=Sk + len(mode))
    do = np.random.default_rng(Sk).standard_normal(q.shape).astype(np.float32)
    lens = np.array([Sk - 77, 200], np.int32) if ragged else None
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_attention(
        q_, k_, v_, causal=causal, block_q=128, block_k=128,
        kv_lens=None if lens is None else jnp.asarray(lens), window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, _ = port_flash(*leaves, causal=causal, window=window,
                      kv_lens=None if lens is None else torch.from_numpy(lens))
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, r, name in zip(grads, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("Sk", [128, 5120])
def test_cpu_backward_launches_no_kernel(Sk):
    """On CPU tensors the backward runs the plain version on either side of
    the fused rule (Sk 128: the fused form, 5120: the pair) and counts no
    launch of ``flash_bwd_fused``, ``flash_bwd_dq`` or ``flash_bwd_dkv``."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, Sk, 2, 32, seed=Sk))
    do = torch.ones_like(q)
    scale = 1.0 / math.sqrt(32)
    o, lse = flash_attention_reference(q, k, v, True, scale)
    port_kernels.reset_launch_counts()
    grads = port_kernels.flash_attention_backward(q, k, v, o, lse, do, True,
                                                  scale)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, True, scale)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    counts = port_kernels.launch_counts()
    assert {n: counts[n] for n in ("flash_bwd_fused", "flash_bwd_dq",
                                   "flash_bwd_dkv")} == dict.fromkeys(
        ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"), 0)
