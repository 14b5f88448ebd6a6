"""The port's grouped quantizer (plain path, CPU) against the JAX
package's ``ops/pallas/quantizer.py``: deterministic codes, scales and
offsets bitwise equal to ``_quantize_ref`` over bits x mode x group size
(with an all-zero and a constant group), and to the Pallas kernel in
interpret mode where its shapes tile, up to XLA's rewrite of the division
by qmax under jit (``assert_jit_close``); ``dequantize``,
``fake_quantize``'s straight-through gradient, stochastic rounding in
distribution, and the KV-cache ``quantize_kv``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jdecode
from deepspeed_tpu.ops.pallas import quantizer as jq
from deepspeed_tpu_torch.ops.kernels import decode_attention as tdecode
from deepspeed_tpu_torch.ops.kernels import quantizer as tq


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _groups(groups, gsize, seed):
    """[groups, gsize] fp32 with group 1 all zero and group 2 constant."""
    x = (np.random.default_rng(seed).standard_normal((groups, gsize))
         * 3).astype(np.float32)
    x[1] = 0.0
    x[2] = 1.5
    return x


def _assert_bitwise(port, ref):
    for t, r in zip(port, ref):
        r = np.asarray(r)
        assert t.dtype == {np.int8: torch.int8,
                           np.float32: torch.float32}[r.dtype.type]
        np.testing.assert_array_equal(t.numpy(), r)


def assert_jit_close(codes, scale, jcodes, jscale):
    """The port (true division ``absmax / qmax``, as the JAX source and
    its eager ``_quantize_ref``) against JAX code run under ``jit``, where
    XLA rewrites the division by the constant qmax into a multiply by its
    fp32 reciprocal: scales within 1 ulp, codes bitwise equal in every
    group whose scale is equal and within 1 elsewhere.  ``scale`` [...]
    or [..., 1] per group of ``codes`` [..., gsize]."""
    s, js = scale.numpy().reshape(-1), np.asarray(jscale).reshape(-1)
    np.testing.assert_array_max_ulp(s, js, maxulp=1)
    q = codes.numpy().astype(np.int32).reshape(s.size, -1)
    jq_ = np.asarray(jcodes).astype(np.int32).reshape(s.size, -1)
    same = s == js
    np.testing.assert_array_equal(q[same], jq_[same])
    assert np.abs(q - jq_).max() <= 1


@pytest.mark.parametrize("gsize", [1, 64, 100, 1024, 4096, 5000])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_matches_jax_reference(bits, symmetric, gsize):
    x = _groups(6, gsize, seed=bits * 10 + gsize)
    ref = jq._quantize_ref(jnp.asarray(x), bits, symmetric, False, None)
    out = tq.quantize(torch.from_numpy(x), groups=6, bits=bits,
                      symmetric=symmetric)
    _assert_bitwise(out, ref)
    # the all-zero group: the 1e-12 floor, codes 0, an exact round trip
    assert out[1][1] == np.float32(1e-12) and (out[0][1] == 0).all()
    back = tq.dequantize(*out[:2], None if symmetric else out[2])
    assert (back[1] == 0).all()


@pytest.mark.parametrize("groups,gsize,bits,symmetric", [
    (16, 128, 8, True), (16, 128, 8, False), (8, 256, 4, True),
    (8, 256, 4, False)])
def test_quantize_matches_jax_pallas_kernel(pallas_interpret, groups, gsize,
                                            bits, symmetric):
    """Shapes the TPU kernel tiles (groups % 8 == 0, gsize >= 128) go
    through ``_quant_kernel`` in interpret mode."""
    x = _groups(groups, gsize, seed=groups + gsize)
    ref = jq.quantize(jnp.asarray(x), groups=groups, bits=bits,
                      symmetric=symmetric)
    out = tq.quantize(torch.from_numpy(x), groups=groups, bits=bits,
                      symmetric=symmetric)
    assert_jit_close(out[0], out[1], ref[0], ref[1])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_input_quantizes_as_its_fp32_value(dtype):
    """The kernel and the plain version read 16-bit input in its own
    dtype; widening is exact, so the codes equal JAX's on the fp32 cast
    (what ``quantize_leaf`` hands it)."""
    x = torch.from_numpy(_groups(8, 96, seed=3)).to(dtype)
    x32 = x.float().numpy()
    for symmetric in (True, False):
        ref = jq._quantize_ref(jnp.asarray(x32), 8, symmetric, False, None)
        _assert_bitwise(tq.quantize(x, 8, 8, symmetric), ref)


def test_quantize_symmetric_and_dequantize_match_jax():
    x = _groups(5, 33, seed=4)
    q, s = tq.quantize_symmetric(torch.from_numpy(x), bits=6)
    jq_, js = jq.quantize_symmetric(jnp.asarray(x), bits=6)
    _assert_bitwise((q, s), (jq_, js))
    np.testing.assert_array_equal(
        tq.dequantize_symmetric(q, s).numpy(),
        np.asarray(jq.dequantize_symmetric(jq_, js)))
    codes, scale, offset = tq.quantize(torch.from_numpy(x), 5, 8, False)
    ref = jq.dequantize(jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()),
                        jnp.asarray(offset.numpy()), dtype=jnp.float32)
    np.testing.assert_array_equal(
        tq.dequantize(codes, scale, offset).numpy(), np.asarray(ref))
    assert tq.dequantize(codes, scale, dtype=torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("symmetric", [True, False])
def test_fake_quantize_forward_and_straight_through_gradient(symmetric):
    x = _groups(4, 48, seed=5).reshape(8, 24)
    ref = jq.fake_quantize(jnp.asarray(x), groups=4, bits=4,
                           symmetric=symmetric)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tq.fake_quantize(xt, groups=4, bits=4, symmetric=symmetric)
    assert out.shape == xt.shape
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, 24)).astype(np.float32))
    (gx,) = torch.autograd.grad(out, xt, g)
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quantize(
        v, groups=4, bits=4, symmetric=symmetric) * jnp.asarray(g.numpy())))(
            jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), g.numpy())
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jg))


@pytest.mark.parametrize("symmetric", [True, False])
def test_stochastic_rounding_statistics(symmetric):
    """The TPU's PRNG stream is not reproduced: same seed → same codes,
    another seed → other codes, every code within 1 of the deterministic
    one, and the rounding error unbiased over 10^6 elements."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1000, 1000)).astype(np.float32))
    det, scale, offset = tq.quantize(x, 1000, 8, symmetric)

    def sr(seed):
        gen = torch.Generator().manual_seed(seed)
        return tq.quantize(x, 1000, 8, symmetric, stochastic=True,
                           generator=gen)

    a, b, c = sr(1), sr(1), sr(2)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    torch.testing.assert_close(a[1], scale, rtol=0, atol=0)
    assert (a[0].int() - det.int()).abs().max() <= 1
    assert (a[0] != det).float().mean() > 0.2
    back = tq.dequantize(a[0], a[1], None if symmetric else a[2])
    err = ((back - x.view(1000, 1000)) / a[1][:, None]).mean().item()
    assert abs(err) < 0.01, err
    # JAX's stochastic reference obeys the same bounds
    jcodes = np.asarray(jq._quantize_ref(jnp.asarray(x.numpy()), 8,
                                         symmetric, True,
                                         jax.random.PRNGKey(0))[0])
    assert np.abs(jcodes.astype(np.int32) - det.int().numpy()).max() <= 1


def test_sr_noise_is_uniform_on_half_interval():
    n = tq.sr_noise(123, (4, 250_000))
    assert n.dtype == torch.float32 and n.shape == (4, 250_000)
    assert n.min() >= -0.5 and n.max() < 0.5
    assert abs(n.mean().item()) < 2e-3
    assert abs(n.var().item() - 1 / 12) < 2e-3
    # counter based: element i's noise does not depend on the shape
    torch.testing.assert_close(tq.sr_noise(123, (10,)),
                               n.view(-1)[:10], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    x = np.random.default_rng(8).standard_normal((2, 5, 3, 3, 64)).astype(
        np.float32)
    x[0, 1, 0, 2] = 0.0                   # an all-zero head vector
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    k = xt[:, :, 1]                       # strided, as qkv_proj hands it
    codes, scale = tdecode.quantize_kv(k)
    jcodes, jscale = jdecode.quantize_kv(jnp.asarray(k.float().numpy()))
    _assert_bitwise((codes, scale), (jcodes, jscale))
    assert scale.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(
        tdecode.dequantize_kv(codes, scale, torch.float32).numpy(),
        np.asarray(jdecode.dequantize_kv(jcodes, jscale, jnp.float32)))


@pytest.mark.parametrize("call,err,match", [
    (lambda x: tq.quantize(x, groups=7), ValueError, "not divisible"),
    (lambda x: tq.quantize(x, bits=9), ValueError, "bits"),
    (lambda x: tq.quantize(x, bits=1), ValueError, "bits"),
    (lambda x: tq.quantizer_kernel(x.int()), TypeError, "not supported"),
    (lambda x: tq.quantizer_kernel(x.view(2, 2, 2, 2, 3)), ValueError,
     "row dims"),
    (lambda x: tq.quantizer_kernel(x.view(8, 6)[:, ::2]), ValueError,
     "contiguous"),
])
def test_quantizer_refuses_bad_input(call, err, match):
    """Checks run before any build or launch, so CPU tensors reach the
    kernel wrapper's checks here."""
    with pytest.raises(err, match=match):
        call(torch.zeros(48))
