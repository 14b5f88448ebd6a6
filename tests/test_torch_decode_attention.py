"""The port's cached attention (plain path, CPU) against the JAX
package's ``cached_attention``: the decode and chunk Pallas kernels in
interpret mode at S_max 256, the dense reference at shapes the TPU
kernels do not tile.  fp32, tolerance 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops.kernels import cached_attention

TOL = 1e-5


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _inputs(B, Sq, Smax, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Smax, H, D)).astype(np.float32),
            rng.standard_normal((B, Smax, H, D)).astype(np.float32))


def _both(jax_fn, q, ck, cv, pos):
    """(port output, JAX output) for scalar ``pos`` or a per-row list."""
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    ref = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            jpos))
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    out = cached_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), tpos)
    return out.numpy(), ref


@pytest.mark.parametrize("Sq,pos", [
    (1, 100), (1, [37, 200]),            # decode kernel, scalar / ragged
    (8, 64), (8, [5, 180]),              # chunk kernel, scalar / ragged
    (16, 130), (16, [0, 239]),
])
def test_cached_attention_matches_jax_kernels(pallas_interpret, Sq, pos):
    from deepspeed_tpu.ops.pallas.decode_attention import cached_attention \
        as jax_cached
    q, ck, cv = _inputs(2, Sq, 256, 2, 64, seed=Sq)
    out, ref = _both(jax_cached, q, ck, cv, pos)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Smax,Sq,pos", [
    (40, 1, 17), (40, 1, [3, 39]), (8, 3, 2), (24, 5, [0, 19]),
])
def test_cached_attention_untiled_shapes_match_reference(Smax, Sq, pos):
    """Shapes the TPU kernels do not tile (S_max not a 128 multiple, odd
    chunks): the JAX package takes its dense reference; every CUDA shape
    takes the port's kernels."""
    from deepspeed_tpu.ops.pallas.decode_attention import \
        cached_attention_reference
    q, ck, cv = _inputs(2, Sq, Smax, 3, 32, seed=Smax + Sq)
    out, ref = _both(cached_attention_reference, q, ck, cv, pos)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("option", [
    {"k_scale": 1, "v_scale": 1, "window": 4}, {"window": 4},
    {"slopes": 1}])
def test_unported_options_raise(option):
    """The window and ALiBi options raise, on the int8 cache too."""
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(1, 1, 16, 2, 32, 0))
    with pytest.raises(NotImplementedError, match="not ported"):
        cached_attention(q, ck, cv, 3, **option)


@pytest.mark.parametrize("case,err,match", [
    ("int_dtype", TypeError, "not supported"),
    ("mixed_dtype", TypeError, "mixed dtypes"),
    ("head_dim_48", ValueError, "head dim 48"),
    ("strided_head_dim", ValueError, "contiguous"),
    ("misaligned_rows", ValueError, "16-byte aligned"),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, err,
                                                             match):
    """The wrappers' checks run before any launch; they are plain Python,
    so they are exercised here on CPU tensors."""
    from deepspeed_tpu_torch.ops.kernels.utils import check_kernel_inputs
    q = torch.zeros(2, 4, 2, 64)
    k = torch.zeros(2, 8, 2, 64)
    if case == "int_dtype":
        q, k = q.int(), k.int()
    elif case == "mixed_dtype":
        k = k.half()
    elif case == "head_dim_48":
        q, k = q[..., :48].contiguous(), k[..., :48].contiguous()
    elif case == "strided_head_dim":
        k = torch.zeros(2, 8, 2, 128)[..., ::2]
    else:
        k = torch.zeros(2, 8, 2, 65)[..., 1:]
    with pytest.raises(err, match=match):
        check_kernel_inputs("decode_attn", q, k)
    assert check_kernel_inputs("decode_attn", torch.zeros(2, 4, 2, 64),
                               torch.zeros(2, 8, 2, 64)) == torch.float32
