"""The int8 KV cache's write, ``quantize_kv_into`` (plain path, CPU),
against the JAX package's: ``quantize_kv`` of the new K and V, then
``lax.dynamic_update_slice`` (a shared position) or ``.at[rows,
cols].set`` (per-row positions), as ``deepspeed_tpu/models/
gpt_inference.py`` writes its int8 cache.  Decode (uniform and ragged),
a ragged extend chunk and a prefill; codes and scales bitwise against
eager JAX.  Then the ``quantize_kv_append`` kernel wrapper's refusals,
which run before any build or launch."""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jdecode
from deepspeed_tpu_torch.ops.kernels import (quantize_kv_append,
                                             quantize_kv_into)

B, SMAX, H, D = 3, 48, 2, 64


def _cache(seed):
    """A layer of an int8 cache already holding codes and scales."""
    rng = np.random.default_rng(seed)
    codes = [rng.integers(-127, 128, (B, SMAX, H, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(1e-3, 1e-2, (B, SMAX, H, 1)).astype(np.float32)
              for _ in range(2)]
    return codes + scales


def _new_kv(Sq, seed, dtype):
    """K and V as strided views of a [B, Sq, 3, H, D] qkv product, one
    head vector all zero."""
    qkv = np.random.default_rng(seed).standard_normal(
        (B, Sq, 3, H, D)).astype(np.float32)
    qkv[0, 0, 1, 1] = 0.0
    t = torch.from_numpy(qkv).to(dtype)
    return t[:, :, 1], t[:, :, 2]


def _jax_write(layer, k, v, pos, Sq):
    """The JAX package's int8 write of one layer."""
    out = [jnp.asarray(a) for a in layer]
    ragged = isinstance(pos, list)
    for i, val in enumerate((k, v)):
        codes, scale = jdecode.quantize_kv(jnp.asarray(val.float().numpy()))
        for j, new in ((i, codes), (i + 2, scale)):
            if ragged:
                rows = jnp.arange(B)[:, None]
                cols = jnp.asarray(pos)[:, None] + jnp.arange(Sq)
                out[j] = out[j].at[rows, cols].set(new)
            else:
                out[j] = lax.dynamic_update_slice(out[j], new, (0, pos, 0, 0))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,Sq,pos", [
    ("decode uniform", 1, 17), ("decode ragged", 1, [0, 29, 47]),
    ("extend ragged", 5, [3, 40, 11]), ("extend uniform", 5, 20),
    ("prefill", 16, 0)])
def test_quantize_kv_into_matches_jax(case, Sq, pos, dtype):
    layer = _cache(Sq)
    k, v = _new_kv(Sq, Sq + 1, dtype)
    want = _jax_write(layer, k, v, pos, Sq)
    got = [torch.from_numpy(a.copy()) for a in layer]
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    quantize_kv_into(k, v, got, tpos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the write reached exactly the new slots
    written = np.zeros((B, SMAX), bool)
    for b in range(B):
        p = pos[b] if isinstance(pos, list) else pos
        written[b, p:p + Sq] = True
    for g, old in zip(got, layer):
        np.testing.assert_array_equal(g.numpy()[~written], old[~written])


def _append_args(case):
    """Arguments of ``quantize_kv_append`` on CPU tensors, with one of
    them made wrong."""
    k = v = torch.zeros(B, 1, H, D, dtype=torch.bfloat16)
    kc = vc = torch.zeros(B, SMAX, H, D, dtype=torch.int8)
    ks = vs = torch.zeros(B, SMAX, H, 1)
    pos = 3
    if case == "bf16_cache":
        kc = vc = torch.zeros(B, SMAX, H, D, dtype=torch.bfloat16)
    elif case == "misaligned_rows":
        kc = vc = torch.zeros(B, SMAX, H, D + 8, dtype=torch.int8)[..., :D]
    elif case == "scale_shape":
        ks = torch.zeros(B, SMAX, H)
    elif case == "scale_dtype":
        vs = torch.zeros(B, SMAX, H, 1, dtype=torch.float16)
    elif case == "pos_past_end":
        pos = SMAX
    elif case == "pos_negative":
        pos = -1
    elif case == "pos_dtype":
        pos = torch.zeros(B, dtype=torch.int64)
    elif case == "kv_shapes":
        v = torch.zeros(B, 2, H, D, dtype=torch.bfloat16)
    elif case == "kv_dtype":
        k = torch.zeros(B, 1, H, D, dtype=torch.int32)
    return k, v, kc, vc, ks, vs, pos


@pytest.mark.parametrize("case,err,match", [
    ("bf16_cache", TypeError, "int8 codes"),
    ("misaligned_rows", ValueError, "16-byte aligned"),
    ("scale_shape", ValueError, "scales must be fp32"),
    ("scale_dtype", ValueError, "scales must be fp32"),
    ("pos_past_end", ValueError, "outside"),
    ("pos_negative", ValueError, "outside"),
    ("pos_dtype", ValueError, "int32"),
    ("kv_shapes", ValueError, r"\[B, Sq, H, D\]"),
    ("kv_dtype", TypeError, "K and V must share"),
])
def test_append_wrapper_refuses_what_the_kernel_does_not_take(case, err,
                                                              match):
    with pytest.raises(err, match=match):
        quantize_kv_append(*_append_args(case))
