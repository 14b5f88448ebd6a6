"""The port's NHWC bias-add family (plain path, CPU) against the JAX
package's ``ops/pallas/spatial.py``: bitwise in fp32, through the Pallas
kernels in interpret mode where their ``C % 128`` gate lets them run
(C = 128, 256, rows past one 256-row block) and against the JAX fallback
elsewhere (C = 4, 320, which the port's kernel also takes).  In bf16 the
plain version rounds once."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import spatial as jspatial
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import spatial as tspatial

VARIANTS = ("nhwc_bias_add", "nhwc_bias_add_add", "nhwc_bias_add_bias_add")


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the JAX kernels through Pallas interpret mode."""
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _operands(variant, shape, seed, dtype=np.float32):
    """(x, bias[, other[, other_bias]]) as numpy arrays."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = rng.standard_normal(shape).astype(dtype)
    ops = [x, rng.standard_normal(C).astype(dtype)]
    if variant != "nhwc_bias_add":
        ops.append(rng.standard_normal(shape).astype(dtype))
    if variant == "nhwc_bias_add_bias_add":
        ops.append(rng.standard_normal(C).astype(dtype))
    return ops


def _both(variant, ops):
    port = getattr(tspatial, variant)(*map(torch.from_numpy, ops)).numpy()
    ref = np.asarray(getattr(jspatial, variant)(*map(jnp.asarray, ops)))
    return port, ref


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(2, 4, 8, 128), (1, 10, 30, 256)])
def test_matches_pallas_kernel_bitwise(pallas_interpret, variant, shape):
    port, ref = _both(variant, _operands(variant, shape, seed=shape[-1]))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("C", [4, 320])
def test_matches_jax_fallback_bitwise(variant, C):
    """C % 128 != 0: the JAX package adds in plain XLA; the port's plain
    version (and kernel) take every C."""
    port, ref = _both(variant, _operands(variant, (2, 5, 7, C), seed=C))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_rounds_once_and_launches_nothing(variant):
    """bf16 operands: fp32 sums in the kernel's order, one rounding; on
    CPU tensors no kernel launches."""
    ops = [torch.from_numpy(a).to(torch.bfloat16)
           for a in _operands(variant, (1, 3, 3, 64), seed=1)]
    before = kernels.launch_counts()
    out = getattr(tspatial, variant)(*ops)
    want = ops[0].float()
    for t in ops[1:]:
        want = want + t.float()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.to(torch.bfloat16))
    assert kernels.launch_counts() == before


def test_kernel_wrapper_checks_operands():
    """The CUDA wrapper refuses operands its kernel does not take, before
    any launch (the checks run on any device)."""
    x = torch.zeros(2, 3, 3, 8)
    with pytest.raises(ValueError, match="wrong operands"):
        kernels.spatial_kernel(x, torch.zeros(8), x)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spatial_kernel(x.transpose(1, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="biases"):
        kernels.spatial_add_kernel(x, torch.zeros(7), x)
