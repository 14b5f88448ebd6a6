"""The host SIMD Adam of ZeRO-Offload (``deepspeed_tpu_torch/ops/adam/
cpu_adam.py``, ``ops/op_builder``) against the JAX package's.

Both packages build the same C++ (``csrc/adam/cpu_adam.cpp``) with the
same flags, so on the same seeded buffers the port's step is bitwise the
JAX package's: params, moments and the bf16 copy-out, Adam and AdamW,
with and without bias correction, over lengths that take the threaded
path and the SIMD tail.  Against the port's plain Adam (the
``fused_adam`` kernel's reference) the step agrees to 1e-6 relative: the
two take their bias corrections at other precisions (double here, fp32
there) and divide in another order (an element near 0 is measured
against its buffer's largest magnitude).  A failed build raises with the
compiler's stderr; concurrent builders into one directory all load."""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.ops.adam.cpu_adam import cpu_adam_step as jax_step
from deepspeed_tpu.ops.op_builder import builder as jax_builder
from deepspeed_tpu.ops.op_builder.cpu_adam import \
    CPUAdamBuilder as JaxCPUAdamBuilder
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, cpu_adam_step
from deepspeed_tpu_torch.ops.kernels.fused_adam import (adam_hyper,
                                                        fused_adam_reference)
from deepspeed_tpu_torch.ops.op_builder import builder
from deepspeed_tpu_torch.ops.op_builder.cpu_adam import CPUAdamBuilder

#: lengths: threaded (>= 2^16) with a tail past the 16-lane tiles, and
#: one thread with a tail
SIZES = (100_003, 4_099)
STEPS = 3
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.fixture(scope="module")
def libs():
    return CPUAdamBuilder().load(), JaxCPUAdamBuilder().load()


def _buffers(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) * 0.1
             for _ in range(STEPS)]
    return p, grads


def _run_port(lib, p, grads, adamw, bias, bf16):
    p = torch.from_numpy(p.copy())
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    out = torch.empty(p.numel(), dtype=torch.bfloat16) if bf16 else None
    for step, g in enumerate(grads, 1):
        cpu_adam_step(lib, p, torch.from_numpy(g), m, v, step,
                      HYPER["lr"], HYPER["beta1"], HYPER["beta2"],
                      HYPER["eps"], HYPER["weight_decay"], adamw, bias,
                      bf16_out=out)
    bits = out.view(torch.int16).numpy().view(np.uint16) if bf16 else None
    return p.numpy(), m.numpy(), v.numpy(), bits


def _run_jax(lib, p, grads, adamw, bias, bf16):
    p = p.copy()
    m, v = np.zeros_like(p), np.zeros_like(p)
    out = np.empty(p.size, np.uint16) if bf16 else None
    for step, g in enumerate(grads, 1):
        jax_step(lib, p, g, m, v, step, HYPER["lr"], HYPER["beta1"],
                 HYPER["beta2"], HYPER["eps"], HYPER["weight_decay"], adamw,
                 bias, bf16_out=out)
    return p, m, v, out


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_out"])
@pytest.mark.parametrize("adamw,bias", [(True, True), (False, True),
                                        (True, False)],
                         ids=["adamw", "adam", "adamw_no_bias_correction"])
@pytest.mark.parametrize("n", SIZES)
def test_step_bitwise_equal_to_jax(libs, n, adamw, bias, bf16):
    p, grads = _buffers(n, seed=n)
    got = _run_port(libs[0], p, grads, adamw, bias, bf16)
    want = _run_jax(libs[1], p, grads, adamw, bias, bf16)
    for name, a, b in zip(("p", "m", "v", "bf16"), got, want):
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_bf16_copy_out_is_the_rounded_master(libs):
    """The copy-out is the updated master rounded to nearest even, as
    torch rounds it."""
    p, grads = _buffers(SIZES[0], seed=1)
    master, _, _, bits = _run_port(libs[0], p, grads, True, True, True)
    want = torch.from_numpy(master).to(torch.bfloat16)
    np.testing.assert_array_equal(
        bits, want.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam"])
def test_step_matches_plain_adam(libs, adamw):
    p, grads = _buffers(SIZES[0], seed=2)
    got = _run_port(libs[0], p, grads, adamw, True, False)
    pt = torch.from_numpy(p.copy())
    m, v = torch.zeros_like(pt), torch.zeros_like(pt)
    for step, g in enumerate(grads, 1):
        hyper = adam_hyper(HYPER["lr"], HYPER["beta1"], HYPER["beta2"],
                           HYPER["eps"], HYPER["weight_decay"], step)
        fused_adam_reference(pt, torch.from_numpy(g.copy()), m, v, hyper,
                             adam_w_mode=adamw)
    # 1e-6 relative, an element near 0 measured against the buffer's
    # largest magnitude (one fp32 ulp of rounding apart there)
    for name, a, b in zip(("p", "m", "v"), got, (pt, m, v)):
        b = b.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


def test_class_matches_jax_class():
    port, jax_opt = DeepSpeedCPUAdam(lr=1e-3, weight_decay=0.01), \
        JaxCPUAdam(lr=1e-3, weight_decay=0.01)
    assert port.simd_width == jax_opt.simd_width
    p, grads = _buffers(SIZES[1], seed=3)
    pp, pj = torch.from_numpy(p.copy()), p.copy()
    for g in grads[:2]:
        port.step(0, pp, torch.from_numpy(g))
        jax_opt.step(0, pj, g)
    out = port.step_with_copy(0, pp, torch.from_numpy(grads[2]))
    want = jax_opt.step_with_copy(0, pj, grads[2])
    np.testing.assert_array_equal(pp.numpy(), pj)
    np.testing.assert_array_equal(
        out.view(torch.int16).numpy().view(np.uint16), want)
    sd = port.state_dict()
    assert sd["steps"] == {0: 3}
    np.testing.assert_array_equal(sd["m"][0].numpy(),
                                  jax_opt.state_dict()["m"][0])
    with pytest.raises(ValueError, match="registered with"):
        port.step(0, pp[:100].clone(), torch.zeros(100))


def test_refuses_bad_buffers(libs):
    p = torch.zeros(64)
    for bad in (torch.zeros(63), torch.zeros(64, dtype=torch.float64),
                torch.zeros(128)[::2]):
        with pytest.raises(ValueError, match="cpu_adam_step"):
            cpu_adam_step(libs[0], p, bad, torch.zeros(64), torch.zeros(64),
                          1, 1e-3, 0.9, 0.999, 1e-8, 0.0)
    with pytest.raises(ValueError, match="bf16_out"):
        cpu_adam_step(libs[0], p, torch.zeros(64), torch.zeros(64),
                      torch.zeros(64), 1, 1e-3, 0.9, 0.999, 1e-8, 0.0,
                      bf16_out=torch.zeros(64))


def test_build_flags_and_host_probes_are_jax_packages():
    assert builder.cpu_arch() == jax_builder.cpu_arch()
    assert builder.simd_width() == jax_builder.simd_width()
    assert CPUAdamBuilder().cxx_args() == JaxCPUAdamBuilder().cxx_args()
    assert CPUAdamBuilder().lib_path().parent == builder.BUILD_DIR
    assert builder.BUILD_DIR.parts[-2:] == ("build", "torch_host")


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    (tmp_path / "includes").mkdir()
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(builder, "CSRC", tmp_path)
    monkeypatch.setattr(builder, "BUILD_DIR", tmp_path / "out")

    class Broken(builder.OpBuilder):
        NAME = "broken"

        def sources(self):
            return ["broken.cpp"]

    with pytest.raises(RuntimeError, match="building op broken failed") as e:
        Broken().build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


def _build_in(build_dir):
    builder.BUILD_DIR = builder.Path(build_dir)
    return str(CPUAdamBuilder().build())


def test_concurrent_builds_all_load(tmp_path):
    """Builders racing into one directory (test workers) each compile
    under a name of their own and rename into place: every one ends with
    the same loadable library and no temporary file is left."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        paths = pool.map(_build_in, [str(tmp_path)] * 3, chunksize=1)
    assert len(set(paths)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    import ctypes
    lib = ctypes.CDLL(paths[0])
    assert lib.ds_adam_simd_width() in (1, 8, 16)
