"""The port's fused Adam (plain path, CPU) against the JAX package's
``fused_adam_step`` (the Pallas kernel in interpret mode) and its pytree
``adam_update``, over three steps from seeded numpy buffers.  fp32
params: tolerance 1e-6 (relative and absolute), the JAX tests' own for
this kernel; bf16 params: the rounded params equal to within one bf16 ulp
(2^-7 relative), moments 1e-6.  A skipped step leaves every state bitwise
unchanged."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu_torch.ops.adam import SGD, FusedAdam
from deepspeed_tpu_torch.ops.kernels import fused_adam, fused_adam_step
from deepspeed_tpu_torch.ops.kernels.fused_adam import adam_hyper
from deepspeed_tpu_torch.ops.optimizer import get_optimizer_class

TOL = 1e-6
N = 1000           # not a multiple of 4: exercises the tail


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _buffers(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    grads = [rng.standard_normal(N).astype(np.float32) for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("adam_w_mode,bias_correction",
                         [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_fused_adam_step_matches_jax_kernel(pallas_interpret, adam_w_mode,
                                            bias_correction, param_dtype):
    from deepspeed_tpu.ops.pallas import fused_adam_step as jstep
    p, grads = _buffers(1)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jp = jnp.asarray(p, param_dtype)
    tp = torch.from_numpy(p).to(tdt)
    jm = jv = jnp.zeros(N, jnp.float32)
    tm = tv = torch.zeros(N)
    for step, g in enumerate(grads, start=1):
        jp, jm, jv = jstep(jp, jnp.asarray(g, param_dtype), jm, jv, step, **kw)
        tp, tm, tv = fused_adam_step(tp, torch.from_numpy(g).to(tdt), tm, tv,
                                     step, **kw)
    assert tp.dtype == tdt
    got = tp.float().numpy()
    want = np.asarray(jp, np.float32)
    if param_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_optimizer_matches_adam_update(adam_w_mode):
    """``FusedAdam.step_flat`` over a flat buffer == the JAX pytree
    ``adam_update`` on one leaf, three steps, with a gradient scale."""
    from deepspeed_tpu.ops.adam.fused_adam import adam_init, adam_update
    p, grads = _buffers(2)
    opt = FusedAdam(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode)
    master = torch.from_numpy(p.copy())
    state = opt.init(master)
    jparams, jstate = {"w": jnp.asarray(p)}, adam_init({"w": jnp.asarray(p)})
    for g in grads:
        acc = torch.from_numpy(g * 4.0)             # the accumulator, ×scale 4
        opt.step_flat(master, acc, state, opt.current_hyperparams(),
                      grad_scale=torch.tensor(0.25))
        state["step"] += 1
        assert not acc.any()                        # zeroed by the step
        jparams, jstate = adam_update(
            {"w": jnp.asarray(g)}, jstate, jparams, lr=1e-2, beta1=0.9,
            beta2=0.999, eps=1e-8, weight_decay=0.01, adam_w_mode=adam_w_mode)
    np.testing.assert_allclose(master.numpy(), np.asarray(jparams["w"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state["exp_avg"].numpy(),
                               np.asarray(jstate["exp_avg"]["w"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state["exp_avg_sq"].numpy(),
                               np.asarray(jstate["exp_avg_sq"]["w"]),
                               rtol=TOL, atol=TOL)


def test_skip_leaves_state_bitwise_unchanged():
    p, grads = _buffers(3)
    master = torch.from_numpy(p.copy())
    m = torch.from_numpy(grads[0].copy())
    v = torch.from_numpy(np.abs(grads[1]))
    compute = master.to(torch.bfloat16)
    g = torch.from_numpy(grads[2].copy())
    before = [t.clone() for t in (master, m, v, compute)]
    fused_adam(master, g, m, v, adam_hyper(1e-2, 0.9, 0.999, 1e-8, 0.01, 5),
               p_compute=compute, skip=torch.tensor(True))
    for got, want in zip((master, m, v, compute), before):
        assert torch.equal(got, want)
    assert not g.any()
    fused_adam(master, torch.from_numpy(grads[2].copy()), m, v,
               adam_hyper(1e-2, 0.9, 0.999, 1e-8, 0.01, 5),
               p_compute=compute, skip=torch.tensor(False))
    assert not torch.equal(master, before[0])
    assert torch.equal(compute, master.to(torch.bfloat16))


def test_registry_and_amsgrad_refusal():
    assert get_optimizer_class("AdamW") is FusedAdam
    assert get_optimizer_class("sgd") is SGD
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer_class("lion")


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_matches_jax_sgd(momentum, nesterov):
    from deepspeed_tpu.ops.adam.fused_adam import SGD as JSGD
    p, grads = _buffers(4)
    jopt = JSGD(lr=0.1, momentum=momentum, weight_decay=0.01,
                nesterov=nesterov)
    opt = SGD(lr=0.1, momentum=momentum, weight_decay=0.01, nesterov=nesterov)
    jp = {"w": jnp.asarray(p)}
    jstate = jopt.init(jp)
    master = torch.from_numpy(p.copy())
    state = opt.init(master)
    for g in grads:
        jp, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jp,
                                 {"lr": 0.1, "weight_decay": 0.01})
        opt.step_flat(master, torch.from_numpy(g.copy()), state,
                      opt.current_hyperparams())
    np.testing.assert_allclose(master.numpy(), np.asarray(jp["w"]),
                               rtol=TOL, atol=TOL)
