"""The port's ``DeepSpeedTransformerLayer`` (plain path, CPU, fp32)
against the JAX package's layer on the same weights and seeded numpy
inputs: the output, the input's gradient and every parameter's gradient
of ``(y * g).sum()``, in both LayerNorm orders, unmasked, with per-row
``seq_lens`` and with a ``pad_mask`` with holes, at 1e-5 (relative and
absolute).  Post-LN is exactly ``models/bert._block``; the module's
parameters, init, dtype and dropout refusal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import transformer as jtr
from deepspeed_tpu_torch import (DeepSpeedTransformerConfig,
                                 DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.models import bert
from deepspeed_tpu_torch.ops.transformer import transformer as ttr

TOL = 1e-5
B, S, D, HEADS, FFN = 2, 16, 64, 4, 128
MODES = ("none", "seq_lens", "pad_mask")
ORDERS = (True, False)


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    seq_lens = np.array([11, 16], np.int32)
    pad_mask = (np.arange(S)[None, :] < seq_lens[:, None]).astype(np.int32)
    pad_mask[1, ::3] = 0
    return x, g, seq_lens, pad_mask


def _masks(mode, seq_lens, pad_mask, to):
    return {"pad_mask": to(pad_mask) if mode == "pad_mask" else None,
            "seq_lens": to(seq_lens) if mode == "seq_lens" else None}


@pytest.fixture(scope="module")
def ref():
    """The JAX layer's weights, inputs, and (y, dx, dparams) of every
    LayerNorm order and mask mode."""
    x, g, seq_lens, pad_mask = _inputs()
    out = {}
    params = None
    for pre in ORDERS:
        cfg = jtr.DeepSpeedTransformerConfig(
            hidden_size=D, intermediate_size=FFN, heads=HEADS,
            pre_layer_norm=pre)
        layer = jtr.DeepSpeedTransformerLayer(cfg, rng=jax.random.PRNGKey(5))
        params = jax.device_get(layer.params)
        for mode in MODES:
            masks = _masks(mode, seq_lens, pad_mask, jnp.asarray)
            y, vjp = jax.vjp(lambda p, xx: layer.apply(p, xx, **masks),
                             params, jnp.asarray(x))
            dp, dx = vjp(jnp.asarray(g))
            out[(pre, mode)] = (np.asarray(y), np.asarray(dx),
                                jax.device_get(dp))
    return {"params": params, "out": out}


def _config(pre=True, **kw):
    return DeepSpeedTransformerConfig(hidden_size=D, intermediate_size=FFN,
                                      heads=HEADS, pre_layer_norm=pre, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pre", ORDERS, ids=["pre_ln", "post_ln"])
def test_outputs_and_gradients_match_jax(ref, pre, mode):
    x, g, seq_lens, pad_mask = _inputs()
    layer = DeepSpeedTransformerLayer(_config(pre),
                                      initial_weights=ref["params"],
                                      device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt, **_masks(mode, seq_lens, pad_mask, torch.from_numpy))
    (y * torch.from_numpy(g)).sum().backward()
    want_y, want_dx, want_dp = ref["out"][(pre, mode)]
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=TOL, atol=TOL)
    grads = {name: p.grad for name, p in layer.named_parameters()}
    assert sorted(grads) == sorted(want_dp)
    for name, want in want_dp.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_post_ln_is_the_bert_block(ref, mode):
    x, _, seq_lens, pad_mask = _inputs()
    layer = DeepSpeedTransformerLayer(_config(pre=False),
                                      initial_weights=ref["params"],
                                      device="cpu")
    masks = _masks(mode, seq_lens, pad_mask, torch.from_numpy)
    bcfg = bert.BertConfig(vocab_size=1, max_seq_len=1, n_layer=1,
                           n_head=HEADS, d_model=D, d_ff=FFN,
                           dtype=torch.float32)
    with torch.no_grad():
        want = bert._block(
            torch.from_numpy(x),
            None if masks["pad_mask"] is None else masks["pad_mask"].bool(),
            masks["seq_lens"], layer.params, bcfg)
        assert torch.equal(layer(torch.from_numpy(x), **masks), want)
        assert torch.equal(ttr.apply(layer.params, torch.from_numpy(x),
                                     layer.config, **masks), want)


def test_module_parameters_and_init():
    cfg = _config(bf16=True)
    a = DeepSpeedTransformerLayer(cfg, generator=torch.Generator()
                                  .manual_seed(3))
    b = DeepSpeedTransformerLayer(cfg, generator=torch.Generator()
                                  .manual_seed(3))
    names = [n for n, _ in a.named_parameters()]
    assert names == list(ttr.PARAM_NAMES)
    hd = D // HEADS
    shapes = {"wqkv": (D, 3, HEADS, hd), "bqkv": (3, HEADS, hd),
              "wo": (HEADS, hd, D), "wi": (D, FFN), "bi": (FFN,),
              "wo_mlp": (FFN, D)}
    for name, p in a.named_parameters():
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        assert tuple(p.shape) == shapes.get(name, (D,)), name
        assert torch.equal(p, getattr(b, name))
    assert abs(a.wi.std().item() - cfg.initializer_range) < 2e-3
    assert torch.equal(a.ln1_scale, torch.ones(D)) and not a.bo.any()
    y = a(torch.randn(B, S, D))
    assert y.dtype == torch.bfloat16 and y.shape == (B, S, D)
    assert _config(fp16=True).dtype == torch.float16
    assert _config().dtype == torch.float32 and _config().ffn == FFN
    assert DeepSpeedTransformerConfig(hidden_size=32, heads=2).ffn == 128


@pytest.mark.parametrize("field", ["attn_dropout_ratio",
                                   "hidden_dropout_ratio"])
def test_dropout_above_zero_raises(field):
    with pytest.raises(NotImplementedError, match="Queue 1 #3.1"):
        _config(**{field: 0.1})
    assert getattr(_config(**{field: 0.0}), field) == 0.0
