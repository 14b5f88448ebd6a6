"""The port's GPT and KV-cached inference (CPU, plain kernels) against the
JAX package's ``gpt``/``gpt_inference`` on a tiny fp32 model whose weights
are drawn with numpy and fed to both sides.  Logits to 1e-4.

The helpers ``tiny_configs`` and ``tiny_params`` are shared with the
engine and serving tests."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_inference as jinf
from deepspeed_tpu_torch.models import convert, gpt, gpt_inference as tinf

TOL = 1e-4


def tiny_configs(dtype="float32"):
    """(JAX GPTConfig, port GPTConfig) of the tiny test model."""
    jcfg = jgpt.GPTConfig(vocab_size=512, max_seq_len=256, n_layer=2,
                          n_head=4, d_model=128, dtype=getattr(jnp, dtype))
    return jcfg, convert.config_from_jax(jcfg)


def tiny_params(jcfg, seed=0):
    """The JAX parameter tree as numpy arrays, drawn at a larger std than
    ``gpt.init``'s 0.02 so greedy decoding does not collapse onto one
    repeated token."""
    rng = np.random.default_rng(seed)
    d, f, L = jcfg.d_model, jcfg.ffn_dim, jcfg.n_layer
    h, hd, v = jcfg.n_head, jcfg.head_dim, jcfg.padded_vocab

    def n(*shape, std=0.3):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    blocks = {
        "ln1_scale": 1 + n(L, d, std=0.1), "ln1_bias": n(L, d, std=0.1),
        "wqkv": n(L, d, 3, h, hd), "bqkv": n(L, 3, h, hd, std=0.1),
        "wo": n(L, h, hd, d, std=0.1), "bo": n(L, d, std=0.1),
        "ln2_scale": 1 + n(L, d, std=0.1), "ln2_bias": n(L, d, std=0.1),
        "wi": n(L, d, f, std=0.1), "bi": n(L, f, std=0.1),
        "wo_mlp": n(L, f, d, std=0.1), "bo_mlp": n(L, d, std=0.1),
    }
    return {"wte": n(v, d), "wpe": n(jcfg.max_seq_len, d), "blocks": blocks,
            "lnf_scale": 1 + n(d, std=0.1), "lnf_bias": n(d, std=0.1)}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = tiny_configs()
    tree = tiny_params(jcfg)
    jparams = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in tree.items()}
    return jcfg, jparams, tcfg, convert.from_jax_params(tree)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _assert_cache(tcache, jcache):
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=TOL, rtol=TOL)
    assert tcache.length == int(jcache.length)


def test_forward_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 24, 0)
    ref = np.asarray(jgpt.apply(jp, jnp.asarray(toks), jcfg))
    out = gpt.apply(tp, _t(toks), tcfg).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_prefill_logits_and_cache_match_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 20, 1)
    jlg, jc = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                           jinf.init_cache(jcfg, 2, 64))
    tlg, tc = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 64))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_cache(tc, jc)
    # logits_at computes only the asked rows, with the same values
    at = torch.tensor([19, 7])
    tlg2, _ = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 64),
                           logits_at=at)
    np.testing.assert_allclose(tlg2.numpy(), np.asarray(jlg)[[0, 1], [19, 7]],
                               atol=TOL, rtol=TOL)


def test_extend_scalar_matches_jax_and_full_prefill(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 28, 2)
    jc = jinf.prefill(jp, jnp.asarray(toks[:, :16]), jcfg,
                      jinf.init_cache(jcfg, 2, 64))[1]
    jlg, jc = jinf.extend(jp, jnp.asarray(toks[:, 16:]), jcfg, jc)
    tc = tinf.prefill(tp, _t(toks[:, :16]), tcfg,
                      tinf.init_cache(tcfg, 2, 64))[1]
    tlg, tc = tinf.extend(tp, _t(toks[:, 16:]), tcfg, tc)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_cache(tc, jc)
    full = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 64))[0]
    np.testing.assert_allclose(tlg.numpy(), full[:, 16:].numpy(), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="overflows"):
        tinf.extend(tp, _t(_tokens(2, 40, 3)), tcfg, tc)


def test_extend_ragged_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 12, 4)
    chunk = _tokens(2, 4, 5)
    lengths = [5, 9]
    jc = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                      jinf.init_cache(jcfg, 2, 32))[1]
    jlg, jc = jinf.extend(jp, jnp.asarray(chunk), jcfg, jc,
                          lengths=jnp.asarray(lengths, jnp.int32))
    tc = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 32))[1]
    tlg, tc = tinf.extend(tp, _t(chunk), tcfg, tc, lengths=lengths)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_cache(tc, jc)


def test_decode_step_ragged_and_scalar_match_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 14, 6)
    jc = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                      jinf.init_cache(jcfg, 2, 32))[1]
    tc = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 2, 32))[1]
    nxt = np.asarray([3, 77], np.int32)
    jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), jcfg, jc,
                               lengths=jnp.asarray([7, 11], jnp.int32))
    tlg, tc = tinf.decode_step(tp, _t(nxt), tcfg, tc, lengths=[7, 11])
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_cache(tc, jc)
    jlg, jc = jinf.decode_step(jp, jnp.asarray(nxt), jcfg, jc)
    tlg, tc = tinf.decode_step(tp, _t(nxt), tcfg, tc)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _assert_cache(tc, jc)


def test_slot_ops_round_trip_match_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(1, 9, 7)
    jsmall = jinf.prefill(jp, jnp.asarray(toks), jcfg,
                          jinf.init_cache(jcfg, 1, 32))[1]
    tsmall = tinf.prefill(tp, _t(toks), tcfg, tinf.init_cache(tcfg, 1, 32))[1]
    jbig = jinf.write_slot(jinf.init_cache(jcfg, 3, 32), jnp.asarray(1),
                           jsmall)
    tbig = tinf.write_slot(tinf.init_cache(tcfg, 3, 32), 1, tsmall)
    _assert_cache(tbig, jbig)
    assert not tbig.k[:, 0].any() and not tbig.k[:, 2].any()
    jback = jinf.read_slot(jbig, jnp.asarray(1), length=9)
    tback = tinf.read_slot(tbig, 1, length=9)
    _assert_cache(tback, jback)
    # read_slot is a copy: later writes to the slot cache do not reach it
    tinf.reset_slot(tbig, 1)
    _assert_cache(tback, jback)
    jbig = jinf.reset_slot(jbig, jnp.asarray(1))
    _assert_cache(tbig, jbig)
    assert not tbig.k.any()
    with pytest.raises(ValueError, match="max_len"):
        tinf.write_slot(tinf.init_cache(tcfg, 3, 16), 0, tsmall)


def test_config_from_jax_refuses_act_quant_bits():
    """A JAX config with activation fake-quant raises rather than
    converting to a port config that silently serves without it."""
    import dataclasses
    jcfg, _ = tiny_configs()
    with pytest.raises(NotImplementedError, match="act_quant_bits=4"):
        convert.config_from_jax(dataclasses.replace(jcfg, act_quant_bits=4))


def test_config_from_jax_with_act_quant_bits_none_converts(model):
    """``act_quant_bits=None`` (the default) still converts, and the
    converted model gives the JAX logits."""
    import dataclasses
    jcfg, jp, _, tp = model
    jcfg = dataclasses.replace(jcfg, act_quant_bits=None)
    tcfg = convert.config_from_jax(jcfg)
    toks = _tokens(2, 16, 3)
    np.testing.assert_allclose(
        gpt.apply(tp, _t(toks), tcfg).numpy(),
        np.asarray(jgpt.apply(jp, jnp.asarray(toks), jcfg)),
        atol=TOL, rtol=TOL)
