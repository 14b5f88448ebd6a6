"""The port's ``init_inference``/``InferenceEngine.generate`` (CPU) against
the JAX package's engine on a tiny fp32 model: greedy tokens equal for
uniform and ragged prompts and under ``eos_token_id``; ``filter_logits``
equal over a grid; sampling reproducible under a fixed generator; the
config options that are not ported raise (int8 serving:
``test_torch_int8_serving.py``)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.sampling import filter_logits as jax_filter
from deepspeed_tpu_torch.inference.sampling import filter_logits
from deepspeed_tpu_torch.models import convert

from .test_torch_gpt_inference import tiny_configs, tiny_params


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = tiny_configs()
    tree = tiny_params(jcfg, seed=1)
    jparams = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in tree.items()}
    jeng = deepspeed_tpu.init_inference(model=(jcfg, jparams),
                                        config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(
        model=(tcfg, convert.from_jax_params(tree)),
        config={"dtype": "float32"}, device="cpu")
    return jeng, teng


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _assert_varied(out):
    """Equal tokens prove little if each row repeats one token."""
    for row in np.asarray(out):
        assert len(set(row.tolist())) >= 3, row


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_equals_jax(engines, ragged):
    jeng, teng = engines
    toks = _prompts(3, 16, 2)
    lens = [16, 9, 4] if ragged else None
    ref = np.asarray(jeng.generate(toks, max_new_tokens=12,
                                   prompt_lens=lens))
    out = teng.generate(toks, max_new_tokens=12, prompt_lens=lens).numpy()
    np.testing.assert_array_equal(out, ref)
    _assert_varied(out)


def test_greedy_generate_eos_equals_jax(engines):
    jeng, teng = engines
    toks = _prompts(2, 10, 3)
    plain = teng.generate(toks, max_new_tokens=10).numpy()
    eos = int(plain[0, 3])      # row 0 emits it early, so rows stop apart
    ref = np.asarray(jeng.generate(toks, max_new_tokens=10,
                                   eos_token_id=eos))
    out = teng.generate(toks, max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[0, 3:] == eos).all()


@pytest.mark.parametrize("top_k", [0, 1, 7])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3, 0.0, -0.5])
def test_filter_logits_matches_jax(top_k, top_p):
    lg = np.random.default_rng(top_k).standard_normal((4, 50)).astype(
        np.float32) * 3
    for temperature in (0.5, 1.0, 2.0):
        ref = np.asarray(jax_filter(jnp.asarray(lg), temperature,
                                    top_k=top_k, top_p=top_p))
        out = filter_logits(torch.from_numpy(lg), temperature, top_k=top_k,
                            top_p=top_p).numpy()
        np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
        keep = np.isfinite(ref)
        np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6)
        assert keep.any(axis=-1).all()


def test_sampled_generate_is_reproducible(engines):
    _, teng = engines
    toks = _prompts(2, 8, 4)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return teng.generate(toks, max_new_tokens=10, do_sample=True,
                             top_k=50, top_p=0.9, generator=gen).numpy()

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert a.max() < 512


@pytest.mark.parametrize("config,match", [
    ({"dtype": "int8", "quant": {"int8_compute": True}}, "int8"),
    ({"moe": {"ep_size": 2}}, "expert-parallel"),
    ({"tensor_parallel": {"tp_size": 2}}, "tensor-parallel"),
])
def test_unported_config_options_raise(engines, config, match):
    _, teng = engines
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.init_inference(
            model=(teng.model_config, teng.params), config=config,
            device="cpu")


def test_unknown_config_key_raises(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="unknown config keys"):
        deepspeed_tpu_torch.init_inference(
            model=(teng.model_config, teng.params),
            config={"dtype": "float32", "no_such_key": 1}, device="cpu")
