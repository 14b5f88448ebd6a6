"""The port's HF decoder policies against the JAX package's, on
random-init ``transformers`` models (nothing is downloaded): the same
arrays exactly (fp32), and ``init_inference(model=hf_model)`` logits equal
to the JAX engine's and HF's own at 3e-4 (the JAX tests' parity
tolerance), for GPT-2, GPT-Neo, OPT, BLOOM, GPT-NeoX and GPT-J; and OPT's
two refused layouts, refused by both packages."""

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.module_inject import replace_policy as jpol
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.module_inject import replace_policy as tpol

transformers = pytest.importorskip("transformers")
import torch  # noqa: E402

ATOL = 3e-4


def _gpt2():
    cfg = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32,
                                  n_layer=2, n_head=2, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg)


def _neo():
    cfg = transformers.GPTNeoConfig(
        vocab_size=128, max_position_embeddings=64, hidden_size=32,
        num_layers=2, num_heads=2, attention_types=[[["global", "local"], 1]],
        window_size=4, intermediate_size=64, resid_dropout=0.0,
        embed_dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(3)
    return transformers.GPTNeoForCausalLM(cfg)


def _bloom(heads=2, hidden=32):
    cfg = transformers.BloomConfig(vocab_size=128, hidden_size=hidden,
                                   n_layer=2, n_head=heads,
                                   hidden_dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(2)
    return transformers.BloomForCausalLM(cfg)


def _opt(**layout):
    kw = dict(word_embed_proj_dim=32, do_layer_norm_before=True)
    kw.update(layout)
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, ffn_dim=64, max_position_embeddings=64,
        dropout=0.0, attention_dropout=0.0, activation_function="relu", **kw)
    torch.manual_seed(1)
    return transformers.OPTForCausalLM(cfg)


def _neox():
    cfg = transformers.GPTNeoXConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=True, hidden_dropout=0.0,
        attention_dropout=0.0)
    torch.manual_seed(3)
    return transformers.GPTNeoXForCausalLM(cfg)


def _gptj():
    cfg = transformers.GPTJConfig(vocab_size=128, n_positions=64, n_embd=32,
                                  n_layer=2, n_head=2, rotary_dim=8,
                                  resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    torch.manual_seed(4)
    model = transformers.GPTJForCausalLM(cfg)
    with torch.no_grad():   # HF initialises the head's bias to zero
        model.lm_head.bias.normal_(0.0, 0.02)
    return model


MODELS = {"gpt2": (_gpt2, "HFGPT2LayerPolicy"),
          "neo": (_neo, "HFGPTNEOLayerPolicy"),
          "opt": (_opt, "HFOPTLayerPolicy"),
          "bloom": (_bloom, "BLOOMLayerPolicy"),
          "bloom_6_heads": (lambda: _bloom(6, 48), "BLOOMLayerPolicy"),
          "neox": (_neox, "GPTNEOXLayerPolicy"),
          "gptj": (_gptj, "HFGPTJLayerPolicy")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_policy_converts_to_the_jax_arrays(name):
    make, policy = MODELS[name]
    hf = make().eval()
    sd = hf.state_dict()
    jp, tp = getattr(jpol, policy), getattr(tpol, policy)
    assert jp.match(sd) and tp.match(sd)
    jcfg = jp.model_config(hf.config)
    tcfg = tp.model_config(hf.config)
    assert tcfg == convert.config_from_jax(jcfg, dtype=tcfg.dtype)
    want = _flat(jp.convert(sd, jcfg))
    got = _flat(convert.to_numpy_params(tp.convert(sd, tcfg)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_inference_matches_jax_engine(name):
    hf = MODELS[name][0]().eval()
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    jeng = deepspeed_tpu.init_inference(model=hf, config={"dtype": "float32"})
    teng = deepspeed_tpu_torch.init_inference(
        model=hf, config={"dtype": "float32"}, device="cpu")
    ref = np.asarray(jeng(tokens))[:, :, :128]
    got = teng(tokens).numpy()[:, :, :128]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    with torch.no_grad():
        hf_logits = hf(torch.as_tensor(tokens)).logits.numpy()
    np.testing.assert_allclose(got, hf_logits, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("layout", [{"word_embed_proj_dim": 16},
                                    {"do_layer_norm_before": False}],
                         ids=["embedding_projection", "post_ln"])
def test_opt_layouts_the_jax_policy_refuses_are_refused(layout):
    """OPT with embedding projections, and OPT-350m's post-LN layout: the
    JAX policy asserts them away, the port's raises."""
    hf = _opt(**layout).eval()
    assert tpol.match_decoder(hf.state_dict()) is tpol.HFOPTLayerPolicy
    with pytest.raises(AssertionError):
        jpol.HFOPTLayerPolicy.model_config(hf.config)
    with pytest.raises(NotImplementedError, match="not supported"):
        deepspeed_tpu_torch.init_inference(
            model=hf, config={"dtype": "float32"}, device="cpu")
