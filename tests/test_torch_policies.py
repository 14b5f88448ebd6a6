"""The port's HF decoder policies against the JAX package's, on
random-init ``transformers`` models (nothing is downloaded): the same
arrays exactly (fp32), and ``init_inference(model=hf_model)`` logits equal
to the JAX engine's and HF's own at 3e-4 (the JAX tests' parity
tolerance), for GPT-2, GPT-Neo, OPT, BLOOM, GPT-NeoX and GPT-J; and OPT's
two refused layouts, refused by both packages.  The encoder policies:
BERT (``BertForMaskedLM``, ``BertModel``) and the CLIP text tower convert
to the JAX policies' arrays exactly, and ``gpt.encode`` of the converted
CLIP tower equals JAX's ``gpt.encode`` and HF's ``last_hidden_state`` at
2e-4 (the JAX CLIP test's tolerance)."""

import types

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.module_inject import replace_policy as jpol
from deepspeed_tpu_torch.models import convert, gpt
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


CLIP_TOL = 2e-4


def _bert(cls):
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(5)
    return getattr(transformers, cls)(cfg).eval()


@pytest.mark.parametrize("cls", ["BertForMaskedLM", "BertModel"])
def test_bert_policy_converts_to_the_jax_arrays(cls):
    """Transposed linears, q/k/v stacked per head, the vocabulary padded
    (120 → 128), the ``bert.`` prefix optional; a bare ``BertModel`` gets
    the identity MLM transform and a zero vocabulary bias."""
    hf = _bert(cls)
    sd = hf.state_dict()
    assert jpol.HFBertLayerPolicy.match(sd) and tpol.HFBertLayerPolicy.match(sd)
    jcfg, jparams = jpol.convert_hf_bert(hf)
    tcfg, tparams = tpol.convert_hf_bert(hf)
    assert tcfg == convert.bert_config_from_jax(jcfg, dtype=tcfg.dtype)
    want, got = _flat(jparams), _flat(convert.to_numpy_params(tparams))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["wte"].shape == (128, 64)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in tparams["blocks"].values())


def _clip():
    cfg = transformers.CLIPTextConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=32, hidden_act="quick_gelu")
    torch.manual_seed(6)
    return transformers.CLIPTextModel(cfg).eval()


def test_clip_text_tower_matches_jax_and_hf():
    hf = _clip()
    jcfg, jparams = jpol.convert_hf_clip_text(hf)
    tcfg, tparams = tpol.convert_hf_clip_text(hf)
    assert tcfg == convert.config_from_jax(jcfg, dtype=tcfg.dtype)
    assert tcfg.activation == "quick_gelu"
    want, got = _flat(jparams), _flat(convert.to_numpy_params(tparams))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    tokens = np.random.default_rng(7).integers(0, 128, size=(2, 32))
    tokens[1, 5:] = 127                     # a short prompt, end-padded
    jout = np.asarray(jgpt.encode(jparams, tokens, jcfg))
    tout = gpt.encode(tparams, torch.as_tensor(tokens), tcfg).numpy()
    np.testing.assert_allclose(tout, jout, atol=CLIP_TOL, rtol=CLIP_TOL)
    with torch.no_grad():
        hf_out = hf(torch.as_tensor(tokens)).last_hidden_state.numpy()
    np.testing.assert_allclose(tout, hf_out, atol=CLIP_TOL, rtol=CLIP_TOL)


def test_clip_policy_reads_a_full_clip_config_and_bare_keys():
    """A ``CLIPModel`` config is read through its ``text_config``; a bare
    text-model state dict gets the ``text_model.`` prefix; an activation
    other than quick-GeLU maps to the erf GeLU."""
    hf = _clip()
    full = types.SimpleNamespace(text_config=hf.config)
    assert tpol.HFCLIPLayerPolicy.model_config(full) == \
        tpol.HFCLIPLayerPolicy.model_config(hf.config)
    bare = types.SimpleNamespace(
        config=hf.config,
        state_dict=lambda: {k[len("text_model."):]: v
                            for k, v in hf.state_dict().items()})
    cfg, params = tpol.convert_hf_clip_text(bare)
    _, want = tpol.convert_hf_clip_text(hf)
    for key, w in _flat(convert.to_numpy_params(want)).items():
        np.testing.assert_array_equal(
            _flat(convert.to_numpy_params(params))[key], w, err_msg=key)
    gelu = types.SimpleNamespace(**{**vars(hf.config), "hidden_act": "gelu"})
    assert tpol.HFCLIPLayerPolicy.model_config(gelu).activation == "gelu_exact"
    assert jpol.HFCLIPLayerPolicy.model_config(gelu).activation == "gelu_exact"
