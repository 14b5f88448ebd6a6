"""The port's encoder serving (``BertInferenceEngine`` through
``init_inference``, plain path, CPU) against the JAX package's engine on
the same params and seeded numpy batches.

One JAX fp32 engine per module gives every reference (``forward``,
``encode``, ``pooled``, with and without a padded ``attention_mask``);
the port's engines come from a ``(BertConfig, params)`` tuple, a
``ModelSpec`` and ``transformers`` BERT modules (random init, nothing is
downloaded).  Tolerances: fp32 outputs 1e-5 (the JAX test's), HF logits
2e-4 (the JAX test's HF parity); ``save_16bit_model`` files (of the BERT
engine and of the GPT engine, on a tiny GPT-2) key by key
bitwise in bf16, and in int8 bitwise but where JAX's jitted quantizer
(a multiply by the reciprocal, ROADMAP.md Queue 3) puts a code 1 off:
there within one quantization step and the bf16 roundings; the int8
engine's mean absolute log-softmax drift below 0.05 (the JAX test's
bound) against bf16 and against JAX's int8 engine."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import BertInferenceEngine as JaxBertEngine
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference.engine import (BertInferenceEngine,
                                                  InferenceEngine)
from deepspeed_tpu_torch.inference.quantization import Int8Param
from deepspeed_tpu_torch.models import bert, convert, gpt
from deepspeed_tpu_torch.runtime.model import from_bert, from_gpt

JCFG = jbert.BertConfig(vocab_size=256, max_seq_len=64, n_layer=2, n_head=4,
                        d_model=64, dtype=jnp.float32)
CFG = convert.bert_config_from_jax(JCFG)
TOL = 1e-5
HF_TOL = 2e-4
DRIFT_MAX = 0.05
SURFACES = ("forward", "encode", "pooled")
#: the leaves the int8 engines store as codes and scales
INT8_KEYS = {f"['blocks']['{n}']" for n in ("wqkv", "wo", "wi", "wo_mlp")}


def _mask():
    mask = np.ones((2, 32), np.int32)
    mask[0, 20:] = 0
    return mask


@pytest.fixture(scope="module")
def ref():
    """The JAX fp32 engine's outputs on one seeded batch, unmasked and
    masked, and the JAX params as numpy arrays."""
    params = jax.device_get(jbert.init(JCFG, jax.random.PRNGKey(0)))
    jeng = deepspeed_tpu.init_inference(model=(JCFG, params),
                                        config={"dtype": "float32"})
    assert isinstance(jeng, JaxBertEngine)
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 32))
    out = {(name, masked): np.asarray(getattr(jeng, name)(
        tokens, attention_mask=_mask() if masked else None))
        for name in SURFACES for masked in (False, True)}
    return {"params": params, "tokens": tokens, "out": out}


def _engine(ref, dtype="float32", **kw):
    return deepspeed_tpu_torch.init_inference(
        (CFG, convert.from_jax_params(ref["params"])), {"dtype": dtype},
        device="cpu", **kw)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", SURFACES)
def test_tuple_engine_matches_jax(ref, name, masked):
    eng = _engine(ref)
    assert isinstance(eng, BertInferenceEngine)
    got = getattr(eng, name)(ref["tokens"],
                             attention_mask=_mask() if masked else None)
    want = ref["out"][(name, masked)]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_masks_route_as_the_jax_engine(ref, monkeypatch):
    """An all-ones mask is the unmasked program (bitwise equal, the flash
    op); a padded mask takes the dense path and changes the result."""
    flash_calls = []
    real = bert.flash_attention_qkv
    monkeypatch.setattr(bert, "flash_attention_qkv",
                        lambda *a, **k: flash_calls.append(1) or real(*a, **k))
    eng, tokens = _engine(ref), ref["tokens"]
    plain = eng(tokens)
    assert len(flash_calls) == CFG.n_layer
    ones = eng(tokens, attention_mask=np.ones_like(tokens))
    assert len(flash_calls) == 2 * CFG.n_layer
    assert torch.equal(ones, plain)
    masked = eng(tokens, attention_mask=torch.as_tensor(_mask()))
    assert len(flash_calls) == 2 * CFG.n_layer
    assert not torch.allclose(masked, plain)


def test_model_spec_dispatch(ref):
    """A BERT ModelSpec with params serves through the encoder engine, a
    GPT one through InferenceEngine, both equal to their tuple engines;
    a ModelSpec without params fails as the JAX assertion does."""
    tparams = convert.from_jax_params(ref["params"])
    spec = dataclasses.replace(from_bert(CFG), params=tparams)
    eng = deepspeed_tpu_torch.init_inference(spec, {"dtype": "float32"},
                                             device="cpu")
    assert isinstance(eng, BertInferenceEngine)
    assert torch.equal(eng(ref["tokens"]), _engine(ref)(ref["tokens"]))
    gcfg = gpt.GPTConfig(vocab_size=256, max_seq_len=64, n_layer=2,
                         n_head=2, d_model=64, dtype=torch.float32)
    gparams = gpt.init(gcfg, torch.Generator().manual_seed(0))
    geng = deepspeed_tpu_torch.init_inference(
        dataclasses.replace(from_gpt(gcfg), params=gparams),
        {"dtype": "float32"}, device="cpu")
    assert isinstance(geng, InferenceEngine)
    want = deepspeed_tpu_torch.init_inference(
        (gcfg, gparams), {"dtype": "float32"}, device="cpu")
    assert torch.equal(geng(ref["tokens"]), want(ref["tokens"]))
    with pytest.raises(AssertionError, match="materialized params"):
        deepspeed_tpu_torch.init_inference(from_bert(CFG), device="cpu")


@pytest.mark.parametrize("config", [
    {"dtype": "int8", "quant": {"int8_compute": True}},
    {"kv_cache_dtype": "int8"}], ids=["int8_compute", "kv_cache_dtype"])
def test_refusals_carry_the_jax_messages(ref, config):
    with pytest.raises(NotImplementedError) as jerr:
        deepspeed_tpu.init_inference(model=(JCFG, ref["params"]),
                                     config=config)
    with pytest.raises(NotImplementedError) as terr:
        deepspeed_tpu_torch.init_inference(
            (CFG, convert.from_jax_params(ref["params"])), config,
            device="cpu")
    assert str(terr.value) == str(jerr.value)


#: the GPT engine's save: a tiny GPT-2 of the JAX package
JGPT = jgpt.GPTConfig(vocab_size=256, max_seq_len=64, n_layer=2, n_head=2,
                      d_model=64, dtype=jnp.float32)


@pytest.fixture(scope="module")
def served16(ref, tmp_path_factory):
    """The JAX package's bf16 and int8 engines (BERT, and the tiny GPT on
    its own params): their ``save_16bit_model`` files, and the BERT int8
    engine's logits."""
    root = tmp_path_factory.mktemp("save16")
    gparams = jax.device_get(jgpt.init(JGPT, jax.random.PRNGKey(2)))
    out = {"gpt_params": gparams}
    for family, model in (("bert", (JCFG, ref["params"])),
                          ("gpt", (JGPT, gparams))):
        for dtype in ("bfloat16", "int8"):
            jeng = deepspeed_tpu.init_inference(model=model,
                                                config={"dtype": dtype})
            path = str(root / f"jax_{family}_{dtype}.npz")
            jeng.save_16bit_model(path)
            out[(family, dtype)] = path
            if family == "bert" and dtype == "int8":
                out["logits"] = np.asarray(jeng(ref["tokens"]), np.float32)
    return out


def _bits(a):
    return a.view(np.uint16) if a.dtype.kind == "V" else a


def _bf16(a):
    """A ``|V2`` bf16 array as fp32 values."""
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_save_16bit_model_matches_jax_file(ref, served16, family, dtype,
                                           tmp_path):
    if family == "bert":
        eng = _engine(ref, dtype)
    else:
        eng = deepspeed_tpu_torch.init_inference(
            (convert.config_from_jax(JGPT),
             convert.from_jax_params(served16["gpt_params"])),
            {"dtype": dtype}, device="cpu")
        assert isinstance(eng, InferenceEngine)
    # a layer-stacked leaf held as per-layer pieces saves as one array
    wi = eng.params["blocks"]["wi"]
    eng.params["blocks"]["wi"] = [wi[i] for i in range(wi.shape[0])]
    path = str(tmp_path / "port.npz")
    eng.save_16bit_model(path)
    with np.load(served16[(family, dtype)]) as zj, np.load(path) as zt:
        assert zt.files == zj.files
        assert "['blocks']['wqkv']" in zt.files
        for key in zj.files:
            want, got = zj[key], zt[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert got.dtype != np.int8, key
            if dtype == "bfloat16" or key not in INT8_KEYS:
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=key)
            else:
                # a code within 1 (test_torch_quantizer.assert_jit_close)
                # moves the weight by one quantization step (the row's
                # absmax / 127) and each side's bf16 rounding
                g, w = _bf16(got), _bf16(want)
                step = np.abs(w).max(axis=-1, keepdims=True) / 127
                assert (np.abs(g - w) <= step * 1.01
                        + np.abs(w) * 2.0 ** -7).all(), key
                assert (g == w).mean() > 0.99, key


def _lsm(x):
    x = torch.as_tensor(np.array(x, np.float32))[..., :JCFG.vocab_size]
    return torch.log_softmax(x, dim=-1)


def test_int8_engine_weights_and_drift(ref, served16):
    eng8, eng16 = _engine(ref, "int8"), _engine(ref, "bfloat16")
    blocks = eng8.params["blocks"]
    assert {k for k, v in blocks.items() if isinstance(v, Int8Param)} == \
        {"wqkv", "wo", "wi", "wo_mlp"}
    assert blocks["wqkv"].q.dtype == torch.int8
    assert eng8.model_config.dtype == torch.bfloat16
    # the codes dequantize to the bf16 engine's weights within a step
    w16 = eng16.params["blocks"]["wi"].float()
    step = blocks["wi"].scale
    assert (blocks["wi"].to(torch.float32) - w16).abs().le(
        step * 0.5 + 1e-6).all()
    l8 = eng8(ref["tokens"])
    assert l8.dtype == torch.float32
    vs_bf16 = (_lsm(l8) - _lsm(eng16(ref["tokens"]))).abs().mean().item()
    vs_jax = (_lsm(l8) - _lsm(served16["logits"])).abs().mean().item()
    assert vs_bf16 < DRIFT_MAX and vs_jax < DRIFT_MAX, (vs_bf16, vs_jax)


def _transformers():
    return pytest.importorskip("transformers")


def _hf_config(**kw):
    return _transformers().BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw)


def _hf(cls, seed=0):
    torch.manual_seed(seed)
    return getattr(_transformers(), cls)(_hf_config()).eval()


@pytest.mark.parametrize("cls", ["BertForMaskedLM", "BertModel"])
def test_hf_bert_dispatch_matches_hf(cls):
    hf = _hf(cls)
    eng = deepspeed_tpu_torch.init_inference(hf, {"dtype": "float32"},
                                             device="cpu")
    assert isinstance(eng, BertInferenceEngine)
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 10:] = 0
    with torch.no_grad():
        out = hf(torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask))
    if cls == "BertForMaskedLM":
        got = eng(tokens, attention_mask=mask)[:, :, :128]
        np.testing.assert_allclose(got.numpy(), out.logits.numpy(),
                                   atol=HF_TOL, rtol=HF_TOL)
    else:
        np.testing.assert_allclose(
            eng.encode(tokens, attention_mask=mask).numpy(),
            out.last_hidden_state.numpy(), atol=HF_TOL, rtol=HF_TOL)
        np.testing.assert_allclose(
            eng.pooled(tokens, attention_mask=mask).numpy(),
            out.pooler_output.numpy(), atol=HF_TOL, rtol=HF_TOL)


@pytest.mark.parametrize("make", [
    lambda: _hf("BertForSequenceClassification"),
    lambda: _hf("BertForQuestionAnswering"),
    lambda: _transformers().RobertaForMaskedLM(
        _transformers().RobertaConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=80)).eval()],
    ids=["classifier", "qa_outputs", "roberta"])
def test_unconvertible_bert_falls_through(make):
    """Task heads, and BERT-keyed families with other embeddings, are not
    served as BERT: no policy takes them."""
    hf = make()
    with pytest.raises(TypeError, match="init_inference takes"):
        deepspeed_tpu_torch.init_inference(hf, {"dtype": "float32"},
                                           device="cpu")
