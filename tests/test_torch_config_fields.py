"""Every field of the JAX package's ``GPTConfig`` and ``BertConfig``
crosses ``convert.config_from_jax`` / ``bert_config_from_jax``: set to a
value other than its default, it is either carried into the port's
config or refused with an error.  A field that stays behind silently
must be on ``INERT`` with its reason; a field the JAX package adds later
fails ``test_every_field_has_a_case`` until it gets a case here."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.models import convert

#: a small valid config each case starts from
GPT_BASE = {"vocab_size": 256, "max_seq_len": 64, "n_layer": 2, "n_head": 2,
            "d_model": 64}
BERT_BASE = dict(GPT_BASE)

#: a value other than the default for every field of the JAX GPTConfig
GPT_CASES = {
    "vocab_size": 300, "max_seq_len": 48, "n_layer": 3, "n_head": 4,
    "d_model": 128, "d_ff": 96, "dtype": jnp.float32,
    "param_dtype": jnp.bfloat16, "dropout": 0.1, "remat": True,
    "remat_policy": "attn_out", "scan_unroll": 2, "loss_chunk": 16,
    "use_flash_attention": False, "vocab_round_to": 64,
    "sequence_parallel": "ring", "act_quant_bits": 8,
    "act_quant_symmetric": False,
    "sparse_attention": FixedSparsityConfig(num_heads=2, block=16),
    "pos_embed": "rotary", "rotary_pct": 0.5, "rotary_base": 500.0,
    "rotary_interleaved": True, "activation": "relu",
    "parallel_residual": True, "attn_softmax_scale": 0.5,
    "local_attention_window": 8, "local_attention_alternating": True,
    "tie_word_embeddings": False, "lm_head_bias": True, "pos_offset": 2,
    "embed_layernorm": True}

#: the same for every field of the JAX BertConfig
BERT_CASES = {
    "vocab_size": 300, "max_seq_len": 48, "type_vocab_size": 3,
    "n_layer": 3, "n_head": 4, "d_model": 128, "d_ff": 96,
    "dtype": jnp.float32, "param_dtype": jnp.bfloat16,
    "layer_norm_eps": 1e-5, "dropout": 0.1, "attn_dropout": 0.1,
    "remat": True, "use_flash_attention": False, "vocab_round_to": 64}

#: fields the port does not carry, harmless by design, each with its reason
INERT = {
    "scan_unroll": "an XLA schedule knob of lax.scan; the port's layer "
                   "loop is eager Python",
    "use_flash_attention": "False takes JAX's mha_reference, the same math "
                           "as the port's flash kernels",
    "sequence_parallel": "acts only when the mesh's seq axis is > 1; the "
                         "port runs on one device",
    "act_quant_symmetric": "qualifies act_quant_bits, which the converter "
                           "refuses unless None",
    "rotary_pct": "qualifies pos_embed='rotary', which the port refuses",
    "rotary_base": "qualifies pos_embed='rotary', which the port refuses",
    "rotary_interleaved": "qualifies pos_embed='rotary', which the port "
                          "refuses",
}

#: JAX dtype fields, carried as the torch dtype of the same name
DTYPES = ("dtype", "param_dtype")


def _expected(name, value):
    return convert._torch_dtype(value) if name in DTYPES else value


def _walk(jax_cls, port_from_jax, base, name, value):
    jcfg = jax_cls(**{**base, name: value})
    assert getattr(jcfg, name) != getattr(jax_cls(**base), name)
    try:
        port = port_from_jax(jcfg)
    except (NotImplementedError, ValueError, TypeError):
        assert name not in INERT, f"{name} is on INERT but refused"
        return
    if name in INERT:
        return
    got = getattr(port, name)
    if name == "sparse_attention":
        assert type(got).__name__ == type(value).__name__
        assert vars(got) == vars(value)
    else:
        assert got == _expected(name, value), (name, got, value)


@pytest.mark.parametrize("jax_cls,cases", [(jgpt.GPTConfig, GPT_CASES),
                                           (jbert.BertConfig, BERT_CASES)])
def test_every_field_has_a_case(jax_cls, cases):
    fields = {f.name for f in dataclasses.fields(jax_cls)}
    assert fields == set(cases), (
        f"fields without a case: {fields - set(cases)}; cases without a "
        f"field: {set(cases) - fields}")


@pytest.mark.parametrize("name", sorted(GPT_CASES))
def test_gpt_field_is_carried_or_refused(name):
    _walk(jgpt.GPTConfig, convert.config_from_jax, GPT_BASE, name,
          GPT_CASES[name])


@pytest.mark.parametrize("name", sorted(BERT_CASES))
def test_bert_field_is_carried_or_refused(name):
    _walk(jbert.BertConfig, convert.bert_config_from_jax, BERT_BASE, name,
          BERT_CASES[name])


@pytest.mark.parametrize("fields", [
    {"pos_embed": "alibi", "embed_layernorm": True},
    {"local_attention_window": 256, "local_attention_alternating": True,
     "attn_softmax_scale": 1.0},
    {"local_attention_window": 4}])
def test_gpt_family_fields_are_carried(fields):
    """BLOOM's and GPT-Neo's fields cross together (the walk above sets one
    field at a time, and its pos_embed case is the refused rotary)."""
    port = convert.config_from_jax(jgpt.GPTConfig(**GPT_BASE, **fields))
    for name, value in fields.items():
        assert getattr(port, name) == value, (name, getattr(port, name))


def test_param_dtype_is_carried():
    """The fault this walk was written for: bf16 master weights converted
    to fp32."""
    jcfg = jgpt.GPTConfig(**GPT_BASE, param_dtype=jnp.bfloat16)
    assert convert.config_from_jax(jcfg).param_dtype == torch.bfloat16
    jb = jbert.BertConfig(**BERT_BASE, param_dtype=jnp.bfloat16)
    assert convert.bert_config_from_jax(jb).param_dtype == torch.bfloat16
