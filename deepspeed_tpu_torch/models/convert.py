"""Weight and config conversion between the JAX package's models (GPT,
BERT) and the port.

The port keeps the JAX parameter tree and layouts, so conversion is a
re-wrap both ways: :func:`from_jax_params` takes the tree as numpy arrays
(what ``jax.device_get(params)`` returns) and builds the same tree of
torch tensors; :func:`to_numpy_params` turns a port tree back into numpy
arrays, so trained weights compare either way.  A JAX ``Int8Param`` leaf
(int8 serving: codes and scales) becomes the port's
:class:`~deepspeed_tpu_torch.inference.quantization.Int8Param`.  Nothing
here imports JAX.
"""

from __future__ import annotations

import inspect
from typing import Any, Mapping

import numpy as np
import torch

from ..inference.quantization import Int8Param
from ..ops.sparse_attention import sparsity_config
from . import bert, gpt

_CONFIG_FIELDS = ("vocab_size", "max_seq_len", "n_layer", "n_head", "d_model",
                  "d_ff", "vocab_round_to", "attn_softmax_scale", "pos_embed",
                  "activation", "parallel_residual", "local_attention_window",
                  "tie_word_embeddings", "lm_head_bias", "pos_offset",
                  "embed_layernorm", "dropout", "remat", "remat_policy",
                  "loss_chunk")


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy/JAX dtype (or its name) as the torch dtype."""
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}[name]


def from_jax_params(tree: Mapping[str, Any], device=None,
                    dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays → the same nested dict of tensors on
    ``device``.  Float arrays (bfloat16 included) become ``dtype`` (fp32
    when None); integer arrays keep their type; an ``Int8Param`` (duck
    typed: ``q`` and ``scale``) keeps int8 codes and fp32 scales."""
    def leaf(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return Int8Param(
                q=torch.from_numpy(np.array(x.q, dtype=np.int8)).to(device),
                scale=torch.from_numpy(np.array(x.scale, dtype=np.float32))
                .to(device))
        # a copy: jax.device_get hands out read-only arrays
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(np.array(a)).to(device)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dtype or torch.float32)

    return {k: from_jax_params(v, device, dtype) if isinstance(v, Mapping)
            else leaf(v) for k, v in tree.items()}


def to_numpy_params(tree: Mapping[str, Any]) -> dict:
    """Nested dict of tensors → the same nested dict of numpy arrays
    (16-bit floats widened to fp32; a list of per-layer tensors stacked on
    dim 0)."""
    def leaf(x):
        if isinstance(x, (list, tuple)):
            x = torch.stack(list(x))
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype != torch.float32:
            x = x.float()
        return x.numpy()

    return {k: to_numpy_params(v) if isinstance(v, Mapping) else leaf(v)
            for k, v in tree.items()}


def config_from_jax(jax_config, dtype=None) -> gpt.GPTConfig:
    """The port's ``GPTConfig`` with the fields of a JAX ``GPTConfig``;
    ``dtype`` defaults to the JAX config's compute dtype."""
    fields = {f: getattr(jax_config, f) for f in _CONFIG_FIELDS}
    return gpt.GPTConfig(
        dtype=dtype if dtype is not None else _torch_dtype(jax_config.dtype),
        sparse_attention=sparsity_from_jax(jax_config.sparse_attention),
        **fields)


_BERT_CONFIG_FIELDS = ("vocab_size", "max_seq_len", "type_vocab_size",
                       "n_layer", "n_head", "d_model", "d_ff",
                       "layer_norm_eps", "dropout", "attn_dropout", "remat",
                       "use_flash_attention", "vocab_round_to")


def bert_config_from_jax(jax_config, dtype=None) -> bert.BertConfig:
    """The port's ``BertConfig`` with the fields of a JAX ``BertConfig``;
    ``dtype`` defaults to the JAX config's compute dtype."""
    fields = {f: getattr(jax_config, f) for f in _BERT_CONFIG_FIELDS}
    return bert.BertConfig(
        dtype=dtype if dtype is not None else _torch_dtype(jax_config.dtype),
        **fields)


def sparsity_from_jax(jax_sparsity):
    """The port's ``SparsityConfig`` subclass of the same name as a JAX
    package instance, built by its constructor from the instance's
    attributes (so the same checks run) and then holding all of them;
    None stays None, and a class the port does not have raises."""
    if jax_sparsity is None:
        return None
    name = type(jax_sparsity).__name__
    cls = getattr(sparsity_config, name, None)
    if not (isinstance(cls, type)
            and issubclass(cls, sparsity_config.SparsityConfig)):
        raise TypeError(f"sparse_attention: no port of {name}")
    attrs = dict(vars(jax_sparsity))
    params = inspect.signature(cls.__init__).parameters
    port = cls(**{k: v for k, v in attrs.items() if k in params})
    port.__dict__.update(attrs)
    return port
