"""Weight and config conversion between the JAX package's models (GPT,
BERT, the diffusion UNet and VAE) and the port.

The port keeps the JAX parameter tree and layouts, so conversion is a
re-wrap both ways: :func:`from_jax_params` takes the tree as numpy arrays
(what ``jax.device_get(params)`` returns) and builds the same tree of
torch tensors, through nested dicts and lists; :func:`to_numpy_params`
turns a port tree back into numpy arrays, so trained weights compare
either way.  A JAX ``Int8Param`` leaf (int8 serving: codes and scales)
becomes the port's
:class:`~deepspeed_tpu_torch.inference.quantization.Int8Param`.  The one
layout that differs is the diffusion models' convolution weights: HWIO in
the JAX tree, OIHW (PyTorch's) in the port's, transposed once here by
:func:`diffusion_from_jax` and :func:`diffusion_to_numpy`.  Nothing here
imports JAX.
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
                  "local_attention_alternating", "tie_word_embeddings",
                  "lm_head_bias", "pos_offset", "embed_layernorm", "dropout",
                  "remat", "remat_policy", "loss_chunk")


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy/JAX dtype (or its name) as the torch dtype."""
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}[name]


def from_jax_params(tree: Mapping[str, Any], device=None,
                    dtype: torch.dtype | None = None) -> dict:
    """Nested dicts and lists of numpy arrays → the same tree of tensors
    on ``device``.  Float arrays (bfloat16 included) become ``dtype``
    (fp32 when None); integer arrays keep their type; an ``Int8Param``
    (duck typed: ``q`` and ``scale``) keeps int8 codes and fp32 scales."""
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

    def node(v):
        if isinstance(v, Mapping):
            return {k: node(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)) and not hasattr(v, "q"):
            return [node(x) for x in v]
        return leaf(v)

    return node(tree)


def to_numpy_params(tree: Mapping[str, Any]) -> dict:
    """Nested dicts of tensors → the same tree of numpy arrays (16-bit
    floats widened to fp32).  A list of dicts stays a list (the diffusion
    trees' blocks); a list of per-layer tensors is stacked on dim 0."""
    def leaf(x):
        if isinstance(x, (list, tuple)):
            x = torch.stack(list(x))
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype != torch.float32:
            x = x.float()
        return x.numpy()

    def node(v):
        if isinstance(v, Mapping):
            return {k: node(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], Mapping):
            return [node(x) for x in v]
        return leaf(v)

    return node(tree)


def _map_conv_weights(tree, fn):
    """``fn`` applied to every 4-D leaf of a diffusion tree (its
    convolution weights: the linears are 2-D, the rest 1-D)."""
    if isinstance(tree, Mapping):
        return {k: _map_conv_weights(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_conv_weights(v, fn) for v in tree]
    return fn(tree) if tree.ndim == 4 else tree


def diffusion_from_jax(tree: Mapping[str, Any], device=None,
                       dtype: torch.dtype | None = None) -> dict:
    """A JAX ``unet_init``/``vae_init`` tree (numpy arrays) → the port's
    tree: :func:`from_jax_params`, then each HWIO convolution weight
    transposed once to a contiguous OIHW tensor."""
    return _map_conv_weights(from_jax_params(tree, device, dtype),
                             lambda w: w.permute(3, 2, 0, 1).contiguous())


def diffusion_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Inverse of :func:`diffusion_from_jax`: the JAX tree's layout (HWIO
    convolutions) as numpy arrays."""
    return _map_conv_weights(to_numpy_params(tree),
                             lambda w: np.ascontiguousarray(
                                 w.transpose(2, 3, 1, 0)))


def config_from_jax(jax_config, dtype=None) -> gpt.GPTConfig:
    """The port's ``GPTConfig`` with the fields of a JAX ``GPTConfig``;
    ``dtype`` defaults to the JAX config's compute dtype, ``param_dtype``
    is the JAX config's.  A field of the JAX config the port does not
    have raises rather than being dropped, unless it is inert on one
    device or qualifies an option that raises (see
    ``tests/test_torch_config_fields.py``)."""
    bits = getattr(jax_config, "act_quant_bits", None)
    if bits is not None:
        raise NotImplementedError(
            f"GPTConfig.act_quant_bits={bits!r}: activation fake-quant "
            "(quantize_activation) is not ported yet; only None is")
    fields = {f: getattr(jax_config, f) for f in _CONFIG_FIELDS}
    return gpt.GPTConfig(
        dtype=dtype if dtype is not None else _torch_dtype(jax_config.dtype),
        param_dtype=_torch_dtype(jax_config.param_dtype),
        sparse_attention=sparsity_from_jax(jax_config.sparse_attention),
        **fields)


_BERT_CONFIG_FIELDS = ("vocab_size", "max_seq_len", "type_vocab_size",
                       "n_layer", "n_head", "d_model", "d_ff",
                       "layer_norm_eps", "dropout", "attn_dropout", "remat",
                       "use_flash_attention", "vocab_round_to")


def bert_config_from_jax(jax_config, dtype=None) -> bert.BertConfig:
    """The port's ``BertConfig`` with the fields of a JAX ``BertConfig``;
    ``dtype`` defaults to the JAX config's compute dtype, ``param_dtype``
    is the JAX config's."""
    fields = {f: getattr(jax_config, f) for f in _BERT_CONFIG_FIELDS}
    return bert.BertConfig(
        dtype=dtype if dtype is not None else _torch_dtype(jax_config.dtype),
        param_dtype=_torch_dtype(jax_config.param_dtype), **fields)


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
