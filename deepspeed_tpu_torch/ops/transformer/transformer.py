"""The public encoder block: the port of ``ops/transformer/transformer.py``.

``DeepSpeedTransformerLayer`` is the block users drop into BERT-style
models (reference ``DeepSpeedTransformerLayer`` /
``DeepSpeedTransformerConfig``).  It is an ``nn.Module`` whose fp32
parameters carry the JAX layer's names and the per-layer layouts of
``models/bert.py``'s blocks (``wqkv`` [d, 3, H, Dh], ``wo`` [H, Dh, d],
...), so converted BERT weights slot straight in.  The compute runs in the
config's dtype; gradients reach the fp32 parameters through the casts.

Post-LN (``pre_layer_norm=False``) is exactly ``models/bert._block``;
pre-LN follows the JAX layer: LayerNorm before attention and before the
exact-GeLU MLP, residuals around both.  Attention takes the flash kernels
(non-causal; ``seq_lens`` [B] as per-row key lengths, differentiable
through ``flash_bwd_fused`` up to 4096 keys) unless a ``pad_mask`` [B, S]
is given, which takes the dense masked attention.  Dropout above 0
raises (ROADMAP.md Queue 1 #3.1).  The random init draws from a
``torch.Generator``, not JAX's threefry: the same layout, other weights.

The pure forward is the module-level :func:`apply` (``nn.Module.apply``
is PyTorch's recursive ``fn`` walk and keeps that meaning).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...accelerator import get_accelerator
from ...models import bert
from ...models.gpt import _layer_norm

Params = Dict[str, Any]

#: the parameter names, in the JAX layer's order
PARAM_NAMES = ("wqkv", "bqkv", "wo", "bo", "ln1_scale", "ln1_bias", "wi",
               "bi", "wo_mlp", "bo_mlp", "ln2_scale", "ln2_bias")


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """The JAX config's fields (reference ``transformer.py:38`` minus its
    CUDA stream and stochastic-mode knobs)."""

    hidden_size: int = 768
    intermediate_size: Optional[int] = None     # default 4 * hidden_size
    heads: int = 12
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    fp16: bool = False
    bf16: bool = False

    def __post_init__(self):
        for name in ("attn_dropout_ratio", "hidden_dropout_ratio"):
            if getattr(self, name) != 0.0:
                raise NotImplementedError(
                    f"DeepSpeedTransformerConfig.{name}="
                    f"{getattr(self, name)!r}: dropout is not ported yet "
                    "(ROADMAP.md Queue 1 #3.1); only 0.0 is")
        if self.hidden_size % self.heads:
            raise ValueError(f"heads {self.heads} must divide hidden_size "
                             f"{self.hidden_size}")

    @property
    def dtype(self) -> torch.dtype:
        if self.bf16:
            return torch.bfloat16
        if self.fp16:
            return torch.float16
        return torch.float32

    @property
    def ffn(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def _bert_config(config: DeepSpeedTransformerConfig) -> bert.BertConfig:
    """The one-layer ``BertConfig`` that the block functions read."""
    return bert.BertConfig(
        vocab_size=1, max_seq_len=1, n_layer=1, n_head=config.heads,
        d_model=config.hidden_size, d_ff=config.ffn, dtype=config.dtype,
        layer_norm_eps=config.layer_norm_eps)


def init_params(config: DeepSpeedTransformerConfig,
                generator: torch.Generator, device=None) -> Params:
    """Random fp32 weights on ``device`` (default: the generator's):
    the four matmul weights normal with std ``initializer_range`` (drawn
    in ``PARAM_NAMES`` order), biases 0, LayerNorm scales 1."""
    device = generator.device if device is None else torch.device(device)
    d, h, f = config.hidden_size, config.heads, config.ffn
    hd = d // h

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * config.initializer_range

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {"wqkv": normal(d, 3, h, hd), "bqkv": full(0.0, 3, h, hd),
            "wo": normal(h, hd, d), "bo": full(0.0, d),
            "ln1_scale": full(1.0, d), "ln1_bias": full(0.0, d),
            "wi": normal(d, f), "bi": full(0.0, f),
            "wo_mlp": normal(f, d), "bo_mlp": full(0.0, d),
            "ln2_scale": full(1.0, d), "ln2_bias": full(0.0, d)}


def apply(params: Params, x: torch.Tensor, config: DeepSpeedTransformerConfig,
          pad_mask: Optional[torch.Tensor] = None,
          seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block's forward on explicit params: ``x`` [B, S, d] (cast to
    the config's dtype) → the same shape in that dtype.  ``seq_lens`` [B]
    hides keys at or past each row's length (the flash kernels'
    ``kv_lens``); ``pad_mask`` [B, S] (1 = a live key) takes the dense
    masked attention."""
    bcfg = _bert_config(config)
    x = x.to(config.dtype)
    if pad_mask is not None:
        pad_mask = pad_mask.bool()
    if seq_lens is not None:
        seq_lens = seq_lens.to(torch.int32)
    if not config.pre_layer_norm:
        return bert._block(x, pad_mask, seq_lens, params, bcfg)
    cdt, eps = config.dtype, config.layer_norm_eps
    B, S, d = x.shape
    h = _layer_norm(x, params["ln1_scale"], params["ln1_bias"], eps)
    qkv = (h @ params["wqkv"].to(cdt).reshape(d, -1)).view(
        B, S, 3, config.heads, d // config.heads) + params["bqkv"].to(cdt)
    attn = bert._attention(qkv, pad_mask, seq_lens, bcfg)
    attn_out = attn.reshape(B, S, d) @ params["wo"].to(cdt).reshape(d, d) \
        + params["bo"].to(cdt)
    x = x + attn_out
    h2 = _layer_norm(x, params["ln2_scale"], params["ln2_bias"], eps)
    ff = F.gelu(h2 @ params["wi"].to(cdt) + params["bi"].to(cdt),
                approximate="none")
    return x + (ff @ params["wo_mlp"].to(cdt) + params["bo_mlp"].to(cdt))


def _fp32(w, device) -> torch.Tensor:
    """An initial weight (numpy array or tensor) as an fp32 tensor."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.array(w, dtype=np.float32))
    return w.detach().to(device=device, dtype=torch.float32).clone()


class DeepSpeedTransformerLayer(nn.Module):
    """One encoder block: ``layer(x, pad_mask=None, seq_lens=None)`` →
    same-shape activations in the config's dtype.

    The parameters are fp32 ``nn.Parameter``s named as the JAX layer's
    tree (:data:`PARAM_NAMES`); ``initial_weights`` (a tree of numpy
    arrays or tensors under those names, a JAX layer's ``params`` as
    ``jax.device_get`` gives them) sets them, else :func:`init_params`
    draws them from ``generator`` (default: seeded with 0 on the
    device).  ``device=None`` means the generator's device when one is
    given, else CUDA (raising when there is none); pass ``device="cpu"``
    for the plain PyTorch path."""

    def __init__(self, config: DeepSpeedTransformerConfig,
                 generator: Optional[torch.Generator] = None,
                 initial_weights: Optional[Params] = None, device=None):
        super().__init__()
        self.config = config
        if device is None and generator is not None:
            device = generator.device
        device = get_accelerator().resolve_device(device)
        if initial_weights is not None:
            weights = {k: _fp32(initial_weights[k], device)
                       for k in PARAM_NAMES}
        else:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            weights = init_params(config, generator, device)
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(weights[name]))

    @property
    def params(self) -> Params:
        """The parameters as the JAX layer's tree (name → tensor)."""
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        return apply(self.params, x, self.config, pad_mask, seq_lens)
