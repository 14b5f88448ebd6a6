"""GPT-2 causal transformer: the port of ``models/gpt.py``.

Only the GPT-2 variant is ported: learned positions, pre-LN blocks with a
serial residual, tanh-GeLU MLP, tied embedding head.  The other
architecture variants of the JAX ``GPTConfig`` (rotary/ALiBi positions,
relu, parallel residual, banded windows, untied or biased heads, position
offsets, embedding LayerNorm) raise ``NotImplementedError``.

Parameters keep the JAX package's tree and layouts, so converting its
weights is a re-wrap (``convert.from_jax_params``): ``wte`` [V_pad, d],
``wpe`` [S, d], and the layer-stacked ``blocks`` (``wqkv`` [L, d, 3, H,
Dh], ``bqkv`` [L, 3, H, Dh], ``wo`` [L, H, Dh, d], ``wi`` [L, d, F],
``wo_mlp`` [L, F, d], LayerNorm scales and biases [L, d]).  Matmuls run
in ``config.dtype``; LayerNorm math and the logits are fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.kernels.flash_attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None          # default 4*d_model
    dtype: torch.dtype = torch.bfloat16     # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # dtype of the weights at init
    vocab_round_to: int = 128
    attn_softmax_scale: Optional[float] = None  # None → 1/sqrt(head_dim)
    # architecture variants of the JAX config; only the GPT-2 values are
    # ported, and any other value raises
    pos_embed: str = "learned"
    activation: str = "gelu"
    parallel_residual: bool = False
    local_attention_window: int = 0
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    pos_offset: int = 0
    embed_layernorm: bool = False

    def __post_init__(self):
        ported = {"pos_embed": "learned", "activation": "gelu",
                  "parallel_residual": False, "local_attention_window": 0,
                  "tie_word_embeddings": True, "lm_head_bias": False,
                  "pos_offset": 0, "embed_layernorm": False}
        for name, want in ported.items():
            if getattr(self, name) != want:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r}: only the "
                    f"GPT-2 variant ({name}={want!r}) is ported yet")
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_head {self.n_head}")

    @property
    def ffn_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round_to
        return ((self.vocab_size + r - 1) // r) * r


# canonical size presets (the JAX package's, BASELINE.md tracked configs)
GPT2_125M = GPTConfig(n_layer=12, n_head=12, d_model=768)
GPT2_350M = GPTConfig(n_layer=24, n_head=16, d_model=1024)
GPT2_760M = GPTConfig(n_layer=24, n_head=16, d_model=1536)
GPT2_1_3B = GPTConfig(n_layer=24, n_head=32, d_model=2048)
GPT2_2_7B = GPTConfig(n_layer=32, n_head=32, d_model=2560)
GPT3_6_7B = GPTConfig(n_layer=32, n_head=32, d_model=4096, max_seq_len=2048)
GPT2_13B = GPTConfig(n_layer=40, n_head=40, d_model=5120, max_seq_len=2048)

PRESETS = {
    "gpt2-125m": GPT2_125M,
    "gpt2-350m": GPT2_350M,
    "gpt2-760m": GPT2_760M,
    "gpt2-1.3b": GPT2_1_3B,
    "gpt2-2.7b": GPT2_2_7B,
    "gpt3-6.7b": GPT3_6_7B,
    "gpt2-13b": GPT2_13B,
}


# --------------------------------------------------------------------- init

def init(config: GPTConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Random weights at full width with the JAX ``init``'s stds (normal
    0.02, residual projections 0.02/sqrt(2L), LayerNorm 1/0, biases 0), in
    ``config.param_dtype`` on ``device``.  The draws come from
    ``generator`` (which must live on ``device``), not JAX's bits."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, v, L = config.d_model, config.padded_vocab, config.n_layer
    h, hd, f = config.n_head, config.head_dim, config.ffn_dim
    pdt = config.param_dtype
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def normal(shape, s):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * s).to(pdt)

    def full(shape, value):
        return torch.full(shape, value, dtype=pdt, device=device)

    blocks = {
        "ln1_scale": full((L, d), 1.0),
        "ln1_bias": full((L, d), 0.0),
        "wqkv": normal((L, d, 3, h, hd), std),
        "bqkv": full((L, 3, h, hd), 0.0),
        "wo": normal((L, h, hd, d), resid_std),
        "bo": full((L, d), 0.0),
        "ln2_scale": full((L, d), 1.0),
        "ln2_bias": full((L, d), 0.0),
        "wi": normal((L, d, f), std),
        "bi": full((L, f), 0.0),
        "wo_mlp": normal((L, f, d), resid_std),
        "bo_mlp": full((L, d), 0.0),
    }
    return {
        "wte": normal((v, d), std),
        "wpe": normal((config.max_seq_len, d), std),
        "blocks": blocks,
        "lnf_scale": full((d,), 1.0),
        "lnf_bias": full((d,), 0.0),
    }


def layer_params(params: Params, idx: int) -> Params:
    """Layer ``idx``'s slice of the stacked ``blocks`` (views, no copy)."""
    return {name: w[idx] for name, w in params["blocks"].items()}


# -------------------------------------------------------------------- apply

def _layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _attention(q, k, v, config: GPTConfig):
    """Causal MHA on [B, S, H, D] through the flash kernel (CUDA) or its
    plain version (CPU)."""
    return flash_attention(q, k, v, causal=True,
                           sm_scale=config.attn_softmax_scale)[0]


def qkv_proj(x, p: Params, config: GPTConfig):
    """LN1 + qkv projection: [B, S, d] → (q, k, v) each [B, S, H, Dh],
    strided views of one [B, S, 3, H, Dh] product."""
    cdt = config.dtype
    B, S, d = x.shape
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = h @ p["wqkv"].to(cdt).reshape(d, -1)
    qkv = qkv.view(B, S, 3, config.n_head, config.head_dim) \
        + p["bqkv"].to(cdt)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def attn_project(attn, p: Params, config: GPTConfig):
    """Attention output projection W_o·attn + b_o (no residual)."""
    cdt = config.dtype
    B, S, H, Dh = attn.shape
    return attn.reshape(B, S, H * Dh) @ p["wo"].to(cdt).reshape(H * Dh, -1) \
        + p["bo"].to(cdt)


def mlp_out(x, p: Params, config: GPTConfig):
    """LN2 + tanh-GeLU MLP (no residual add)."""
    cdt = config.dtype
    h2 = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    ff = h2 @ p["wi"].to(cdt) + p["bi"].to(cdt)
    ff = F.gelu(ff, approximate="tanh")
    return ff @ p["wo_mlp"].to(cdt) + p["bo_mlp"].to(cdt)


def block_tail(x, attn, p: Params, config: GPTConfig):
    """Attention output projection + residual + LN2 + MLP + residual."""
    x = x + attn_project(attn, p, config)
    return x + mlp_out(x, p, config)


def embed(params: Params, tokens, config: GPTConfig, positions=None):
    """Token + learned position embedding.  ``positions``: [S] shared or
    [B, S] per row (ragged decode)."""
    cdt = config.dtype
    x = params["wte"].to(cdt)[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    pe = params["wpe"].to(cdt)[positions]
    return x + (pe if pe.dim() == x.dim() else pe[None])


def _head_logits(params: Params, h, config: GPTConfig):
    """Tied head on final-LayerNormed hiddens: operands in the compute
    dtype, fp32 logits (a bf16 product would round the logits and create
    greedy ties the JAX path does not have)."""
    cdt = config.dtype
    head = params["wte"].to(cdt)
    h2 = h.to(cdt).reshape(-1, h.shape[-1])
    if h2.is_cuda and cdt != torch.float32:
        logits = torch.mm(h2, head.t(), out_dtype=torch.float32)
    else:
        # the same products (exact in fp32) with fp32 accumulation
        logits = h2.float() @ head.float().t()
    return logits.view(*h.shape[:-1], -1)


def lm_logits(params: Params, x, config: GPTConfig):
    """Final LN + head → fp32 logits [..., padded_vocab]."""
    return _head_logits(
        params, _layer_norm(x, params["lnf_scale"], params["lnf_bias"]),
        config)


def backbone(params: Params, tokens, config: GPTConfig):
    """Embed + transformer stack: tokens [B, S] → hidden [B, S, d]
    (before the final LayerNorm)."""
    x = embed(params, tokens, config)
    for idx in range(config.n_layer):
        p = layer_params(params, idx)
        q, k, v = qkv_proj(x, p, config)
        x = block_tail(x, _attention(q, k, v, config), p, config)
    return x


def apply(params: Params, tokens, config: GPTConfig):
    """Forward pass: tokens [B, S] → logits [B, S, padded_vocab] fp32."""
    return lm_logits(params, backbone(params, tokens, config), config)
