"""BERT-family encoder: the port of ``models/bert.py``.

The reference's headline pre-training workload is BERT-large MLM
(``docs/_tutorials/bert-pretraining.md``).  Bidirectional attention with a
padding mask, token-type embeddings, post-LayerNorm residuals (the
original BERT ordering), exact-erf GeLU, an MLM head with its own dense
transform and LayerNorm and a tied decoder with a vocab bias, and the
[CLS] pooler.

Attention: with ``seq_lens`` [B] (right-padded batches, the MLM layout)
and no hole mask it runs through the flash kernels with per-row key
lengths (``flash_attention_qkv(..., causal=False, kv_lens=seq_lens)``,
differentiable); an arbitrary ``attention_mask`` [B, S] takes the dense
masked path in plain torch, with -1e9 rather than -inf so a fully padded
row stays finite (JAX ``bert.py:162-188``).  An all-ones mask is the
unmasked case and keeps the flash path.  With ``remat`` each block is
recomputed in the backward from its saved input only (the counterpart of
``jax.checkpoint(..., nothing_saveable)``), so the forward kernel runs
twice per block and step.  ``dropout`` and ``attn_dropout`` > 0 raise
``NotImplementedError``: they wait for the hashed-dropout kernel.

Parameters keep the JAX package's tree and layouts, so converting its
weights is a re-wrap (``convert.from_jax_params``); the layer-stacked
``blocks`` leaves ([L, ...]) may also be lists of per-layer tensors, as
the engine hands them.  Matmuls run in ``config.dtype``; LayerNorm math
and the MLM logits are fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.kernels.flash_attention import flash_attention_qkv
from .gpt import _head_logits, _layer_norm, layer_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None          # default 4*d_model
    dtype: torch.dtype = torch.bfloat16     # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # dtype of the weights at init
    layer_norm_eps: float = 1e-12
    # only 0.0 is ported for both (the hashed-dropout kernel is to come)
    dropout: float = 0.0
    attn_dropout: float = 0.0
    remat: bool = False
    use_flash_attention: bool = True
    vocab_round_to: int = 128

    def __post_init__(self):
        for name in ("dropout", "attn_dropout"):
            if getattr(self, name) != 0.0:
                raise NotImplementedError(
                    f"BertConfig.{name}={getattr(self, name)!r}: only 0.0 is "
                    "ported yet")
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


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(n_layer=24, n_head=16, d_model=1024)

PRESETS = {"bert-base": BERT_BASE, "bert-large": BERT_LARGE}


# --------------------------------------------------------------------- init

def init(config: BertConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Random weights at full width with the JAX ``init``'s stds (normal
    0.02, LayerNorm 1/0, biases 0), in ``config.param_dtype`` on
    ``device``.  The draws come from ``generator`` (which must live on
    ``device``), not JAX's bits."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, v, L = config.d_model, config.padded_vocab, config.n_layer
    h, hd, f = config.n_head, config.head_dim, config.ffn_dim
    pdt = config.param_dtype

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(pdt)

    def full(shape, value):
        return torch.full(shape, value, dtype=pdt, device=device)

    blocks = {
        "wqkv": normal((L, d, 3, h, hd)),
        "bqkv": full((L, 3, h, hd), 0.0),
        "wo": normal((L, h, hd, d)),
        "bo": full((L, d), 0.0),
        "ln1_scale": full((L, d), 1.0),     # post-attention LN
        "ln1_bias": full((L, d), 0.0),
        "wi": normal((L, d, f)),
        "bi": full((L, f), 0.0),
        "wo_mlp": normal((L, f, d)),
        "bo_mlp": full((L, d), 0.0),
        "ln2_scale": full((L, d), 1.0),     # post-MLP LN
        "ln2_bias": full((L, d), 0.0),
    }
    return {
        "wte": normal((v, d)),
        "wpe": normal((config.max_seq_len, d)),
        "wtype": normal((config.type_vocab_size, d)),
        "emb_ln_scale": full((d,), 1.0),
        "emb_ln_bias": full((d,), 0.0),
        "blocks": blocks,
        # MLM head: dense transform + LN + tied decoder with bias
        "mlm_dense": normal((d, d)),
        "mlm_dense_bias": full((d,), 0.0),
        "mlm_ln_scale": full((d,), 1.0),
        "mlm_ln_bias": full((d,), 0.0),
        "mlm_bias": full((v,), 0.0),
        # pooler (NSP / classification)
        "pool_w": normal((d, d)),
        "pool_b": full((d,), 0.0),
    }


# -------------------------------------------------------------------- apply

def _attention(qkv, pad_mask, seq_lens, config: BertConfig):
    """Bidirectional MHA on the packed qkv [B, S, 3, H, Dh] → [B, S, H, Dh]:
    the flash kernels (per-row ``seq_lens`` or none) without a hole mask,
    else dense masked attention."""
    if pad_mask is None and config.use_flash_attention:
        return flash_attention_qkv(qkv, causal=False, kv_lens=seq_lens)[0]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 1.0 / math.sqrt(config.head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if pad_mask is None and seq_lens is not None:
        pad_mask = torch.arange(q.shape[1], device=q.device)[None, :] \
            < seq_lens[:, None]
    if pad_mask is not None:
        # large-finite rather than -inf: a fully padded row must give
        # finite outputs, not NaNs that survive the MLM label mask
        s = s.masked_fill(~pad_mask[:, None, None, :], -1e9)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def _block(x, pad_mask, seq_lens, p: Params, config: BertConfig):
    """Post-LN transformer encoder block (original BERT ordering)."""
    cdt = config.dtype
    eps = config.layer_norm_eps
    B, S, d = x.shape
    qkv = (x @ p["wqkv"].to(cdt).reshape(d, -1)).view(
        B, S, 3, config.n_head, config.head_dim) + p["bqkv"].to(cdt)
    attn = _attention(qkv, pad_mask, seq_lens, config)
    attn_out = attn.reshape(B, S, d) @ p["wo"].to(cdt).reshape(d, d) \
        + p["bo"].to(cdt)
    x = _layer_norm(x + attn_out, p["ln1_scale"], p["ln1_bias"], eps)
    ff = x @ p["wi"].to(cdt) + p["bi"].to(cdt)
    ff = F.gelu(ff, approximate="none")
    ff_out = ff @ p["wo_mlp"].to(cdt) + p["bo_mlp"].to(cdt)
    return _layer_norm(x + ff_out, p["ln2_scale"], p["ln2_bias"], eps)


def encode(params: Params, tokens, config: BertConfig, token_type_ids=None,
           attention_mask=None, seq_lens=None):
    """tokens [B, S] → hidden states [B, S, d] in the compute dtype.

    Right-padded batches should pass ``seq_lens`` [B] (the flash kernels,
    per-row masked); ``attention_mask`` [B, S] covers arbitrary masks
    through the dense path."""
    cdt = config.dtype
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    ttype = token_type_ids if token_type_ids is not None \
        else torch.zeros_like(tokens)
    x = F.embedding(tokens, params["wte"].to(cdt)) \
        + F.embedding(pos, params["wpe"].to(cdt))[None] \
        + F.embedding(ttype, params["wtype"].to(cdt))
    x = _layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"],
                    config.layer_norm_eps)
    # an all-ones mask is the unmasked case and keeps the flash path
    if attention_mask is not None and bool(attention_mask.all()):
        attention_mask = None
    pad_mask = attention_mask.bool() if attention_mask is not None else None
    if seq_lens is not None:
        # the kernels' type, once for every layer's three launches
        seq_lens = seq_lens.to(torch.int32)
    remat = config.remat and torch.is_grad_enabled()
    for idx in range(config.n_layer):
        p = layer_params(params, idx)
        if remat:
            # keeps the block input (and what it closes over) only
            x = torch.utils.checkpoint.checkpoint(
                _block, x, pad_mask, seq_lens, p, config,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, pad_mask, seq_lens, p, config)
    return x


def mlm_logits(params: Params, hidden, config: BertConfig):
    """MLM head: transform + GeLU + LN + tied decoder (+ vocab bias), fp32
    logits [..., padded_vocab]."""
    cdt = config.dtype
    h = hidden @ params["mlm_dense"].to(cdt) + params["mlm_dense_bias"].to(cdt)
    h = F.gelu(h, approximate="none")
    h = _layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                    config.layer_norm_eps)
    return _head_logits({"wte": params["wte"]}, h, config) \
        + params["mlm_bias"].float()


def pooled_output(params: Params, hidden, config: BertConfig):
    """[CLS] pooler (NSP / classification input)."""
    cdt = config.dtype
    return torch.tanh(hidden[:, 0] @ params["pool_w"].to(cdt)
                      + params["pool_b"].to(cdt))


def apply(params: Params, tokens, config: BertConfig, token_type_ids=None,
          attention_mask=None, seq_lens=None):
    """tokens → MLM logits [B, S, padded_vocab] fp32."""
    return mlm_logits(params, encode(params, tokens, config, token_type_ids,
                                     attention_mask, seq_lens), config)


def loss_fn(params: Params, batch, config: BertConfig):
    """Masked-LM cross-entropy, the mean over labelled positions.

    batch: {"tokens": [B, S] (the input with [MASK]s applied),
    "mlm_labels": [B, S] (-100 = not predicted), optional
    "token_type_ids", "attention_mask", "seq_lens"}."""
    unported = sorted(k for k in batch if k.startswith("_"))
    if unported:
        raise NotImplementedError(f"batch keys {unported} (dropout) are not "
                                  "ported yet")
    labels = batch["mlm_labels"]
    logits = apply(params, batch["tokens"], config,
                   batch.get("token_type_ids"), batch.get("attention_mask"),
                   batch.get("seq_lens"))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def flops_per_token(config: BertConfig) -> float:
    """6N + attention flops per token (MFU accounting, forward and
    backward)."""
    d, L, S = config.d_model, config.n_layer, config.max_seq_len
    n_params = (config.padded_vocab * d + S * d + config.type_vocab_size * d
                + L * (12 * d * d + 13 * d) + 2 * d * d + 4 * d)
    return 6.0 * n_params + 12.0 * L * d * S
