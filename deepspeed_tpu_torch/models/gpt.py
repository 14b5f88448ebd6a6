"""GPT causal transformer: the port of ``models/gpt.py``.

Ported: pre-LN blocks with a serial residual, tanh-GeLU MLP and a tied
embedding head, with learned positions (GPT-2) or ALiBi (BLOOM:
``pos_embed="alibi"``, no ``wpe``, the per-head ``-slope·dist`` bias at a
fixed 1/sqrt(Dh) scale), an optional embedding LayerNorm
(``embed_layernorm``, BLOOM), and banded-causal local attention
(``local_attention_window``; with ``local_attention_alternating`` only
the odd layers are banded, GPT-Neo, whose ``attn_softmax_scale`` is 1.0).
A banded layer runs the flash kernel's window option; ALiBi layers run
the dense :func:`_alibi_attention`, as the JAX package does.  The other
architecture variants of the JAX ``GPTConfig`` (rotary positions, relu,
parallel residual, untied or biased heads, position offsets), dropout and
the ``"dots"`` remat policy raise ``NotImplementedError``.

Training: :func:`loss_fn` (mean next-token cross-entropy, optionally over
``loss_chunk``-token chunks of the head) is differentiable through the
flash kernels' ``torch.autograd.Function`` (a banded layer's through the
window option of the forward and both backward kernels; the block-sparse
kernels' under ``sparse_attention``, JAX ``gpt.py:416-421``).  With ``remat`` each
block is recomputed in the backward from its saved input (``_RematBlock``);
``remat_policy="attn_out"`` also keeps each block's attention output O and
its fp32 logsumexp, so the recompute replays the attention from them and
the backward never re-runs the forward kernel (JAX ``gpt.py:609-631``).

Parameters keep the JAX package's tree and layouts, so converting its
weights is a re-wrap (``convert.from_jax_params``): ``wte`` [V_pad, d],
``wpe`` [S, d], and the layer-stacked ``blocks`` (``wqkv`` [L, d, 3, H,
Dh], ``bqkv`` [L, 3, H, Dh], ``wo`` [L, H, Dh, d], ``wi`` [L, d, F],
``wo_mlp`` [L, F, d], LayerNorm scales and biases [L, d]).  Matmuls run
in ``config.dtype``; LayerNorm math and the logits are fp32.  Under ALiBi
the tree has no ``wpe``; with ``embed_layernorm`` it has ``emb_ln_scale``
and ``emb_ln_bias`` [d].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..utils.logging import logger

from ..ops.kernels.block_sparse_attention import (block_sparse_attention,
                                                  block_sparse_attention_qkv,
                                                  config_plan)
from ..ops.kernels.decode_attention import cached_attention_reference
from ..ops.kernels.flash_attention import flash_attention, flash_attention_qkv
from ..ops.sparse_attention.sparsity_config import SparsityConfig

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
    # architecture variants of the JAX config: learned or ALiBi positions,
    # the embedding LayerNorm and the banded window (every layer, or the
    # odd ones when alternating) are ported; any other value raises
    pos_embed: str = "learned"          # learned | alibi
    activation: str = "gelu"
    parallel_residual: bool = False
    local_attention_window: int = 0     # >0: banded-causal window width
    local_attention_alternating: bool = False   # odd layers local (GPT-Neo)
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    pos_offset: int = 0
    embed_layernorm: bool = False       # BLOOM's word_embeddings_layernorm
    # training: only dropout 0.0 is ported; remat recomputes each block in
    # the backward ("nothing": saves the block input; "attn_out": also the
    # attention output and lse); loss_chunk > 0 computes the head's logits
    # one chunk of the sequence at a time
    dropout: float = 0.0
    remat: bool = False
    remat_policy: str = "nothing"
    loss_chunk: int = 0
    # block-sparse attention (the port's SparsityConfig): every layer's
    # attention visits only the layout's live blocks, causal
    sparse_attention: Optional[SparsityConfig] = None

    def __post_init__(self):
        ported = {"pos_embed": ("learned", "alibi"), "activation": ("gelu",),
                  "parallel_residual": (False,),
                  "tie_word_embeddings": (True,), "lm_head_bias": (False,),
                  "pos_offset": (0,)}
        for name, want in ported.items():
            if getattr(self, name) not in want:
                raise NotImplementedError(
                    f"GPTConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (ported: {want}; ROADMAP.md Queue 1 #6)")
        if self.local_attention_window < 0:
            raise ValueError(f"local_attention_window "
                             f"{self.local_attention_window} < 0")
        if self.pos_embed == "alibi" and self.sparse_attention is not None:
            raise ValueError("alibi attention does not compose with "
                             "sparse_attention")
        if self.dropout != 0.0:
            raise NotImplementedError(
                f"GPTConfig.dropout={self.dropout!r}: only dropout 0.0 is "
                "ported yet")
        if self.remat_policy == "dots":
            raise NotImplementedError(
                "GPTConfig.remat_policy='dots' is not ported yet (the port "
                "has 'nothing' and 'attn_out')")
        if self.remat_policy not in ("nothing", "attn_out"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.sparse_attention is not None and not isinstance(
                self.sparse_attention, SparsityConfig):
            raise TypeError(
                f"GPTConfig.sparse_attention must be a deepspeed_tpu_torch "
                f"SparsityConfig, got {type(self.sparse_attention)!r} "
                "(convert.config_from_jax maps the JAX package's classes)")
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
    ``config.param_dtype`` on ``device``: ``wpe`` for learned positions
    only, ``emb_ln_*`` with ``embed_layernorm``.  The draws come from
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
    params = {
        "wte": normal((v, d), std),
        "blocks": blocks,
        "lnf_scale": full((d,), 1.0),
        "lnf_bias": full((d,), 0.0),
    }
    if config.pos_embed == "learned":
        params["wpe"] = normal((config.max_seq_len, d), std)
    if config.embed_layernorm:
        params["emb_ln_scale"] = full((d,), 1.0)
        params["emb_ln_bias"] = full((d,), 0.0)
    return params


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


def alibi_slopes(n_head: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (Press et al.), fp32 [n_head]: geometric from
    2^(-8/n); a non-power-of-two count takes the power-of-two ladder below
    it, then every other slope of the doubled ladder (JAX
    ``gpt.py:269-282``)."""
    def pow2_slopes(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    floor = 1 << (n_head.bit_length() - 1)  # largest power of two <= n_head
    slopes = pow2_slopes(floor)
    if floor != n_head:
        slopes += pow2_slopes(2 * floor)[0::2][:n_head - floor]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def layer_window(config: GPTConfig, idx: int) -> Optional[int]:
    """Layer ``idx``'s band width, or None for a global layer: every layer
    of a windowed model, or only the odd ones when alternating (GPT-Neo;
    JAX ``gpt.py:352-360`` gives global layers a window of the full
    length, which is the same causal attention)."""
    if config.local_attention_window <= 0:
        return None
    if config.local_attention_alternating and idx % 2 == 0:
        return None
    return config.local_attention_window


def _windowed_attention(q, k, v, config: GPTConfig, window: int, pos=None):
    """Dense banded-causal attention (JAX ``gpt.py:325-349``): query i at
    absolute position ``pos + i`` sees key j iff 0 <= pos + i - j <
    ``window``; ``pos`` an int or a per-row [B] tensor, by default
    end-aligned (``Sk - Sq``).  The plain version of the flash kernel's
    window option (and of the cache kernels')."""
    Sq, Sk = q.shape[1], k.shape[1]
    return cached_attention_reference(
        q, k, v, Sk - Sq if pos is None else pos,
        config.attn_softmax_scale, window=window)


def _alibi_attention(q, k, v, config: GPTConfig, pos=None):
    """Dense causal attention with the ALiBi bias (BLOOM; JAX
    ``gpt.py:285-304``): ``-slope·(i - j)`` added to the fp32 scores at a
    fixed 1/sqrt(Dh) scale (``attn_softmax_scale`` is ignored, as in JAX);
    query i at ``pos + i`` (an int or a per-row [B] tensor), by default
    end-aligned.  ALiBi prefill takes this path, outside any kernel."""
    Sq, Sk, H = q.shape[1], k.shape[1], q.shape[2]
    return cached_attention_reference(
        q, k, v, Sk - Sq if pos is None else pos,
        1.0 / math.sqrt(q.shape[-1]), slopes=alibi_slopes(H, q.device))


def _attention(q, k, v, config: GPTConfig, window: Optional[int] = None):
    """Causal MHA on [B, S, H, D] through the flash kernel (CUDA) or its
    plain version (CPU): banded by ``window`` when given (the kernel's
    window option), block-sparse when ``config.sparse_attention`` is set,
    and under ALiBi the dense :func:`_alibi_attention` (the window takes
    precedence, as in JAX ``_attention_impl``)."""
    if window is not None:
        return flash_attention(q, k, v, causal=True,
                               sm_scale=config.attn_softmax_scale,
                               window=window)[0]
    if config.pos_embed == "alibi":
        return _alibi_attention(q, k, v, config)
    if config.sparse_attention is not None:
        return block_sparse_attention(q, k, v, _sparse_plan(config, q),
                                      config.sparse_attention.block)[0]
    return flash_attention(q, k, v, causal=True,
                           sm_scale=config.attn_softmax_scale)[0]


def _sparse_plan(config: GPTConfig, x):
    """The cached causal plan of ``config.sparse_attention`` at x's length
    (x: [B, S, ...]) on x's device.  Like the JAX model (``gpt.py:416-421``)
    the sparse path takes the default 1/sqrt(Dh) scale."""
    return config_plan(config.sparse_attention, x.shape[1], True, x.device)


def qkv_packed(x, p: Params, config: GPTConfig):
    """LN1 + qkv projection: [B, S, d] → the packed [B, S, 3, H, Dh]."""
    cdt = config.dtype
    B, S, d = x.shape
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = h @ p["wqkv"].to(cdt).reshape(d, -1)
    return qkv.view(B, S, 3, config.n_head, config.head_dim) \
        + p["bqkv"].to(cdt)


def qkv_proj(x, p: Params, config: GPTConfig):
    """LN1 + qkv projection: [B, S, d] → (q, k, v) each [B, S, H, Dh],
    strided views of one [B, S, 3, H, Dh] product."""
    qkv = qkv_packed(x, p, config)
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
    """Token embedding, then the embedding LayerNorm (``embed_layernorm``)
    and the learned positions (``pos_embed="learned"``; ALiBi adds none).
    ``positions``: [S] shared or [B, S] per row (ragged decode)."""
    cdt = config.dtype
    x = F.embedding(tokens, params["wte"].to(cdt))
    if config.embed_layernorm:
        x = _layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"])
    if config.pos_embed != "learned":
        return x
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    pe = F.embedding(positions, params["wpe"].to(cdt))
    return x + (pe if pe.dim() == x.dim() else pe[None])


class _HeadLogits(torch.autograd.Function):
    """fp32 logits from 16-bit operands on CUDA (``torch.mm`` with
    ``out_dtype``); the backward takes the logits' gradient in the operand
    dtype, as a mixed-precision matmul's backward does."""

    @staticmethod
    def forward(ctx, h2, head):
        ctx.save_for_backward(h2, head)
        return torch.mm(h2, head.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h2, head = ctx.saved_tensors
        g = g.to(h2.dtype)
        return g @ head, g.t() @ h2


def _head_logits(params: Params, h, config: GPTConfig):
    """Tied head on final-LayerNormed hiddens: operands in the compute
    dtype, fp32 logits (a bf16 product would round the logits and create
    greedy ties the JAX path does not have)."""
    cdt = config.dtype
    head = params["wte"].to(cdt)
    h2 = h.to(cdt).reshape(-1, h.shape[-1])
    if h2.is_cuda and cdt != torch.float32:
        logits = _HeadLogits.apply(h2, head)
    else:
        # the same products (exact in fp32) with fp32 accumulation
        logits = h2.float() @ head.float().t()
    return logits.view(*h.shape[:-1], -1)


def lm_logits(params: Params, x, config: GPTConfig):
    """Final LN + head → fp32 logits [..., padded_vocab]."""
    return _head_logits(
        params, _layer_norm(x, params["lnf_scale"], params["lnf_bias"]),
        config)


#: a block's parameters, in the order ``_RematBlock`` takes them
LAYER_KEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
              "ln2_scale", "ln2_bias", "wi", "bi", "wo_mlp", "bo_mlp")


def _block(x, p: Params, config: GPTConfig, saved=None,
           window: Optional[int] = None):
    """One transformer block on [B, S, d] → (output, (O, lse)).  The
    packed qkv goes to the differentiable flash op (banded by ``window``),
    or the block-sparse one under ``config.sparse_attention``; ``saved`` =
    (O, lse) replays an earlier forward's attention without the kernel.
    An unbanded ALiBi layer runs the dense path (lse None; it recomputes
    rather than replays)."""
    qkv = qkv_packed(x, p, config)
    if window is None and config.pos_embed == "alibi":
        o = _alibi_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             config)
        return block_tail(x, o, p, config), (o, None)
    if window is not None:
        o, lse = flash_attention_qkv(qkv, causal=True,
                                     sm_scale=config.attn_softmax_scale,
                                     saved=saved, window=window)
    elif config.sparse_attention is not None:
        o, lse = block_sparse_attention_qkv(qkv, _sparse_plan(config, qkv),
                                            saved=saved)
    else:
        o, lse = flash_attention_qkv(qkv, causal=True,
                                     sm_scale=config.attn_softmax_scale,
                                     saved=saved)
    return block_tail(x, o, p, config), (o, lse)


class _RematBlock(torch.autograd.Function):
    """Activation remat of one block (JAX ``jax.checkpoint`` per block).

    The forward runs the block without recording a graph and keeps the
    block input; under ``remat_policy="attn_out"`` also the attention's O
    [B, S, H, Dh] and lse [B, H, S] fp32.  The backward re-runs the block
    with gradients from the input and takes its gradient; with O and lse
    kept, the attention is replayed from them, so the forward kernel runs
    once per block and step instead of twice."""

    @staticmethod
    def forward(ctx, x, config, window, *leaves):
        y, (o, lse) = _block(x, dict(zip(LAYER_KEYS, leaves)), config,
                             window=window)
        keep = (o, lse) if config.remat_policy == "attn_out" and \
            lse is not None else ()
        ctx.save_for_backward(x, *keep, *leaves)
        ctx.config, ctx.n_keep, ctx.window = config, len(keep), window
        return y

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        n = ctx.n_keep
        x, keep, leaves = saved[0], saved[1:1 + n], saved[1 + n:]
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(needs[0])
            ps = [t.detach().requires_grad_(need)
                  for t, need in zip(leaves, needs[3:])]
            y, _ = _block(x_in, dict(zip(LAYER_KEYS, ps)), ctx.config,
                          saved=tuple(keep) or None, window=ctx.window)
        inputs = [t for t in (x_in, *ps) if t.requires_grad]
        grads = iter(torch.autograd.grad(y, inputs, gy, allow_unused=True))
        return ((next(grads) if x_in.requires_grad else None), None, None,
                *(next(grads) if t.requires_grad else None for t in ps))


def backbone(params: Params, tokens, config: GPTConfig):
    """Embed + transformer stack: tokens [B, S] → hidden [B, S, d]
    (before the final LayerNorm).  A stacked block weight may also be a
    list of per-layer tensors (the engine's per-layer autograd leaves)."""
    x = embed(params, tokens, config)
    remat = config.remat and torch.is_grad_enabled()
    for idx in range(config.n_layer):
        p = layer_params(params, idx)
        window = layer_window(config, idx)
        if remat:
            x = _RematBlock.apply(x, config, window,
                                  *(p[k] for k in LAYER_KEYS))
        else:
            x = _block(x, p, config, window=window)[0]
    return x


def apply(params: Params, tokens, config: GPTConfig):
    """Forward pass: tokens [B, S] → logits [B, S, padded_vocab] fp32."""
    return lm_logits(params, backbone(params, tokens, config), config)


# -------------------------------------------------------------------- train

def _token_nll(logits, targets):
    """Per-token masked NLL sums: (sum nll, count). targets < 0 are masked
    (the -100 convention)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.long().clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def _chunk_nll(h, wte, targets, config: GPTConfig):
    return _token_nll(_head_logits({"wte": wte}, h, config), targets)


def loss_fn(params: Params, batch, config: GPTConfig):
    """Mean next-token cross-entropy. batch: {'tokens': [B, S+1]} or
    {'input_ids', 'labels'} (labels < 0 masked)."""
    unported = sorted(k for k in batch if k.startswith("_"))
    if unported:
        raise NotImplementedError(f"batch keys {unported} (dropout and "
                                  "layer drop) are not ported yet")
    if "input_ids" in batch:
        inputs, targets = batch["input_ids"], batch["labels"]
    else:
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    chunk = config.loss_chunk
    if not chunk:
        tot, cnt = _token_nll(apply(params, inputs, config), targets)
        return tot / torch.clamp(cnt, min=1.0)
    S = inputs.shape[1]
    if S % chunk:
        # largest divisor of S that fits the requested chunk
        eff = next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
        logger.warning(f"loss_chunk={chunk} does not divide seq {S}; "
                       f"using chunk {eff}")
        chunk = eff
    x = backbone(params, inputs, config)
    h = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // chunk):
        hc, tc = h[:, i * chunk:(i + 1) * chunk], targets[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled():
            # the chunk's logits are recomputed in the backward
            t_i, c_i = torch.utils.checkpoint.checkpoint(
                _chunk_nll, hc, params["wte"], tc, config, use_reentrant=False)
        else:
            t_i, c_i = _chunk_nll(hc, params["wte"], tc, config)
        tot, cnt = tot + t_i, cnt + c_i
    return tot / torch.clamp(cnt, min=1.0)


def flops_per_token(config: GPTConfig) -> float:
    """6N + attention flops per token (for MFU accounting)."""
    d, L, S = config.d_model, config.n_layer, config.max_seq_len
    n_params = (config.padded_vocab * d + S * d + L * (12 * d * d + 13 * d) + 2 * d)
    return 6.0 * n_params + 12.0 * L * d * S
