"""GPT with Mixture-of-Experts FFNs: the port of ``models/gpt_moe.py``.

DeepSpeed-MoE's layout: every other layer's dense FFN is an expert layer.
The layers run in pairs, a dense block (``dense_blocks``, the GPT tree's
block) then an attention half block (``moe_attn_blocks``: LN1, attention,
LN2) whose FFN is the ``MoE`` layer of ``moe_blocks`` (``gate``,
``experts`` and, with ``use_residual``, ``residual_mlp`` and
``coefficient``), each subtree stacked over the ``n_layer // 2`` pairs.
:func:`apply` returns the logits and the sum of the pairs' load-balancing
losses; :func:`loss_fn` adds ``aux_loss_coef`` times it to the LM loss.

The model is GPT-2's layout (learned positions, tied head), as the JAX
model's ``apply`` reads ``wte`` and ``wpe`` directly; a config with
another variant raises.  Its experts are ``4·d`` wide whatever ``d_ff``
says (JAX ``_moe_obj`` leaves ``expert_intermediate_size`` unset).
Training gating drops past the capacity (``capacity_factor``, eval:
``eval_capacity_factor``) and never uses random priorities or noise
(``use_rts`` off, as ``_moe_obj`` sets it).  Under ``remat`` each dense
block is ``gpt._RematBlock`` and each half block :class:`_RematMoEHalf`,
which keeps its input (and, under ``"attn_out"``, the attention's O and
lse) and the forward's routing, so the replay routes as the forward did.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..moe.layer import MoE
from ..ops.kernels.flash_attention import flash_attention_qkv
from . import gpt

Params = Dict[str, Any]

#: the GPTConfig fields GPT-MoE keeps at GPT-2's values, and those values
_GPT2_LAYOUT = {"pos_embed": "learned", "pos_offset": 0,
                "embed_layernorm": False, "parallel_residual": False,
                "local_attention_window": 0, "tie_word_embeddings": True,
                "lm_head_bias": False, "sparse_attention": None}


@dataclasses.dataclass(frozen=True)
class GPTMoEConfig(gpt.GPTConfig):
    num_experts: int = 8
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_coef: float = 0.01
    use_residual: bool = False
    ep_size: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.n_layer % 2:
            raise ValueError("GPT-MoE requires an even layer count")
        other = {k: getattr(self, k) for k, v in _GPT2_LAYOUT.items()
                 if getattr(self, k) != v}
        if other:
            raise ValueError(f"GPT-MoE takes GPT-2's layout (learned "
                             f"positions, tied head); got {other}")
        if self.ep_size != 1:
            raise NotImplementedError(
                f"GPTMoEConfig.ep_size={self.ep_size}: expert parallelism "
                "is not ported yet (ROADMAP.md Queue 1 #7)")

    @property
    def n_pairs(self) -> int:
        return self.n_layer // 2


#: the JAX package's preset (BASELINE.md: MoE 350M x 64 experts, top-1)
GPT_MOE_350M_64E = GPTMoEConfig(n_layer=24, n_head=16, d_model=1024,
                                num_experts=64, moe_top_k=1)


def moe_layer(config: GPTMoEConfig, drop_tokens: bool = True) -> MoE:
    """The pairs' expert layer (JAX ``_moe_obj``): deterministic gating."""
    return MoE(hidden_size=config.d_model, num_experts=config.num_experts,
               ep_size=config.ep_size, k=config.moe_top_k,
               capacity_factor=config.capacity_factor,
               eval_capacity_factor=config.eval_capacity_factor,
               min_capacity=config.min_capacity,
               use_residual=config.use_residual, drop_tokens=drop_tokens,
               use_rts=False)


def _as_gpt_config(config: GPTMoEConfig, n_layer: int) -> gpt.GPTConfig:
    base = gpt.GPTConfig(**{f.name: getattr(config, f.name)
                            for f in dataclasses.fields(gpt.GPTConfig)})
    return dataclasses.replace(base, n_layer=n_layer)


#: the dense FFN's leaves, which the attention half block does not have
_FFN_KEYS = ("wi", "bi", "wo_mlp", "bo_mlp")


def init(config: GPTMoEConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Params:
    """Random weights (JAX ``gpt_moe.init``'s stds: the blocks as a GPT of
    ``n_pairs`` layers, experts normal 0.02, the gate fp32) in
    ``config.param_dtype`` on ``device``, drawn from ``generator``.  Each
    pair's experts are drawn in fp32 and cast into the stack one pair at a
    time, so the card holds one pair's fp32 draw beside the stack."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    P = config.n_pairs
    dense = gpt.init(_as_gpt_config(config, P), generator, device)["blocks"]
    attn = gpt.init(_as_gpt_config(config, P), generator, device)["blocks"]
    for k in _FFN_KEYS:
        attn.pop(k)
    moe = moe_layer(config)
    first = moe.init(generator, config.param_dtype, device)
    stack = _map(first, lambda x: torch.empty((P,) + tuple(x.shape),
                                              dtype=x.dtype, device=device))
    for i in range(P):
        layer = first if i == 0 else \
            moe.init(generator, config.param_dtype, device)
        _map2(stack, layer, lambda s, x: s[i].copy_(x))
        del layer
    outer = gpt.init(_as_gpt_config(config, 1), generator, device)
    return {"wte": outer["wte"], "wpe": outer["wpe"], "dense_blocks": dense,
            "moe_attn_blocks": attn, "moe_blocks": stack,
            "lnf_scale": outer["lnf_scale"], "lnf_bias": outer["lnf_bias"]}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _map2(a, b, fn):
    for k, v in a.items():
        if isinstance(v, dict):
            _map2(v, b[k], fn)
        else:
            fn(v, b[k])


def pair_params(params: Params, idx: int) -> Tuple[Params, Params, Params]:
    """Pair ``idx``'s (dense block, attention half block, MoE layer)
    leaves: views of the stacks, or the engine's per-layer leaves."""
    def sl(tree):
        return {k: sl(v) if isinstance(v, dict) else v[idx]
                for k, v in tree.items()}
    return (sl(params["dense_blocks"]), sl(params["moe_attn_blocks"]),
            sl(params["moe_blocks"]))


def _moe_half_block(x, attn_p: Params, moe_p: Params, moe: MoE,
                    config: GPTMoEConfig, train: bool, routing=None,
                    saved=None):
    """The block whose FFN is the expert layer: x + attention, then + the
    MoE of its LN2.  Returns (output, l_aux, routing, (O, lse))."""
    qkv = gpt.qkv_packed(x, attn_p, config)
    o, lse = flash_attention_qkv(qkv, causal=True,
                                 sm_scale=config.attn_softmax_scale,
                                 saved=saved)
    x = x + gpt.attn_project(o, attn_p, config)
    h2 = gpt._layer_norm(x, attn_p["ln2_scale"], attn_p["ln2_bias"])
    out, l_aux, _counts, routing = moe.forward_routed(moe_p, h2, train=train,
                                                      routing=routing)
    return x + out, l_aux, routing, (o, lse)


def _flatten(tree: Params, prefix: Tuple[str, ...] = ()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflatten(paths, leaves) -> Params:
    tree: Params = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


class _RematMoEHalf(torch.autograd.Function):
    """Activation remat of one attention half block and its expert layer
    (JAX ``jax.checkpoint`` of ``_moe_half_block``).  The forward keeps
    the block input, the routing it took and, under ``remat_policy=
    "attn_out"``, the attention's O and lse; the backward replays the
    block with gradients on the kept routing (so it routes bitwise as the
    forward) and the kept attention (so the forward kernel runs once)."""

    @staticmethod
    def forward(ctx, x, config, moe, train, paths, *leaves):
        p = _unflatten(paths, leaves)
        y, l_aux, routing, (o, lse) = _moe_half_block(
            x, p["attn"], p["moe"], moe, config, train)
        keep = (o, lse) if config.remat_policy == "attn_out" else ()
        ctx.save_for_backward(x, *keep, *leaves)
        ctx.config, ctx.moe, ctx.train, ctx.paths = config, moe, train, paths
        ctx.n_keep, ctx.routing = len(keep), routing
        return y, l_aux

    @staticmethod
    def backward(ctx, gy, g_aux):
        saved = ctx.saved_tensors
        n = ctx.n_keep
        x, keep, leaves = saved[0], saved[1:1 + n], saved[1 + n:]
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(needs[0])
            ps = [t.detach().requires_grad_(need)
                  for t, need in zip(leaves, needs[5:])]
            p = _unflatten(ctx.paths, ps)
            y, l_aux, _, _ = _moe_half_block(
                x_in, p["attn"], p["moe"], ctx.moe, ctx.config, ctx.train,
                routing=ctx.routing, saved=tuple(keep) or None)
        inputs = [t for t in (x_in, *ps) if t.requires_grad]
        grads = iter(torch.autograd.grad((y, l_aux), inputs, (gy, g_aux),
                                         allow_unused=True))
        return ((next(grads) if x_in.requires_grad else None), None, None,
                None, None,
                *(next(grads) if t.requires_grad else None for t in ps))


def apply(params: Params, tokens, config: GPTMoEConfig, train: bool = True):
    """tokens [B, S] → (logits [B, S, padded_vocab] fp32, total aux loss
    fp32)."""
    moe = moe_layer(config)
    x = gpt.embed(params, tokens, config)
    remat = config.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_pairs):
        dense_p, attn_p, moe_p = pair_params(params, i)
        if remat:
            x = gpt._RematBlock.apply(x, config, None, None,
                                      *(dense_p[k] for k in gpt.LAYER_KEYS))
            paths, leaves = zip(*_flatten({"attn": attn_p, "moe": moe_p}))
            x, l_aux = _RematMoEHalf.apply(x, config, moe, train, paths,
                                           *leaves)
        else:
            x = gpt._block(x, dense_p, config)[0]
            x, l_aux, _, _ = _moe_half_block(x, attn_p, moe_p, moe, config,
                                             train)
        aux = aux + l_aux
    return gpt.lm_logits(params, x, config), aux


def loss_fn(params: Params, batch, config: GPTMoEConfig,
            train: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S+1]
    (targets < 0 masked) + ``aux_loss_coef`` · the aux loss."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = apply(params, inputs, config, train=train)
    tot, cnt = gpt._token_nll(logits, targets)
    return tot / torch.clamp(cnt, min=1.0) + config.aux_loss_coef * aux


def flops_per_token(config: GPTMoEConfig) -> float:
    """6N + attention FLOPs per token (for MFU) with N the parameters a
    token meets: the embeddings, every attention and dense FFN, the gate
    and ``moe_top_k`` routed experts per expert layer (and the residual
    MLP).  Capacity padding and dropped routes are not counted."""
    d, L, S, P = config.d_model, config.n_layer, config.max_seq_len, \
        config.n_pairs
    f = 4 * d
    expert = 2 * d * f + f + d
    per_pair = (12 * d * d + 13 * d) + (4 * d * d + 8 * d) + \
        config.moe_top_k * expert + d * config.num_experts
    if config.use_residual:
        per_pair += expert + 2 * d
    n_active = config.padded_vocab * d + S * d + P * per_pair + 2 * d
    return 6.0 * n_active + 12.0 * L * d * S
