"""Weight-injection policies: diffusers state dicts → the port's diffusion
models, the port of the diffusers half of ``module_inject/replace_policy.py``.

A policy maps a state dict (torch tensors or numpy arrays) in diffusers'
key names and layouts into the parameter tree of ``models/diffusion.py``
and serves it through ``DSUNet`` or ``DSVAE``: torch ``[out, in]``
linears transpose to ``[in, out]``, 1x1 ``proj_in``/``proj_out`` and VAE
attention convs collapse to linears, and the OIHW convolutions are kept
as they are (the port's tree is OIHW).  The architecture is inferred from
the state dict; ``n_head`` and ``groups`` are not recoverable from the
weights and come from the caller (SD 1.x: 8 and 32).

The HF decoder policies (GPT-2, GPT-Neo, BLOOM; :data:`POLICIES`,
:func:`convert_hf_model`) map a ``transformers`` model's state dict into
the tree of ``models/gpt.py``; OPT, GPT-NeoX and GPT-J match and raise.
The BERT and CLIP text policies are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models import gpt
from ..models.diffusion import UNetConfig, VAEConfig, cast_params

Params = Dict[str, Any]


def _t(x) -> torch.Tensor:
    """A state-dict value as a tensor (numpy arrays are copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _convert_diffusers_resnet(sd: Dict[str, Any], pre: str) -> Params:
    """ResnetBlock2D state-dict slice → the resnet tree (shared by the UNet
    and VAE converters; time_emb_proj/conv_shortcut keyed on presence)."""
    get = lambda k: _t(sd[k])
    p = {"norm1_scale": get(pre + "norm1.weight"),
         "norm1_bias": get(pre + "norm1.bias"),
         "conv1_w": get(pre + "conv1.weight"),
         "conv1_b": get(pre + "conv1.bias"),
         "norm2_scale": get(pre + "norm2.weight"),
         "norm2_bias": get(pre + "norm2.bias"),
         "conv2_w": get(pre + "conv2.weight"),
         "conv2_b": get(pre + "conv2.bias")}
    if pre + "time_emb_proj.weight" in sd:
        p["time_w"] = get(pre + "time_emb_proj.weight").T
        p["time_b"] = get(pre + "time_emb_proj.bias")
    if pre + "conv_shortcut.weight" in sd:
        p["short_w"] = get(pre + "conv_shortcut.weight")
        p["short_b"] = get(pre + "conv_shortcut.bias")
    return p


def _as_linear(w: torch.Tensor) -> torch.Tensor:
    """A torch Linear [out, in] or 1x1 conv [out, in, 1, 1] → [in, out]."""
    return w.reshape(w.shape[0], -1).T


class UNetPolicy:
    """Diffusers ``UNet2DConditionModel`` → the NHWC UNet, served through
    ``DSUNet``."""

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return "conv_in.weight" in sd and \
            any("transformer_blocks" in k for k in sd) and \
            not any(k.startswith(("decoder.", "encoder.")) for k in sd)

    @staticmethod
    def model_config(sd: Dict[str, Any], n_head: int = 8, groups: int = 32,
                     dtype: torch.dtype = torch.float32) -> UNetConfig:
        n_down = 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("down_blocks."))
        chans = tuple(int(sd[f"down_blocks.{i}.resnets.0.conv1.weight"]
                          .shape[0]) for i in range(n_down))
        layers = 1 + max(int(k.split(".")[3]) for k in sd
                         if k.startswith("down_blocks.0.resnets."))
        attn2_k = next(k for k in sd if k.endswith("attn2.to_k.weight"))
        # SD 1.x: the last down block is attention-free (DownBlock2D)
        attn_levels = tuple(
            f"down_blocks.{i}.attentions.0.transformer_blocks.0."
            "attn1.to_q.weight" in sd for i in range(n_down))
        return UNetConfig(
            in_channels=int(sd["conv_in.weight"].shape[1]),
            out_channels=int(sd["conv_out.weight"].shape[0]),
            block_channels=chans, layers_per_block=layers,
            cross_attn_dim=int(sd[attn2_k].shape[1]),
            n_head=n_head, groups=groups, attn_levels=attn_levels,
            dtype=dtype)

    @staticmethod
    def convert(sd: Dict[str, Any], config: UNetConfig,
                device=None) -> Params:
        """The tree in ``config.dtype`` on ``device``."""
        get = lambda k: _t(sd[k])
        lw = lambda k: get(k).T                           # [out,in] -> [in,out]
        res = lambda pre: _convert_diffusers_resnet(sd, pre)

        def attnblk(pre):
            t = pre + "transformer_blocks.0."

            def attn(a):
                return {"q_w": lw(t + a + ".to_q.weight"),
                        "k_w": lw(t + a + ".to_k.weight"),
                        "v_w": lw(t + a + ".to_v.weight"),
                        "o_w": lw(t + a + ".to_out.0.weight"),
                        "o_b": get(t + a + ".to_out.0.bias")}

            return {
                "norm_scale": get(pre + "norm.weight"),
                "norm_bias": get(pre + "norm.bias"),
                # a 1x1 conv in SD 1.x, a Linear with use_linear_projection
                "proj_in_w": _as_linear(get(pre + "proj_in.weight")),
                "proj_in_b": get(pre + "proj_in.bias"),
                "proj_out_w": _as_linear(get(pre + "proj_out.weight")),
                "proj_out_b": get(pre + "proj_out.bias"),
                "block": {
                    "norm1_scale": get(t + "norm1.weight"),
                    "norm1_bias": get(t + "norm1.bias"),
                    "attn1": attn("attn1"),
                    "norm2_scale": get(t + "norm2.weight"),
                    "norm2_bias": get(t + "norm2.bias"),
                    "attn2": attn("attn2"),
                    "norm3_scale": get(t + "norm3.weight"),
                    "norm3_bias": get(t + "norm3.bias"),
                    "ff_in_w": lw(t + "ff.net.0.proj.weight"),
                    "ff_in_b": get(t + "ff.net.0.proj.bias"),
                    "ff_out_w": lw(t + "ff.net.2.weight"),
                    "ff_out_b": get(t + "ff.net.2.bias"),
                },
            }

        n_down = len(config.block_channels)
        L = config.layers_per_block
        params: Params = {
            "time_w1": lw("time_embedding.linear_1.weight"),
            "time_b1": get("time_embedding.linear_1.bias"),
            "time_w2": lw("time_embedding.linear_2.weight"),
            "time_b2": get("time_embedding.linear_2.bias"),
            "conv_in_w": get("conv_in.weight"),
            "conv_in_b": get("conv_in.bias"),
            "norm_out_scale": get("conv_norm_out.weight"),
            "norm_out_bias": get("conv_norm_out.bias"),
            "conv_out_w": get("conv_out.weight"),
            "conv_out_b": get("conv_out.bias"),
            "down": [], "up": [],
            "mid": {"resnet1": res("mid_block.resnets.0."),
                    "attention": attnblk("mid_block.attentions.0."),
                    "resnet2": res("mid_block.resnets.1.")},
        }
        for i in range(n_down):
            blk = {"resnets": [res(f"down_blocks.{i}.resnets.{j}.")
                               for j in range(L)]}
            if config.level_has_attn(i):
                blk["attentions"] = [
                    attnblk(f"down_blocks.{i}.attentions.{j}.")
                    for j in range(L)]
            dkey = f"down_blocks.{i}.downsamplers.0.conv.weight"
            if dkey in sd:
                blk["downsample"] = {"conv_w": get(dkey),
                                     "conv_b": get(dkey[:-6] + "bias")}
            params["down"].append(blk)
        for i in range(n_down):
            blk = {"resnets": [res(f"up_blocks.{i}.resnets.{j}.")
                               for j in range(L + 1)]}
            if config.level_has_attn(n_down - 1 - i):  # mirrored order
                blk["attentions"] = [
                    attnblk(f"up_blocks.{i}.attentions.{j}.")
                    for j in range(L + 1)]
            ukey = f"up_blocks.{i}.upsamplers.0.conv.weight"
            if ukey in sd:
                blk["upsample"] = {"conv_w": get(ukey),
                                   "conv_b": get(ukey[:-6] + "bias")}
            params["up"].append(blk)
        return cast_params(params, config.dtype, device)

    @staticmethod
    def apply(sd: Dict[str, Any], n_head: int = 8, groups: int = 32,
              dtype: torch.dtype = torch.float32,
              enable_cuda_graph: bool = True, device=None):
        from ..model_implementations.diffusers import DSUNet
        config = UNetPolicy.model_config(sd, n_head, groups, dtype)
        return DSUNet(config, UNetPolicy.convert(sd, config, device),
                      enable_cuda_graph=enable_cuda_graph)


class VAEPolicy:
    """Diffusers ``AutoencoderKL`` → the NHWC VAE, served through
    ``DSVAE``."""

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return "post_quant_conv.weight" in sd and \
            any(k.startswith("decoder.") for k in sd)

    @staticmethod
    def model_config(sd: Dict[str, Any], groups: int = 32,
                     dtype: torch.dtype = torch.float32) -> VAEConfig:
        n_down = 1 + max(int(k.split(".")[2]) for k in sd
                         if k.startswith("encoder.down_blocks."))
        chans = tuple(int(sd[f"encoder.down_blocks.{i}.resnets.0.conv1"
                             ".weight"].shape[0]) for i in range(n_down))
        layers = 1 + max(int(k.split(".")[4]) for k in sd
                         if k.startswith("encoder.down_blocks.0.resnets."))
        return VAEConfig(
            in_channels=int(sd["encoder.conv_in.weight"].shape[1]),
            latent_channels=int(sd["post_quant_conv.weight"].shape[1]),
            block_channels=chans, layers_per_block=layers, groups=groups,
            dtype=dtype)

    @staticmethod
    def convert(sd: Dict[str, Any], config: VAEConfig,
                device=None) -> Params:
        """The tree in ``config.dtype`` on ``device``."""
        get = lambda k: _t(sd[k])
        res = lambda pre: _convert_diffusers_resnet(sd, pre)

        def mid_attn(pre):
            """AttnBlock in either key era (to_q/... or
            query/key/value/proj_attn; the norm group_norm or norm)."""
            new = pre + "to_q.weight" in sd
            names = [("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                     ("to_out.0", "proj_attn")]
            out = {}
            for field, (nn, on) in zip("qkvo", names):
                k = pre + (nn if new else on)
                out[f"{field}_w"] = _as_linear(get(k + ".weight"))
                out[f"{field}_b"] = get(k + ".bias")
            norm = pre + ("group_norm." if pre + "group_norm.weight" in sd
                          else "norm.")
            out["norm_scale"] = get(norm + "weight")
            out["norm_bias"] = get(norm + "bias")
            return out

        def half(side, n_blocks, per_block, down: bool):
            p: Params = {
                "conv_in_w": get(f"{side}.conv_in.weight"),
                "conv_in_b": get(f"{side}.conv_in.bias"),
                "mid_resnet1": res(f"{side}.mid_block.resnets.0."),
                "mid_attn": mid_attn(f"{side}.mid_block.attentions.0."),
                "mid_resnet2": res(f"{side}.mid_block.resnets.1."),
                "norm_out_scale": get(f"{side}.conv_norm_out.weight"),
                "norm_out_bias": get(f"{side}.conv_norm_out.bias"),
                "conv_out_w": get(f"{side}.conv_out.weight"),
                "conv_out_b": get(f"{side}.conv_out.bias"),
            }
            kind = "down_blocks" if down else "up_blocks"
            samp = "downsamplers" if down else "upsamplers"
            blocks = []
            for i in range(n_blocks):
                blk = {"resnets": [res(f"{side}.{kind}.{i}.resnets.{j}.")
                                   for j in range(per_block)]}
                skey = f"{side}.{kind}.{i}.{samp}.0.conv.weight"
                if skey in sd:
                    blk["downsample" if down else "upsample"] = {
                        "conv_w": get(skey), "conv_b": get(skey[:-6] + "bias")}
                blocks.append(blk)
            p["down" if down else "up"] = blocks
            return p

        L = config.layers_per_block
        n = len(config.block_channels)
        params = {
            "encoder": half("encoder", n, L, down=True),
            "decoder": half("decoder", n, L + 1, down=False),
            "quant_w": get("quant_conv.weight"),
            "quant_b": get("quant_conv.bias"),
            "post_quant_w": get("post_quant_conv.weight"),
            "post_quant_b": get("post_quant_conv.bias"),
        }
        return cast_params(params, config.dtype, device)

    @staticmethod
    def apply(sd: Dict[str, Any], groups: int = 32,
              dtype: torch.dtype = torch.float32,
              enable_cuda_graph: bool = True, device=None, n_head=None):
        """``n_head`` is accepted and unused: the VAE's attention has one
        head."""
        from ..model_implementations.diffusers import DSVAE
        config = VAEPolicy.model_config(sd, groups, dtype)
        return DSVAE(config, VAEPolicy.convert(sd, config, device),
                     enable_cuda_graph=enable_cuda_graph)


#: generic (non-transformer-LM) policies, matched by init_inference on a
#: state dict (reference generic_policies, replace_module.py)
GENERIC_POLICIES = [UNetPolicy, VAEPolicy]


# ------------------------------------------------ HF decoder policies
#
# The port of ``HFGPT2LayerPolicy``, ``HFGPTNEOLayerPolicy`` and
# ``BLOOMLayerPolicy`` (JAX ``replace_policy.py:28-221,396-471``): an HF
# state dict (torch tensors or numpy arrays) → the stacked [L, ...] tree
# of ``models/gpt.py``, the same arrays as the JAX policies build, as fp32
# tensors.  The OPT, GPT-NeoX and GPT-J policies match as in JAX and
# raise: their variants (offset positions and relu, rotary and parallel
# residual, an untied biased head) are not ported yet.


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _linear_w(sd_get, name):
    """torch Linear stores [out, in]; the tree takes [in, out]."""
    return _np(sd_get(name)).T


def _fused_qkv_per_head(w, b, H, Dh, d):
    """BLOOM fuses qkv as [(H, 3, Dh), d], per head interleaved.  Returns
    (wqkv [d, 3, H, Dh], bqkv [3, H, Dh])."""
    wq = w.reshape(H, 3, Dh, d).transpose(3, 1, 0, 2)
    bq = b.reshape(H, 3, Dh).transpose(1, 0, 2)
    return wq, bq


def _pad_vocab(w, padded_vocab: int):
    """Zero-pad vocab-leading tensors up to the padded vocab."""
    pad = padded_vocab - w.shape[0]
    if pad:
        return np.concatenate([w, np.zeros((pad,) + w.shape[1:], np.float32)])
    return w


def _tree_to_torch(tree, dtype: torch.dtype) -> Params:
    return {k: _tree_to_torch(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            for k, v in tree.items()}


def _prefix(sd: Dict[str, Any]) -> str:
    return "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""


class HFGPT2LayerPolicy:
    """transformers GPT-2 (``GPT2LMHeadModel``); Conv1D weights are stored
    [in, out], so no transposes are needed."""

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any(k.endswith("attn.c_attn.weight") for k in sd)

    @staticmethod
    def model_config(hf_config, dtype=torch.float32) -> gpt.GPTConfig:
        return gpt.GPTConfig(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.n_positions,
            n_layer=hf_config.n_layer,
            n_head=hf_config.n_head,
            d_model=hf_config.n_embd,
            dtype=dtype)

    @staticmethod
    def convert(sd: Dict[str, Any], config: gpt.GPTConfig) -> Params:
        L, d = config.n_layer, config.d_model
        H, Dh = config.n_head, config.head_dim
        prefix = _prefix(sd)

        def get(name):
            return _np(sd[prefix + name])

        def layer(i, name):
            return get(f"h.{i}.{name}")

        block = {
            "ln1_scale": np.stack([layer(i, "ln_1.weight") for i in range(L)]),
            "ln1_bias": np.stack([layer(i, "ln_1.bias") for i in range(L)]),
            "wqkv": np.stack([
                layer(i, "attn.c_attn.weight").reshape(d, 3, H, Dh)
                for i in range(L)]),
            "bqkv": np.stack([
                layer(i, "attn.c_attn.bias").reshape(3, H, Dh)
                for i in range(L)]),
            "wo": np.stack([
                layer(i, "attn.c_proj.weight").reshape(H, Dh, d)
                for i in range(L)]),
            "bo": np.stack([layer(i, "attn.c_proj.bias") for i in range(L)]),
            "ln2_scale": np.stack([layer(i, "ln_2.weight") for i in range(L)]),
            "ln2_bias": np.stack([layer(i, "ln_2.bias") for i in range(L)]),
            "wi": np.stack([layer(i, "mlp.c_fc.weight") for i in range(L)]),
            "bi": np.stack([layer(i, "mlp.c_fc.bias") for i in range(L)]),
            "wo_mlp": np.stack([layer(i, "mlp.c_proj.weight")
                                for i in range(L)]),
            "bo_mlp": np.stack([layer(i, "mlp.c_proj.bias")
                                for i in range(L)]),
        }
        params = {
            "wte": _pad_vocab(get("wte.weight"), config.padded_vocab),
            "wpe": get("wpe.weight"),
            "blocks": block,
            "lnf_scale": get("ln_f.weight"),
            "lnf_bias": get("ln_f.bias"),
        }
        return _tree_to_torch(params, config.param_dtype)


class HFGPTNEOLayerPolicy:
    """transformers GPT-Neo (``GPTNeoForCausalLM``): separate bias-free
    q/k/v projections, an unscaled attention softmax, and alternating
    global/local-window layers (``local_attention_window`` with
    ``local_attention_alternating``)."""

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any("attn.attention.q_proj.weight" in k for k in sd)

    @staticmethod
    def model_config(hf_config, dtype=torch.float32) -> gpt.GPTConfig:
        att_types = [t for pattern, n in getattr(
            hf_config, "attention_types", [[["global"], 1]])
            for t in pattern * n]
        alternating = "local" in att_types
        if alternating and not all(t == ("local" if i % 2 else "global")
                                   for i, t in enumerate(att_types)):
            # the only layout GPT-Neo ships is strict global/local alternation
            raise ValueError(f"unsupported GPT-Neo attention layout "
                             f"{att_types}")
        inter = getattr(hf_config, "intermediate_size", None)
        return gpt.GPTConfig(
            vocab_size=hf_config.vocab_size,
            max_seq_len=hf_config.max_position_embeddings,
            n_layer=hf_config.num_layers,
            n_head=hf_config.num_heads,
            d_model=hf_config.hidden_size,
            d_ff=inter if inter is not None else 4 * hf_config.hidden_size,
            attn_softmax_scale=1.0,      # GPT-Neo never scales by 1/sqrt(Dh)
            local_attention_window=(hf_config.window_size if alternating
                                    else 0),
            local_attention_alternating=alternating,
            dtype=dtype)

    @staticmethod
    def convert(sd: Dict[str, Any], config: gpt.GPTConfig) -> Params:
        L, d = config.n_layer, config.d_model
        H, Dh = config.n_head, config.head_dim
        pre = _prefix(sd)

        def get(name):
            return sd[pre + name]

        def lw(i, name):
            return _linear_w(get, f"h.{i}.{name}.weight")

        def lb(i, name):
            return _np(get(f"h.{i}.{name}.bias"))

        def lnorm(i, name, part):
            return _np(get(f"h.{i}.{name}.{part}"))

        def qkv_w(i):
            return np.stack(
                [lw(i, f"attn.attention.{n}_proj").reshape(d, H, Dh)
                 for n in ("q", "k", "v")], axis=1)

        block = {
            "ln1_scale": np.stack([lnorm(i, "ln_1", "weight")
                                   for i in range(L)]),
            "ln1_bias": np.stack([lnorm(i, "ln_1", "bias")
                                  for i in range(L)]),
            "wqkv": np.stack([qkv_w(i) for i in range(L)]),
            # q/k/v projections carry no bias in GPT-Neo
            "bqkv": np.zeros((L, 3, H, Dh), np.float32),
            "wo": np.stack([lw(i, "attn.attention.out_proj").reshape(H, Dh, d)
                            for i in range(L)]),
            "bo": np.stack([lb(i, "attn.attention.out_proj")
                            for i in range(L)]),
            "ln2_scale": np.stack([lnorm(i, "ln_2", "weight")
                                   for i in range(L)]),
            "ln2_bias": np.stack([lnorm(i, "ln_2", "bias")
                                  for i in range(L)]),
            "wi": np.stack([lw(i, "mlp.c_fc") for i in range(L)]),
            "bi": np.stack([lb(i, "mlp.c_fc") for i in range(L)]),
            "wo_mlp": np.stack([lw(i, "mlp.c_proj") for i in range(L)]),
            "bo_mlp": np.stack([lb(i, "mlp.c_proj") for i in range(L)]),
        }
        params = {
            "wte": _pad_vocab(_np(get("wte.weight")), config.padded_vocab),
            "wpe": _np(get("wpe.weight")),
            "blocks": block,
            "lnf_scale": _np(get("ln_f.weight")),
            "lnf_bias": _np(get("ln_f.bias")),
        }
        return _tree_to_torch(params, config.param_dtype)


class BLOOMLayerPolicy:
    """transformers BLOOM (``BloomForCausalLM``): ALiBi positions, fused
    per-head qkv, embedding LayerNorm."""

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any("self_attention.query_key_value" in k for k in sd) and \
            any("word_embeddings_layernorm" in k for k in sd)

    @staticmethod
    def model_config(hf_config, dtype=torch.float32) -> gpt.GPTConfig:
        return gpt.GPTConfig(
            vocab_size=hf_config.vocab_size,
            max_seq_len=getattr(hf_config, "seq_length", 2048),
            n_layer=hf_config.n_layer,
            n_head=hf_config.n_head,
            d_model=hf_config.hidden_size,
            pos_embed="alibi",
            embed_layernorm=True,
            dtype=dtype)

    @staticmethod
    def convert(sd: Dict[str, Any], config: gpt.GPTConfig) -> Params:
        L, d = config.n_layer, config.d_model
        H, Dh = config.n_head, config.head_dim
        pre = _prefix(sd)

        def get(name):
            return sd[pre + name]

        def fused(i):
            w = _np(get(f"h.{i}.self_attention.query_key_value.weight"))
            b = _np(get(f"h.{i}.self_attention.query_key_value.bias"))
            return _fused_qkv_per_head(w, b, H, Dh, d)

        qkvs = [fused(i) for i in range(L)]

        def lw(i, name):
            return _np(get(f"h.{i}.{name}.weight")).T

        def lb(i, name):
            return _np(get(f"h.{i}.{name}.bias"))

        def ln(i, name, part):
            return _np(get(f"h.{i}.{name}.{part}"))

        block = {
            "ln1_scale": np.stack([ln(i, "input_layernorm", "weight")
                                   for i in range(L)]),
            "ln1_bias": np.stack([ln(i, "input_layernorm", "bias")
                                  for i in range(L)]),
            "wqkv": np.stack([w for w, _ in qkvs]),
            "bqkv": np.stack([b for _, b in qkvs]),
            "wo": np.stack([lw(i, "self_attention.dense").reshape(H, Dh, d)
                            for i in range(L)]),
            "bo": np.stack([lb(i, "self_attention.dense") for i in range(L)]),
            "ln2_scale": np.stack([ln(i, "post_attention_layernorm", "weight")
                                   for i in range(L)]),
            "ln2_bias": np.stack([ln(i, "post_attention_layernorm", "bias")
                                  for i in range(L)]),
            "wi": np.stack([lw(i, "mlp.dense_h_to_4h") for i in range(L)]),
            "bi": np.stack([lb(i, "mlp.dense_h_to_4h") for i in range(L)]),
            "wo_mlp": np.stack([lw(i, "mlp.dense_4h_to_h") for i in range(L)]),
            "bo_mlp": np.stack([lb(i, "mlp.dense_4h_to_h") for i in range(L)]),
        }
        params = {
            "wte": _pad_vocab(_np(get("word_embeddings.weight")),
                              config.padded_vocab),
            "emb_ln_scale": _np(get("word_embeddings_layernorm.weight")),
            "emb_ln_bias": _np(get("word_embeddings_layernorm.bias")),
            "blocks": block,
            "lnf_scale": _np(get("ln_f.weight")),
            "lnf_bias": _np(get("ln_f.bias")),
        }
        return _tree_to_torch(params, config.param_dtype)


class _UnportedPolicy:
    """A decoder family the JAX package injects whose model variants the
    port does not have yet: it matches as the JAX policy does, then
    raises, so such a model is refused by name rather than unmatched."""

    variants = ""

    @classmethod
    def _refuse(cls, *_args, **_kwargs):
        raise NotImplementedError(
            f"{cls.__name__}: {cls.variants} are not ported yet (ROADMAP.md "
            "Queue 1 #6)")

    model_config = convert = _refuse


class HFOPTLayerPolicy(_UnportedPolicy):
    """transformers OPT: positions stored at an offset of 2, relu MLP."""

    variants = "OPT's offset positions and relu MLP"

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any("self_attn.q_proj.weight" in k and "decoder" in k
                   for k in sd)


class GPTNEOXLayerPolicy(_UnportedPolicy):
    """transformers GPT-NeoX: rotary positions, parallel residual, untied
    head."""

    variants = "GPT-NeoX's rotary positions, parallel residual and untied head"

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any("attention.query_key_value" in k and
                   ("gpt_neox" in k or k.startswith("layers.")) for k in sd)


class HFGPTJLayerPolicy(_UnportedPolicy):
    """transformers GPT-J: interleaved rotary, parallel residual, biased
    untied head."""

    variants = ("GPT-J's interleaved rotary positions, parallel residual "
                "and biased untied head")

    @staticmethod
    def match(sd: Dict[str, Any]) -> bool:
        return any("attn.q_proj.weight" in k and "h." in k for k in sd)


#: the decoder policies, in the JAX package's order
POLICIES = [HFGPT2LayerPolicy, HFGPTNEOLayerPolicy, HFOPTLayerPolicy,
            BLOOMLayerPolicy, GPTNEOXLayerPolicy, HFGPTJLayerPolicy]


def match_decoder(sd: Dict[str, Any]):
    """The first decoder policy that matches ``sd``, or None."""
    return next((p for p in POLICIES if p.match(sd)), None)


def convert_hf_model(hf_model, dtype=torch.float32):
    """An HF module (anything with ``.config`` and ``.state_dict()``) →
    (``GPTConfig``, params): the JAX package's automatic policy match."""
    sd = hf_model.state_dict()
    policy = match_decoder(sd)
    if policy is None:
        raise ValueError(f"no injection policy matches this model; known: "
                         f"{[p.__name__ for p in POLICIES]}")
    config = policy.model_config(hf_model.config, dtype=dtype)
    return config, policy.convert(sd, config)
