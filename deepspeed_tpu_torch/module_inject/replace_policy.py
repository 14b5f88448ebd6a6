"""Weight-injection policies: diffusers state dicts → the port's diffusion
models, the port of the diffusers half of ``module_inject/replace_policy.py``.

A policy maps a state dict (torch tensors or numpy arrays) in diffusers'
key names and layouts into the parameter tree of ``models/diffusion.py``
and serves it through ``DSUNet`` or ``DSVAE``: torch ``[out, in]``
linears transpose to ``[in, out]``, 1x1 ``proj_in``/``proj_out`` and VAE
attention convs collapse to linears, and the OIHW convolutions are kept
as they are (the port's tree is OIHW).  The architecture is inferred from
the state dict; ``n_head`` and ``groups`` are not recoverable from the
weights and come from the caller (SD 1.x: 8 and 32).  The HF transformer
policies (GPT-2, BERT, CLIP text, ...) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
