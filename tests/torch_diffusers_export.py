"""The port's diffusion trees (``deepspeed_tpu_torch.models.diffusion``)
as diffusers-named state dicts: the inverse of ``module_inject``'s
``UNetPolicy``/``VAEPolicy`` converters, so ``convert(export(p))`` is
``p``.  OIHW convolutions stay OIHW; ``[in, out]`` linears become torch's
``[out, in]``; the transformers' ``proj_in``/``proj_out`` become 1x1
convs (SD 1.x), except in the UNet's mid block, which takes the Linear
form so both are converted.  The VAE encoder's mid attention uses the new
key era (``to_q``...), the decoder's the old one (``query``...).  Torch
only: ``chip_smoke.py`` builds its full-width state dicts with it."""


def _export_res(p, pre, sd):
    for i in ("1", "2"):
        sd[pre + f"norm{i}.weight"] = p[f"norm{i}_scale"]
        sd[pre + f"norm{i}.bias"] = p[f"norm{i}_bias"]
        sd[pre + f"conv{i}.weight"] = p[f"conv{i}_w"]
        sd[pre + f"conv{i}.bias"] = p[f"conv{i}_b"]
    if "time_w" in p:
        sd[pre + "time_emb_proj.weight"] = p["time_w"].T
        sd[pre + "time_emb_proj.bias"] = p["time_b"]
    if "short_w" in p:
        sd[pre + "conv_shortcut.weight"] = p["short_w"]
        sd[pre + "conv_shortcut.bias"] = p["short_b"]


def _export_attnblk(p, pre, sd, proj_as_conv=True):
    sd[pre + "norm.weight"] = p["norm_scale"]
    sd[pre + "norm.bias"] = p["norm_bias"]
    for name in ("proj_in", "proj_out"):
        w = p[name + "_w"].T                   # [in, out] -> [out, in]
        if proj_as_conv:                       # SD 1.x: 1x1 conv
            w = w[:, :, None, None]
        sd[pre + name + ".weight"] = w
        sd[pre + name + ".bias"] = p[name + "_b"]
    t = pre + "transformer_blocks.0."
    b = p["block"]
    for i in ("1", "2", "3"):
        sd[t + f"norm{i}.weight"] = b[f"norm{i}_scale"]
        sd[t + f"norm{i}.bias"] = b[f"norm{i}_bias"]
    for a in ("attn1", "attn2"):
        for f, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                        ("o", "to_out.0")):
            sd[t + f"{a}.{name}.weight"] = b[a][f + "_w"].T
        sd[t + a + ".to_out.0.bias"] = b[a]["o_b"]
    sd[t + "ff.net.0.proj.weight"] = b["ff_in_w"].T
    sd[t + "ff.net.0.proj.bias"] = b["ff_in_b"]
    sd[t + "ff.net.2.weight"] = b["ff_out_w"].T
    sd[t + "ff.net.2.bias"] = b["ff_out_b"]


def _export_sampler(blk, key, pre, sd):
    if key in blk:
        sd[pre + ".0.conv.weight"] = blk[key]["conv_w"]
        sd[pre + ".0.conv.bias"] = blk[key]["conv_b"]


def export_unet_sd(params):
    sd = {"time_embedding.linear_1.weight": params["time_w1"].T,
          "time_embedding.linear_1.bias": params["time_b1"],
          "time_embedding.linear_2.weight": params["time_w2"].T,
          "time_embedding.linear_2.bias": params["time_b2"],
          "conv_in.weight": params["conv_in_w"],
          "conv_in.bias": params["conv_in_b"],
          "conv_norm_out.weight": params["norm_out_scale"],
          "conv_norm_out.bias": params["norm_out_bias"],
          "conv_out.weight": params["conv_out_w"],
          "conv_out.bias": params["conv_out_b"]}
    for side, key in (("down", "downsample"), ("up", "upsample")):
        for i, blk in enumerate(params[side]):
            for j, r in enumerate(blk["resnets"]):
                _export_res(r, f"{side}_blocks.{i}.resnets.{j}.", sd)
            for j, a in enumerate(blk.get("attentions", [])):
                _export_attnblk(a, f"{side}_blocks.{i}.attentions.{j}.", sd)
            _export_sampler(blk, key, f"{side}_blocks.{i}.{side}samplers",
                            sd)
    _export_res(params["mid"]["resnet1"], "mid_block.resnets.0.", sd)
    _export_attnblk(params["mid"]["attention"], "mid_block.attentions.0.", sd,
                    proj_as_conv=False)   # the Linear form too
    _export_res(params["mid"]["resnet2"], "mid_block.resnets.1.", sd)
    return sd


def export_vae_sd(params):
    sd = {}
    for name in ("quant", "post_quant"):
        sd[name + "_conv.weight"] = params[name + "_w"]
        sd[name + "_conv.bias"] = params[name + "_b"]
    for side, down in (("encoder", True), ("decoder", False)):
        p = params[side]
        sd[f"{side}.conv_in.weight"] = p["conv_in_w"]
        sd[f"{side}.conv_in.bias"] = p["conv_in_b"]
        _export_res(p["mid_resnet1"], f"{side}.mid_block.resnets.0.", sd)
        _export_res(p["mid_resnet2"], f"{side}.mid_block.resnets.1.", sd)
        ma = p["mid_attn"]
        pre = f"{side}.mid_block.attentions.0."
        sd[pre + "group_norm.weight"] = ma["norm_scale"]
        sd[pre + "group_norm.bias"] = ma["norm_bias"]
        if side == "encoder":
            names = {"q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0"}
        else:
            names = {"q": "query", "k": "key", "v": "value", "o": "proj_attn"}
        for f, n in names.items():
            sd[pre + n + ".weight"] = ma[f + "_w"].T
            sd[pre + n + ".bias"] = ma[f + "_b"]
        sd[f"{side}.conv_norm_out.weight"] = p["norm_out_scale"]
        sd[f"{side}.conv_norm_out.bias"] = p["norm_out_bias"]
        sd[f"{side}.conv_out.weight"] = p["conv_out_w"]
        sd[f"{side}.conv_out.bias"] = p["conv_out_b"]
        kind = "down" if down else "up"
        for i, blk in enumerate(p[kind]):
            for j, r in enumerate(blk["resnets"]):
                _export_res(r, f"{side}.{kind}_blocks.{i}.resnets.{j}.", sd)
            _export_sampler(blk, kind + "sample",
                            f"{side}.{kind}_blocks.{i}.{kind}samplers", sd)
    return sd
