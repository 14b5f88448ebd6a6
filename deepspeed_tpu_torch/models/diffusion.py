"""NHWC diffusion models, conditional UNet and VAE: the port of
``models/diffusion.py``.

The architecture is the Stable-Diffusion ``UNet2DConditionModel`` /
``AutoencoderKL`` shape (down, mid and up ResNet blocks, spatial
transformers with self and cross attention and a GEGLU feed-forward, a
sinusoidal timestep MLP) at configurable width and depth.  Activations
stay NHWC at every public function, as in the JAX package: a convolution
runs ``F.conv2d`` on the NHWC tensor viewed as NCHW (channels-last in
memory), so cuDNN's output is channels-last too and, permuted back, gives
the contiguous [N·H·W, C] rows every conv bias is added to by the spatial
kernel (``ops/kernels/spatial.py`` ``nhwc_bias_add``, on CUDA the
``csrc/spatial.cu`` kernel).  Attention, normalisation and the matmuls
are plain PyTorch, as they are plain JAX in the reference.

The parameter tree keeps the JAX tree's names, nesting (``down``, ``up``
and ``resnets`` are lists) and layouts, with one exception: convolution
weights are OIHW, PyTorch's layout, where the JAX tree has HWIO
(``convert.diffusion_from_jax`` transposes them once).  Linears are [in,
out].  The blocks follow the JAX code's dtypes: GroupNorm reduces in fp32
and casts after its scale and bias, the transformer's LayerNorm takes its
mean in the input dtype and its variance in fp32, attention scores and
softmax are fp32 and cast to v's dtype before the second product, and the
GEGLU gate is the tanh GeLU (``jax.nn.gelu``'s default).  One deliberate
difference: the sinusoidal timestep embedding is cast to
``config.dtype`` before the time MLP, as diffusers does; the JAX code
keeps it fp32, which in a bf16 config promotes every block after the
first time-embedding add to fp32.  In fp32 the two agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels.spatial import nhwc_bias_add

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (32, 64)
    layers_per_block: int = 1
    cross_attn_dim: int = 64      # encoder_hidden_states feature size
    n_head: int = 4
    groups: int = 8               # GroupNorm groups
    sample_size: int = 32
    #: which down levels carry spatial transformers (None = all); SD 1.x is
    #: (True, True, True, False), mirrored on the up path
    attn_levels: Optional[Tuple[bool, ...]] = None
    dtype: torch.dtype = torch.float32

    def level_has_attn(self, i: int) -> bool:
        return self.attn_levels is None or bool(self.attn_levels[i])


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_channels: Tuple[int, ...] = (32, 64)
    layers_per_block: int = 1
    groups: int = 8
    dtype: torch.dtype = torch.float32


#: Stable Diffusion 1.5 at its published widths
#: (``runwayml/stable-diffusion-v1-5`` ``unet/config.json``,
#: ``vae/config.json``), compute in bf16
SD15_UNET = UNetConfig(in_channels=4, out_channels=4,
                       block_channels=(320, 640, 1280, 1280),
                       layers_per_block=2, cross_attn_dim=768, n_head=8,
                       groups=32, sample_size=64,
                       attn_levels=(True, True, True, False),
                       dtype=torch.bfloat16)
SD15_VAE = VAEConfig(in_channels=3, latent_channels=4,
                     block_channels=(128, 256, 512, 512), layers_per_block=2,
                     groups=32, dtype=torch.bfloat16)


# ------------------------------------------------------------------ helpers

def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (low, high) of one spatial dim."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x, w, stride: int, pad) -> torch.Tensor:
    """x [B, H, W, Cin] NHWC, w OIHW, pad ((top, bottom), (left, right))
    → contiguous NHWC without bias."""
    (t, b), (l, r) = pad
    if t != b or l != r:
        x = F.pad(x, (0, 0, l, r, t, b))
        t = l = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, stride, (t, l))
    return y.permute(0, 2, 3, 1).contiguous()


def _conv(x, w, b, stride: int = 1):
    """NHWC conv with "SAME" padding, OIHW weights; the bias through the
    spatial kernel."""
    k = w.shape[-1]
    pad = (_same_pad(x.shape[1], k, stride), _same_pad(x.shape[2], k, stride))
    return nhwc_bias_add(_conv_nhwc(x, w, stride, pad), b.to(x.dtype))


def _group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    B, H, W, C = x.shape
    g = x.reshape(B, H, W, groups, C // groups).float()
    var, mean = torch.var_mean(g, dim=(1, 2, 4), keepdim=True, correction=0)
    g = (g - mean) * torch.rsqrt(var + eps)
    return (g.reshape(B, H, W, C) * scale + bias).to(x.dtype)


def _silu(x):
    return F.silu(x)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding (diffusers Timesteps): t [B] -> fp32 [B, dim],
    ``[cos, sin]``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ------------------------------------------------------------------ resnet

def _resblock(x, temb, p, groups: int):
    """GN→SiLU→conv → +time proj → GN→SiLU→conv, residual (1x1 shortcut
    when channels change): diffusers ResnetBlock2D."""
    h = _conv(_silu(_group_norm(x, p["norm1_scale"], p["norm1_bias"], groups)),
              p["conv1_w"], p["conv1_b"])
    if temb is not None and "time_w" in p:
        h = h + (_silu(temb) @ p["time_w"].to(h.dtype)
                 + p["time_b"].to(h.dtype))[:, None, None, :]
    h = _conv(_silu(_group_norm(h, p["norm2_scale"], p["norm2_bias"], groups)),
              p["conv2_w"], p["conv2_b"])
    if "short_w" in p:
        x = _conv(x, p["short_w"], p["short_b"])
    return x + h


def _attention(q, k, v, n_head: int):
    """[B, S, C] q, k, v → [B, Sq, C]: fp32 scores and softmax, the
    weights cast to v's dtype before the second product."""
    B, Sq, C = q.shape
    Sk = k.shape[1]
    d = C // n_head
    q = q.reshape(B, Sq, n_head, d).transpose(1, 2)
    k = k.reshape(B, Sk, n_head, d).transpose(1, 2)
    v = v.reshape(B, Sk, n_head, d).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / \
        math.sqrt(d)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(w, v)
    return out.transpose(1, 2).reshape(B, Sq, C)


def _layer_norm(x, s, b, eps: float = 1e-5):
    """The transformer block's LayerNorm: mean in x's dtype, variance in
    fp32, the reciprocal std cast to x's dtype."""
    m = x.mean(dim=-1, keepdim=True)
    v = x.float().var(dim=-1, keepdim=True, correction=0)
    return ((x - m) * torch.rsqrt(v + eps).to(x.dtype)) * s + b


def _transformer_block(h, ctx, p, n_head: int):
    """norm→self-attn, norm→cross-attn(ctx), norm→GEGLU ff: diffusers
    BasicTransformerBlock."""
    def attn(x, kv, ap):
        q = x @ ap["q_w"].to(x.dtype)
        k = kv @ ap["k_w"].to(x.dtype)
        v = kv @ ap["v_w"].to(x.dtype)
        o = _attention(q, k, v, n_head)
        return o @ ap["o_w"].to(x.dtype) + ap["o_b"].to(x.dtype)

    x1 = _layer_norm(h, p["norm1_scale"], p["norm1_bias"])
    h = h + attn(x1, x1, p["attn1"])
    h = h + attn(_layer_norm(h, p["norm2_scale"], p["norm2_bias"]),
                 ctx.to(h.dtype), p["attn2"])
    # GEGLU: one projection producing (value, gate) halves
    x = _layer_norm(h, p["norm3_scale"], p["norm3_bias"])
    proj = x @ p["ff_in_w"].to(x.dtype) + p["ff_in_b"].to(x.dtype)
    val, gate = proj.chunk(2, dim=-1)
    ff = (val * F.gelu(gate, approximate="tanh")) @ \
        p["ff_out_w"].to(x.dtype) + p["ff_out_b"].to(x.dtype)
    return h + ff


def _spatial_transformer(x, ctx, p, groups: int, n_head: int):
    """GN → proj in → transformer block on [B, H*W, C] → proj out,
    residual: diffusers Transformer2DModel."""
    B, H, W, C = x.shape
    h = _group_norm(x, p["norm_scale"], p["norm_bias"], groups)
    h = h.reshape(B, H * W, C) @ p["proj_in_w"].to(x.dtype) \
        + p["proj_in_b"].to(x.dtype)
    h = _transformer_block(h, ctx, p["block"], n_head)
    h = h @ p["proj_out_w"].to(x.dtype) + p["proj_out_b"].to(x.dtype)
    return x + h.reshape(B, H, W, C)


def _downsample(x, p, pad=((1, 1), (1, 1))):
    """Stride-2 conv.  diffusers' UNet Downsample2D pads symmetrically; the
    VAE encoder pads (0, 1) asymmetrically: pass it."""
    y = _conv_nhwc(x, p["conv_w"], 2, pad)
    return nhwc_bias_add(y, p["conv_b"].to(x.dtype))


def _nearest2x(x):
    """NHWC nearest ×2: output pixel i reads input i // 2, as
    ``jax.image.resize(method="nearest")`` does at an exact ×2."""
    x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return x.permute(0, 2, 3, 1).contiguous()


def _upsample(x, p):
    return _conv(_nearest2x(x), p["conv_w"], p["conv_b"])


# ------------------------------------------------------------------- UNet

def unet_apply(params: Params, sample: torch.Tensor, timestep,
               encoder_hidden_states: torch.Tensor,
               config: UNetConfig) -> torch.Tensor:
    """sample [B, H, W, C_in] NHWC, timestep [B] (or scalar),
    encoder_hidden_states [B, S, cross_attn_dim] -> noise pred
    [B, H, W, C_out] in ``config.dtype``."""
    cdt = config.dtype
    g = config.groups
    x = sample.to(cdt)
    timestep = torch.as_tensor(timestep, device=x.device)
    if timestep.dim() == 0:
        timestep = timestep.expand(x.shape[0])
    ctx = encoder_hidden_states.to(cdt)

    temb = timestep_embedding(timestep, config.block_channels[0]).to(cdt)
    temb = _silu(temb @ params["time_w1"].to(cdt) + params["time_b1"].to(cdt))
    temb = temb @ params["time_w2"].to(cdt) + params["time_b2"].to(cdt)

    x = _conv(x, params["conv_in_w"], params["conv_in_b"])
    skips = [x]
    for down in params["down"]:
        for j in range(config.layers_per_block):
            x = _resblock(x, temb, down["resnets"][j], g)
            if "attentions" in down:
                x = _spatial_transformer(x, ctx, down["attentions"][j], g,
                                         config.n_head)
            skips.append(x)
        if "downsample" in down:
            x = _downsample(x, down["downsample"])
            skips.append(x)

    mid = params["mid"]
    x = _resblock(x, temb, mid["resnet1"], g)
    x = _spatial_transformer(x, ctx, mid["attention"], g, config.n_head)
    x = _resblock(x, temb, mid["resnet2"], g)

    for up in params["up"]:
        for j in range(config.layers_per_block + 1):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resblock(x, temb, up["resnets"][j], g)
            if "attentions" in up:
                x = _spatial_transformer(x, ctx, up["attentions"][j], g,
                                         config.n_head)
        if "upsample" in up:
            x = _upsample(x, up["upsample"])

    x = _silu(_group_norm(x, params["norm_out_scale"], params["norm_out_bias"],
                          g))
    return _conv(x, params["conv_out_w"], params["conv_out_b"])


# -------------------------------------------------------------------- VAE

def _vae_mid_attention(x, p, groups: int):
    """Single-head spatial self-attention (AutoencoderKL mid AttnBlock)."""
    B, H, W, C = x.shape
    h = _group_norm(x, p["norm_scale"], p["norm_bias"], groups)
    h = h.reshape(B, H * W, C)
    q = h @ p["q_w"].to(h.dtype) + p["q_b"].to(h.dtype)
    k = h @ p["k_w"].to(h.dtype) + p["k_b"].to(h.dtype)
    v = h @ p["v_w"].to(h.dtype) + p["v_b"].to(h.dtype)
    o = _attention(q, k, v, n_head=1)
    o = o @ p["o_w"].to(h.dtype) + p["o_b"].to(h.dtype)
    return x + o.reshape(B, H, W, C)


def vae_decode(params: Params, z: torch.Tensor,
               config: VAEConfig) -> torch.Tensor:
    """latents [B, h, w, latent_channels] -> image [B, h*2^(L-1), ..., C]
    (diffusers AutoencoderKL.decode: post_quant 1x1 → decoder)."""
    cdt = config.dtype
    g = config.groups
    p = params["decoder"]
    x = _conv(z.to(cdt), params["post_quant_w"], params["post_quant_b"])
    x = _conv(x, p["conv_in_w"], p["conv_in_b"])
    x = _resblock(x, None, p["mid_resnet1"], g)
    if "mid_attn" in p:
        x = _vae_mid_attention(x, p["mid_attn"], g)
    x = _resblock(x, None, p["mid_resnet2"], g)
    for up in p["up"]:
        for j in range(config.layers_per_block + 1):
            x = _resblock(x, None, up["resnets"][j], g)
        if "upsample" in up:
            x = _upsample(x, up["upsample"])
    x = _silu(_group_norm(x, p["norm_out_scale"], p["norm_out_bias"], g))
    return _conv(x, p["conv_out_w"], p["conv_out_b"])


def vae_encode(params: Params, img: torch.Tensor, config: VAEConfig,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """image -> latents: the mean, or with ``generator`` a sample
    ``mean + std * noise`` (the noise drawn on the generator's device)."""
    cdt = config.dtype
    g = config.groups
    p = params["encoder"]
    x = _conv(img.to(cdt), p["conv_in_w"], p["conv_in_b"])
    for down in p["down"]:
        for j in range(config.layers_per_block):
            x = _resblock(x, None, down["resnets"][j], g)
        if "downsample" in down:
            x = _downsample(x, down["downsample"], pad=((0, 1), (0, 1)))
    x = _resblock(x, None, p["mid_resnet1"], g)
    if "mid_attn" in p:
        x = _vae_mid_attention(x, p["mid_attn"], g)
    x = _resblock(x, None, p["mid_resnet2"], g)
    x = _silu(_group_norm(x, p["norm_out_scale"], p["norm_out_bias"], g))
    moments = _conv(x, p["conv_out_w"], p["conv_out_b"])
    moments = _conv(moments, params["quant_w"], params["quant_b"])
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is None:
        return mean
    noise = torch.randn(mean.shape, generator=generator,
                        device=generator.device).to(mean.device, mean.dtype)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


# ------------------------------------------------------------------- init

class _Init:
    """Seeded fp32 weights on the generator's device, in the JAX init's
    shapes and scales (OIHW convolutions)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

    def normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.gen.device)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, device=self.gen.device)

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, device=self.gen.device)

    def conv(self, cin: int, cout: int, k: int) -> torch.Tensor:
        return self.normal(cout, cin, k, k) / math.sqrt(k * k * cin)

    def lin(self, i: int, o: int) -> torch.Tensor:
        return self.normal(i, o) / math.sqrt(i)

    def resblock(self, cin: int, cout: int, temb_dim: Optional[int]):
        p = {"norm1_scale": self.ones(cin), "norm1_bias": self.zeros(cin),
             "conv1_w": self.conv(cin, cout, 3), "conv1_b": self.zeros(cout),
             "norm2_scale": self.ones(cout), "norm2_bias": self.zeros(cout),
             "conv2_w": self.conv(cout, cout, 3), "conv2_b": self.zeros(cout)}
        if temb_dim is not None:
            p["time_w"] = self.lin(temb_dim, cout)
            p["time_b"] = self.zeros(cout)
        if cin != cout:
            p["short_w"] = self.conv(cin, cout, 1)
            p["short_b"] = self.zeros(cout)
        return p

    def transformer(self, c: int, ctx_dim: int):
        def attn(kv_dim):
            return {"q_w": self.lin(c, c), "k_w": self.lin(kv_dim, c),
                    "v_w": self.lin(kv_dim, c), "o_w": self.lin(c, c),
                    "o_b": self.zeros(c)}

        return {
            "norm_scale": self.ones(c), "norm_bias": self.zeros(c),
            "proj_in_w": self.lin(c, c), "proj_in_b": self.zeros(c),
            "proj_out_w": self.normal(c, c) / math.sqrt(c) * 0.2,
            "proj_out_b": self.zeros(c),
            "block": {
                "norm1_scale": self.ones(c), "norm1_bias": self.zeros(c),
                "attn1": attn(c),
                "norm2_scale": self.ones(c), "norm2_bias": self.zeros(c),
                "attn2": attn(ctx_dim),
                "norm3_scale": self.ones(c), "norm3_bias": self.zeros(c),
                "ff_in_w": self.lin(c, 8 * c), "ff_in_b": self.zeros(8 * c),
                "ff_out_w": self.lin(4 * c, c), "ff_out_b": self.zeros(c),
            },
        }

    def mid_attn(self, c: int):
        p = {"norm_scale": self.ones(c), "norm_bias": self.zeros(c)}
        for f in "qkvo":
            p[f"{f}_w"] = self.lin(c, c)
            p[f"{f}_b"] = self.zeros(c)
        return p


def unet_init(config: UNetConfig,
              generator: Optional[torch.Generator] = None) -> Params:
    """fp32 UNet weights from ``generator`` (default: a CPU generator
    seeded with 0), on its device."""
    init = _Init(generator)
    chans = config.block_channels
    temb_dim = 4 * chans[0]
    params: Params = {
        "time_w1": init.lin(chans[0], temb_dim),
        "time_b1": init.zeros(temb_dim),
        "time_w2": init.lin(temb_dim, temb_dim),
        "time_b2": init.zeros(temb_dim),
        "conv_in_w": init.conv(config.in_channels, chans[0], 3),
        "conv_in_b": init.zeros(chans[0]),
        "norm_out_scale": init.ones(chans[0]),
        "norm_out_bias": init.zeros(chans[0]),
        "conv_out_w": init.conv(chans[0], config.out_channels, 3),
        "conv_out_b": init.zeros(config.out_channels),
    }
    down = []
    cin = chans[0]
    skip_chans = [chans[0]]
    for i, c in enumerate(chans):
        blk: Params = {"resnets": []}
        if config.level_has_attn(i):
            blk["attentions"] = []
        for j in range(config.layers_per_block):
            blk["resnets"].append(init.resblock(cin if j == 0 else c, c,
                                                temb_dim))
            if config.level_has_attn(i):
                blk["attentions"].append(init.transformer(
                    c, config.cross_attn_dim))
            skip_chans.append(c)
        if i + 1 < len(chans):
            blk["downsample"] = {"conv_w": init.conv(c, c, 3),
                                 "conv_b": init.zeros(c)}
            skip_chans.append(c)
        down.append(blk)
        cin = c
    params["down"] = down

    cmid = chans[-1]
    params["mid"] = {
        "resnet1": init.resblock(cmid, cmid, temb_dim),
        "attention": init.transformer(cmid, config.cross_attn_dim),
        "resnet2": init.resblock(cmid, cmid, temb_dim),
    }

    # the up path mirrors the down path: each resnet takes a skip
    up = []
    x_c = cmid
    rev = list(reversed(chans))
    for i, c in enumerate(rev):
        has_attn = config.level_has_attn(len(chans) - 1 - i)
        blk = {"resnets": []}
        if has_attn:
            blk["attentions"] = []
        for j in range(config.layers_per_block + 1):
            blk["resnets"].append(init.resblock(x_c + skip_chans.pop(), c,
                                                temb_dim))
            if has_attn:
                blk["attentions"].append(init.transformer(
                    c, config.cross_attn_dim))
            x_c = c
        if i + 1 < len(rev):
            blk["upsample"] = {"conv_w": init.conv(c, c, 3),
                               "conv_b": init.zeros(c)}
        up.append(blk)
    params["up"] = up
    return params


def vae_init(config: VAEConfig,
             generator: Optional[torch.Generator] = None) -> Params:
    """fp32 VAE weights from ``generator`` (default: a CPU generator
    seeded with 0), on its device."""
    init = _Init(generator)
    chans = config.block_channels
    enc: Params = {"conv_in_w": init.conv(config.in_channels, chans[0], 3),
                   "conv_in_b": init.zeros(chans[0]), "down": []}
    cin = chans[0]
    for i, c in enumerate(chans):
        blk = {"resnets": [init.resblock(cin if j == 0 else c, c, None)
                           for j in range(config.layers_per_block)]}
        if i + 1 < len(chans):
            blk["downsample"] = {"conv_w": init.conv(c, c, 3),
                                 "conv_b": init.zeros(c)}
        enc["down"].append(blk)
        cin = c
    cmid = chans[-1]
    lat = config.latent_channels
    enc.update({
        "mid_resnet1": init.resblock(cmid, cmid, None),
        "mid_attn": init.mid_attn(cmid),
        "mid_resnet2": init.resblock(cmid, cmid, None),
        "norm_out_scale": init.ones(cmid), "norm_out_bias": init.zeros(cmid),
        "conv_out_w": init.conv(cmid, 2 * lat, 3),
        "conv_out_b": init.zeros(2 * lat)})

    dec: Params = {
        "conv_in_w": init.conv(lat, cmid, 3), "conv_in_b": init.zeros(cmid),
        "mid_resnet1": init.resblock(cmid, cmid, None),
        "mid_attn": init.mid_attn(cmid),
        "mid_resnet2": init.resblock(cmid, cmid, None),
        "up": [],
    }
    x_c = cmid
    for i, c in enumerate(reversed(chans)):
        blk = {"resnets": [init.resblock(x_c if j == 0 else c, c, None)
                           for j in range(config.layers_per_block + 1)]}
        if i + 1 < len(chans):
            blk["upsample"] = {"conv_w": init.conv(c, c, 3),
                               "conv_b": init.zeros(c)}
        dec["up"].append(blk)
        x_c = c
    dec.update({"norm_out_scale": init.ones(x_c),
                "norm_out_bias": init.zeros(x_c),
                "conv_out_w": init.conv(x_c, config.in_channels, 3),
                "conv_out_b": init.zeros(config.in_channels)})
    return {"encoder": enc, "decoder": dec,
            "quant_w": init.conv(2 * lat, 2 * lat, 1),
            "quant_b": init.zeros(2 * lat),
            "post_quant_w": init.conv(lat, lat, 1),
            "post_quant_b": init.zeros(lat)}


def cast_params(tree, dtype: torch.dtype, device=None):
    """Every leaf of a diffusion tree as a contiguous ``dtype`` tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype, device) for v in tree]
    return tree.to(device=device, dtype=dtype).contiguous()


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel()
