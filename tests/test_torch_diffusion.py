"""The port's diffusion serving path (plain path, CPU) against the JAX
package's ``models/diffusion.py``, ``inference/diffusion_pipeline.py`` and
``module_inject`` diffusers policies, fp32, with the same weights (the JAX
init's tree plus seeded noise on every leaf, so no bias is zero and no
norm is the identity) and the same inputs, drawn with numpy.

Weights come from the port's seeded init, exported to the JAX tree's
layout (``convert.diffusion_to_numpy``); the trees' structure and shapes
are held against the JAX init's (``jax.eval_shape``).  The modules that
hold the spatial kernel (``_conv``, ``_downsample``) meet
the Pallas kernel itself in interpret mode; the blocks, ``unet_apply`` at
two configurations (the JAX tests' tiny one and an SD-1.5-shaped one at
small widths), the VAE and a guided 2-step DDIM loop on identical
latents agree within 1e-4 (1e-3 for the loop) of the output's largest
|value|.  Conversion: a diffusers-named export of a port tree goes
through ``UNetPolicy``/``VAEPolicy`` (SD-1.5's 686 and 248 tensors) back
to the same tree, and ``init_inference`` serves it."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import diffusion_pipeline as jpipe
from deepspeed_tpu.model_implementations.diffusers import DSUNet as JDSUNet
from deepspeed_tpu.model_implementations.diffusers import DSVAE as JDSVAE
from deepspeed_tpu.models import diffusion as jdf
from deepspeed_tpu_torch.inference import diffusion_pipeline as tpipe
from deepspeed_tpu_torch.model_implementations.diffusers import DSUNet, DSVAE
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import diffusion as tdf
from deepspeed_tpu_torch.module_inject import UNetPolicy, VAEPolicy
from deepspeed_tpu_torch.ops import kernels

from .torch_diffusers_export import export_unet_sd, export_vae_sd

TOL = 1e-4

UCFG = dict(in_channels=4, out_channels=4, block_channels=(8, 16),
            layers_per_block=1, cross_attn_dim=12, n_head=2, groups=4)
VCFG = dict(in_channels=3, latent_channels=4, block_channels=(8, 16),
            layers_per_block=1, groups=4)
# SD-1.5's structure (4 levels, 2 resnets each, attention-free last level)
# at small widths (test_diffusers.py's SD-shaped test)
SD_UCFG = dict(in_channels=4, out_channels=4, block_channels=(8, 16, 32, 32),
               layers_per_block=2, cross_attn_dim=16, n_head=2, groups=4,
               attn_levels=(True, True, True, False))
SD_VCFG = dict(in_channels=3, latent_channels=4,
               block_channels=(8, 8, 16, 32), layers_per_block=2, groups=4)


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DS_TPU_PALLAS_INTERPRET", "1")
    yield


def _perturb(tree, seed, std=0.1):
    """A numpy tree with seeded noise added to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + std * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(port, ref, tol=TOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _models(ucfg, vcfg, seed):
    """(JAX configs, JAX-layout numpy trees, port configs, port trees)."""
    tu, tv = tdf.UNetConfig(**ucfg), tdf.VAEConfig(**vcfg)
    gen = torch.Generator().manual_seed(seed)
    up = _perturb(convert.diffusion_to_numpy(tdf.unet_init(tu, gen)), seed)
    vp = _perturb(convert.diffusion_to_numpy(tdf.vae_init(tv, gen)), seed + 1)
    return ((jdf.UNetConfig(**ucfg), jdf.VAEConfig(**vcfg)), (up, vp),
            (tu, tv),
            (convert.diffusion_from_jax(up), convert.diffusion_from_jax(vp)))


@pytest.fixture(scope="module")
def tiny():
    return _models(UCFG, VCFG, 0)


@pytest.fixture(scope="module")
def sd_shaped():
    return _models(SD_UCFG, SD_VCFG, 10)


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1", "down", "down_vae"])
def test_conv_and_downsample_meet_pallas_kernel(pallas_interpret, kind):
    """C_out = 128, so the JAX side adds its bias through the Pallas
    kernel (interpret mode)."""
    cin = 128 if kind.startswith("down") else 16
    k = 1 if kind == "conv1x1" else 3
    x = _randn(1, 2, 8, 6, cin)
    w = _randn(2, k, k, cin, 128) / np.sqrt(k * k * cin)
    b = _randn(3, 128)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    if kind.startswith("conv"):
        ref = jdf._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        port = tdf._conv(tx, tw, tb)
    else:
        pad = ((1, 1), (1, 1)) if kind == "down" else ((0, 1), (0, 1))
        p = {"conv_w": w, "conv_b": b}
        ref = jdf._downsample(jnp.asarray(x), p, pad)
        port = tdf._downsample(tx, {"conv_w": tw, "conv_b": tb}, pad)
    _close(port, ref, 1e-5)


def test_nearest_upsample_indices_match_jax_resize():
    x = _randn(4, 2, 3, 5, 6)
    ref = jax.image.resize(jnp.asarray(x), (2, 6, 10, 6), method="nearest")
    port = tdf._nearest2x(torch.from_numpy(x))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    # sin/cos of args up to 999 rad, whose fp32 ulp is 6e-5
    _close(tdf.timestep_embedding(torch.from_numpy(t), 32),
           jdf.timestep_embedding(jnp.asarray(t), 32), 1e-5)


def _block_case(name):
    """(JAX fn, port fn, JAX-layout params, inputs) of one block."""
    init = tdf._Init(torch.Generator().manual_seed(5))

    def params(tree):
        return _perturb(convert.diffusion_to_numpy(tree), 5)

    if name in ("resblock", "resblock_shortcut"):
        cout = 16 if name == "resblock" else 24
        p = params(init.resblock(16, cout, 32))
        return (lambda p, x, t: jdf._resblock(x, t, p, 4),
                lambda p, x, t: tdf._resblock(x, t, p, 4), p,
                [_randn(6, 2, 6, 5, 16), _randn(7, 2, 32)])
    if name == "spatial_transformer":
        p = params(init.transformer(16, 12))
        return (lambda p, x, c: jdf._spatial_transformer(x, c, p, 4, 2),
                lambda p, x, c: tdf._spatial_transformer(x, c, p, 4, 2), p,
                [_randn(6, 2, 6, 5, 16), _randn(7, 2, 7, 12)])
    if name == "vae_mid_attention":
        p = params(init.mid_attn(16))
        return (lambda p, x: jdf._vae_mid_attention(x, p, 4),
                lambda p, x: tdf._vae_mid_attention(x, p, 4), p,
                [_randn(6, 2, 6, 5, 16)])
    p = {"conv_w": _randn(8, 3, 3, 16, 16) / 12.0, "conv_b": _randn(9, 16)}
    return (lambda p, x: jdf._upsample(x, p),
            lambda p, x: tdf._upsample(x, p), p, [_randn(6, 2, 3, 5, 16)])


@pytest.mark.parametrize("name", ["resblock", "resblock_shortcut",
                                  "spatial_transformer", "vae_mid_attention",
                                  "upsample"])
def test_block_matches_jax(name):
    jfn, tfn, p, inputs = _block_case(name)
    ref = jfn(p, *map(jnp.asarray, inputs))
    port = tfn(convert.diffusion_from_jax(p), *map(torch.from_numpy, inputs))
    _close(port, ref)


# ------------------------------------------------------------------ models

def _unet_inputs(ucfg, B=2, H=16, W=16, S=5, seed=20):
    return (_randn(seed, B, H, W, ucfg["in_channels"]),
            np.array([3.0, 700.0][:B], np.float32),
            _randn(seed + 1, B, S, ucfg["cross_attn_dim"]))


@pytest.mark.parametrize("which", ["tiny", "sd_shaped"])
def test_unet_apply_matches_jax(request, which):
    (ju, _), (up, _), (tu, _), (tup, _) = request.getfixturevalue(which)
    ucfg = UCFG if which == "tiny" else SD_UCFG
    x, t, ctx = _unet_inputs(ucfg)
    ref = jax.jit(lambda p, x, t, c: jdf.unet_apply(p, x, t, c, ju))(
        up, x, t, ctx)
    port = tdf.unet_apply(tup, *map(torch.from_numpy, (x, t, ctx)), tu)
    _close(port, ref)


@pytest.mark.parametrize("which", ["tiny", "sd_shaped"])
def test_vae_encode_and_decode_match_jax(request, which):
    (_, jv), (_, vp), (_, tv), (_, tvp) = request.getfixturevalue(which)
    factor = 2 ** (len(tv.block_channels) - 1)
    img = _randn(30, 1, 8 * factor, 8 * factor, 3)
    z = _randn(31, 1, 8, 8, 4)
    ref_z = jax.jit(lambda p, x: jdf.vae_encode(p, x, jv))(vp, img)
    ref_img = jax.jit(lambda p, z: jdf.vae_decode(p, z, jv))(vp, z)
    _close(tdf.vae_encode(tvp, torch.from_numpy(img), tv), ref_z)
    _close(tdf.vae_decode(tvp, torch.from_numpy(z), tv), ref_img)


def test_vae_encode_samples_from_a_generator(tiny):
    _, _, (_, tv), (_, tvp) = tiny
    img = torch.from_numpy(_randn(32, 1, 16, 16, 3))
    mean = tdf.vae_encode(tvp, img, tv)
    draws = [tdf.vae_encode(tvp, img, tv, torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], mean) and draws[0].shape == mean.shape


def test_ddim_alphas_match_jax():
    # fp32 linspace and a 1000-term cumulative product in either order
    np.testing.assert_allclose(tpipe.ddim_alphas().numpy(),
                               np.asarray(jpipe.ddim_alphas()), rtol=1e-5)


def test_guided_pipeline_loop_matches_jax(tiny):
    """Guided 2-step DDIM + VAE decode from the same latents and
    embeddings: the port's loop against the JAX package's compiled one."""
    (ju, jv), (up, vp), (tu, tv), (tup, tvp) = tiny
    lat = _randn(40, 2, 16, 16, 4)
    ctx, unc = _randn(41, 2, 5, 12), _randn(42, 2, 5, 12)
    jp = jpipe.DiffusionPipeline(JDSUNet(ju, up), JDSVAE(jv, vp))
    ref = jax.jit(jp._build(2, True))(up, vp, lat, ctx, unc,
                                      jnp.float32(7.5))
    pipe = tpipe.DiffusionPipeline(DSUNet(tu, tup), DSVAE(tv, tvp))
    port = pipe.denoise(*map(torch.from_numpy, (lat, ctx, unc)), steps=2,
                        guidance_scale=7.5)
    assert port.shape == (2, 32, 32, 3)
    _close(port, ref, 1e-3)


def test_pipeline_call_checks_and_draws_noise(tiny):
    _, _, (tu, tv), (tup, tvp) = tiny
    unet = DSUNet(tu, tup)
    pipe = tpipe.DiffusionPipeline(unet, DSVAE(tv, tvp))
    ctx = torch.from_numpy(_randn(43, 1, 5, 12))
    with pytest.raises(ValueError, match="uncond"):
        pipe(ctx, steps=2, guidance_scale=7.5)
    with pytest.raises(ValueError, match="multiple"):
        pipe(ctx, steps=2, guidance_scale=1.0, height=31)
    with pytest.raises(ValueError, match="steps"):
        pipe(ctx, steps=0, guidance_scale=1.0)
    a = pipe(ctx, torch.zeros_like(ctx), steps=2, height=32, width=32,
             generator=torch.Generator().manual_seed(3))
    b = pipe(ctx, torch.zeros_like(ctx), steps=2, height=32, width=32,
             generator=torch.Generator().manual_seed(3))
    assert a.shape == (1, 32, 32, 3) and torch.equal(a, b)
    assert torch.isfinite(a).all()


# -------------------------------------------------------------- conversion

def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_policies_round_trip_sd15_key_inventory(sd_shaped):
    """A diffusers-named export of the SD-shaped trees has SD-1.5's tensor
    counts; config inference and conversion give the trees back."""
    _, _, (tu, tv), (tup, tvp) = sd_shaped
    sd = export_unet_sd(tup)
    assert len(sd) == 686
    assert UNetPolicy.match(sd) and not VAEPolicy.match(sd)
    cfg = UNetPolicy.model_config(sd, n_head=2, groups=4)
    assert cfg == tu
    _assert_trees_equal(UNetPolicy.convert(sd, cfg), tup)
    vsd = export_vae_sd(tvp)
    assert len(vsd) == 248
    assert VAEPolicy.match(vsd) and not UNetPolicy.match(vsd)
    vcfg = VAEPolicy.model_config(vsd, groups=4)
    assert vcfg == tv
    _assert_trees_equal(VAEPolicy.convert(vsd, vcfg), tvp)
    # numpy state dicts convert the same
    np_sd = {k: v.numpy() for k, v in vsd.items()}
    _assert_trees_equal(VAEPolicy.convert(np_sd, vcfg), tvp)


def test_init_inference_serves_diffusers_state_dicts(tiny):
    """``init_inference`` on a state dict returns DSUNet/DSVAE in the
    config's compute dtype (int8 → bf16), with the reference surface."""
    _, _, (tu, tv), (tup, tvp) = tiny
    unet = deepspeed_tpu_torch.init_inference(
        model=export_unet_sd(tup), config={"dtype": "float32"},
        device="cpu", n_head=2, groups=4)
    assert isinstance(unet, DSUNet)
    assert unet.config == dataclasses.replace(tu, attn_levels=(True, True))
    _assert_trees_equal(unet.params, tup)
    x = torch.from_numpy(_randn(50, 1, 16, 16, 4))
    ctx = torch.from_numpy(_randn(51, 1, 5, 12))
    out = unet(x, 5.0, ctx)["sample"]
    out_nchw = unet(x.permute(0, 3, 1, 2), 5.0, ctx, return_dict=False)[0]
    assert torch.equal(out_nchw, out.permute(0, 3, 1, 2))
    assert unet.fwd_count == 2 and unet.in_channels == 4
    vae = deepspeed_tpu_torch.init_inference(
        model=export_vae_sd(tvp), dtype="int8", device="cpu", groups=4)
    assert isinstance(vae, DSVAE) and vae.dtype == torch.bfloat16
    z = vae.encode(torch.zeros(1, 3, 32, 32), return_dict=False)[0]
    assert z.shape == (1, 4, 16, 16)
    assert vae.decode(z)["sample"].shape == (1, 3, 32, 32)
    with pytest.raises(TypeError, match="diffusers"):
        deepspeed_tpu_torch.init_inference(model={"w": torch.zeros(1)},
                                           device="cpu")


@pytest.mark.parametrize("which", ["tiny", "sd_shaped"])
def test_init_trees_have_the_jax_init_structure(request, which):
    """The port's init, in the JAX layout, has the JAX init's tree and
    shapes (``jax.eval_shape``: no JAX init runs)."""
    (ju, jv), (up, vp), _, _ = request.getfixturevalue(which)
    for fn, cfg, tree in ((jdf.unet_init, ju, up), (jdf.vae_init, jv, vp)):
        ref = jax.eval_shape(lambda k: fn(cfg, k), jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(ref) == \
            jax.tree_util.tree_structure(tree)
        assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda r, a: r.shape == a.shape, ref, tree)))


def test_diffusion_tree_round_trips_through_converters(sd_shaped):
    """``from_jax_params``/``to_numpy_params`` recurse into the lists of
    a diffusion tree; ``diffusion_from_jax``/``diffusion_to_numpy`` add
    the HWIO ↔ OIHW transposes."""
    _, (up, _), _, (tup, _) = sd_shaped
    back = convert.to_numpy_params(convert.from_jax_params(up))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(up)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, up)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.diffusion_to_numpy(tup), up)
    assert tup["conv_in_w"].shape == (8, 4, 3, 3)
    assert tup["conv_in_w"].is_contiguous()


def test_plain_path_launches_no_kernel(tiny):
    _, _, (tu, _), (tup, _) = tiny
    before = kernels.launch_counts()
    tdf.unet_apply(tup, *map(torch.from_numpy, _unet_inputs(UCFG, B=1)), tu)
    assert kernels.launch_counts() == before
