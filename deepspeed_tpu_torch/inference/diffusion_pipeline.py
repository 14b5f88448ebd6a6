"""Text-to-image sampling over the served diffusion models: the port of
``inference/diffusion_pipeline.py``.

DDIM (eta=0, the deterministic sampler SD ships with) over the
scaled-linear beta schedule, classifier-free guidance, then the VAE
decode.  Where the JAX pipeline compiles the whole loop into one XLA
program (``lax.scan``), the port runs it as a Python loop that launches
the UNet's kernels eagerly: per guided step two UNet forwards (the
conditional and the unconditional one, not one forward on a concatenated
batch, as in the JAX code) and the DDIM update in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.diffusion import unet_apply, vae_decode

#: SD latent scaling: the VAE was trained on latents / 0.18215
LATENT_SCALE = 0.18215


def ddim_alphas(num_train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012) -> torch.Tensor:
    """Cumulative alphas of the scaled-linear schedule (SD default), fp32
    on the CPU."""
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_steps, dtype=torch.float32) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


class DiffusionPipeline:
    """text embeddings → images.

    ``unet``/``vae`` are the served wrappers (``DSUNet``/``DSVAE``) or any
    objects with ``.config``/``.params`` matching ``models/diffusion``.
    Text conditioning is given as embeddings ([B, S, cross_attn_dim]
    tensors); the CLIP text tower is not ported yet.
    """

    def __init__(self, unet, vae, num_train_steps: int = 1000):
        self.unet = unet
        self.vae = vae
        self.alphas = ddim_alphas(num_train_steps)
        self.num_train_steps = num_train_steps

    def _build(self, steps: int, guided: bool):
        """The denoising loop and decode as a function of explicit latents:
        ``run(uparams, vparams, latents, ctx, uncond_ctx, cfg_scale)`` →
        images [B, H, W, C] (the JAX ``_build`` counterpart)."""
        ucfg, vcfg = self.unet.config, self.vae.config
        stride = self.num_train_steps // steps
        # evenly spaced timesteps, descending, inside the trained range
        ts = [min(i * stride + 1, self.num_train_steps - 1)
              for i in reversed(range(steps))]

        def coef(a):
            """sqrt(a) and sqrt(1 - a) in fp32, as Python floats."""
            a = torch.as_tensor(a, dtype=torch.float32)
            return torch.sqrt(a).item(), torch.sqrt(1.0 - a).item()

        def run(uparams, vparams, latents, ctx, uncond_ctx, cfg_scale):
            lat = latents
            for t in ts:
                sa_t, s1a_t = coef(self.alphas[t])
                prev = t - stride
                sa_p, s1a_p = coef(self.alphas[max(prev, 0)] if prev >= 0
                                   else 1.0)
                tb = torch.full((lat.shape[0],), float(t),
                                dtype=torch.float32, device=lat.device)
                eps = unet_apply(uparams, lat, tb, ctx, ucfg)
                if guided:
                    eps_u = unet_apply(uparams, lat, tb, uncond_ctx,
                                       ucfg).float()
                    eps = eps_u + cfg_scale * (eps.float() - eps_u)
                eps = eps.float()
                # DDIM (eta=0): x0 estimate, then the deterministic step
                x0 = (lat.float() - s1a_t * eps) / sa_t
                lat = (sa_p * x0 + s1a_p * eps).to(lat.dtype)
            return vae_decode(vparams, lat / LATENT_SCALE, vcfg)

        return run

    def denoise(self, latents: torch.Tensor, text_embeds: torch.Tensor,
                uncond_embeds: Optional[torch.Tensor] = None,
                steps: int = 50, guidance_scale: float = 7.5
                ) -> torch.Tensor:
        """Guided DDIM from the given initial latents [B, h, w, C_in]
        (cast to the UNet's dtype), then the VAE decode → images."""
        self._check(steps, guidance_scale, uncond_embeds)
        guided = guidance_scale != 1.0
        if uncond_embeds is None:
            uncond_embeds = torch.zeros_like(text_embeds)
        with torch.no_grad():
            return self._build(steps, guided)(
                self.unet.params, self.vae.params,
                latents.to(self.unet.dtype), text_embeds, uncond_embeds,
                float(guidance_scale))

    def _check(self, steps, guidance_scale, uncond_embeds):
        if not 1 <= steps < self.num_train_steps:
            raise ValueError(
                f"steps must be in [1, {self.num_train_steps}) (got {steps})")
        if guidance_scale != 1.0 and uncond_embeds is None:
            raise ValueError("guidance_scale != 1 needs uncond_embeds "
                             "(the empty-prompt embeddings)")

    def __call__(self, text_embeds: torch.Tensor,
                 uncond_embeds: Optional[torch.Tensor] = None,
                 steps: int = 50, guidance_scale: float = 7.5,
                 height: Optional[int] = None, width: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """text_embeds [B, S, cross_attn_dim] → images [B, H, W, C].

        ``uncond_embeds`` enables classifier-free guidance (required when
        ``guidance_scale != 1``); ``height``/``width`` are image pixels, a
        multiple of the VAE's downsample factor; the initial noise comes
        from ``generator`` (default: a CPU generator seeded with 0), drawn
        on its device in fp32."""
        ucfg = self.unet.config
        factor = 2 ** (len(self.vae.config.block_channels) - 1)
        for dim, val in (("height", height), ("width", width)):
            if val is not None and val % factor:
                raise ValueError(
                    f"{dim}={val} must be a multiple of the VAE downsample "
                    f"factor {factor} (would silently render "
                    f"{val // factor * factor} pixels)")
        h = (height or ucfg.sample_size * factor) // factor
        w = (width or ucfg.sample_size * factor) // factor
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        latents = torch.randn((text_embeds.shape[0], h, w, ucfg.in_channels),
                              generator=gen, device=gen.device,
                              dtype=torch.float32)
        return self.denoise(latents.to(text_embeds.device), text_embeds,
                            uncond_embeds, steps, guidance_scale)
