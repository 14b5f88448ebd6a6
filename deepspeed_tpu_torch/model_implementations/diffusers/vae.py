"""DSVAE: the served AutoencoderKL wrapper, the port of
``model_implementations/diffusers/vae.py``: ``encode``, ``decode`` and
``forward`` over the NHWC VAE of ``models/diffusion.py``, NCHW inputs
transposed in and out.  It runs eagerly; ``enable_cuda_graph`` is
accepted, and graph capture is later work."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...models.diffusion import VAEConfig, vae_decode, vae_encode
from .unet import tree_device


class DSVAE:
    def __init__(self, config: VAEConfig, params: Dict[str, Any],
                 enable_cuda_graph: bool = True):
        self.config = config
        self.params = params
        self.dtype = config.dtype
        self.device = tree_device(params)

    def _to_nhwc(self, x, channels):
        x = torch.as_tensor(x, device=self.device)
        if x.shape[-1] != channels and x.shape[1] == channels:
            return x.permute(0, 2, 3, 1), True
        return x, False

    def decode(self, latents, return_dict: bool = True):
        z, nchw = self._to_nhwc(latents, self.config.latent_channels)
        with torch.no_grad():
            img = vae_decode(self.params, z, self.config)
        if nchw:
            img = img.permute(0, 3, 1, 2)
        if return_dict:
            return {"sample": img}
        return (img,)

    def encode(self, images, return_dict: bool = True,
               generator: Optional[torch.Generator] = None):
        """``generator=None`` returns the latent mean; with a generator a
        reparameterized sample of the latent distribution."""
        x, nchw = self._to_nhwc(images, self.config.in_channels)
        with torch.no_grad():
            z = vae_encode(self.params, x, self.config, generator)
        if nchw:
            z = z.permute(0, 3, 1, 2)
        if return_dict:
            return {"latent_dist_mean": z}
        return (z,)

    def forward(self, images):
        return self.decode(self.encode(images, return_dict=False)[0])

    __call__ = forward
