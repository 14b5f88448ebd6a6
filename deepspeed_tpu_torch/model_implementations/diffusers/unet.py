"""DSUNet: the served UNet wrapper, the port of
``model_implementations/diffusers/unet.py``.

It serves the NHWC UNet of ``models/diffusion.py`` with the reference
surface (``in_channels``, ``dtype``, ``fwd_count``, a callable forward
that takes NHWC or NCHW samples and returns a dict or a tuple).  The
forward runs eagerly; ``enable_cuda_graph`` is accepted, and capturing
the forward into a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ...models.diffusion import UNetConfig, unet_apply


def tree_device(tree) -> torch.device:
    """The device of a parameter tree's first leaf."""
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


class DSUNet:
    def __init__(self, config: UNetConfig, params: Dict[str, Any],
                 enable_cuda_graph: bool = True):
        self.config = config
        self.params = params
        self.in_channels = config.in_channels
        self.dtype = config.dtype
        self.device = tree_device(params)
        self.fwd_count = 0

    def forward(self, sample, timestep, encoder_hidden_states,
                return_dict: bool = True):
        """sample [B, H, W, C] NHWC (or [B, C, H, W] NCHW, transposed in
        and out), timestep scalar or [B], encoder_hidden_states [B, S,
        D]."""
        sample = torch.as_tensor(sample, device=self.device)
        nchw = sample.shape[-1] != self.in_channels and \
            sample.shape[1] == self.in_channels
        if nchw:
            sample = sample.permute(0, 2, 3, 1)
        with torch.no_grad():
            out = unet_apply(self.params, sample, timestep,
                             torch.as_tensor(encoder_hidden_states,
                                             device=self.device),
                             self.config)
        if nchw:
            out = out.permute(0, 3, 1, 2)
        self.fwd_count += 1
        if return_dict:
            return {"sample": out}
        return (out,)

    __call__ = forward
