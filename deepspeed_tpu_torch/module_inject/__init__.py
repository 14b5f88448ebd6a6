"""Weight-injection policies of the port: diffusers state dicts → the
served UNet and VAE (``UNetPolicy``, ``VAEPolicy``)."""

from .replace_policy import GENERIC_POLICIES, UNetPolicy, VAEPolicy

__all__ = ["GENERIC_POLICIES", "UNetPolicy", "VAEPolicy"]
