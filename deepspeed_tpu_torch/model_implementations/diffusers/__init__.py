from .unet import DSUNet  # noqa: F401
from .vae import DSVAE  # noqa: F401
