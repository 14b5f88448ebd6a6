"""The standalone encoder block (``DeepSpeedTransformerLayer``) and its
pure forward (``apply``)."""

from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer, apply)

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer",
           "apply"]
