"""Weight-injection policies of the port: diffusers state dicts → the
served UNet and VAE (``UNetPolicy``, ``VAEPolicy``), and HF decoder models
→ the GPT tree (``HFGPT2LayerPolicy``, ``HFGPTNEOLayerPolicy``,
``HFOPTLayerPolicy``, ``BLOOMLayerPolicy``, ``GPTNEOXLayerPolicy``,
``HFGPTJLayerPolicy``; ``convert_hf_model``)."""

from .replace_policy import (GENERIC_POLICIES, POLICIES, BLOOMLayerPolicy,
                             GPTNEOXLayerPolicy, HFGPT2LayerPolicy,
                             HFGPTJLayerPolicy, HFGPTNEOLayerPolicy,
                             HFOPTLayerPolicy, UNetPolicy, VAEPolicy,
                             convert_hf_model, match_decoder)

__all__ = ["BLOOMLayerPolicy", "GENERIC_POLICIES", "GPTNEOXLayerPolicy",
           "HFGPT2LayerPolicy", "HFGPTJLayerPolicy", "HFGPTNEOLayerPolicy",
           "HFOPTLayerPolicy", "POLICIES", "UNetPolicy", "VAEPolicy",
           "convert_hf_model", "match_decoder"]
