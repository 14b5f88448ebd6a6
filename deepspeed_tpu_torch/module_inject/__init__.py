"""Weight-injection policies of the port: diffusers state dicts → the
served UNet and VAE (``UNetPolicy``, ``VAEPolicy``); HF decoder models
→ the GPT tree (``HFGPT2LayerPolicy``, ``HFGPTNEOLayerPolicy``,
``HFOPTLayerPolicy``, ``BLOOMLayerPolicy``, ``GPTNEOXLayerPolicy``,
``HFGPTJLayerPolicy``; ``convert_hf_model``); HF BERT → the BERT tree
(``HFBertLayerPolicy``; ``convert_hf_bert``) and the CLIP text tower →
a causal GPT tree (``HFCLIPLayerPolicy``; ``convert_hf_clip_text``);
sharded checkpoint directories and serving-side fake quantization
(``load_checkpoint``: ``load_sharded_state_dict``, ``module_quantize``)."""

from .load_checkpoint import load_sharded_state_dict, module_quantize
from .replace_policy import (GENERIC_POLICIES, POLICIES, BLOOMLayerPolicy,
                             GPTNEOXLayerPolicy, HFBertLayerPolicy,
                             HFCLIPLayerPolicy, HFGPT2LayerPolicy,
                             HFGPTJLayerPolicy, HFGPTNEOLayerPolicy,
                             HFOPTLayerPolicy, UNetPolicy, VAEPolicy,
                             convert_hf_bert, convert_hf_clip_text,
                             convert_hf_model, match_decoder)

__all__ = ["BLOOMLayerPolicy", "GENERIC_POLICIES", "GPTNEOXLayerPolicy",
           "HFBertLayerPolicy", "HFCLIPLayerPolicy", "HFGPT2LayerPolicy",
           "HFGPTJLayerPolicy", "HFGPTNEOLayerPolicy", "HFOPTLayerPolicy",
           "POLICIES", "UNetPolicy", "VAEPolicy", "convert_hf_bert",
           "convert_hf_clip_text", "convert_hf_model",
           "load_sharded_state_dict", "match_decoder", "module_quantize"]
