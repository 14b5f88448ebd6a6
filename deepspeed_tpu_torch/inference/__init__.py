from .config import DeepSpeedInferenceConfig
from .diffusion_pipeline import DiffusionPipeline, ddim_alphas
from .engine import InferenceEngine

__all__ = ["DeepSpeedInferenceConfig", "DiffusionPipeline",
           "InferenceEngine", "ddim_alphas"]
