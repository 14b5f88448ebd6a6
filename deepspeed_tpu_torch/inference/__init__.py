from .config import DeepSpeedInferenceConfig
from .diffusion_pipeline import DiffusionPipeline, ddim_alphas
from .engine import InferenceEngine, InferenceSession

__all__ = ["DeepSpeedInferenceConfig", "DiffusionPipeline",
           "InferenceEngine", "InferenceSession", "ddim_alphas"]
