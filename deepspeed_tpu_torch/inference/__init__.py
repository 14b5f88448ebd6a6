from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine"]
