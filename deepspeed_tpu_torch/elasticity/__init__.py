"""Elasticity of the port (the JAX package's ``elasticity/``): the elastic
admission algebra and the preemptible train loop, ``ElasticTrainRunner``."""

from .config import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                     ElasticityIncompatibleWorldSize)
from .elastic_agent import ElasticTrainRunner
from .elasticity import (compute_elastic_config, elasticity_enabled,
                         ensure_immutable_elastic_config,
                         get_compatible_gpus_v01, get_compatible_gpus_v02)

__all__ = [
    "ElasticityConfig", "ElasticityConfigError", "ElasticityError",
    "ElasticityIncompatibleWorldSize", "ElasticTrainRunner",
    "compute_elastic_config", "elasticity_enabled",
    "ensure_immutable_elastic_config", "get_compatible_gpus_v01",
    "get_compatible_gpus_v02",
]
