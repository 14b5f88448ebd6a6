"""Elasticity config object: the port of the JAX package's
``elasticity/config.py`` (the reference's ``deepspeed/elasticity/config.py``).

Same JSON section:

    "elasticity": {
        "enabled": true,
        "max_train_batch_size": 2000,
        "micro_batch_sizes": [2, 4, 6],
        "min_gpus": 1, "max_gpus": 10000,
        "min_time": 20,
        "prefer_larger_batch": true,
        "version": 0.2,
        "model_parallel_size": 1,
        "num_gpus_per_node": 1
    }
"""

from __future__ import annotations

import json
from typing import Any, Dict

from . import constants as EC


class ElasticityError(Exception):
    """Base elasticity error."""


class ElasticityConfigError(ElasticityError):
    """Bad elasticity config."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """Current world size is not admissible under the elastic config."""


class ElasticityConfig:
    def __init__(self, param_dict: Dict[str, Any]):
        self.enabled = param_dict.get(EC.ENABLED, EC.ENABLED_DEFAULT)
        self.max_acceptable_batch_size = param_dict.get(
            EC.MAX_ACCEPTABLE_BATCH_SIZE, EC.MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT)
        self.micro_batches = param_dict.get(EC.MICRO_BATCHES, EC.MICRO_BATCHES_DEFAULT)
        if not isinstance(self.micro_batches, list) or not self.micro_batches:
            raise ElasticityConfigError(
                f"{EC.MICRO_BATCHES} must be a non-empty list, got "
                f"{self.micro_batches!r}")
        if any((not isinstance(m, int)) or m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"{EC.MICRO_BATCHES} entries must be positive ints, got "
                f"{self.micro_batches!r}")
        self.min_gpus = param_dict.get(EC.MIN_GPUS, EC.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(EC.MAX_GPUS, EC.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"invalid gpu range [{self.min_gpus}, {self.max_gpus}]")
        self.model_parallel_size = param_dict.get(
            EC.MODEL_PARALLEL_SIZE, EC.MODEL_PARALLEL_SIZE_DEFAULT)
        self.num_gpus_per_node = param_dict.get(
            EC.NUM_GPUS_PER_NODE, EC.NUM_GPUS_PER_NODE_DEFAULT)
        self.min_time = param_dict.get(EC.MIN_TIME, EC.MIN_TIME_DEFAULT)
        self.version = float(param_dict.get(EC.VERSION, EC.VERSION_DEFAULT))
        self.prefer_larger_batch_size = param_dict.get(
            EC.PREFER_LARGER_BATCH, EC.PREFER_LARGER_BATCH_DEFAULT)
        self.ignore_non_elastic_batch_info = param_dict.get(
            EC.IGNORE_NON_ELASTIC_BATCH_INFO,
            EC.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)

    def repr(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)
