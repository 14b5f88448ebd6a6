"""Elasticity config keys: the port of the JAX package's
``elasticity/constants.py`` (the reference's
``deepspeed/elasticity/constants.py`` vocabulary)."""

ELASTICITY = "elasticity"

ENABLED = "enabled"
ENABLED_DEFAULT = False

MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000

MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]

MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000

NUM_GPUS_PER_NODE = "num_gpus_per_node"
NUM_GPUS_PER_NODE_DEFAULT = 1

MODEL_PARALLEL_SIZE = "model_parallel_size"
MODEL_PARALLEL_SIZE_DEFAULT = 1

MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0

PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True

IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False

VERSION = "version"
VERSION_DEFAULT = 0.2

LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.3.8"

# env var latching the elastic config hash so a restarted worker can't
# silently run with a different schedule-relevant config
DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"
