"""Config key names and defaults.

A copy of the JAX package's ``runtime/constants.py`` (the counterpart of
the reference's ``deepspeed/runtime/constants.py``), kept in the port so
that it imports nothing of the JAX package.  Keys keep the reference
spelling so existing DeepSpeed JSON configs parse unchanged; the port's
``runtime/config.py`` reads only the sections its training path runs.
"""

#############################################
# Batch size / schedule
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False

SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

MAX_GRAD_NORM = "max_grad_norm"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
ZERO_FORCE_DS_CPU_OPTIMIZER = "zero_force_ds_cpu_optimizer"
ZERO_FORCE_DS_CPU_OPTIMIZER_DEFAULT = True

#############################################
# Precision: fp16 / bf16 / fp32 / amp
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False
FP16_AUTO_CAST = "auto_cast"
FP16_AUTO_CAST_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # legacy key accepted by the reference
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# Logging / timers
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"

#############################################
# Communication
#############################################
COMMS_LOGGER = "comms_logger"
COMMS_LOGGER_ENABLED = "enabled"
COMMS_LOGGER_ENABLED_DEFAULT = False
COMMS_LOGGER_VERBOSE = "verbose"
COMMS_LOGGER_VERBOSE_DEFAULT = False
COMMS_LOGGER_PROF_ALL = "prof_all"
COMMS_LOGGER_PROF_ALL_DEFAULT = True
COMMS_LOGGER_DEBUG = "debug"
COMMS_LOGGER_DEBUG_DEFAULT = False
COMMS_LOGGER_PROF_OPS = "prof_ops"
COMMS_LOGGER_PROF_OPS_DEFAULT = []

COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None

DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

#############################################
# Activation checkpointing
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False
ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False
ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False
ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_PROFILE_DEFAULT = False

#############################################
# Gradient compression / 1-bit
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE

#############################################
# Curriculum / data pipeline
#############################################
CURRICULUM_LEARNING = "curriculum_learning"
CURRICULUM_ENABLED = "enabled"
CURRICULUM_ENABLED_DEFAULT = False

PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

#############################################
# Eigenvalue (MoQ)
#############################################
EIGENVALUE = "eigenvalue"
EIGENVALUE_ENABLED = "enabled"
EIGENVALUE_ENABLED_DEFAULT = False
EIGENVALUE_VERBOSE = "verbose"
EIGENVALUE_VERBOSE_DEFAULT = False
EIGENVALUE_MAX_ITER = "max_iter"
EIGENVALUE_MAX_ITER_DEFAULT = 100
EIGENVALUE_TOL = "tol"
EIGENVALUE_TOL_DEFAULT = 1e-2
EIGENVALUE_STABILITY = "stability"
EIGENVALUE_STABILITY_DEFAULT = 1e-6
EIGENVALUE_GAS_BOUNDARY_RESOLUTION = "gas_boundary_resolution"
EIGENVALUE_GAS_BOUNDARY_RESOLUTION_DEFAULT = 1
EIGENVALUE_LAYER_NAME = "layer_name"
EIGENVALUE_LAYER_NAME_DEFAULT = "bert.encoder.layer"
EIGENVALUE_LAYER_NUM = "layer_num"
EIGENVALUE_LAYER_NUM_DEFAULT = 0

#############################################
# Checkpointing
#############################################
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = None

#############################################
# Elasticity
#############################################
ELASTICITY = "elasticity"

#############################################
# Mixture of Experts (read raw by the JAX package's initialize)
#############################################
MOE = "moe"
MOE_EP_SIZE = "ep_size"
MOE_EP_SIZE_DEFAULT = 1

#############################################
# Run supervision (watchdog / heartbeats / rollback-and-retry)
#############################################
SUPERVISION = "supervision"

#############################################
# Deterministic resumable data pipeline
#############################################
DATA = "data"

#############################################
# Unified telemetry (span tracing / metrics stream / trace capture)
#############################################
TELEMETRY = "telemetry"

#############################################
# Flops profiler / monitor / autotuning keys live in their own modules
#############################################
FLOPS_PROFILER = "flops_profiler"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
AUTOTUNING = "autotuning"

#############################################
# Pipeline section (engine-level)
#############################################
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_PARTITION = "partition"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"

#############################################
# TPU-specific additions (no reference counterpart)
#############################################
TENSOR_PARALLEL = "tensor_parallel"           # {"enabled": bool, "size": int}
SEQUENCE_PARALLEL = "sequence_parallel"       # {"enabled": bool, "size": int, "mode": "ring"|"alltoall"}
MESH = "mesh"                                 # explicit mesh dims override
