"""Compatible-batch algebra: pick one global batch size that trains
identically across a whole range of accelerator counts — the port of the
JAX package's ``elasticity/elasticity.py``, the counterpart of the
reference's ``deepspeed/elasticity/elasticity.py``
(``compute_elastic_config`` :287, v0.1 algebra :125, v0.2 :173).  Same
problem statement — given acceptable micro-batch sizes and a max global
batch, find the global batch maximizing the number of admissible chip
counts (so a preempted/resized job keeps its loss trajectory) — solved
directly: enumerate candidate batches (multiples of the micro batches) and
score each by how many world sizes in [min, max] can realise it as
``micro_batch × gas × dp``.  v0.2 adds model parallelism: only world sizes
divisible by ``model_parallel_size × num_gpus_per_node`` are admissible and
the batch divides over dp = world/mp.

Preemption-resume (the torchelastic role) is handled by
``elastic_agent.ElasticTrainRunner``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger
from . import constants as EC
from .config import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                     ElasticityIncompatibleWorldSize)


def _divisors(n: int) -> List[int]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            if d != n // d:
                out.append(n // d)
        d += 1
    return sorted(out)


def _admissible_world_sizes(batch: int, micro_batches: List[int],
                            min_gpus: int, max_gpus: int,
                            mp_size: int = 1,
                            gpus_per_node: int = 1) -> List[int]:
    """World sizes in range that can run ``batch`` = mbs × gas × dp.

    dp must divide the batch, so only divisor dp values are enumerated
    (keeps the search cheap even with the default max_gpus of 10000).
    """
    out = []
    unit = mp_size * gpus_per_node
    for dp in _divisors(batch):
        w = dp * mp_size
        if w < min_gpus or w > max_gpus or w % unit != 0:
            continue
        per_rank = batch // dp
        if any(per_rank % m == 0 for m in micro_batches):
            out.append(w)
    return sorted(out)


def _candidate_batches(micro_batches: List[int], max_batch: int) -> List[int]:
    cands = set()
    for m in sorted(micro_batches):
        cands.update(range(m, max_batch + 1, m))
    return sorted(cands)


def get_compatible_gpus_v01(micro_batches: List[int],
                            max_acceptable_batch_size: int,
                            min_gpus: int = 1,
                            max_gpus: int = 10000,
                            prefer_larger: bool = True) -> Tuple[int, List[int]]:
    """v0.1 algebra: (final_batch_size, valid_gpus) without model parallel."""
    best: Tuple[int, int] = (-1, -1)  # (n_valid, batch)
    best_gpus: List[int] = []
    for b in _candidate_batches(micro_batches, max_acceptable_batch_size):
        valid = _admissible_world_sizes(b, micro_batches, min_gpus, max_gpus)
        if not valid:
            continue
        key = (len(valid), b if prefer_larger else -b)
        if key > best:
            best, best_gpus = key, valid
    if not best_gpus:
        raise ElasticityError(
            f"no compatible batch ≤ {max_acceptable_batch_size} for "
            f"micro_batches={micro_batches}, gpus [{min_gpus}, {max_gpus}]")
    final_batch = best[1] if prefer_larger else -best[1]
    return final_batch, best_gpus


def get_compatible_gpus_v02(micro_batches: List[int],
                            max_acceptable_batch_size: int,
                            min_gpus: int = 1,
                            max_gpus: int = 10000,
                            prefer_larger: bool = True,
                            num_gpus_per_node: int = 1,
                            model_parallel_size: int = 1) -> Tuple[int, List[int]]:
    """v0.2: model-parallel-aware (reference elasticity.py:173)."""
    best: Tuple[int, int] = (-1, -1)
    best_gpus: List[int] = []
    for b in _candidate_batches(micro_batches, max_acceptable_batch_size):
        valid = _admissible_world_sizes(
            b, micro_batches, min_gpus, max_gpus,
            mp_size=model_parallel_size, gpus_per_node=num_gpus_per_node)
        if not valid:
            continue
        key = (len(valid), b if prefer_larger else -b)
        if key > best:
            best, best_gpus = key, valid
    if not best_gpus:
        raise ElasticityError(
            f"no compatible batch ≤ {max_acceptable_batch_size} for "
            f"micro_batches={micro_batches}, gpus [{min_gpus}, {max_gpus}], "
            f"mp={model_parallel_size}")
    final_batch = best[1] if prefer_larger else -best[1]
    return final_batch, best_gpus


def _micro_batch_for(batch: int, world_size: int, micro_batches: List[int],
                     mp_size: int, prefer_larger: bool) -> Tuple[int, int]:
    """Pick (micro_batch, gas) for a specific world size."""
    dp = world_size // mp_size
    per_rank = batch // dp
    fits = [m for m in micro_batches if per_rank % m == 0]
    m = max(fits) if prefer_larger else min(fits)
    return m, per_rank // m


def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get(EC.ELASTICITY, {}).get(EC.ENABLED, False))


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """A restarted worker must see the exact elastic config the job was
    admitted with (reference elasticity.py:254): the scheduler latches a
    hash in the environment; any drift is fatal."""
    blob = json.dumps(runtime_elastic_config_dict, sort_keys=True)
    digest = hashlib.sha256(blob.encode()).hexdigest()
    latched = os.environ.get(EC.DEEPSPEED_ELASTICITY_CONFIG)
    if latched is None:
        os.environ[EC.DEEPSPEED_ELASTICITY_CONFIG] = digest
    elif latched != digest:
        raise ElasticityConfigError(
            "elastic config changed since job admission — scheduling "
            "decisions (batch size, admissible world sizes) would no longer "
            "hold; restart the job instead of editing elasticity in place")


def compute_elastic_config(ds_config: Dict,
                           target_deepspeed_version: Optional[str] = None,
                           world_size: int = 0,
                           return_microbatch: bool = False):
    """Resolve the elastic schedule (reference elasticity.py:287).

    Returns ``(final_batch_size, valid_gpus)`` and, with
    ``return_microbatch`` and a concrete ``world_size``, the micro batch.
    Raises ``ElasticityIncompatibleWorldSize`` if ``world_size`` isn't
    admissible.
    """
    if EC.ELASTICITY not in ds_config:
        raise ElasticityConfigError(
            f'ds_config has no "{EC.ELASTICITY}" section')
    cfg = ElasticityConfig(ds_config[EC.ELASTICITY])
    if not cfg.enabled:
        raise ElasticityConfigError("elasticity is not enabled in the config")
    if ("train_batch_size" in ds_config or
            "train_micro_batch_size_per_gpu" in ds_config or
            "gradient_accumulation_steps" in ds_config) and \
            not cfg.ignore_non_elastic_batch_info:
        raise ElasticityConfigError(
            "batch parameters in the config conflict with elasticity "
            "(the elastic algebra owns them); remove them or set "
            f"{EC.IGNORE_NON_ELASTIC_BATCH_INFO}")

    if cfg.version >= 0.2:
        final_batch, valid_gpus = get_compatible_gpus_v02(
            cfg.micro_batches, cfg.max_acceptable_batch_size,
            cfg.min_gpus, cfg.max_gpus, cfg.prefer_larger_batch_size,
            cfg.num_gpus_per_node, cfg.model_parallel_size)
        mp = cfg.model_parallel_size
    else:
        final_batch, valid_gpus = get_compatible_gpus_v01(
            cfg.micro_batches, cfg.max_acceptable_batch_size,
            cfg.min_gpus, cfg.max_gpus, cfg.prefer_larger_batch_size)
        mp = 1

    logger.info(f"[elasticity] final_batch_size={final_batch}, "
                f"valid world sizes={valid_gpus}")
    if world_size > 0 and world_size not in valid_gpus:
        raise ElasticityIncompatibleWorldSize(
            f"world size {world_size} is not admissible; valid: {valid_gpus}")
    if return_microbatch:
        if world_size <= 0:
            raise ElasticityConfigError(
                "return_microbatch requires a concrete world_size")
        micro, _gas = _micro_batch_for(
            final_batch, world_size, cfg.micro_batches, mp,
            cfg.prefer_larger_batch_size)
        return final_batch, valid_gpus, micro
    return final_batch, valid_gpus
