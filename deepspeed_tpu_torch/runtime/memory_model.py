"""The analytic memory model of ZeRO (the port of the JAX package's
``runtime/memory_model.py``): the device bytes of the ZeRO state, the
peak of the streamed offload step, and the device's budget.  The config's
``"auto"`` micro-batch and the offload step's ``pipeline_transfers``
switch read it.
"""

from __future__ import annotations

from typing import Optional

import torch


def zero_state_bytes(num_params: int, dp: int, stage: int,
                     mixed_precision: bool, offload: bool) -> int:
    """Per-device bytes of params, fp32 master, gradients and the Adam
    moments."""
    n, dp = int(num_params), max(1, int(dp))
    param_b = n * (2 if mixed_precision else 4)
    master_b = n * 4 if (mixed_precision or stage >= 1) else 0
    grad_b = n * 4
    opt_b = n * 8  # adam m+v fp32
    if stage >= 1:
        master_b //= dp
        opt_b //= dp
    if stage >= 2:
        grad_b //= dp
    if stage >= 3:
        param_b //= dp
    if offload:
        master_b = opt_b = 0  # host-resident
    return param_b + master_b + grad_b + opt_b


def offload_peak_bytes(num_params: int, largest_leaf_params: int,
                       mixed_precision: bool = True,
                       grad_accum_bytes: int = 4,
                       pipeline_transfers: bool = True) -> int:
    """Peak device bytes of the streamed offload step, activations
    excluded: the compute-dtype params and the accumulator
    (``grad_accum_bytes`` a parameter: 4 for fp32, 2 for a 16-bit
    ``data_types.grad_accum_dtype``) persist; the step streams one leaf
    at a time, two with ``pipeline_transfers`` (the next leaf's transfer
    overlaps the host Adam); the master and the moments live on the
    host.  (The JAX package's ``compression_residual_bytes`` belongs to
    ``grad_compression``, which is not ported.)"""
    p = 2 if mixed_precision else 4
    inflight = 2 if pipeline_transfers else 1
    return int(num_params) * (p + int(grad_accum_bytes)) \
        + inflight * int(largest_leaf_params) * p


def device_budget(memory_fraction: float = 0.85,
                  device_memory_bytes: Optional[int] = None) -> Optional[int]:
    """Usable device bytes: ``memory_fraction`` of
    ``device_memory_bytes``, else of the current CUDA device's total
    memory (``torch.cuda.mem_get_info``); None without a card."""
    if device_memory_bytes is not None:
        return int(device_memory_bytes * memory_fraction)
    if not torch.cuda.is_available():
        return None
    _, total = torch.cuda.mem_get_info()
    return int(total * memory_fraction)
