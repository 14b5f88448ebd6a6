"""Sharded HF checkpoint loading and serving-side weight quantization: the
port of ``module_inject/load_checkpoint.py``.

``load_sharded_state_dict`` reads a directory that ``save_pretrained``
wrote with sharding (``pytorch_model-00001-of-000NN.bin`` and its index
json, ``.safetensors`` shards, or ``.npz`` shards) into one flat state
dict for the injection policies, one shard at a time.

``module_quantize`` fake-quantizes the matmul weights of a converted
parameter tree (symmetric, groupwise): the weights land on the int grid
while the compute dtype stays as it is.  It runs the port's
``fake_quantize``, so on CUDA tensors each quantized leaf is one launch
of the ``quantizer`` kernel.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from ..ops.kernels.quantizer import fake_quantize
from ..utils.logging import logger

Params = Dict[str, Any]


def _is_weight_file(name: str) -> bool:
    """A weight shard of a directory without an index: HF Trainer
    directories also hold ``optimizer.pt``, ``training_args.bin`` and
    ``scheduler.pt``, none of them a state dict."""
    if name.endswith(".npz"):
        return True
    return (name.startswith(("pytorch_model", "model", "tf_model")) and
            name.endswith((".bin", ".pt", ".safetensors")))


def load_sharded_state_dict(ckpt_dir: str) -> Dict[str, Any]:
    """Merge a sharded checkpoint directory into one flat state dict
    (``.bin``/``.pt`` shards as tensors, ``.npz`` and ``.safetensors`` as
    numpy arrays).  An index file is chosen deterministically, one of
    ``safetensors`` first; ``.bin``/``.pt`` shards load with
    ``weights_only=True``, so no checkpoint pickle runs."""
    index_files = sorted(
        (f for f in os.listdir(ckpt_dir) if f.endswith(".index.json")),
        key=lambda f: (0 if "safetensors" in f else 1, f))
    if index_files:
        with open(os.path.join(ckpt_dir, index_files[0])) as f:
            index = json.load(f)
        shards = sorted(set(index["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(ckpt_dir) if _is_weight_file(f))
    if not shards:
        raise FileNotFoundError(f"no checkpoint shards under {ckpt_dir}")
    sd: Dict[str, Any] = {}
    for shard in shards:
        path = os.path.join(ckpt_dir, shard)
        if shard.endswith(".npz"):
            with np.load(path) as z:
                part = {k: z[k] for k in z.files}
        elif shard.endswith(".safetensors"):
            from safetensors.numpy import load_file  # optional dependency
            part = load_file(path)
        else:
            part = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(part, dict):
            raise ValueError(f"{shard} is not a state dict "
                             f"({type(part).__name__})")
        sd.update(part)
        logger.info(f"[load_checkpoint] merged shard {shard} "
                    f"({len(part)} tensors)")
    return sd


def module_quantize(params: Params, bits: int = 8, groups_per_layer: int = 1,
                    min_ndim: int = 2) -> Params:
    """Groupwise symmetric fake-quantization of every weight leaf of a
    tree of tensors.  A layer-stacked leaf ([L, ...], three or more dims)
    takes ``L * groups_per_layer`` groups, so that one outlier layer does
    not set the step of the whole stack; a leaf of fewer than
    ``min_ndim`` dims (biases, norms) or not floating point passes
    through."""
    def q(leaf):
        if leaf.ndim < min_ndim or not leaf.is_floating_point():
            return leaf
        groups = groups_per_layer
        if leaf.ndim >= 3:          # the leading dim stacks the layers
            groups = leaf.shape[0] * groups_per_layer
        return fake_quantize(leaf, groups=groups, bits=bits,
                             symmetric=True).to(leaf.dtype)

    def node(v):
        if isinstance(v, Mapping):
            return {k: node(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [node(x) for x in v]
        return q(v)

    return node(params)
