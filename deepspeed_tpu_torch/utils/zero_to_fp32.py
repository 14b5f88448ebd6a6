"""Recover a consolidated fp32 state dict from an engine checkpoint.

The port of the JAX package's ``utils/zero_to_fp32.py`` (the reference's
``deepspeed/utils/zero_to_fp32.py``, whose shim the engine drops beside
its checkpoints).  Checkpoints of either package store global arrays, so
recovery = read the fp32 master (falling back to params) and write one
portable ``.npz``.

CLI:  python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <out.npz> [tag]
API:  get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None)
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np

SEP = "/"


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{param-path: fp32 array} for every model parameter.

    Prefers the optimizer's fp32 master copy (exact), falling back to the
    stored (possibly bf16-widened) params for checkpoints saved without a
    separate master.
    """
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}")
        with open(latest) as f:
            tag = f.read().strip()
    ckpt = os.path.join(checkpoint_dir, tag)
    model = _load_npz(os.path.join(ckpt, "model_states.npz"))
    params = {k[len("params" + SEP):]: v for k, v in model.items()
              if k.startswith("params" + SEP)}
    optim_path = os.path.join(ckpt, "optim_states.npz")
    if os.path.exists(optim_path):
        optim = _load_npz(optim_path)
        masters = {k[len("master" + SEP):]: v for k, v in optim.items()
                   if k.startswith("master" + SEP)}
        if masters:
            params = {k: masters.get(k, v) for k, v in params.items()}
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str,
        tag: Optional[str] = None) -> None:
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"saved {len(sd)} tensors ({total:,} params, fp32) to {output_file}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    convert_zero_checkpoint_to_fp32_state_dict(
        argv[0], argv[1], tag=argv[2] if len(argv) > 2 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
