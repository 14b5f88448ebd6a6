"""ZeRO-Offload's host optimizer.

The port of the JAX package's ``runtime/zero/offload_engine.py``
(``HostOffloadOptimizer``, the counterpart of the reference's
``cpu_offload`` path in ``stage_1_and_2.py`` and of the stage-3 NVMe swap
of optimizer state).  The device runs forward, backward and the gradient
preparation; this class holds the fp32 master and the Adam moments, one
flat CPU tensor per parameter leaf, in host memory (``device="cpu"``) or
in swap files streamed through host memory (``device="nvme"``), and steps
them with the host SIMD Adam (``ops/adam/cpu_adam.py``).  The engine
drives a step leaf by leaf (``step_begin``, ``step_one`` per leaf,
``step_end``), so the transfers of the neighbouring leaves overlap it.

One process and one parameter group: the JAX package's multi-host shard
helpers and per-group hyperparameters are not ported (ROADMAP.md Queue 1
#3.5, #7).  The checkpoint file (``save``/``load``) is the JAX package's
npz: ``step`` and ``master_i``, ``m_i``, ``v_i`` per leaf, flat fp32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...ops.adam.cpu_adam import cpu_adam_step
from ...ops.op_builder.cpu_adam import CPUAdamBuilder
from ...utils.logging import logger
from ..checkpoint_engine.storage import atomic_write_npz
from ..swap_tensor import AioConfig, OptimizerStateSwapper


def _flat32(t, copy: bool = True) -> torch.Tensor:
    """``t`` as a flat contiguous fp32 CPU tensor; one that owns its
    memory unless ``copy`` is off (then a CPU fp32 tensor is taken as
    it is, as the JAX package takes a numpy array)."""
    t = torch.as_tensor(t).detach()
    return t.to("cpu", torch.float32, copy=copy).contiguous().reshape(-1)


class HostOffloadOptimizer:
    """Adam over fp32 state in host memory (cpu) or swap files (nvme)."""

    def __init__(self, master_leaves: Sequence[torch.Tensor],
                 device: str = "cpu", nvme_path: Optional[str] = None,
                 aio_config: Optional[AioConfig] = None,
                 pipeline_read: bool = True, pipeline_write: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True, num_threads: int = 0):
        if device not in ("cpu", "nvme"):
            raise ValueError(f"offload device {device!r} (want 'cpu' or "
                             "'nvme')")
        self.device = device
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.num_threads = num_threads
        self.step_count = 0
        self._lib = CPUAdamBuilder().load()
        self._shapes = [tuple(l.shape) for l in master_leaves]
        self._swapper: Optional[OptimizerStateSwapper] = None
        if device == "cpu":
            self._master = [_flat32(l, copy=False) for l in master_leaves]
            self._m = [torch.zeros_like(f) for f in self._master]
            self._v = [torch.zeros_like(f) for f in self._master]
            return
        if not nvme_path:
            raise ValueError("offload device 'nvme' requires nvme_path")
        self._swapper = OptimizerStateSwapper(
            nvme_path, aio_config, pipeline_read=pipeline_read,
            pipeline_write=pipeline_write)
        for i, leaf in enumerate(master_leaves):
            f = _flat32(leaf, copy=False)
            self._swapper.put(self._key(i), {
                "master": f, "m": torch.zeros_like(f),
                "v": torch.zeros_like(f)})
            # one leaf's state in host memory at a time
            self._swapper.flush_writes()
        self._master = self._m = self._v = None
        logger.info(f"[offload] {len(self._shapes)} leaves "
                    f"({sum(int(np.prod(s)) for s in self._shapes) / 1e6:.1f}"
                    f"M fp32 params) swapped to {nvme_path}")

    @staticmethod
    def _key(i: int) -> str:
        return f"group{i}"

    @property
    def num_groups(self) -> int:
        return len(self._shapes)

    def numel(self, i: int) -> int:
        return int(np.prod(self._shapes[i]))

    @property
    def swapper(self) -> Optional[OptimizerStateSwapper]:
        """The swap store of ``device="nvme"``, else None."""
        return self._swapper

    def step(self, host_grads: List[torch.Tensor], lr: float,
             weight_decay: Optional[float] = None) -> List[torch.Tensor]:
        """One Adam step over every leaf; returns the updated masters."""
        if len(host_grads) != self.num_groups:
            raise ValueError(f"{len(host_grads)} gradients for "
                             f"{self.num_groups} leaves")
        self.step_begin(weight_decay)
        outs = [self.step_one(i, g, lr) for i, g in enumerate(host_grads)]
        self.step_end()
        return outs

    def step_begin(self, weight_decay: Optional[float] = None) -> None:
        """Count the step; ``step_one`` per leaf and ``step_end`` follow."""
        if weight_decay is not None:
            self.weight_decay = weight_decay
        self.step_count += 1

    def step_one(self, i: int, g: torch.Tensor, lr: float,
                 bf16_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Adam-step leaf ``i`` with its unscaled fp32 gradient ``g``
        (flat, on the CPU); with ``bf16_out`` the updated params' bf16
        copy too.  Returns the updated flat fp32 master."""
        if self._swapper is None:
            p, m, v = self._master[i], self._m[i], self._v[i]
        else:
            nxt = self._key(i + 1) if i + 1 < self.num_groups else None
            state = self._swapper.get(self._key(i), prefetch_next=nxt)
            p, m, v = state["master"], state["m"], state["v"]
        cpu_adam_step(self._lib, p, g.reshape(-1), m, v, self.step_count, lr,
                      self.beta1, self.beta2, self.eps, self.weight_decay,
                      self.adamw_mode, self.bias_correction,
                      bf16_out=bf16_out, num_threads=self.num_threads)
        if self._swapper is not None:
            self._swapper.put(self._key(i), {"master": p, "m": m, "v": v})
        return p

    def step_end(self) -> None:
        if self._swapper is not None:
            self._swapper.flush_writes()

    # ------------------------------------------------------------ checkpoint
    def _groups(self):
        """(master, m, v) per leaf, read in from the swap files for nvme."""
        for i in range(self.num_groups):
            if self._swapper is None:
                yield self._master[i], self._m[i], self._v[i]
            else:
                s = self._swapper.get(self._key(i))
                yield s["master"], s["m"], s["v"]

    def state_dict(self) -> Dict:
        masters, ms, vs = [], [], []
        for p, m, v in self._groups():
            masters.append(p)
            ms.append(m)
            vs.append(v)
        return {"step": self.step_count, "master": masters, "m": ms, "v": vs}

    def load_state_dict(self, sd: Dict) -> None:
        """Replace the step, the masters and the moments."""
        fields = [[_flat32(x) for x in sd[k]] for k in ("master", "m", "v")]
        for f in fields:
            if len(f) != self.num_groups or any(
                    t.numel() != self.numel(i) for i, t in enumerate(f)):
                raise ValueError(
                    "offload state does not match the model's leaves: "
                    f"{[t.numel() for t in f]} vs "
                    f"{[self.numel(i) for i in range(self.num_groups)]}")
        self.step_count = int(sd["step"])
        if self._swapper is None:
            self._master, self._m, self._v = fields
            return
        for i, (p, m, v) in enumerate(zip(*fields)):
            self._swapper.put(self._key(i), {"master": p, "m": m, "v": v})
        self._swapper.flush_writes()

    def save(self, path: str) -> None:
        """The step and every leaf's master and moments as one npz, the
        JAX package's keys, written atomically (a kill mid-save leaves no
        torn file).  Synchronous: the next step updates these buffers in
        place."""
        arrays = {"step": np.asarray(self.step_count)}
        for i, (p, m, v) in enumerate(self._groups()):
            arrays[f"master_{i}"] = p.numpy()
            arrays[f"m_{i}"] = m.numpy()
            arrays[f"v_{i}"] = v.numpy()
        atomic_write_npz(path, arrays)

    def load(self, path: str) -> None:
        """Read a ``save``d npz (of either package) leaf by leaf: one
        leaf's state in transit at a time."""
        with np.load(path) as z:
            names = set(z.files)
            want = {f"{k}_{i}" for k in ("master", "m", "v")
                    for i in range(self.num_groups)} | {"step"}
            if not want <= names:
                raise KeyError(f"{path} lacks {sorted(want - names)[:6]}")
            for i in range(self.num_groups):
                p, m, v = (torch.from_numpy(np.ascontiguousarray(
                    z[f"{k}_{i}"], np.float32).reshape(-1))
                    for k in ("master", "m", "v"))
                if p.numel() != self.numel(i):
                    raise ValueError(f"{path}: leaf {i} has {p.numel()} "
                                     f"elements, the model {self.numel(i)}")
                if self._swapper is None:
                    self._master[i].copy_(p)
                    self._m[i].copy_(m)
                    self._v[i].copy_(v)
                else:
                    self._swapper.put(self._key(i),
                                      {"master": p, "m": m, "v": v})
                    self._swapper.flush_writes()
            self.step_count = int(z["step"])

    def set_masters(self, leaves: Sequence) -> None:
        """Overwrite the fp32 masters only, keeping the moments and the
        step count: a weight swap (``load_module_state_dict``) does not
        restart the optimizer's trajectory."""
        if len(leaves) != self.num_groups:
            raise ValueError(f"{len(leaves)} leaves for {self.num_groups}")
        for i, leaf in enumerate(leaves):
            f = _flat32(leaf, copy=self._swapper is not None)
            if f.numel() != self.numel(i):
                raise ValueError(f"leaf {i} has {f.numel()} elements, the "
                                 f"master {self.numel(i)}")
            if self._swapper is None:
                self._master[i].copy_(f)
            else:
                s = self._swapper.get(self._key(i))
                self._swapper.put(self._key(i), {
                    "master": f, "m": s["m"], "v": s["v"]})
                self._swapper.flush_writes()

    def master(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s fp32 master, flat (read in for nvme)."""
        if self._swapper is None:
            return self._master[i]
        return self._swapper.get(self._key(i))["master"]

    def masters(self) -> List[torch.Tensor]:
        """The fp32 master leaves in their shapes (read in for nvme)."""
        return [self.master(i).view(s) for i, s in enumerate(self._shapes)]

    def close(self) -> None:
        if self._swapper is not None:
            self._swapper.close()
            self._swapper = None
