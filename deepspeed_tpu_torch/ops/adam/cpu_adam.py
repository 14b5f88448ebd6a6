"""Adam on the host, over the native SIMD extension.

The port of the JAX package's ``ops/adam/cpu_adam.py`` (the counterpart
of the reference's ``DeepSpeedCPUAdam``, backed by
``csrc/adam/cpu_adam.cpp``): ZeRO-Offload keeps the fp32 master and the
Adam moments in host memory and steps them on the CPU.  The buffers are
torch CPU tensors handed to the C kernel by ``data_ptr``; the kernel
updates them in place, across every core (``std::thread``), and with
``bf16_out`` also writes the updated params rounded to bf16 (round to
nearest even), which is what the device uploads.  The source and the
flags are the JAX package's, so the bits are too.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..op_builder.cpu_adam import CPUAdamBuilder


def _check(name: str, t: torch.Tensor, n: int, dtypes) -> None:
    if t.device.type != "cpu" or t.dtype not in dtypes or \
            not t.is_contiguous() or t.numel() != n:
        raise ValueError(
            f"cpu_adam_step: {name} must be a contiguous CPU tensor of "
            f"{n} elements in {dtypes}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous {t.is_contiguous()})")


def cpu_adam_step(lib, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, step: int, lr: float, beta1: float,
                  beta2: float, eps: float, weight_decay: float,
                  adamw_mode: bool = True, bias_correction: bool = True,
                  bf16_out: Optional[torch.Tensor] = None,
                  num_threads: int = 0) -> None:
    """One Adam step in place over flat fp32 CPU buffers ``p`` (params),
    ``g``, ``m``, ``v``; with ``bf16_out`` (bf16 or int16, the same
    length) the updated params' bf16 bits too.  ``step`` counts from 1."""
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check(name, t, n, (torch.float32,))
    bc1 = 1.0 - beta1 ** step if bias_correction else 1.0
    bc2 = 1.0 - beta2 ** step if bias_correction else 1.0
    args = (n, lr, beta1, beta2, eps, weight_decay, int(adamw_mode), bc1,
            bc2, num_threads)
    ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
    if bf16_out is None:
        lib.ds_adam_step(*ptrs, *args)
    else:
        _check("bf16_out", bf16_out, n, (torch.bfloat16, torch.int16))
        lib.ds_adam_step_copy(*ptrs, bf16_out.data_ptr(), *args)


class DeepSpeedCPUAdam:
    """Stateful fp32 Adam over flat CPU tensors, one state per group id."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True, num_threads: int = 0):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.num_threads = num_threads
        self._lib = CPUAdamBuilder().load()
        self._m: Dict[int, torch.Tensor] = {}
        self._v: Dict[int, torch.Tensor] = {}
        self._steps: Dict[int, int] = {}

    @property
    def simd_width(self) -> int:
        return int(self._lib.ds_adam_simd_width())

    def _state_for(self, group_id: int, n: int):
        if group_id not in self._m:
            self._m[group_id] = torch.zeros(n, dtype=torch.float32)
            self._v[group_id] = torch.zeros(n, dtype=torch.float32)
            self._steps[group_id] = 0
        if self._m[group_id].numel() != n:
            # the C kernel writes n elements into these buffers
            raise ValueError(
                f"param group {group_id} was registered with "
                f"{self._m[group_id].numel()} elements, got {n}")
        return self._m[group_id], self._v[group_id]

    def _step(self, group_id, params, grads, lr, bf16_out=None) -> None:
        grads = grads.to(torch.float32).contiguous()
        m, v = self._state_for(group_id, params.numel())
        self._steps[group_id] += 1
        cpu_adam_step(self._lib, params, grads, m, v, self._steps[group_id],
                      self.lr if lr is None else lr, self.beta1, self.beta2,
                      self.eps, self.weight_decay, self.adamw_mode,
                      self.bias_correction, bf16_out=bf16_out,
                      num_threads=self.num_threads)

    def step(self, group_id: int, params: torch.Tensor, grads: torch.Tensor,
             lr: Optional[float] = None) -> None:
        """In-place Adam on flat fp32 ``params`` given ``grads``."""
        self._step(group_id, params, grads, lr)

    def step_with_copy(self, group_id: int, params: torch.Tensor,
                       grads: torch.Tensor, lr: Optional[float] = None
                       ) -> torch.Tensor:
        """The step and the updated params in bf16, fused."""
        out = torch.empty(params.numel(), dtype=torch.bfloat16)
        self._step(group_id, params, grads, lr, bf16_out=out)
        return out

    def state_dict(self) -> Dict:
        return {"m": self._m, "v": self._v, "steps": self._steps,
                "lr": self.lr}

    def load_state_dict(self, sd: Dict) -> None:
        self._m = {k: torch.as_tensor(x, dtype=torch.float32)
                   for k, x in sd["m"].items()}
        self._v = {k: torch.as_tensor(x, dtype=torch.float32)
                   for k, x in sd["v"].items()}
        self._steps = dict(sd["steps"])
        if "lr" in sd:
            self.lr = float(sd["lr"])
