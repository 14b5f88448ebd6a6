"""Builder of the host SIMD Adam (JAX ``ops/op_builder/cpu_adam.py``,
reference ``op_builder/cpu_adam.py``): ``csrc/adam/cpu_adam.cpp``."""

from __future__ import annotations

import ctypes

from .builder import OpBuilder

_vp, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
#: (p, g, m, v, n, lr, beta1, beta2, eps, wd, adamw, bc1, bc2, nthreads)
_ADAM_ARGS = [_vp, _vp, _vp, _vp, ctypes.c_int64, _f, _f, _f, _f, _f, _i,
              _f, _f, _i]


class CPUAdamBuilder(OpBuilder):
    NAME = "cpu_adam"

    def sources(self):
        return ["adam/cpu_adam.cpp"]

    def _bind(self, lib: ctypes.CDLL) -> None:
        lib.ds_adam_step.argtypes = _ADAM_ARGS
        lib.ds_adam_step.restype = None
        # the bf16 copy-out follows v
        lib.ds_adam_step_copy.argtypes = _ADAM_ARGS[:4] + [_vp] + \
            _ADAM_ARGS[4:]
        lib.ds_adam_step_copy.restype = None
        lib.ds_adam_simd_width.argtypes = []
        lib.ds_adam_simd_width.restype = ctypes.c_int
