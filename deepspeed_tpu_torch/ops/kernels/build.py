"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` becomes one shared library
with a plain C interface, compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``build/torch_kernels/``
at the repository root.  A library's file name carries a hash of its
source and of every ``csrc/*.cuh`` header, so an edited source is rebuilt
and an unchanged one is loaded as it is.  All sources that need building
are compiled at once, one ``nvcc`` process each.  A failed build raises
with nvcc's stderr; nothing falls back to the plain versions.

The libraries are built at first use (the first kernel launch), or ahead
of it by :func:`build_all`.  Building needs the CUDA toolkit; importing
this module does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas register/shared-memory report of each library built by this
#: process, by source name
ptxas_reports: Dict[str, str] = {}
#: seconds from the start of the concurrent build to the end of each
#: source's nvcc, by source name
build_seconds: Dict[str, float] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def _build(names: List[str]) -> None:
    """Compile every library in ``names`` concurrently."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, outputs = {}, {}

    def wait(name, proc):
        # drains the pipes (ptxas's report can outgrow them) and times
        # this source alone
        outputs[name] = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0

    for name in names:
        out = BUILD_DIR / f"{name}.{_digest(name)}.so"
        tmp = BUILD_DIR / f"{name}.{_digest(name)}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs[name] = (proc, tmp, out,
                       threading.Thread(target=wait, args=(name, proc)))
        procs[name][3].start()
    failures = []
    for name, (proc, tmp, out, waiter) in procs.items():
        waiter.join()
        stdout, stderr = outputs[name]
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n"
                            f"{stdout}{stderr}")
            continue
        ptxas_reports[name] = stderr
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds every stale
    library first."""
    with _lock:
        if name not in _libs:
            _load_all()
        return _libs[name]


def _load_all() -> None:
    names = sources()
    stale = [n for n in names
             if not (BUILD_DIR / f"{n}.{_digest(n)}.so").exists()]
    if stale:
        _build(stale)
    for n in names:
        if n not in _libs:
            _libs[n] = ctypes.CDLL(str(BUILD_DIR / f"{n}.{_digest(n)}.so"))


def function(name: str, argtypes: list, symbol: str = None
             ) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` (default ``name``) of
    ``csrc/<name>.cu`` with its argument types declared; it returns a
    ``cudaError_t`` as an int."""
    fn = getattr(load(name), symbol or name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        err = load(name).ds_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: kernel launch failed: cudaError "
                           f"{status} ({err(status).decode()})")


def build_all() -> float:
    """Build (if stale) and load every kernel library; returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        _load_all()
    return time.perf_counter() - t0
