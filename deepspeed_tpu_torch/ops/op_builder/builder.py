"""Build the host extensions with ``g++`` and load them with ctypes.

The port of the JAX package's ``ops/op_builder/builder.py`` (the
counterpart of the reference's ``op_builder/builder.py``: ``OpBuilder``
:106, ``cpu_arch`` :336, ``simd_width`` :385).  ZeRO-Offload steps its
optimizer on the host: the SIMD Adam (``csrc/adam/cpu_adam.cpp``) and the
async file I/O engine of the NVMe path (``csrc/aio/ds_aio.cpp``) are
plain C++ with a C interface.  Their sources are the repository's
``csrc/`` (shared with the JAX package and read only); each becomes one
shared library in ``build/torch_host/`` at the repository root.

A library's file name carries a hash of its sources, the headers of
``csrc/includes``, the flags and the host's ISA, so an edited source is
rebuilt and a library built for another CPU is never loaded.  It is
compiled under a name of its own process and renamed into place, so
builders racing on one cache (test workers) never load a half-written
file.  The flags are the JAX package's, and so are the bits the Adam
computes.  If the compiler refuses ``-march=native``, the build is
retried without it; a build that still fails raises with the compiler's
stderr.  Nothing falls back to a Python optimizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = REPO_ROOT / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "torch_host"
#: the JAX package's flags (its builder.py:100-102)
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-g"]
NATIVE_FLAGS = ["-march=native", "-mfma"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def cpu_arch() -> str:
    """The host's ISA family (reference ``cpu_arch`` :336)."""
    m = platform.machine().lower()
    if m in ("x86_64", "amd64"):
        return "x86_64"
    if m in ("aarch64", "arm64"):
        return "aarch64"
    return m


def simd_width() -> int:
    """Float lanes of the widest SIMD the host advertises (reference
    ``simd_width`` :385)."""
    if cpu_arch() != "x86_64":
        return 4 if cpu_arch() == "aarch64" else 1
    try:
        flags = Path("/proc/cpuinfo").read_text()
    except OSError:
        return 1
    if "avx512f" in flags:
        return 16
    if "avx2" in flags or "avx" in flags:
        return 8
    return 4


class OpBuilder:
    """One host extension: its sources, flags and C signatures."""

    NAME = "base"

    def sources(self) -> List[str]:
        """Paths relative to the repository's ``csrc/``."""
        raise NotImplementedError

    def cxx_args(self) -> List[str]:
        return CXX_FLAGS + (NATIVE_FLAGS if cpu_arch() == "x86_64" else [])

    def compiler(self) -> str:
        for cc in (os.environ.get("CXX"), "g++", "clang++"):
            if cc and shutil.which(cc):
                return cc
        raise RuntimeError(f"op {self.NAME}: no C++ compiler (g++, "
                           "clang++ or $CXX) to build it with")

    def _build_key(self) -> str:
        h = hashlib.sha256()
        for s in self.sources():
            h.update((CSRC / s).read_bytes())
        for f in sorted((CSRC / "includes").glob("*.h")):
            h.update(f.read_bytes())
        h.update(" ".join(self.cxx_args()).encode())
        h.update(f"{cpu_arch()}:simd{simd_width()}".encode())
        return h.hexdigest()[:16]

    def lib_path(self) -> Path:
        return BUILD_DIR / f"lib_{self.NAME}_{self._build_key()}.so"

    def build(self) -> Path:
        """Compile the library unless it is built; returns its path."""
        out = self.lib_path()
        if out.exists():
            return out
        cc = self.compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(
            f".building.{os.getpid()}.{threading.get_ident()}.so")
        srcs = [str(CSRC / s) for s in self.sources()]

        def compile_with(args: List[str]) -> subprocess.CompletedProcess:
            return subprocess.run(
                [cc, *args, f"-I{CSRC / 'includes'}", *srcs, "-o", str(tmp),
                 "-lpthread"], capture_output=True, text=True)

        args = self.cxx_args()
        res = compile_with(args)
        if res.returncode != 0 and args != CXX_FLAGS:
            # -march=native can fail on an unusual host: build portable
            res = compile_with(CXX_FLAGS)
        if res.returncode != 0:
            raise RuntimeError(f"building op {self.NAME} failed "
                               f"(rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """Build if needed and load the library, once per process."""
        with _lock:
            if self.NAME not in _loaded:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                _loaded[self.NAME] = lib
            return _loaded[self.NAME]

    def _bind(self, lib: ctypes.CDLL) -> None:
        """Declare argtypes and restype of the library's entry points."""
        raise NotImplementedError
