#!/usr/bin/env python3
"""Registers and local-memory traffic of each warp-specialised region of
the port's tensor-core kernels, from the machine code.

    python3 scripts/sass_regions.py [SOURCE.cu ...] [--kernel TEXT] [--out FILE]

Compiles each source (default ``deepspeed_tpu_torch/csrc/flash_bwd_fused.cu``)
to a cubin with the build's ``nvcc`` flags (``ops/kernels/build.py``), the
directory of the source first on the include path, then reads the SASS
(``cuobjdump -sass``).  ``ptxas -v`` reports one register count for a
kernel, the launch's; a kernel whose warpgroups move registers with
``setmaxnreg`` runs its regions at other counts.  For every kernel whose
name contains TEXT (default ``flash_bwd_fused_tc``) this prints, for the
code before the first ``USETMAXREG``, the code from the register
allocation (``USETMAXREG.TRY_ALLOC``, the consumers) and the code from the
release (``USETMAXREG.DEALLOC``, the producer) to the next region, the
highest register the region names and its count of local stores and loads
(``STL``, ``LDL``: spills), beside ptxas's spill stores for the kernel and
its ``setmaxnreg`` warnings (C7507-C7509).  Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from deepspeed_tpu_torch.ops.kernels import build  # noqa: E402


def _stats(lines):
    regs = [int(r) for line in lines for r in re.findall(r"\bR(\d+)\b", line)]
    return {"max_register": max(regs, default=-1),
            "stl": sum(" STL" in line for line in lines),
            "ldl": sum(" LDL" in line for line in lines)}


def regions(sass_function: str) -> dict:
    """{region: stats} of one kernel's SASS: ``entry`` up to the first
    USETMAXREG, ``alloc`` and ``dealloc`` from each to the next one."""
    lines = sass_function.split("\n")
    marks = sorted((i, "alloc" if "TRY_ALLOC" in line else "dealloc")
                   for i, line in enumerate(lines) if "USETMAXREG" in line)
    out = {"entry": _stats(lines[:marks[0][0] if marks else len(lines)])}
    for k, (start, name) in enumerate(marks):
        end = marks[k + 1][0] if k + 1 < len(marks) else len(lines)
        out[name] = _stats(lines[start:end])
    return out


def analyse(source: str, kernel: str) -> dict:
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        r = subprocess.run([build._nvcc(), *flags, "-cubin", "-I",
                            os.path.dirname(os.path.abspath(source)), "-I",
                            str(build.CSRC), "-o", cubin, source],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {source}:\n{r.stderr[-4000:]}")
        sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    report = r.stderr
    spills = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function properties for (\S+)\n\s+\d+ bytes stack frame, (\d+) bytes spill stores",
        report)}
    warnings = [line.strip() for line in report.splitlines()
                if re.search(r"setmaxnreg|C750[789]", line)]
    out = {"warnings": warnings, "kernels": {}}
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            out["kernels"][name] = {"spill_stores": spills.get(name),
                                    "regions": regions(fn)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*",
                    default=[str(build.CSRC / "flash_bwd_fused.cu")])
    ap.add_argument("--kernel", default="flash_bwd_fused_tc")
    ap.add_argument("--out", default=os.path.join("build", "sass_regions.json"))
    args = ap.parse_args()
    result = {}
    for source in args.sources:
        res = analyse(source, args.kernel)
        result[source] = res
        print(f"[sass regions] {source}: setmaxnreg warnings {len(res['warnings'])}")
        for name, k in res["kernels"].items():
            short = re.sub(r"^_Z.*?(" + re.escape(args.kernel) + r")", r"\1", name)
            print(f"[sass regions]   {short}: ptxas spill stores {k['spill_stores']}; "
                  + "; ".join(f"{region} max R{s['max_register']}, STL {s['stl']}, LDL {s['ldl']}"
                              for region, s in k["regions"].items()))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
