#!/usr/bin/env python3
"""Run the port's training phase and its preemptible run alone, on one card.

    python3 scripts/torch_preemptible_run.py [--out FILE]

Builds the kernels as ``chip_smoke.py`` does, runs its phase 6 (GPT-2 350M training steps, the step time the
preemptible run's steps compare with) and its phase 6b
(``run_preemptible``: the straight runs, the watchdog, the SIGTERM drain
and fallback resume, the NaN rollback, the recovery tag's reload, the
step with telemetry off and on), each with its own gates, and writes both
phases' results as JSON to ``--out`` (default
``chiprun_out/preemptible.json``).  Its log lines are ``chip_smoke.py``'s,
beside the card's name and power limit.  A few minutes of the card,
against the whole smoke's thirteen."""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "preemptible.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(smi)
    cs.log(f"[build] {cs.build.build_all():.1f} s")
    res, _, trainer, _ = cs.run_training()
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, _ = cs.run_preemptible(smi)
    cs.log(f"[time] phase 6b {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "training": res, "preemptible": out}, f,
                  indent=1, default=str)


if __name__ == "__main__":
    main()
