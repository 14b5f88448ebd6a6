#!/usr/bin/env python3
"""Time the port's full-width training steps of several checkouts on one
card, in turns.

    python3 scripts/torch_train_ab.py ROOT [ROOT ...] [--only TEXT] [--out FILE]

Each root is a checkout of the repository (``git archive`` of a commit
unpacked into a directory); each turn runs in a process of its own that
imports ``deepspeed_tpu_torch`` from that root, builds its kernels there
and, for each cell, calls ``initialize`` → ``train_batch_fused`` at
``chip_smoke.py``'s training setup (random weights from a seed, bf16,
remat ``attn_out``, Adam lr 1e-4 wd 0.01, ZeRO 1, gas 1), one batch of
tokens made from a seed:

- GPT-2 350M at seq 1024, micro-batch 16;
- GPT-2 760M at seq 1024, micro-batch 16;
- GPT-2 2.7B at seq 1024, micro-batch 8;
- GPT-Neo 1.3B at seq 2048, micro-batch 8.

Per cell it records 2 warm-up and 10 timed steps (host clock around a
synchronised step: p50 and mean ms), the peak of
``torch.cuda.max_memory_allocated`` from before ``initialize``, the losses
(finite and falling, or the turn fails), and the time of the root's
``global_grad_norm`` on the engine's flat gradient buffer alone (CUDA
events, mean of 10).  ``--only`` keeps the cells whose name contains TEXT.
The turns go over the roots and back (old, new, new, old for two), so a
drift of the card over the call shows as a difference between the two
turns of one root.  Prints the card's name and power limit, then one line
per cell and metric with each root's two values and the ratio of their
sum to the first root's, and writes them as JSON to ``--out`` (default
``build/train_ab.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

CELLS = (("GPT-2 350M", "GPT2_350M", 1024, 16),
         ("GPT-2 760M", "GPT2_760M", 1024, 16),
         ("GPT-2 2.7B", "GPT2_2_7B", 1024, 8),
         ("GPT-Neo 1.3B", None, 2048, 8))
WARMUP, STEPS = 2, 10
CONFIG = {"gradient_accumulation_steps": 1, "steps_per_print": 1 << 30,
          "optimizer": {"type": "Adam",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "zero_optimization": {"stage": 1}, "bf16": {"enabled": True}}


def _worker(root: str, only: str) -> dict:
    """Run every cell whose name contains ``only`` with the package of
    ``root``; returns {cell: {metric: value}}."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.model import from_gpt
    from deepspeed_tpu_torch.runtime.utils import global_grad_norm

    kernels.build.build_all()
    neo = gpt.GPTConfig(
        vocab_size=50257, max_seq_len=2048, n_layer=24, n_head=16,
        d_model=2048, d_ff=8192, attn_softmax_scale=1.0,
        local_attention_window=256, local_attention_alternating=True)
    res = {}
    for name, preset, seq, micro in CELLS:
        if only not in name:
            continue
        base = neo if preset is None else getattr(gpt, preset)
        cfg = dataclasses.replace(base, max_seq_len=seq, dtype=torch.bfloat16,
                                  remat=True, remat_policy="attn_out")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=from_gpt(cfg),
            config={**CONFIG, "train_micro_batch_size_per_gpu": micro},
            generator=torch.Generator(device="cuda").manual_seed(2024))
        batch = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, (micro, seq + 1))}
        losses, times = [], []
        for i in range(WARMUP + STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch_fused(batch)))
            torch.cuda.synchronize()
            if i >= WARMUP:
                times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: losses not finite and falling: "
                                 f"{losses}")
        flat = engine._flat["grad_acc"]
        global_grad_norm(flat)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            global_grad_norm(flat)
        end.record()
        torch.cuda.synchronize()
        times.sort()
        res[name] = {"step_ms_p50": 1e3 * times[len(times) // 2],
                     "step_ms_mean": 1e3 * sum(times) / len(times),
                     "peak_gib": peak,
                     "norm_ms": start.elapsed_time(end) / 10,
                     "norm_elements": flat.numel(),
                     "loss_first": losses[0], "loss_last": losses[-1]}
        del engine, flat
        gc.collect()
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=os.path.join("build", "train_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.worker, args.only)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = list(range(len(args.roots)))
    turns = []
    for r in order + order[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.roots[0], "--only", args.only,
                              "--worker", args.roots[r]],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        turns.append((args.roots[r],
                      json.loads(out.stdout.strip().splitlines()[-1])))
        print(f"[train ab] turn {len(turns)} ({args.roots[r]}) done",
              flush=True)
    for cell, metrics in turns[0][1].items():
        for metric in ("step_ms_p50", "step_ms_mean", "peak_gib", "norm_ms"):
            vals = {root: [t[cell][metric] for rr, t in turns if rr == root]
                    for root in args.roots}
            base = sum(vals[args.roots[0]])
            print(f"[train ab] {cell} {metric}: " + ", ".join(
                f"{root} {v[0]:.4f} / {v[1]:.4f} ({sum(v) / base:.4f})"
                for root, v in vals.items()))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "roots": args.roots, "turns": turns},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
