#!/usr/bin/env python3
"""Time the port's kernels of several checkouts on one card, in turns.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...] [--only TEXT[,TEXT...]] [--out FILE]

Each root is a checkout of the repository (``git archive`` of a commit
unpacked into a directory); each turn runs in a process of its own that
imports ``deepspeed_tpu_torch`` from that root, builds its kernels there
and times, as a CUDA graph of N launches between CUDA events, bf16
inputs made from one seed:

- ``flash_fwd`` at B4 S512, B16 S1024 and B4 S4096 causal, and at B64
  S128 non-causal with ragged ``kv_lens``;
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` at B16 S1024 and B4 S4096
  causal, and at B64 S128 with ``kv_lens``;
- ``flash_bwd_fused`` at ``chip_smoke.py``'s ``FUSED_BWD_SHAPES`` (B16
  S1024 H16 D64 causal, B8 S2048 H16 D128 causal and with a window of 256,
  B4 S4096 H16 D64 causal, B64 S128 H16 D64 with ragged ``kv_lens``) and
  at GPT-2 760M's and 2.7B's training shapes (B16 S1024 H16 D96, B8 S1024
  H32 D80, causal);
- ``block_sparse_fwd``, ``block_sparse_bwd_dq`` and
  ``block_sparse_bwd_dkv`` at B4 S4096 H16 D64 causal under the Fixed
  layout at block 64 (the sparse training slice's);
- ``nhwc_bias_add`` at SD-1.5's four shapes ([1,64,64,320], [1,8,8,1280],
  [1,512,512,128], [1,64,64,4] bf16), and beside it ``x + b``, the
  PyTorch call it is held to (the same in every root: a yardstick timed
  in the same call);
- ``decode_attn`` and ``decode_attn_int8`` at B8 S_max 1024 H16 D64 with
  ragged positions (``chip_smoke.check_decode``'s), every row full, and
  every row at pos 0, and at B1 full, rotating over enough cache layers
  to stay out of L2;
- ``quantizer`` at GPT-2 350M's four int8 leaves in bf16, and the int8
  cache's per-layer write at the decode step (K and V of [8, 1, 16, 64]
  from the qkv view into an 8-slot layer, ragged positions): one
  ``quantize_kv_into`` where the root has it, else what its
  ``gpt_inference`` did (``quantize_kv`` of K and of V, then four indexed
  writes);
- ``int8 generate``: the device kernels a decode step launches in GPT-2
  350M's int8 ``generate`` (int8 weights and cache, random weights from a
  seed; 4 ragged prompts of up to 512 tokens), counted by
  ``torch.profiler`` as the kernels of a 16-token run less those of a
  1-token run, over 15 (a count, not a time).

``--only`` keeps the cases whose name contains TEXT (a kernel's name or a
part of it), or any of several comma-separated TEXTs.  The turns go over
the roots and back (old, new, new, old for two), so a drift of the card
over the call shows as a difference between the two turns of one root.
Prints the card's name and power limit, then one line per kernel and
shape with each root's two times and the ratio of their sum to the first
root's, and writes them as JSON to ``--out`` (default
``build/kernel_ab.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

H, D = 16, 64


def _worker(root: str, only: str) -> dict:
    """Time every case with the package of ``root`` whose name contains
    ``only``; returns {case: ms}."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        aligned_do_and_delta
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    kernels.build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def time_ms(fn, n):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(n):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def sets(B, S, count):
        """``count`` sets of (q, k, v, dO), q/k/v views of [B, S, 3, H, D]."""
        out = []
        for _ in range(count):
            qkv = torch.randn((B, S, 3, H, D), generator=gen, device="cuda"
                              ).to(torch.bfloat16)
            do = torch.randn((B, S, H, D), generator=gen, device="cuda"
                             ).to(torch.bfloat16)
            out.append((qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do))
        return out

    scale = 1.0 / D ** 0.5
    res = {}

    def wanted(case):
        return any(part in case for part in only.split(","))

    def timed(case, fn, n):
        if wanted(case):
            res[case] = time_ms(fn, n)

    flash_shapes = ((4, 512, True, False), (16, 1024, True, False),
                    (4, 4096, True, False), (64, 128, False, True))
    flash_cases = [f"{k} B{B} S{S} {'causal' if c else 'kv_lens'}"
                   for B, S, c, _ in flash_shapes
                   for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    for B, S, causal, ragged in flash_shapes:
        if not any(wanted(c) for c in flash_cases):
            break
        data = sets(B, S, max(1, min(8, (120 << 20) // (4 * B * S * H * D * 2))))
        lens = (torch.from_numpy(np.random.default_rng(1).integers(
            1, S + 1, B).astype(np.int32)).cuda() if ragged else None)
        n = len(data)
        kw = {"kv_lens": lens} if ragged else {}
        tag = f"B{B} S{S} {'causal' if causal else 'kv_lens'}"
        timed(f"flash_fwd {tag}", lambda i: kernels.flash_fwd(
            *data[i % n][:3], causal, scale, **kw), 20)
        if S == 512:
            continue
        stats = []
        for q, k, v, do in data:
            o, lse = kernels.flash_fwd(q, k, v, causal, scale, **kw)
            stats.append((lse, aligned_do_and_delta(do, o)[1]))
        timed(f"flash_bwd_dq {tag}", lambda i: kernels.flash_bwd_dq(
            *data[i % n], *stats[i % n], causal, scale, **kw), 10)
        timed(f"flash_bwd_dkv {tag}", lambda i: kernels.flash_bwd_dkv(
            *data[i % n], *stats[i % n], causal, scale, **kw), 10)

    fused_shapes = ((16, 1024, 16, 64, True, None, False),
                    (8, 2048, 16, 128, True, None, False),
                    (8, 2048, 16, 128, True, 256, False),
                    (4, 4096, 16, 64, True, None, False),
                    (64, 128, 16, 64, False, None, True),
                    (16, 1024, 16, 96, True, None, False),
                    (8, 1024, 32, 80, True, None, False))
    for B, S, Hf, Df, causal, window, ragged in fused_shapes:
        case = (f"flash_bwd_fused B{B} S{S} H{Hf} D{Df} "
                + ("causal" if causal else "kv_lens")
                + (f" window {window}" if window else ""))
        if not wanted(case):
            continue
        count = max(2, min(8, (120 << 20) // (4 * B * S * Hf * Df * 2)))
        lens = (torch.from_numpy(np.random.default_rng(1).integers(
            1, S + 1, B).astype(np.int32)).cuda() if ragged else None)
        sc = 1.0 / Df ** 0.5
        data = []
        for _ in range(count):
            qkv = torch.randn((B, S, 3, Hf, Df), generator=gen, device="cuda"
                              ).to(torch.bfloat16)
            do = torch.randn((B, S, Hf, Df), generator=gen, device="cuda"
                             ).to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            o, lse = kernels.flash_fwd(q, k, v, causal, sc, lens, window)
            data.append((q, k, v, do, lse, aligned_do_and_delta(do, o)[1]))
        timed(case, lambda i: kernels.flash_bwd_fused(
            *data[i % count], causal, sc, kv_lens=lens, window=window), 10)
        del data

    tag = "B4 S4096 causal, Fixed block 64"
    sparse_cases = [f"{k} {tag}" for k in ("block_sparse_fwd",
                                           "block_sparse_bwd_dq",
                                           "block_sparse_bwd_dkv")]
    if any(wanted(c) for c in sparse_cases):
        cfg = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1,
                                  attention="unidirectional",
                                  different_layout_per_head=True,
                                  num_different_global_patterns=4)
        plan = kernels.sparse_plan(cfg.make_layout(4096), 64, True, "cuda")
        data = sets(4, 4096, 4)
        stats = []
        for q, k, v, do in data:
            o, lse = kernels.block_sparse_fwd(q, k, v, plan, scale)
            stats.append((lse, aligned_do_and_delta(do, o)[1]))
        timed(sparse_cases[0], lambda i: kernels.block_sparse_fwd(
            *data[i % 4][:3], plan, scale), 20)
        timed(sparse_cases[1], lambda i: kernels.block_sparse_bwd_dq(
            *data[i % 4], *stats[i % 4], plan, scale), 10)
        timed(sparse_cases[2], lambda i: kernels.block_sparse_bwd_dkv(
            *data[i % 4], *stats[i % 4], plan, scale), 10)
        del data, stats

    SMAX = 1024
    for B, kinds in ((8, ("ragged", "full", "zero")), (1, ("full",))):
        decode_cases = [f"{k} B{B} S_max {SMAX} {kind}"
                        for k in ("decode_attn", "decode_attn_int8")
                        for kind in kinds]
        if not any(wanted(c) for c in decode_cases):
            continue
        L = max(2, (200 << 20) // (2 * B * SMAX * H * D * 2))
        ck, cv = (torch.randn((L, B, SMAX, H, D), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        int8 = []
        for c in (ck, cv):
            codes, scl = kernels.quantize_kv(c.view(-1, SMAX, H, D))
            int8 += [codes.view(c.shape), scl.view(L, B, SMAX, H, 1)]
        q = torch.randn((B, 1, 3, H, D), generator=gen, device="cuda"
                        ).to(torch.bfloat16)[:, :, 0]
        for kind in kinds:
            host = {"ragged": np.random.default_rng(3).integers(0, SMAX, B),
                    "full": np.full(B, SMAX - 1), "zero": np.zeros(B)}[kind]
            pos = torch.as_tensor(host.astype(np.int32)).cuda()
            timed(f"decode_attn B{B} S_max {SMAX} {kind}",
                  lambda i: kernels.decode_attn(q, ck[i % L], cv[i % L], pos,
                                                scale), 50)
            timed(f"decode_attn_int8 B{B} S_max {SMAX} {kind}",
                  lambda i: kernels.decode_attn_int8(
                      q, int8[0][i % L], int8[2][i % L], pos, scale,
                      int8[1][i % L], int8[3][i % L]), 50)
        del ck, cv, int8
    B = 8

    leaves = (("wqkv", 24 * 1024 * 3 * 16, 64), ("wo", 24 * 16 * 64, 1024),
              ("wi", 24 * 1024, 4096), ("wo_mlp", 24 * 4096, 1024))
    for name, rows, gsize in leaves:
        case = f"quantizer {name} [{rows}, {gsize}] bf16"
        if wanted(case):
            x = (torch.randn((rows, gsize), generator=gen, device="cuda")
                 * 0.02).to(torch.bfloat16)
            timed(case, lambda i: kernels.quantize_rows(x, 8, True,
                                                        offsets=False), 10)
            del x

    case = "int8 kv write, decode step [8, 1, 16, 64] ragged"
    if wanted(case):
        qkv = torch.randn((B, 1, 3, H, D), generator=gen, device="cuda"
                          ).to(torch.bfloat16)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        layer = [torch.zeros((B, SMAX, H, D), dtype=torch.int8,
                             device="cuda") for _ in range(2)]
        layer += [torch.zeros((B, SMAX, H, 1), device="cuda")
                  for _ in range(2)]
        pos = torch.as_tensor(np.random.default_rng(3).integers(
            0, SMAX, B).astype(np.int32)).cuda()
        into = getattr(kernels, "quantize_kv_into", None)
        if into is not None:
            timed(case, lambda i: into(k, v, layer, pos), 50)
        else:
            rows_ = torch.arange(B, device="cuda")
            slots = pos.long()

            def old_write(i):
                for val, buf, sbuf in ((k, layer[0], layer[2]),
                                       (v, layer[1], layer[3])):
                    codes, scl = kernels.quantize_kv(val)
                    buf[rows_, slots] = codes[:, 0]
                    sbuf[rows_, slots] = scl[:, 0]
            timed(case, old_write, 50)

    case = "int8 generate: device kernels per decode step"
    if wanted(case):
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch.models import gpt
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        cfg = gpt.GPT2_350M
        params = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(1234),
                          device="cuda")
        engine = deepspeed_tpu_torch.init_inference(
            (cfg, params), {"dtype": "int8", "kv_cache_dtype": "int8"})
        toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (4, 512))
        lens = [512, 384, 200, 77]

        def kernels_of(n):
            engine.generate(toks, max_new_tokens=n, prompt_lens=lens).cpu()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.generate(toks, max_new_tokens=n, prompt_lens=lens).cpu()
            return sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)

        res[case] = (kernels_of(16) - kernels_of(1)) / 15
        del engine, params

    for shape in ((1, 64, 64, 320), (1, 8, 8, 1280), (1, 512, 512, 128),
                  (1, 64, 64, 4)):
        tag = f"{list(shape)} bf16"
        if not (wanted(f"nhwc_bias_add {tag}") or wanted(f"x + b {tag}")):
            continue
        count = max(1, min(8, (256 << 20) // (4 * math.prod(shape))))
        xs = [(torch.randn(shape, generator=gen, device="cuda"
                           ).to(torch.bfloat16),
               torch.randn(shape[-1], generator=gen, device="cuda"
                           ).to(torch.bfloat16)) for _ in range(count)]
        timed(f"nhwc_bias_add {tag}",
              lambda i: kernels.nhwc_bias_add(*xs[i % count]), 50)
        timed(f"x + b {tag}", lambda i: xs[i % count][0] + xs[i % count][1],
              50)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=os.path.join("build", "kernel_ab.json"))
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
        turns.append((args.roots[r], json.loads(out.stdout.strip().splitlines()[-1])))
        print(f"[ab] turn {len(turns)} ({args.roots[r]}) done", flush=True)
    for case in turns[0][1]:
        ms = {root: [t[case] for rr, t in turns if rr == root]
              for root in args.roots}
        base = sum(ms[args.roots[0]])
        print(f"[ab] {case}: " + ", ".join(
            f"{root} {v[0]:.4f} / {v[1]:.4f} ms ({sum(v) / base:.4f})"
            for root, v in ms.items()))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "roots": args.roots, "turns": turns},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
