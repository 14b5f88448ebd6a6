#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout; it never
imports JAX.  In order it

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   hand-written kernels (``deepspeed_tpu_torch/csrc``) from the checkout;
   reports each tensor-core instantiation (bf16, fp16; every head dim of
   ``KERNEL_HEAD_DIMS``, 32, 64, 80, 96 and 128; a D 80 or 96 one fails if
   it spills more than its kernel's D 128 one) of
   ``flash_fwd_tc``, ``flash_bwd_dq_tc``, ``flash_bwd_dkv_tc``,
   ``flash_bwd_fused_tc`` (failing if it spills at all, or if ptxas
   warns that one of its ``setmaxnreg`` was ignored),
   ``chunk_attn_tc`` (also over the int8 cache), ``block_sparse_fwd_tc``,
   ``block_sparse_bwd_dq_tc`` and ``block_sparse_bwd_dkv_tc`` with its
   registers and spill stores (``[ptxas]``, failing if a bf16 D64 one
   spills or a banded one spills more than its unbanded one) and its
   count of HGMMA (wgmma) and UTMALDG (TMA load) instructions from
   ``cuobjdump -sass`` (``[sass]``, failing where either is 0);
2. holds each kernel against its plain PyTorch version at the shapes its
   slice gives it, in bf16 (plain computed in fp32 from the same inputs),
   and times kernel, plain version, a one-call PyTorch yardstick the port
   never calls (``scaled_dot_product_attention`` with or without a mask,
   its backward, fused ``AdamW``) and the card's bound for the work; the
   flash forward at B4 S512, B1 S128 and the GPT step's B16 S1024, the
   backward pair at B16 S1024 and B1 S128 (two launches of each bitwise
   equal); ``flash_fwd``, ``flash_bwd_fused``, ``decode_attn(_int8)`` and
   ``chunk_attn(_int8)`` at GPT-2 760M's (D 96) and 2.7B's (D 80) shapes,
   the backward pair at B4 S4096 H16 D96 and B2 S4096 H32 D80 and the
   block-sparse trio at B4 S4096 H16 D96 and H32 D80 (Fixed, block 64),
   each timed in turns with its D 128 instantiation at the same B, S, H
   and failing above ``HEAD_DIM_RATIO`` of it, and the backward at D 80
   past Sk 4096 on the pair, one launch each (``check_head_dims``); the
   block-sparse trio at the sparse slice's shape (B4 S4096 H16 D64, Fixed
   layout, block 64; two launches of each bitwise equal) beside the dense
   flash trio at the same shape, with its bounds and SDPA's causal forward
   and backward there; the
   two fused-LAMB kernels over BERT-large's 335,902,592 parameters in its
   24 leaf segments (no library call computes LAMB); the flash trio at the
   BERT slice's shape (B64 S128 H16 D64, non-causal, ragged ``kv_lens``)
   beside SDPA with the key-padding mask; the quantizer at GPT-2 350M's
   four int8 leaves in bf16 and at the int8 decode step's one token of K
   (bitwise equal to its plain version; no library call),
   ``quantize_kv_append`` (a layer's K and V quantized into its int8
   cache slots, the whole cache bitwise equal to the plain version's) at
   the decode step, a ragged extend chunk and ``profile_generate``'s
   prefill, and the int8-cache ``decode_attn``/``chunk_attn`` at the
   bf16 rows' shapes (against the plain version on the dequantized cache,
   SDPA on the bf16 cache as yardstick; two launches of each of the four
   cache kernels bitwise equal); ``decode_attn(_int8)`` at the serving
   batch's ragged, full and pos-0 frontiers and for one request at S_max
   (``[ptxas]``/``[sass]`` lines for each decode instantiation: HMMA and
   UTMALDG counts); then sweeps every dtype
   and head dim the attention kernels take: every cache frontier of a
   small ragged batch (bf16 and int8 caches), the chunk at Sq 7, 63, 65
   and 129 with a single live k-tile, pos + Sq = S_max and ragged rows,
   odd, cross-length, no-key causal and tile-edge shapes (S 63, 64, 65,
   127, 129, 255, 257) for the flash forward and backward, every
   block-sparse block size at S 256 and at S 80 (block 16) and 96 (block
   32), which end inside a 64-wide tile, causal or not, with empty rows
   (one at a 64-tile edge), and five layout kinds, and key
   lengths 0, 1, a partial tile, 63, 64, 65 and S at S 128 and 129;
   sweeps the quantizer
   over input dtype x bits x mode x group size (bitwise) and checks its
   stochastic rounding in distribution; checks that a skipped Adam or
   LAMB step leaves its state bitwise unchanged; holds the three NHWC
   bias-add variants bitwise against their plain version at the diffusion
   path's shapes in bf16 and fp32 (and from unaligned rows at C = 3, from
   an unaligned bias, at C = 12 and at one row per SM), and
   the bias-GeLU forward and backward at [16384, 4096] (mask bitwise,
   values within ``BF16_REL_TOL`` in bf16 and 1e-5 in fp32, the backward
   bitwise repeatable); and the band and ALiBi options: ``flash_fwd``
   with window 256 at GPT-Neo 1.3B's prefill heads (B4 S2048 H16 D128;
   at most ``BAND_SKIP_RATIO`` of the causal kernel's time),
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` with window 256 at its training
   shape (B8 S2048 H16 D128; each at most ``BAND_SKIP_RATIO`` of its
   causal kernel's time there, two launches bitwise equal, SDPA's
   backward under the band as a float mask as yardstick),
   ``decode_attn(_int8)`` with window 256 at B8 S_max 2048 H16 D128, rows
   near S_max (at most ``BAND_SKIP_RATIO`` of the unbanded kernel's time)
   and with BLOOM-560m's slopes at B8 S_max 1024 H16 D64, and
   ``chunk_attn(_int8)`` with each option on a 128-token extend chunk
   (against SDPA with the option as an explicit float mask; two launches
   of each bitwise equal), then ``[option sweep]``: every window of
   ``SWEEP_WINDOWS`` at the tile-edge lengths and two Sq < Sk shapes for
   the flash forward and both backward kernels, slopes at 6 and 16
   heads, every dtype and head dim, bf16 and int8 caches; and the fused
   backward ``flash_bwd_fused`` at GPT-2 350M's step (B16 S1024 H16 D64),
   GPT-Neo 1.3B's global and local layers (B8 S2048 H16 D128, window 256),
   the dense comparison's B4 S4096 and BERT-large's B64 S128 ragged
   ``kv_lens`` (20 launches bitwise equal at GPT-2's and GPT-Neo's global
   shape, two elsewhere; the pair's dq + dkv and SDPA's backward timed
   beside it, with the ratios to SDPA's and to the bound; at most
   ``FUSED_BWD_RATIO`` of the pair's time at the first three), then
   ``[fused sweep]``: ``BWD_SWEEP``, the option sweep's windows, key
   lengths at Sk 300 and causal rows without keys, every dtype and head
   dim;
3. checks a tiny fp32 model end to end on the card against the same model
   on the host (plain kernels): equal greedy tokens, logits within 1e-3,
   and again with int8 weights and an int8 cache;
   and trains it 5 steps through ``initialize`` on both, dense GPT, GPT
   under a block-sparse layout, BERT MLM under LAMB and GPT-Neo's
   attention with a window of 40 at seq 97: losses within 1e-5
   relative, master params within 1e-4, and two card runs bitwise equal
   (the backward on the fused kernel, the pair never launched);
   and serves an SD-1.5-shaped tiny UNet and VAE in fp32 from diffusers
   state dicts, a guided 2-step DDIM image on both within 1e-4 of its
   largest value, two card runs bitwise equal;
4. with every launch count at 0, drives the serving path at full width:
   GPT-2 350M (24 layers, bf16, random weights from a seed) through
   ``init_inference`` → ``generate``, then a ``SlotBatcher`` answering 16
   requests; reads the counts, and checks full-width logits against an
   fp32 host forward and each greedy request against a rerun alone;
   profiles a short ``generate`` (kernel time on the card against the
   host's wall time);
5. the same for int8 serving (``dtype="int8"``, ``kv_cache_dtype="int8"``:
   int8 weights and KV cache, bf16 compute), counts at 0 before the
   engine is built: parameter and KV bytes per token against the bf16
   engine's, exact launches of ``generate`` (quantizer 0, one
   ``quantize_kv_append`` a layer per forward, ``decode_attn_int8`` 24
   per step), logits against an fp32 host forward
   of the same dequantized weights, batched = alone, agreement with the
   bf16 run (reported), peak memory, a profile (device kernels per decode
   step), and decode ms per token of the bf16 and int8 engines timed in
   turns;
5b. with every launch count at 0 before each engine's run, drives GPT-Neo
   1.3B (window 256 on its odd layers, unscaled softmax) and BLOOM-560m
   (ALiBi, embedding LayerNorm) at their published widths (random
   weights, bf16) through ``init_inference`` → ``generate`` (4 prompts
   of 300-512 tokens, 32 new) and a 6-request ``SlotBatcher``, checks
   their logits (bf16, and an fp32 engine on the card) against an fp32
   host forward on a 320-token prompt, then the same with an int8 KV
   cache; each family must launch the option kernels it runs
   (``FAMILY_OPTIONS``: ``flash_fwd[window]``, ``decode_attn[window]``,
   ``decode_attn[alibi]``, ... and their int8 variants);
5c. with every launch count at 0 before each engine's run, drives GPT-2
   760M (d 1536, 16 heads of 96) and GPT-2 2.7B (d 2560, 32 heads of
   80) at full width and depth (random weights, bf16) through
   ``init_inference`` → ``generate`` and a ``SlotBatcher`` (760M: phase
   3's and 4's sizes, then phase 5's int8 weights and cache; 2.7B: the
   families' sizes), exact launches (``flash_fwd`` a layer per prefill,
   ``decode_attn`` a layer per token), logits of a 32-token prompt
   against an fp32 host forward, batched = alone, a profile
   (``run_wide_serving``);
6. with every launch count at 0, drives the training path at full width:
   bench.py's configuration (GPT-2 350M, seq 1024, bf16, remat
   ``attn_out``, Adam lr 1e-4 wd 0.01, ZeRO 1, micro-batch 16) through
   ``initialize`` → ``train_batch_fused``, 2 warm-up and 10 timed steps on
   one batch; reads the counts (``flash_bwd_fused`` 24 per step, the pair
   0); checks the card's bf16 loss of one row against the host's fp32
   loss, finite and falling losses; reports step time, tokens/s, MFU and
   peak memory, and profiles 2 steps, beside the same path's numbers
   with the two-kernel backward;
6b. with every launch count at 0, the preemptible run of the same
   configuration at full width and depth (``run_preemptible``):
   ``initialize(training_data=...)`` over 256 seeded rows of 1025 tokens
   (``data.resumable``, shuffled) → ``ElasticTrainRunner.run``. Two
   straight 8-step runs bitwise equal (every flat buffer, the moments,
   the scale state, the losses, the loader state); the second runs under
   a 3 s step watchdog whose first step ``HangFor`` holds past the
   deadline until ``on_expire`` releases it: one ``watchdog.expired``
   with every thread's stack, no kill, the thread stopped at the end. An
   async engine saves at step 2 and steps at once; ``SignalAtStep``
   (SIGTERM) at step 3 drains into a committed tag (``preempt.signal``,
   ``ckpt.preempt_save``); ``CorruptRandomBytes`` on that tag; an engine
   from another seed resumes, falls back to the step-2 tag, its loader on
   batch 2, and runs to step 8 bitwise equal to the straight run.  A
   ``NaNLossWindow`` at step 3 rolls back (``nan_abort_threshold`` 1,
   ``max_rollbacks`` 2) past the corrupt tag to step 2, quarantines
   exactly [2, 3), and its replay to step 8 (a save there journals
   ``rollback.recovered``) is bitwise equal to a straight run whose loader
   had [2, 3) installed (the scaler's good-step count restarts at the
   reset); that save's tag (sync) verifies and loads into an engine from
   another seed bitwise equal to the rollback run's end, its loader on
   the same position.  With spans and the metrics stream on, a step's spans are
   ``train.step`` around ``train.fwd``, ``train.bwd``,
   ``train.optimizer`` and ``train.host_sync``, the runs' inventory adds
   ``train.data_fetch``, ``ckpt.save``, ``ckpt.commit``, ``ckpt.load``,
   ``elastic.resume`` and ``elastic.rollback``, the trace validates, the
   ``wall_clock_breakdown`` lines print, ``metrics.jsonl`` rows carry
   ``train.tokens_per_s`` and ``train.mfu``; step ms with telemetry off
   and on in turns (reported only).  Prints the tag's bytes, the async
   save's block, the drain's seconds, the resume's load seconds (verify,
   read, copy; each load timed to a device barrier), the rollback's and
   the recovery save's seconds and the recovery tag's load beside the
   card's name and power limit; 50 steps' exact launches (``flash_fwd``
   and ``flash_bwd_fused`` 24 a step, Adam 1).  The tags go to a
   temporary directory the phase removes;
6c. the same for GPT-Neo 1.3B (published widths, random weights) at its
   context of 2048, micro-batch 8: exact launches per step (``flash_fwd``
   and ``flash_bwd_fused`` 24 each, their window option 12 each, the pair
   0, Adam 1), the row at seq 1024 held
   to 0.02 or to ``FAMILY_SENSITIVITY`` times its error with every layer
   global, MFU beside the live band's attention FLOPs;
6d. the same for GPT-2 760M (micro-batch 16) and 2.7B (micro-batch 8) at
   seq 1024 through the D 96 and 80 kernels, 2 warm-up and 5 timed
   steps (``WIDE_TRAIN_STEPS``): ``flash_fwd`` and
   ``flash_bwd_fused`` a layer per step, the pair 0; the row check at
   1024 and 256 tokens (``run_wide_training``); then 2.7B at seq 8192,
   micro-batch 1, past four key blocks of 1024: ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` a layer per step at D 80,
   ``flash_bwd_fused`` 0, the row check at 256 tokens;
7. the same for the sparse training path: the same model at seq 4096
   under the Fixed block-sparse layout (block 64), micro-batch 4, with the
   live-pair attention FLOPs beside MFU; 7b. GPT-2 760M the same way
   through the D 96 block-sparse trio (a layer per step each, no flash
   kernel), 2 warm-up and 5 timed steps, the row check at 1024 tokens;
   then a few steps of the 350M model with dense causal flash, for
   comparison (its backward on the fused kernel: seq 4096 is four key
   blocks of 1024);
8. the same for the BERT slice: BERT-large MLM at seq 128 (bf16, remat,
   the flash trio with per-row key lengths) under the BERT tutorial's LAMB
   (lr 11e-3, clip 1.0), micro-batch 64 of right-padded rows, with step
   time, live and padded tokens/s, MFU, peak memory, launches per step
   (48 ``flash_fwd``, 24 ``flash_bwd_fused``, the pair 0, 1 and 1 LAMB,
   0 Adam) and a profile of 2 steps;
8b. with every launch count at 0, one step of a tiny-width GPT (2
   layers, d 128, GPT-Neo's alternating window) at seq 5120, past the
   fused rule: the backward takes the pair, 2 + 2 launches (1 + 1 with
   the window), ``flash_bwd_fused`` none;
9. with every launch count at 0, drives the diffusion serving path at
   full width: Stable Diffusion 1.5 (published widths, random weights from
   a seed, bf16) through ``init_inference`` on diffusers-named state
   dicts (686 and 248 tensors) → ``DSUNet``/``DSVAE`` →
   ``DiffusionPipeline``, one prompt, guided 50-step DDIM, 512x512:
   exactly 6,636 ``nhwc_bias_add`` launches (66 per UNet forward, 36 per
   VAE decode); seconds per image, UNet forward, DDIM step and decode ms,
   FLOPs and MFU, the fp32 attention scores' time, peak memory, the
   card's UNet forward and VAE decode within 5% relative L2 of fp32 on
   the host, and a profile;
10. with every launch count at 0, runs ``bias_gelu_dropout`` forward and
   backward through autograd at [16, 1024, 4096] bf16, rate 0.1: one
   launch of each kernel per call, y and dx zero where the mask drops;
11. prints the kernels line (one row per kernel, and one per kernel
   option, such as ``decode_attn[window]``; an attention kernel's row
   carries ``head_dims``: its launches at each head dim over the main
   paths, their profiled runs and logits checks included, which
   ``launches`` leaves out; ``nhwc_bias_add_add`` and
   ``nhwc_bias_add_bias_add``, which no path of the JAX package calls,
   are held in the check phase only and say so; ``bf16_fp16_kernel``
   names the tensor-core kernel a wrapper launches on bf16 and fp16
   tensors: ``flash_fwd_tc``, ``flash_bwd_dq_tc``, ``flash_bwd_dkv_tc``,
   ``flash_bwd_fused_tc``, ``chunk_attn_tc``, ``block_sparse_fwd_tc``, ``block_sparse_bwd_dq_tc``,
   ``block_sparse_bwd_dkv_tc``), then ``{"ok": true, "device": ...}``
   last.

Any failure raises: no result line, non-zero exit.  The numbers also go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import logging
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# The host's fp32 references (the tiny models trained on the host, the
# full-width forwards) are held to the card's results at tolerances that
# Adam amplifies: a gradient below the summation noise of one step turns
# into a whole learning-rate step either way.  Pin the host's arithmetic
# (ATen's vector code and MKL's code branch) to AVX2, so those references
# do not change with the CPU model of the card's machine.
os.environ.setdefault("ATEN_CPU_CAPABILITY", "avx2")
os.environ.setdefault("MKL_CBWR", "AVX2")

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import bert, diffusion, gpt
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.diffusion_pipeline import DiffusionPipeline
from deepspeed_tpu_torch.model_implementations.diffusers import DSUNet, DSVAE
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.inference.quantization import (Int8Param,
                                                        param_bytes,
                                                        quantize_params_int8)
from deepspeed_tpu_torch.models import gpt_inference
from deepspeed_tpu_torch.ops.kernels import (
    adam_hyper, block_sparse_attention_backward_reference,
    block_sparse_attention_reference, build, cached_attention_reference,
    dequantize_kv, flash_attention_backward_reference,
    flash_attention_reference, fused_adam_reference, fused_lamb_reference,
    lamb_hyper, quantize, quantize_kv, quantize_kv_into,
    quantize_kv_into_reference, quantize_rows, sparse_plan)
from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
    BLOCKS, SparsePlan)
from deepspeed_tpu_torch.ops.kernels.flash_attention import \
    aligned_do_and_delta
from deepspeed_tpu_torch.ops.kernels.fused_lamb import lamb_plan
from deepspeed_tpu_torch.ops.kernels.quantizer import _quantize_ref
from deepspeed_tpu_torch.ops.kernels.utils import (HEAD_DIMS,
                                                   KERNEL_HEAD_DIMS)
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, VariableSparsityConfig)
from deepspeed_tpu_torch.elasticity import ElasticTrainRunner
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    async_checkpoint_engine, native_checkpoint_engine, verify_tag)
from deepspeed_tpu_torch.runtime.data_pipeline import ResumableDataLoader
from deepspeed_tpu_torch.runtime.model import from_bert, from_gpt
from deepspeed_tpu_torch.runtime.supervision import read_events
from deepspeed_tpu_torch.telemetry import (read_metrics, trace_events,
                                           validate_trace)
from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from deepspeed_tpu_torch.serving import ServingConfig, SlotBatcher
from tests.torch_diffusers_export import export_unet_sd, export_vae_sd

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor FLOP/s and
#: fp32 FLOP/s outside the tensor cores (the optimizers' elementwise math)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
#: kernel vs plain (fp32) tolerance in bf16: 5x bf16's half-ulp (2^-9) of
#: the output's magnitude; the kernel rounds O (and, in flash_fwd, p) to
#: bf16 where the fp32 plain version does not
BF16_REL_TOL = 1e-2
#: greedy batched-vs-alone divergence is allowed only where the top-2
#: logit margin at the first differing step is below this (fp32 logits)
TIE_TOL = 0.05
OUT_DIR = "chiprun_out"
#: the run's start, for the ``[time]`` lines between its phases
T0 = time.perf_counter()
ACCEL = get_accelerator()

SOURCES = {"flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                         "deepspeed_tpu/ops/pallas/flash_attention.py:133"),
           "decode_attn": ("deepspeed_tpu_torch/csrc/decode_attn.cu",
                           "deepspeed_tpu/ops/pallas/decode_attention.py:101"),
           "chunk_attn": ("deepspeed_tpu_torch/csrc/chunk_attn.cu",
                          "deepspeed_tpu/ops/pallas/decode_attention.py:218"),
           "flash_bwd_dq": ("deepspeed_tpu_torch/csrc/flash_bwd_dq.cu",
                            "deepspeed_tpu/ops/pallas/flash_attention.py:246"),
           "flash_bwd_dkv": ("deepspeed_tpu_torch/csrc/flash_bwd_dkv.cu",
                             "deepspeed_tpu/ops/pallas/flash_attention.py:304"),
           "flash_bwd_fused": ("deepspeed_tpu_torch/csrc/flash_bwd_fused.cu",
                               "deepspeed_tpu/ops/pallas/flash_attention.py:304"),
           "fused_adam": ("deepspeed_tpu_torch/csrc/fused_adam.cu",
                          "deepspeed_tpu/ops/pallas/fused_adam.py:29"),
           "block_sparse_fwd": (
               "deepspeed_tpu_torch/csrc/block_sparse_fwd.cu",
               "deepspeed_tpu/ops/pallas/block_sparse_attention.py:107"),
           "block_sparse_bwd_dq": (
               "deepspeed_tpu_torch/csrc/block_sparse_bwd_dq.cu",
               "deepspeed_tpu/ops/pallas/block_sparse_attention.py:193"),
           "block_sparse_bwd_dkv": (
               "deepspeed_tpu_torch/csrc/block_sparse_bwd_dkv.cu",
               "deepspeed_tpu/ops/pallas/block_sparse_attention.py:229"),
           "fused_lamb_phase1": ("deepspeed_tpu_torch/csrc/fused_lamb.cu",
                                 "deepspeed_tpu/ops/pallas/fused_lamb.py:78"),
           "fused_lamb_phase2": ("deepspeed_tpu_torch/csrc/fused_lamb.cu",
                                 "deepspeed_tpu/ops/pallas/fused_lamb.py:102"),
           "quantizer": ("deepspeed_tpu_torch/csrc/quantizer.cu",
                         "deepspeed_tpu/ops/pallas/quantizer.py:89"),
           "decode_attn_int8": (
               "deepspeed_tpu_torch/csrc/decode_attn.cu",
               "deepspeed_tpu/ops/pallas/decode_attention.py:101"),
           "chunk_attn_int8": (
               "deepspeed_tpu_torch/csrc/chunk_attn.cu",
               "deepspeed_tpu/ops/pallas/decode_attention.py:218"),
           "quantize_kv_append": ("deepspeed_tpu_torch/csrc/quantizer.cu",
                                  "deepspeed_tpu/ops/pallas/quantizer.py:89"),
           "nhwc_bias_add": ("deepspeed_tpu_torch/csrc/spatial.cu",
                             "deepspeed_tpu/ops/pallas/spatial.py:28"),
           "nhwc_bias_add_add": ("deepspeed_tpu_torch/csrc/spatial.cu",
                                 "deepspeed_tpu/ops/pallas/spatial.py:34"),
           "nhwc_bias_add_bias_add": (
               "deepspeed_tpu_torch/csrc/spatial.cu",
               "deepspeed_tpu/ops/pallas/spatial.py:41"),
           "bias_gelu_fwd": (
               "deepspeed_tpu_torch/csrc/fused_bias_gelu.cu",
               "deepspeed_tpu/ops/pallas/fused_bias_gelu.py:70"),
           "bias_gelu_bwd": (
               "deepspeed_tpu_torch/csrc/fused_bias_gelu.cu",
               "deepspeed_tpu/ops/pallas/fused_bias_gelu.py:80")}


def log(msg: str) -> None:
    print(msg, flush=True)


#: the tensor-core kernels' sources and their instantiations that must
#: run on wgmma (HGMMA) fed by TMA (UTMALDG); chunk_attn_tc also has an
#: int8-cache instantiation ("bf16 int8", "fp16 int8") per dtype and D,
#: the flash trio a banded one ("bf16 band", "fp16 band")
TC_SOURCES = {"flash_fwd": "flash_fwd_tc", "flash_bwd_dkv": "flash_bwd_dkv_tc",
              "flash_bwd_dq": "flash_bwd_dq_tc",
              "flash_bwd_fused": "flash_bwd_fused_tc", "chunk_attn": "chunk_attn_tc",
              "block_sparse_fwd": "block_sparse_fwd_tc",
              "block_sparse_bwd_dq": "block_sparse_bwd_dq_tc",
              "block_sparse_bwd_dkv": "block_sparse_bwd_dkv_tc"}
TC_TYPES = {"__nv_bfloat16": "bf16", "__half": "fp16"}
#: what the bool template parameter of a tensor-core kernel selects
TC_BOOL = {"chunk_attn_tc": " int8", "flash_fwd_tc": " band",
           "flash_bwd_dq_tc": " band", "flash_bwd_dkv_tc": " band",
           "flash_bwd_fused_tc": " band"}
#: the kernel each wrapper launches on bf16 and fp16 tensors, for the
#: kernels line
TC_ENTRY = {"flash_fwd": "flash_fwd_tc", "flash_bwd_dkv": "flash_bwd_dkv_tc",
            "decode_attn": "decode_attn_mma (mma.sync)",
            "flash_bwd_dq": "flash_bwd_dq_tc",
            "flash_bwd_fused": "flash_bwd_fused_tc", "chunk_attn": "chunk_attn_tc",
            "chunk_attn_int8": "chunk_attn_tc (int8 cache)",
            "block_sparse_fwd": "block_sparse_fwd_tc",
            "block_sparse_bwd_dq": "block_sparse_bwd_dq_tc",
            "block_sparse_bwd_dkv": "block_sparse_bwd_dkv_tc"}


def _tc_instance(mangled: str):
    """(kernel, dtype, D) of a mangled tensor-core kernel name, or None;
    the dtype of an instantiation whose bool parameter is set ends in its
    ``TC_BOOL`` suffix."""
    for kernel in TC_SOURCES.values():
        m = re.search(kernel + r"I(13__nv_bfloat16|6__half)Li(\d+)E(Lb([01])E)?",
                      mangled)
        if m:
            dt = TC_TYPES[m.group(1).lstrip("0123456789")]
            return kernel, dt + (TC_BOOL[kernel] if m.group(4) == "1" else ""), \
                int(m.group(2))
    return None


#: the head dims each tensor-core kernel is instantiated for (its
#: wrapper's, ``KERNEL_HEAD_DIMS``)
TC_DIMS = {tc: KERNEL_HEAD_DIMS[src] for src, tc in TC_SOURCES.items()}
#: the head dims that run in the tile of D 128 (``csrc/common.cuh``
#: ``tile_dim``), each held to its kernel's D 128 instantiation
PADDED_DIMS = tuple(D for D in HEAD_DIMS if 64 < D < 128)


#: the sources whose warp-specialised kernels move registers between
#: warpgroups with ``setmaxnreg`` (a ptxas warning that one was ignored
#: fails the build checks)
SETMAXNREG_SOURCES = ("flash_bwd_fused",)


def _tc_wanted():
    """Every (kernel, dtype, D) the tensor-core sources must hold."""
    want = [(k, dt, D) for k in TC_SOURCES.values() for dt in TC_TYPES.values()
            for D in TC_DIMS[k]]
    return want + [(k, dt + suffix, D) for k, suffix in TC_BOOL.items()
                   for dt in TC_TYPES.values() for D in TC_DIMS[k]]


def check_ptxas_tc():
    """Registers and spill stores of each tensor-core instantiation from
    the build's ``-Xptxas -v`` report; fails if a bf16 D64 one spills
    (D128 may, and is reported), a banded one spills more than the
    unbanded instantiation of its kernel, dtype and D, a
    ``flash_bwd_fused_tc`` one spills at all, or ptxas warns that a
    ``setmaxnreg`` of ``SETMAXNREG_SOURCES`` was ignored."""
    rows = {}
    for src in TC_SOURCES:
        rep = build.ptxas_reports.get(src, "")
        for part in re.split(r"Compiling entry function '", rep)[1:]:
            inst = _tc_instance(part.split("'")[0])
            if inst is None:
                continue
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            rows[inst] = (int(regs.group(1)) if regs else -1,
                          int(spill.group(1)) if spill else 0)
    for (kernel, dt, D), (regs, spill) in sorted(rows.items()):
        log(f"[ptxas] {kernel}<{dt}, D{D}>: {regs} registers, spill stores "
            f"{spill} bytes")
    for kernel, dt, D in _tc_wanted():
        if dt.startswith("bf16") and D == 64 and \
                rows.get((kernel, dt, D), (0, 1))[1] != 0:
            raise AssertionError(f"{kernel} {dt} D64 spills or was not built")
        if dt.endswith(" band") and rows.get((kernel, dt, D), (0, 1 << 30))[1] \
                > rows.get((kernel, dt[:-5], D), (0, -1))[1]:
            raise AssertionError(f"{kernel} {dt} D{D} spills more than its "
                                 "unbanded instantiation, or was not built")
    log("[ptxas] every banded instantiation spills no more than its "
        "unbanded one")
    for dt in TC_TYPES.values():
        for suffix in ("", " band"):
            for D in HEAD_DIMS:
                spill = rows.get(("flash_bwd_fused_tc", dt + suffix, D), (0, 1 << 30))[1]
                if spill != 0:
                    raise AssertionError(
                        f"flash_bwd_fused_tc {dt}{suffix} D{D} spills {spill} "
                        "bytes, or was not built")
    ignored = [line.strip() for src in SETMAXNREG_SOURCES
               for line in build.ptxas_reports.get(src, "").splitlines()
               if re.search(r"setmaxnreg|C750[789]", line)]
    if ignored:
        raise AssertionError("ptxas ignored a setmaxnreg: " + "; ".join(ignored))
    log("[ptxas] flash_bwd_fused_tc spills 0 bytes at each dtype, D and band; "
        f"no setmaxnreg ignored in {list(SETMAXNREG_SOURCES)}")
    for kernel, dt, D in _tc_wanted():
        if D in PADDED_DIMS:
            have = rows.get((kernel, dt, D), (0, 1 << 30))[1]
            twin = rows.get((kernel, dt, 128), (0, -1))[1]
            if have > twin:
                raise AssertionError(f"{kernel} {dt} D{D} spills {have} bytes, "
                                     f"its D128 instantiation {twin}")
    log(f"[ptxas] every D{PADDED_DIMS} instantiation spills no more than its "
        "kernel's D128 one")
    return {f"{k}<{dt},{D}>": {"registers": r, "spill_stores": sp}
            for (k, dt, D), (r, sp) in rows.items()}


def check_sass():
    """The count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in
    each tensor-core instantiation, from ``cuobjdump -sass`` of the built
    libraries; fails if a bf16 or fp16 one has none of either (the
    int8-cache chunk_attn_tc loads Q and the int8 codes with TMA and
    widens the codes in shared memory)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for src in TC_SOURCES:
        lib = build.BUILD_DIR / f"{src}.{build._digest(src)}.so"
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for part in re.split(r"Function : ", sass)[1:]:
            inst = _tc_instance(part.split()[0])
            if inst is not None:
                counts[inst] = (len(re.findall(r"\bHGMMA\.", part)),
                                len(re.findall(r"\bUTMALDG\.", part)))
    for (kernel, dt, D), (hg, tma) in sorted(counts.items()):
        log(f"[sass] {kernel}<{dt}, D{D}>: HGMMA {hg}, UTMALDG {tma}")
    bad = [w for w in _tc_wanted() if min(counts.get(w, (0, 0))) == 0]
    if bad:
        raise AssertionError(f"no wgmma or no TMA in {bad}")
    return {f"{k}<{dt},{D}>": {"HGMMA": hg, "UTMALDG": tma}
            for (k, dt, D), (hg, tma) in counts.items()}


#: the decode kernels' type codes in mangled names
_MANGLED_TYPES = {"f": "fp32", "6__half": "fp16", "13__nv_bfloat16": "bf16",
                  "a": "int8"}


def _decode_instance(mangled: str):
    """(kernel, types, D) of a mangled ``decode_attn_mma<T, D>`` or
    ``decode_attn_fma<T, C, D>`` name, or None; ``types`` is the query
    type, then " int8" for an int8 cache."""
    m = re.search(r"(decode_attn_mma|decode_attn_fma)I(f|6__half|"
                  r"13__nv_bfloat16)(a)?\S*?Li(\d+)E", mangled)
    if m is None:
        return None
    return (m.group(1), _MANGLED_TYPES[m.group(2)]
            + (" int8" if m.group(3) else ""), int(m.group(4)))


#: every decode instantiation: 16-bit caches on mma.sync, fp32 and int8
#: caches on FMAs
DECODE_WANTED = ([("decode_attn_mma", dt, D) for dt in ("bf16", "fp16")
                  for D in HEAD_DIMS]
                 + [("decode_attn_fma", dt, D)
                    for dt in ("fp32", "fp32 int8", "fp16 int8", "bf16 int8")
                    for D in HEAD_DIMS])


def check_decode_build():
    """Registers and spill stores (``-Xptxas -v``) of every decode
    instantiation, and its HMMA (mma.sync) and UTMALDG (TMA load) counts
    from ``cuobjdump -sass``; fails if one has no TMA load, an mma one no
    HMMA, a bf16 D64 one spills, or a D 80 or 96 one spills more than
    its kernel's D 128 one."""
    rows = {}
    rep = build.ptxas_reports.get("decode_attn", "")
    for part in re.split(r"Compiling entry function '", rep)[1:]:
        inst = _decode_instance(part.split("'")[0])
        if inst is not None:
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            rows[inst] = [int(regs.group(1)) if regs else -1,
                          int(spill.group(1)) if spill else 0, 0, 0]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = build.BUILD_DIR / f"decode_attn.{build._digest('decode_attn')}.so"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in re.split(r"Function : ", sass)[1:]:
        inst = _decode_instance(part.split()[0])
        if inst is not None:
            row = rows.setdefault(inst, [-1, 0, 0, 0])
            row[2] = len(re.findall(r"\bHMMA\.", part))
            row[3] = len(re.findall(r"\bUTMALDG\.", part))
    for (k, dt, D), (regs, spill, hmma, tma) in sorted(rows.items()):
        log(f"[ptxas] {k}<{dt}, D{D}>: {regs} registers, spill stores "
            f"{spill} bytes; [sass] HMMA {hmma}, UTMALDG {tma}")
    bad = [w for w in DECODE_WANTED if w not in rows or not rows[w][3]
           or (w[0] == "decode_attn_mma" and not rows[w][2])
           or (w[1] == "bf16" and w[2] == 64 and rows[w][1])
           or (w[2] in PADDED_DIMS
               and rows[w][1] > rows.get((w[0], w[1], 128), [0, -1])[1])]
    if bad:
        raise AssertionError(f"decode kernels without TMA or HMMA, not "
                             f"built, spilling (bf16 D64), or spilling more "
                             f"than their D128 instantiation: {bad}")
    return {f"{k}<{dt},{D}>": {"registers": r, "spill_stores": sp,
                               "HMMA": hm, "UTMALDG": t}
            for (k, dt, D), (r, sp, hm, t) in rows.items()}


@functools.cache
def _side_stream():
    """The one side stream of ``time_ms``'s warm-up: cuBLAS keeps a 32 MiB
    workspace for each stream it has run on, for the rest of the run."""
    return torch.cuda.Stream()


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn(i)`` over ``n`` calls.  The calls are
    captured into one CUDA graph and the graph's replay is timed with CUDA
    events, so the host's launch overhead (Python, ctypes) does not hide
    the device time of short kernels."""
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    ACCEL.synchronize()
    start, end = ACCEL.event(), ACCEL.event()
    start.record()
    graph.replay()
    end.record()
    ACCEL.synchronize()
    return start.elapsed_time(end) / n


def eager_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``n`` eager calls between two CUDA
    events: for yardsticks that cannot be captured in a graph (autograd,
    ``torch.optim``), each call long enough that launch overhead is small
    beside it."""
    for _ in range(warmup):
        fn()
    ACCEL.synchronize()
    start, end = ACCEL.event(), ACCEL.event()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    ACCEL.synchronize()
    return start.elapsed_time(end) / n


def pct(xs, q):
    """Nearest-rank percentile."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


# ------------------------------------------------------------- kernels

def _qkv_views(n, B, S, H, D, gen):
    """``n`` sets of q, k, v as strided views of [B, S, 3, H, D], the
    layout the model's qkv projection hands the kernels."""
    sets = []
    for _ in range(n):
        qkv = torch.randn((B, S, 3, H, D), generator=gen, device="cuda",
                          dtype=torch.float32).to(torch.bfloat16)
        sets.append((qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))
    return sets


def _report(name, shape, err, tol, ms, plain_ms, lib_ms, nbytes, flops,
            peak_flops=BF16_FLOPS):
    """One kernel's row; ``lib_ms`` None where no PyTorch call computes
    the same function."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    row = {"name": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"[kernel] {name} {shape}: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib} bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: max_abs_err {err} > tol {tol}")
    return row


def check_flash(B, S, H=16, D=64):
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + S)
    per_set = 3 * B * S * H * D * 2
    sets = _qkv_views(max(1, min(16, (120 << 20) // per_set)), B, S, H, D, gen)
    scale = 1.0 / math.sqrt(D)
    q, k, v = sets[0]
    o, lse = kernels.flash_fwd(q, k, v, True, scale)
    o32, lse32 = flash_attention_reference(q.float(), k.float(), v.float(),
                                           True, scale)
    ACCEL.synchronize()
    err = (o.float() - o32).abs().max().item()
    lse_err = (lse - lse32).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"flash_fwd lse err {lse_err} > 1e-3")
    tol = BF16_REL_TOL * max(1.0, o32.abs().max().item())
    n = len(sets)
    ms = time_ms(lambda i: kernels.flash_fwd(*sets[i % n], True, scale), 20)
    plain_ms = time_ms(
        lambda i: flash_attention_reference(*sets[i % n], True, scale), 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda i: sdpa(*(t.transpose(1, 2) for t in sets[i % n]),
                                    is_causal=True), 20)
    pairs = B * H * S * (S + 1) // 2
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4
    return _report("flash_fwd", f"B{B} S{S} H{H} D{D} bf16 causal", err, tol,
                   ms, plain_ms, lib_ms, nbytes, 4 * D * pairs)


def check_flash_bwd(B, S, H=16, D=64):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` against the fp32 plain
    backward, from bf16 q, k, v (views of [B, S, 3, H, D]), dO and the
    forward kernel's O and lse.  Plain ms is the whole plain backward (dq,
    dk and dv in one function, one batch row at a time: ``_plain_bwd``);
    library ms is the backward of
    ``scaled_dot_product_attention(is_causal=True)``, timed alone, which
    also computes all three."""
    gen = torch.Generator(device="cuda").manual_seed(7 * B + S)
    per_set = 4 * B * S * H * D * 2
    n = max(1, min(8, (120 << 20) // per_set))
    scale = 1.0 / math.sqrt(D)
    sets = []
    for q, k, v in _qkv_views(n, B, S, H, D, gen):
        do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        o, lse = kernels.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, o, lse, delta))
    q, k, v, do, o, lse, delta = sets[0]
    dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    dq2 = kernels.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dk2, dv2 = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    ref = _plain_bwd(q, k, v, o, lse, do, True, scale)
    ACCEL.synchronize()
    repeat = {"flash_bwd_dq": bool(torch.equal(dq, dq2)),
              "flash_bwd_dkv": bool(torch.equal(dk, dk2)
                                    and torch.equal(dv, dv2))}
    log(f"[flash_bwd repeat] B{B} S{S}: two launches give bitwise equal dq "
        f"{repeat['flash_bwd_dq']}, dk and dv {repeat['flash_bwd_dkv']}")
    if not all(repeat.values()):
        raise AssertionError(f"flash backward: two launches differ {repeat}")
    del dq2, dk2, dv2
    errs = [(a.float() - r).abs().max().item() for a, r in zip((dq, dk, dv), ref)]
    tols = [BF16_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]

    def kernel(fn):
        def run(i):
            q_, k_, v_, do_, _, lse_, delta_ = sets[i % n]
            return fn(q_, k_, v_, do_, lse_, delta_, True, scale)
        return run

    ms_dq = time_ms(kernel(kernels.flash_bwd_dq), 10)
    ms_dkv = time_ms(kernel(kernels.flash_bwd_dkv), 10)
    plain_ms = eager_ms(lambda: _plain_bwd(q, k, v, o, lse, do, True, scale),
                        1, warmup=1)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           is_causal=True)
    gout = do.transpose(1, 2)
    lib_ms = eager_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                  retain_graph=True), 10)
    pairs = B * H * S * (S + 1) // 2
    elem = B * S * H * D * 2                          # one bf16 [B, S, H, D]
    stats = 2 * B * H * S * 4                         # lse and delta, fp32
    shape = f"B{B} S{S} H{H} D{D} bf16 causal"
    return [_report("flash_bwd_dq", shape, errs[0], tols[0], ms_dq, plain_ms,
                    lib_ms, 5 * elem + stats, 6 * D * pairs),
            _report("flash_bwd_dkv", shape, max(errs[1:]), min(tols[1:]),
                    ms_dkv, plain_ms, lib_ms, 6 * elem + stats,
                    8 * D * pairs)]


#: fused_adam vs its plain version (times max(1, |ref|)): both run the
#: same fp32 arithmetic, the kernel with contracted multiply-adds
ADAM_TOL = 1e-5


def check_fused_adam(n=355_000_000):
    """``fused_adam`` over ``n`` elements (the full-width model's flat
    buffers) against its plain version; library ms is
    ``torch.optim.AdamW(fused=True).step()`` over the same fp32 tensors
    (it writes no bf16 copy and leaves the gradient)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    m = torch.randn(n, generator=gen, device="cuda") * 0.1
    v = torch.rand(n, generator=gen, device="cuda") * 0.01
    pc = p.to(torch.bfloat16)
    hyper = adam_hyper(1e-4, 0.9, 0.999, 1e-8, 0.01, 3, device="cuda")
    ref = [t.clone() for t in (p, g, m, v)]
    kernels.fused_adam(p, g, m, v, hyper, p_compute=pc)
    fused_adam_reference(*ref, hyper)
    ACCEL.synchronize()
    pairs = list(zip((p, m, v), (ref[0], ref[2], ref[3])))
    err = max((a - r).abs().max().item() for a, r in pairs)
    tol = ADAM_TOL * max(1.0, max(r.abs().max().item() for _, r in pairs))
    if not (torch.equal(pc, p.to(torch.bfloat16)) and not g.any()):
        raise AssertionError("fused_adam: bf16 copy or zeroed gradient wrong")
    del ref
    g.normal_(generator=gen)
    ms = time_ms(lambda i: kernels.fused_adam(p, g, m, v, hyper,
                                              p_compute=pc), 10)
    plain_ms = time_ms(lambda i: fused_adam_reference(p, g, m, v, hyper, pc), 2)
    p.grad = g
    opt = torch.optim.AdamW([p], lr=1e-4, weight_decay=0.01, fused=True)
    lib_ms = eager_ms(opt.step, 10)
    del p, g, m, v, pc, opt
    return _report("fused_adam", f"n {n} fp32 master, bf16 copy", err,
                   tol, ms, plain_ms, lib_ms, 34 * n, 15 * n)


def check_adam_skip(n=1_000_003):
    """A skipped step (``skip`` set) leaves p, m, v and the bf16 copy
    bitwise unchanged and zeroes the gradient."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    p, g, m, v = (torch.randn(n, generator=gen, device="cuda") for _ in range(4))
    v = v.abs()
    pc = p.to(torch.bfloat16)
    before = [t.clone() for t in (p, m, v, pc)]
    kernels.fused_adam(p, g, m, v, adam_hyper(1e-3, 0.9, 0.999, 1e-8, 0.01, 1,
                                              device="cuda"),
                       p_compute=pc, skip=torch.ones((), dtype=torch.bool,
                                                     device="cuda"))
    ACCEL.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((p, m, v, pc), before))
    log(f"[adam skip] n {n}: state bitwise unchanged {same}, gradient zeroed "
        f"{not g.any().item()}")
    if not same or g.any():
        raise AssertionError("fused_adam with skip changed its state")


#: the BERT slice's model: bench.py's BERT-large at seq 128, bf16, remat
BERT_LARGE_128 = dataclasses.replace(bert.BERT_LARGE, max_seq_len=128,
                                     dtype=torch.bfloat16, remat=True)
#: the BERT tutorial's seq-128 LAMB (DeepSpeedExamples bing_bert
#: deepspeed_bsz64k_lamb_config_seq128.json)
LAMB_PARAMS = {"lr": 11e-3, "weight_decay": 0.01, "bias_correction": False,
               "max_coeff": 0.3, "min_coeff": 0.01}
#: fused_lamb vs its plain version (times max(1, |ref|)): the same fp32
#: arithmetic, the kernel with contracted multiply-adds and its norms
#: summed in another order
LAMB_TOL = 1e-5


def bert_segments(cfg):
    """(offset, numel) of every leaf of ``bert.init(cfg)`` in the engine's
    order, and each leaf's init kind ("n" normal 0.02, "1" ones, "0"
    zeros), from the shapes alone."""
    d, v, L, f = cfg.d_model, cfg.padded_vocab, cfg.n_layer, cfg.ffn_dim
    leaves = [(v * d, "n"), (cfg.max_seq_len * d, "n"),
              (cfg.type_vocab_size * d, "n"), (d, "1"), (d, "0"),
              (L * d * 3 * d, "n"), (L * 3 * d, "0"), (L * d * d, "n"),
              (L * d, "0"), (L * d, "1"), (L * d, "0"), (L * d * f, "n"),
              (L * f, "0"), (L * f * d, "n"), (L * d, "0"), (L * d, "1"),
              (L * d, "0"), (d * d, "n"), (d, "0"), (d, "1"), (d, "0"),
              (v, "0"), (d * d, "n"), (d, "0")]
    segments, off = [], 0
    for numel, _ in leaves:
        segments.append((off, numel))
        off += numel
    return segments, [kind for _, kind in leaves]


def check_fused_lamb():
    """The two ``fused_lamb`` kernels over BERT-large's 335,902,592 fp32
    elements in its 24 leaf segments (init-like values: zero biases give
    trust 1, LayerNorm scales and matrices clamp), with the bf16 copy,
    against the fp32 plain version; no PyTorch call computes LAMB, so no
    library time."""
    segs, kinds = bert_segments(BERT_LARGE_128)
    n = segs[-1][0] + segs[-1][1]
    if n != 335_902_592:
        raise AssertionError(f"BERT-large has {n} parameters")
    gen = torch.Generator(device="cuda").manual_seed(12)
    p = torch.empty(n, device="cuda")
    for (off, numel), kind in zip(segs, kinds):
        if kind == "n":
            p[off:off + numel].normal_(0.0, 0.02, generator=gen)
        else:
            p[off:off + numel].fill_(float(kind))
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.randn(n, generator=gen, device="cuda") * 1e-3
    v = torch.rand(n, generator=gen, device="cuda") * 1e-5
    pc = p.to(torch.bfloat16)
    hyper = lamb_hyper(LAMB_PARAMS["lr"], 0.9, 0.999, 1e-8, 0.01, 3,
                       bias_correction=False,
                       max_coeff=LAMB_PARAMS["max_coeff"],
                       min_coeff=LAMB_PARAMS["min_coeff"], device="cuda")
    ref = [t.clone() for t in (p, g, m, v)]
    kernels.fused_lamb(p, g, m, v, hyper, segs, p_compute=pc)
    fused_lamb_reference(*ref, hyper, segs)
    ACCEL.synchronize()
    err_mv = max((a - r).abs().max().item() for a, r in ((m, ref[2]), (v, ref[3])))
    err_p = (p - ref[0]).abs().max().item()
    tol = LAMB_TOL * max(1.0, max(r.abs().max().item()
                                  for r in (ref[0], ref[2], ref[3])))
    if not (torch.equal(pc, p.to(torch.bfloat16)) and not g.any()):
        raise AssertionError("fused_lamb: bf16 copy or zeroed gradient wrong")
    plan = lamb_plan(tuple(segs), p.device)
    ratio = plan.ratio.cpu()
    hi, lo = LAMB_PARAMS["max_coeff"], LAMB_PARAMS["min_coeff"]
    log(f"[lamb] trust ratios of the 24 segments: {int((ratio == 1).sum())} "
        f"at 1 (a zero norm), {int((ratio == hi).sum())} at max_coeff, "
        f"{int((ratio == lo).sum())} at min_coeff, the rest "
        f"{[round(x, 4) for x in ratio.tolist() if x not in (1.0, hi, lo)]}")
    del ref
    g.normal_(generator=gen)
    ms1 = time_ms(lambda i: kernels.fused_lamb_phase1(p, g, m, v, hyper, plan), 10)
    ms2 = time_ms(lambda i: kernels.fused_lamb_phase2(p, m, v, hyper, plan,
                                                      pc), 10)
    plain_ms = eager_ms(lambda: fused_lamb_reference(p, g, m, v, hyper, segs,
                                                     pc), 2, 1)
    del p, g, m, v, pc
    torch.cuda.empty_cache()
    shape = f"n {n} fp32 in 24 BERT-large segments, bf16 copy"
    rows = [_report("fused_lamb_phase1", shape, err_mv, tol, ms1, plain_ms,
                    None, 28 * n, 20 * n, FP32_FLOPS),
            _report("fused_lamb_phase2", shape, err_p, tol, ms2, plain_ms,
                    None, 18 * n, 9 * n, FP32_FLOPS)]
    log(f"[lamb] both phases {ms1 + ms2:.4f} ms against the step's bound "
        f"{46 * n / HBM_BYTES_PER_S * 1e3:.4f} ms (46 bytes per element)")
    return rows


def check_lamb_skip(n=1_000_003):
    """A skipped LAMB step (``skip`` set) leaves p, m, v and the bf16 copy
    bitwise unchanged and zeroes the gradient; segments at odd offsets,
    one empty."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    p, g, m, v = (torch.randn(n, generator=gen, device="cuda") for _ in range(4))
    v = v.abs()
    pc = p.to(torch.bfloat16)
    before = [t.clone() for t in (p, m, v, pc)]
    segs = [(0, 333_333), (333_333, 0), (333_333, n - 333_333)]
    kernels.fused_lamb(p, g, m, v, lamb_hyper(1e-3, 0.9, 0.999, 1e-8, 0.01, 1,
                                              device="cuda"),
                       segs, p_compute=pc,
                       skip=torch.ones((), dtype=torch.bool, device="cuda"))
    ACCEL.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((p, m, v, pc), before))
    log(f"[lamb skip] n {n}: state bitwise unchanged {same}, gradient zeroed "
        f"{not g.any().item()}")
    if not same or g.any():
        raise AssertionError("fused_lamb with skip changed its state")


def _caches(B, Smax, H, D, gen, min_bytes=200 << 20):
    """A [L, B, Smax, H, D] K and V pair with enough layers that rotating
    through them keeps each launch's cache reads out of the 50 MB L2."""
    per_layer = 2 * B * Smax * H * D * 2
    L = max(2, -(-min_bytes // per_layer))
    mk = lambda: torch.randn((L, B, Smax, H, D), generator=gen, device="cuda",
                             dtype=torch.float32).to(torch.bfloat16)
    return mk(), mk(), L


def _int8_cache(ck, cv):
    """The bf16 caches [L, B, Smax, H, D] with their int8 form appended:
    (K, V, K codes, V codes, K scales, V scales), quantized per head
    vector by ``quantize_kv``."""
    out = [ck, cv]
    for c in (ck, cv):
        codes, scale = quantize_kv(c.view(-1, *c.shape[2:]))
        out.append((codes.view(c.shape), scale.view(c.shape[:-1] + (1,))))
    return (ck, cv, out[2][0], out[3][0], out[2][1], out[3][1])


def _cache_check(name, kernel, q, cache, pos, mask, Sq, repeat=False,
                 window=None, slopes=None):
    """Shared half of the decode/chunk checks: error vs the fp32 plain
    version on layer 0, then kernel/plain/SDPA times rotating layers.
    ``cache``: bf16 (K, V) [L, B, Smax, H, D], or for the int8 kernels
    ``_int8_cache``'s six tensors: the kernel reads the codes and scales,
    the plain version the dequantized cache (as the CPU path does), SDPA
    the bf16 cache under ``mask``.  ``repeat``: fail unless a second
    launch on layer 0 is bitwise equal to the first.  ``window`` and
    ``slopes`` are the kernels' band and ALiBi options: the bound counts
    the band's rows and pairs only."""
    int8 = len(cache) == 6
    ck, cv = cache[:2]
    kv = cache[2:] if int8 else cache            # what the kernel reads
    L = ck.shape[0]
    B, H, D = q.shape[0], q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    opts = {"window": window, "slopes": slopes}

    def run(i):
        layer = [t[i % L] for t in kv]
        return kernel(q, *layer[:2], pos, scale, *layer[2:], **opts)

    def dense(i, dtype):
        if not int8:
            return ck[i % L].to(dtype), cv[i % L].to(dtype)
        kq, vq, ks, vs = (t[i % L] for t in kv)
        return dequantize_kv(kq, ks, dtype), dequantize_kv(vq, vs, dtype)

    out = run(0)
    ref = cached_attention_reference(q.float(), *dense(0, torch.float32),
                                     pos, scale, **opts)
    if repeat:
        same = bool(torch.equal(out, run(0)))
        log(f"[{name} repeat] Sq{Sq} pos {pos}: two launches give bitwise "
            f"equal output {same}")
        if not same:
            raise AssertionError(f"{name}: two launches differ")
    ACCEL.synchronize()
    err = (out.float() - ref).abs().max().item()
    tol = BF16_REL_TOL * max(1.0, ref.abs().max().item())
    ms = time_ms(run, 50)
    plain_ms = time_ms(lambda i: cached_attention_reference(
        q, *dense(i, q.dtype), pos, scale, **opts), 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda i: sdpa(
        q.transpose(1, 2), ck[i % L].transpose(1, 2),
        cv[i % L].transpose(1, 2), attn_mask=mask, scale=scale), 50)
    pos_host = pos.cpu().numpy() if torch.is_tensor(pos) else \
        np.full((B,), pos)
    w = window or ck.shape[2] + Sq
    # live rows: from the first query's band start to the last query
    rows = int(sum(min(ck.shape[2], p + Sq) - max(0, p - w + 1)
                   for p in pos_host))
    visible = int(sum(min(p + i + 1, w) for p in pos_host
                      for i in range(Sq)))
    # K and V of a live row: bf16, or int8 codes and two fp32 scales
    row_bytes = H * (2 * D + 8) if int8 else H * D * 2 * 2
    nbytes = rows * row_bytes + 2 * B * Sq * H * D * 2
    kind = "int8 cache, bf16 q" if int8 else "bf16"
    if window is not None:
        kind += f", window {window}"
    if slopes is not None:
        kind += ", ALiBi slopes"
    shape = (f"B{B} Sq{Sq} Smax{ck.shape[2]} H{H} D{D} {kind} pos "
             f"{pos_host.tolist()}")
    return _report(name, shape, err, tol, ms, plain_ms, lib_ms, nbytes,
                   4 * D * H * visible)


#: check_decode's positions: ragged from a seed (the serving shape's), every
#: row full (pos = S_max - 1), every row at pos 0 (one live key); and a
#: single request (B 1) full, whose 16 heads' keys split over clusters
DECODE_POS = ("ragged", "full", "zero")
DECODE_CASES = tuple((8, kind) for kind in DECODE_POS) + ((1, "full"),)


def check_decode(B=8, Smax=1024, H=16, D=64, int8=False, kind="ragged"):
    """``decode_attn`` on a bf16 cache, or with ``int8`` its int8-cache
    variant on the same data quantized, at ``kind`` positions (a device
    tensor, as the decode loop hands it); two launches bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    ck, cv, _ = _caches(B, Smax, H, D, gen)
    host = {"ragged": np.random.default_rng(3).integers(0, Smax, B),
            "full": np.full(B, Smax - 1), "zero": np.zeros(B)}[kind]
    pos = torch.as_tensor(host.astype(np.int32)).cuda()
    q = _qkv_views(1, B, 1, H, D, gen)[0][0]
    mask = (torch.arange(Smax, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]        # [B, 1, 1, Smax]
    if int8:
        return _cache_check("decode_attn_int8", kernels.decode_attn_int8, q,
                            _int8_cache(ck, cv), pos, mask, 1, repeat=True)
    return _cache_check("decode_attn", kernels.decode_attn, q, (ck, cv), pos,
                        mask, 1, repeat=True)


def check_chunk(pos, Sq=128, Smax=1024, H=16, D=64, int8=False):
    """``chunk_attn`` on a bf16 cache, or its int8-cache variant."""
    gen = torch.Generator(device="cuda").manual_seed(pos)
    ck, cv, _ = _caches(1, Smax, H, D, gen)
    q = _qkv_views(1, 1, Sq, H, D, gen)[0][0]
    qpos = pos + torch.arange(Sq, device="cuda")
    mask = (torch.arange(Smax, device="cuda")[None, :]
            <= qpos[:, None])[None, None]                    # [1, 1, Sq, Smax]
    if int8:
        return _cache_check("chunk_attn_int8", kernels.chunk_attn_int8, q,
                            _int8_cache(ck, cv), pos, mask, Sq, repeat=True)
    return _cache_check("chunk_attn", kernels.chunk_attn, q, (ck, cv), pos,
                        mask, Sq, repeat=True)


#: GPT-2 350M's int8 leaves as ``quantize_leaf`` hands them to the
#: kernel: (name, rows, group size) of ``w.reshape(-1, w.shape[-1])``
QUANT_LEAVES = (("wqkv", 24 * 1024 * 3 * 16, 64), ("wo", 24 * 16 * 64, 1024),
                ("wi", 24 * 1024, 4096), ("wo_mlp", 24 * 4096, 1024))
#: fp32 operations per element of the quantizer: |x| and max, subtract,
#: divide, round, two clamps
QUANT_FLOPS = 6


def _quant_err(x, bits, symmetric, seed=None, offsets=True):
    """The kernel's codes, scales (and offsets) against the plain
    version's on the same input: the largest absolute difference, after
    checking that every output is bitwise equal."""
    got = quantize_rows(x, bits, symmetric, seed, offsets)
    ref = _quantize_ref(x, bits, symmetric, seed)
    err = 0.0
    for a, r in zip(got, ref):
        if a is None:
            continue
        err = max(err, (a.float() - r.float()).abs().max().item())
        if not torch.equal(a, r):
            raise AssertionError(
                f"quantizer {tuple(x.shape)} {x.dtype} bits {bits} "
                f"symmetric {symmetric} seed {seed}: not bitwise equal to "
                f"the plain version (max diff {err})")
    return err


def check_quantizer():
    """The ``quantizer`` kernel at GPT-2 350M's four int8 leaves in bf16,
    as the engine quantizes them (symmetric, 8 bits, no offsets): codes
    and scales bitwise equal to the plain version; one row for the four
    launches together first, then one per leaf, then the decode step's
    (:func:`check_quantizer_decode`).  No PyTorch call computes grouped
    absmax quantization (library: none)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, err, ms, plain_ms, nbytes, flops = [], 0.0, 0.0, 0.0, 0, 0
    for name, n_rows, gsize in QUANT_LEAVES:
        x = (torch.randn((n_rows, gsize), generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        e = _quant_err(x, 8, True, offsets=False)
        t = time_ms(lambda i: quantize_rows(x, 8, True, offsets=False), 10)
        tp = time_ms(lambda i: _quantize_ref(x, 8, True), 2)
        b = x.numel() * 3 + n_rows * 4      # bf16 in, int8 codes, fp32 scale
        f = QUANT_FLOPS * x.numel()
        rows.append(_report("quantizer", f"{name} [{n_rows}, {gsize}] bf16 "
                            "symmetric 8-bit", e, 0.0, t, tp, None, b, f,
                            FP32_FLOPS))
        err, ms, plain_ms = max(err, e), ms + t, plain_ms + tp
        nbytes, flops = nbytes + b, flops + f
        del x
    total = _report("quantizer", "GPT-2 350M wqkv+wo+wi+wo_mlp (4 launches) "
                    "bf16 symmetric 8-bit", err, 0.0, ms, plain_ms, None,
                    nbytes, flops, FP32_FLOPS)
    return [total] + rows + [check_quantizer_decode()]


def check_quantizer_decode(slots=8, H=16, D=64):
    """The quantizer at the int8 decode step's shape, where nearly all its
    launches are: one token's K of the 8-slot ``SlotBatcher`` ([8, 1, 16,
    64], 128 groups of 64) through ``quantize_kv`` from the strided view
    of the [8, 1, 3, 16, 64] qkv product, as each layer quantizes its new K
    and V; codes and scales bitwise equal to the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((slots, 1, 3, H, D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k = qkv[:, :, 1]
    codes, scale = quantize_kv(k)
    ref = _quantize_ref(k, 8, True)
    if not (torch.equal(codes, ref[0]) and torch.equal(scale[..., 0], ref[1])):
        raise AssertionError("quantize_kv at the decode step's shape differs "
                             "from the plain version")
    groups = slots * H
    return _report("quantizer", f"decode step: one token's K [{slots}, 1, "
                   f"{H}, {D}] bf16 from the qkv view ({groups} groups of "
                   f"{D}, quantize_kv) symmetric 8-bit", 0.0, 0.0,
                   time_ms(lambda i: quantize_kv(k), 50),
                   time_ms(lambda i: _quantize_ref(k, 8, True), 10), None,
                   groups * D * 3 + groups * 4, QUANT_FLOPS * groups * D,
                   FP32_FLOPS)


#: check_kv_append's cases: (label, B, Sq, S_max, ragged): the int8 decode
#: step of the 8-slot batcher, a ragged extend chunk, profile_generate's
#: prefill (4 prompts of 512)
KV_APPEND_CASES = (("decode step", 8, 1, 1024, True),
                   ("ragged extend chunk", 8, 16, 1024, True),
                   ("prefill", 4, 512, 1024, False))


def check_kv_append(H=16, D=64):
    """``quantize_kv_append``: one launch quantizes a layer's new K and V
    from the strided [B, Sq, 3, H, D] qkv view and writes codes and scales
    into the layer's int8 cache at slots pos + i; the whole cache (codes
    and scales, written slots and the rest) bitwise equal to the plain
    version's at every case of ``KV_APPEND_CASES``.  No PyTorch call
    computes it (library: none)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, B, Sq, Smax, ragged in KV_APPEND_CASES:
        qkv = torch.randn((B, Sq, 3, H, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        rng = np.random.default_rng(B * Sq)
        pos = torch.as_tensor(rng.integers(0, Smax - Sq + 1, B).astype(
            np.int32)).cuda() if ragged else 0
        base = [torch.randint(-127, 128, (B, Smax, H, D), generator=gen,
                              device="cuda", dtype=torch.int8)
                for _ in range(2)]
        base += [torch.rand((B, Smax, H, 1), generator=gen, device="cuda")
                 for _ in range(2)]
        got = [t.clone() for t in base]
        ref = [t.clone() for t in base]
        quantize_kv_into(k, v, got, pos)
        quantize_kv_into_reference(k, v, ref, pos)
        err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(got, ref))
        if not all(torch.equal(a, r) for a, r in zip(got, ref)):
            raise AssertionError(f"quantize_kv_append ({label}) differs "
                                 f"from the plain version (max diff {err})")
        n = B * Sq * H * D * 2                         # K and V elements
        pos_s = pos.tolist() if torch.is_tensor(pos) else pos
        rows.append(_report(
            "quantize_kv_append", f"{label}: K and V [{B}, {Sq}, {H}, {D}] "
            f"bf16 from the qkv view into an int8 cache of S_max {Smax}, pos "
            f"{pos_s}", err, 0.0,
            time_ms(lambda i: quantize_kv_into(k, v, got, pos), 50),
            time_ms(lambda i: quantize_kv_into_reference(k, v, ref, pos), 10),
            None, n * 3 + n // D * 4, QUANT_FLOPS * n, FP32_FLOPS))
    return rows


def check_quantizer_sweep(groups=67):
    """Every input dtype x bits {8, 4, 2} x symmetric/asymmetric x group
    size {1, 64, 100, 1024, 4096, 5000} (8 lanes, a warp and a CTA per
    group), each with an all-zero and a constant group: kernel = plain
    version bitwise, offsets included; then the strided K view of a qkv
    projection through ``quantize_kv``, and stochastic rounding."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for bits in (8, 4, 2):
            for symmetric in (True, False):
                for gsize in (1, 64, 100, 1024, 4096, 5000):
                    x = torch.randn((groups, gsize), generator=gen,
                                    device="cuda") * 3
                    x[1] = 0.0
                    x[2] = 1.5
                    _quant_err(x.to(dt), bits, symmetric)
                    cases += 1
    qkv = torch.randn((2, 37, 3, 16, 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    codes, scale = quantize_kv(qkv[:, :, 1])
    ref = _quantize_ref(qkv[:, :, 1], 8, True)
    if not (torch.equal(codes, ref[0])
            and torch.equal(scale[..., 0], ref[1])):
        raise AssertionError("quantize_kv on a strided K view differs from "
                             "the plain version")
    res = {"deterministic_cases_bitwise": cases + 1}
    x = torch.randn((1000, 1000), generator=gen, device="cuda")
    for symmetric in (True, False):
        det, scale, offset = quantize(x, 1000, 8, symmetric)

        def sr(seed):
            return quantize(x, 1000, 8, symmetric, stochastic=True,
                            generator=torch.Generator(
                                device="cuda").manual_seed(seed))

        a, b, c = sr(1), sr(1), sr(2)
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        differs = not torch.equal(a[0], c[0])
        step = (a[0].int() - det.int()).abs().max().item()
        moved = (a[0] != det).float().mean().item()
        back = kernels.dequantize(a[0], a[1], None if symmetric else a[2])
        bias = ((back - x) / a[1][:, None]).mean().item()
        plain_err = _quant_err(x, 8, symmetric, seed=987654321)
        key = "symmetric" if symmetric else "asymmetric"
        res[key] = {"same_seed_bitwise": same, "other_seed_differs": differs,
                    "max_step_from_deterministic": step,
                    "share_rounded_other_way": moved, "mean_error": bias,
                    "kernel_vs_plain_max_err": plain_err}
        log(f"[quantizer sr] {key} 10^6 elements: same seed bitwise {same}, "
            f"other seed differs {differs}, max step from deterministic "
            f"{step}, share moved {moved:.3f}, mean (deq - x)/scale "
            f"{bias:.2e} (tol 1e-2), kernel = plain (same seed) bitwise")
        if not (same and differs and step <= 1 and abs(bias) <= 0.01):
            raise AssertionError(f"stochastic rounding ({key}): {res[key]}")
    log(f"[quantizer sweep] {cases} cases (bf16/fp16/fp32 x bits 8/4/2 x "
        "symmetric/asymmetric x gsize 1/64/100/1024/4096/5000, zero and "
        "constant groups) and a strided K view: codes, scales, offsets "
        "bitwise equal to the plain version")
    return res


def bert_seq_lens(B, S, rng, short_prob=0.1):
    """The BERT slice's row lengths (Google BERT create_pretraining_data.py,
    short_seq_prob 0.1): a share ``short_prob`` of rows takes a length
    uniform in 5..S, the others S."""
    return np.where(rng.random(B) < 1 - short_prob, S,
                    rng.integers(5, S + 1, B))


def mlm_batch(B, S, vocab, rng, short_prob=0.1):
    """Right-padded MLM traffic: lengths as :func:`bert_seq_lens`; 15% of
    live positions masked ([MASK] = 1) and labelled, -100 elsewhere (pads
    included); token types 0 up to a random split, then 1; ``seq_lens``."""
    lens = bert_seq_lens(B, S, rng, short_prob)
    tokens = rng.integers(3, vocab, (B, S))
    live = np.arange(S)[None, :] < lens[:, None]
    pick = live & (rng.random((B, S)) < 0.15)
    labels = np.where(pick, tokens, -100)
    tokens = np.where(pick, 1, np.where(live, tokens, 0))
    split = rng.integers(1, lens)
    ttype = (np.arange(S)[None, :] >= split[:, None]).astype(np.int64)
    return {"tokens": tokens, "mlm_labels": labels, "token_type_ids": ttype,
            "seq_lens": lens}


def check_flash_kv_lens(B=64, S=128, H=16, D=64):
    """The flash trio at the BERT slice's shape (micro-batch 64, seq 128,
    BERT-large's heads), non-causal with this slice's ragged ``kv_lens``,
    bf16, against the fp32 plain versions; the dk and dv of padding keys
    must be exactly 0.  Plain ms is the plain forward, or the whole plain
    backward; library ms is ``scaled_dot_product_attention`` with the
    expanded [B, 1, 1, S] key-padding mask, forward or its backward.  The
    bound counts the live key rows only (padding rows need not be read)."""
    lens_np = bert_seq_lens(B, S, np.random.default_rng(0))
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    n = 4                                   # 134 MB of inputs: past the L2
    sets = _sparse_sets(n, B, S, H, D, gen)
    scale = 1.0 / math.sqrt(D)
    stats = _forward_stats(lambda q, k, v: kernels.flash_fwd(
        q, k, v, False, scale, lens), sets)
    q, k, v, do = sets[0]
    o, lse, delta = stats[0]
    dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, False, scale,
                              kv_lens=lens)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, False, scale,
                                   kv_lens=lens)
    o32, lse32 = flash_attention_reference(q.float(), k.float(), v.float(),
                                           False, scale, lens)
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), False,
        scale, lens)
    ACCEL.synchronize()
    fwd_err = (o.float() - o32).abs().max().item()
    fwd_tol = BF16_REL_TOL * max(1.0, o32.abs().max().item())
    lse_err = (lse - lse32).abs().max().item()
    errs = [(a.float() - r).abs().max().item() for a, r in zip((dq, dk, dv), ref)]
    tols = [BF16_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
    pad = torch.arange(S, device="cuda")[None, :] >= lens[:, None]
    pad_zero = not (dk[pad].any() or dv[pad].any())
    del o32, lse32, ref
    if not (lse_err <= 1e-3 and pad_zero):
        raise AssertionError(f"flash kv_lens: lse err {lse_err}, padding "
                             f"dk/dv zero {pad_zero}")
    ms_fwd = time_ms(lambda i: kernels.flash_fwd(*sets[i % n][:3], False,
                                                 scale, lens), 20)
    ms_dq = time_ms(_bwd_runner(kernels.flash_bwd_dq, sets, stats, False,
                                scale, None, lens), 20)
    ms_dkv = time_ms(_bwd_runner(kernels.flash_bwd_dkv, sets, stats, False,
                                 scale, None, lens), 20)
    plain_fwd = eager_ms(lambda: flash_attention_reference(
        q, k, v, False, scale, lens), 5)
    plain_bwd = eager_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, False, scale, lens), 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kmask = (~pad)[:, None, None, :]
    lib_fwd = time_ms(lambda i: sdpa(*(t.transpose(1, 2) for t in sets[i % n][:3]),
                                     attn_mask=kmask), 20)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=kmask)
    lib_bwd = eager_ms(lambda: torch.autograd.grad(out, leaves,
                                                   do.transpose(1, 2),
                                                   retain_graph=True), 20)
    del out, leaves
    live = int(lens_np.sum())
    pairs = H * S * live                    # every query row sees its row's keys
    elem = B * S * H * D * 2                # one bf16 [B, S, H, D]
    live_kv = live * H * D * 2              # one bf16 K or V, live rows
    stat_bytes = B * H * S * 4
    shape = (f"B{B} S{S} H{H} D{D} bf16 non-causal, kv_lens "
             f"({int((lens_np < S).sum())} short rows, {live} live keys)")
    log(f"[flash kv_lens] {shape}: lse err {lse_err:.2e} (tol 1e-3), padding "
        f"keys' dk and dv exactly 0 {pad_zero}")
    return [_report("flash_fwd", shape, fwd_err, fwd_tol, ms_fwd, plain_fwd,
                    lib_fwd, 2 * elem + 2 * live_kv + stat_bytes,
                    4 * D * pairs),
            _report("flash_bwd_dq", shape, errs[0], tols[0], ms_dq, plain_bwd,
                    lib_bwd, 3 * elem + 2 * live_kv + 2 * stat_bytes,
                    6 * D * pairs),
            _report("flash_bwd_dkv", shape, max(errs[1:]), min(tols[1:]),
                    ms_dkv, plain_bwd, lib_bwd,
                    4 * elem + 2 * live_kv + 2 * stat_bytes, 8 * D * pairs)]


def check_kv_lens_sweep(H=2):
    """Every dtype and head dim the flash trio is built for, with lengths
    0 (clamped to 1), 1, a partial tile, both sides of and on a 64-key
    tile edge and S, causal or not, at S 128 and 129: forward and backward
    within the sweep's relative tolerance, lse within 1e-3, and the dk and
    dv of padding keys exactly 0."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        for D in HEAD_DIMS:
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device="cuda").to(dt)
            scale = 1.0 / math.sqrt(D)
            err, lse_err = 0.0, 0.0
            for S, causal in ((128, False), (128, True), (129, False),
                              (129, True)):
                lens = torch.tensor([0, 1, 37, 63, 64, 65, S],
                                    dtype=torch.int32, device="cuda")
                B = len(lens)
                pad = (torch.arange(S, device="cuda")[None, :]
                       >= lens.clamp(min=1)[:, None])
                q, k, v, do = (rnd(B, S, H, D) for _ in range(4))
                o, lse = kernels.flash_fwd(q, k, v, causal, scale, lens)
                _, delta = aligned_do_and_delta(do, o)
                dq, dk, dv = _backward_kernels(q, k, v, do, lse, delta,
                                               causal, scale, kv_lens=lens)
                o32, lse32 = flash_attention_reference(
                    q.float(), k.float(), v.float(), causal, scale, lens)
                ref = flash_attention_backward_reference(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    do.float(), causal, scale, lens)
                outs = (o, dq, dk, dv)
                if not all(torch.isfinite(t).all() for t in outs):
                    raise AssertionError(f"kv_lens sweep {dt} D{D}: non-finite")
                if dk[pad].any() or dv[pad].any():
                    raise AssertionError("kv_lens sweep: padding dk/dv != 0")
                err = max(err, *(((a.float() - r).abs().max()
                                  / r.abs().max().clamp(min=1.0)).item()
                                 for a, r in zip(outs, (o32, *ref))))
                lse_err = max(lse_err, (lse - lse32).abs().max().item())
            worst[f"{str(dt)[6:]} D{D}"] = err
            log(f"[kv_lens sweep] {str(dt)[6:]} D{D}: lens "
                f"{lens.tolist()[:-1]} and S of S 128 and 129, causal and "
                f"not: worst relative "
                f"err {err:.3e} (tol {tol:.0e}), lse err {lse_err:.2e} (tol "
                f"1e-3), padding keys' dk and dv zero")
            if not (err <= tol and lse_err <= 1e-3):
                raise AssertionError(f"kv_lens sweep {dt} D{D}: err {err}, "
                                     f"lse err {lse_err}")
    return worst


#: kernel vs fp32 plain tolerance of the sweep, per input dtype (times
#: max(1, |ref|)): a few half-ulps of the output's rounding
SWEEP_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def check_sweep(S=300, Sq=7, B=3, H=2):
    """Every dtype and head dim the kernels are built for, over every
    frontier: ``decode_attn`` and ``chunk_attn`` at each pos in
    0..S-Sq-1 with ragged per-row positions (frontiers that split a
    warp's key groups once hung ``decode_attn``), and their int8-cache
    variants on the same cache quantized (against the plain version on
    the dequantized cache), ``flash_fwd`` at an odd width, and the flash
    backward pair at ``BWD_SWEEP``.  Returns the worst error per (dtype,
    D)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        for D in HEAD_DIMS:
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device="cuda").to(dt)
            ck, cv = rnd(B, S, H, D), rnd(B, S, H, D)
            q1, qc = rnd(B, 1, H, D), rnd(B, Sq, H, D)
            err = torch.zeros((), device="cuda")
            err8 = torch.zeros((), device="cuda")
            scale = 1.0 / math.sqrt(D)
            (kq, ks), (vq, vs) = quantize_kv(ck), quantize_kv(cv)
            k8, v8 = (dequantize_kv(kq, ks, torch.float32),
                      dequantize_kv(vq, vs, torch.float32))
            for p in range(S - Sq):
                pos = torch.tensor([p, (p * 7) % (S - Sq), S - Sq - 1 - p],
                                   dtype=torch.int32, device="cuda")
                for kernel, q in ((kernels.decode_attn, q1),
                                  (kernels.chunk_attn, qc)):
                    ref = cached_attention_reference(
                        q.float(), ck.float(), cv.float(), pos, scale)
                    out = kernel(q, ck, cv, pos, scale).float()
                    err = torch.maximum(err, (out - ref).abs().max()
                                        / ref.abs().max().clamp(min=1.0))
                for kernel, q in ((kernels.decode_attn_int8, q1),
                                  (kernels.chunk_attn_int8, qc)):
                    ref = cached_attention_reference(q.float(), k8, v8, pos,
                                                     scale)
                    out = kernel(q, kq, vq, pos, scale, ks, vs).float()
                    err8 = torch.maximum(err8, (out - ref).abs().max()
                                         / ref.abs().max().clamp(min=1.0))
            qf, kf, vf = rnd(2, 77, 3, D), rnd(2, 77, 3, D), rnd(2, 77, 3, D)
            of, lse = kernels.flash_fwd(qf, kf, vf, True, scale)
            rf, rl = flash_attention_reference(qf.float(), kf.float(),
                                               vf.float(), True, scale)
            err = torch.maximum(err, (of.float() - rf).abs().max()
                                / rf.abs().max().clamp(min=1.0))
            lse_err = (lse - rl).abs().max().item()
            bwd_err = max(_bwd_sweep_err(rnd, Sq_, Sk_, D, causal)
                          for Sq_, Sk_, causal in BWD_SWEEP)
            worst[f"{str(dt)[6:]} D{D}"] = max(err.item(), bwd_err)
            worst[f"{str(dt)[6:]} D{D} int8 cache"] = err8.item()
            log(f"[sweep] {str(dt)[6:]} D{D}: pos 0..{S - Sq - 1} ragged, "
                f"worst relative err {err.item():.3e}, int8 cache "
                f"{err8.item():.3e} (tol {tol:.0e}), "
                f"flash lse err {lse_err:.2e} (tol 1e-3); flash forward and "
                f"backward {BWD_SWEEP} worst relative err {bwd_err:.3e} (tol "
                f"{tol:.0e}), lse within 1e-3, no-key rows zero")
            if not (err.item() <= tol and err8.item() <= tol
                    and lse_err <= 1e-3 and bwd_err <= tol):
                raise AssertionError(f"sweep {dt} D{D}: err {err.item()} "
                                     f"int8 err {err8.item()} "
                                     f"lse err {lse_err} bwd err {bwd_err}")
    return worst


#: chunk lengths of the chunk sweep: one q-tile short, full less one, one
#: row into the second tile, one row into the third
CHUNK_SWEEP_SQ = (7, 63, 65, 129)


def check_chunk_sweep(Smax=576, B=3, H=2):
    """``chunk_attn`` and ``chunk_attn_int8`` at the edges of
    ``chunk_attn_tc``'s tiles (64 queries, 64 keys) and of its key split
    over a cluster: every dtype and head dim, each chunk length of
    ``CHUNK_SWEEP_SQ``, at pos 0 (a single live k-tile, fewer than the
    cluster's ranks), pos + Sq = S_max, and ragged per-row positions (one
    row at 0, one at the end); on the 16-bit cache and on its int8 form,
    against the fp32 plain version (of the dequantized cache for int8).
    S_max 576 is 9 k-tiles: clusters of 8 ranks at Sq 7 and 65, 4 at 129.
    Returns the worst relative error per dtype and cache."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        err = {"cache": torch.zeros((), device="cuda"),
               "int8 cache": torch.zeros((), device="cuda")}
        for D in HEAD_DIMS:
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device="cuda").to(dt)
            ck, cv = rnd(B, Smax, H, D), rnd(B, Smax, H, D)
            (kq, ks), (vq, vs) = quantize_kv(ck), quantize_kv(cv)
            k8, v8 = (dequantize_kv(kq, ks, torch.float32),
                      dequantize_kv(vq, vs, torch.float32))
            scale = 1.0 / math.sqrt(D)
            for Sq in CHUNK_SWEEP_SQ:
                q = rnd(B, Sq, H, D)
                ragged = torch.tensor([0, Smax - Sq, (Smax - Sq) // 2 + 3],
                                      dtype=torch.int32, device="cuda")
                for pos in (0, Smax - Sq, ragged):
                    for key, out, kf, vf in (
                            ("cache", kernels.chunk_attn(q, ck, cv, pos, scale),
                             ck.float(), cv.float()),
                            ("int8 cache", kernels.chunk_attn_int8(
                                q, kq, vq, pos, scale, ks, vs), k8, v8)):
                        ref = cached_attention_reference(q.float(), kf, vf,
                                                         pos, scale)
                        err[key] = torch.maximum(
                            err[key], (out.float() - ref).abs().max()
                            / ref.abs().max().clamp(min=1.0))
        for key, e in err.items():
            worst[f"{str(dt)[6:]} {key}"] = e.item()
        log(f"[chunk sweep] {str(dt)[6:]} D{HEAD_DIMS} Sq {CHUNK_SWEEP_SQ} "
            f"S_max {Smax}, pos 0 / S_max - Sq / ragged: worst relative err "
            f"{err['cache'].item():.3e}, int8 cache "
            f"{err['int8 cache'].item():.3e} (tol {tol:.0e})")
        if not max(e.item() for e in err.values()) <= tol:
            raise AssertionError(f"chunk sweep {dt}: {worst}")
    return worst


# ------------------------------------------------- band and ALiBi options

#: GPT-Neo's local window (HF ``window_size``)
OPTION_WINDOW = 256
#: the options' rows may not take more than this share of the unbanded
#: kernel's time at the same shape: the band is skipped, not just masked
BAND_SKIP_RATIO = 0.5


def _option_mask(q_abs, Smax, dtype, window=None, slopes=None):
    """The options as SDPA's explicit float mask [B|1, H|1, Sq, Smax]:
    ``-slope·dist`` (0 without slopes) where key j is visible to a query
    at ``q_abs`` ([B|1, Sq]): 0 <= dist < window; -inf elsewhere."""
    dist = (q_abs[:, :, None]
            - torch.arange(Smax, device=q_abs.device)).float()[:, None]
    vis = dist >= 0
    if window is not None:
        vis &= dist < window
    bias = torch.zeros_like(dist) if slopes is None else \
        -slopes.view(1, -1, 1, 1) * dist
    return bias.masked_fill(~vis, float("-inf")).to(dtype)


def check_flash_window(B=4, S=2048, H=16, D=128, window=OPTION_WINDOW):
    """``flash_fwd`` with a window at GPT-Neo 1.3B's prefill heads against
    the fp32 plain version, two launches bitwise equal, beside the causal
    kernel at the same shape (the band's tiles are skipped: at most
    ``BAND_SKIP_RATIO`` of its time) and SDPA with the band as a float
    mask."""
    gen = torch.Generator(device="cuda").manual_seed(S + window)
    sets = _qkv_views(2, B, S, H, D, gen)
    q, k, v = sets[0]
    scale = 1.0 / math.sqrt(D)
    o, lse = kernels.flash_fwd(q, k, v, True, scale, window=window)
    same = bool(torch.equal(o, kernels.flash_fwd(q, k, v, True, scale,
                                                 window=window)[0]))
    o32, lse32 = flash_attention_reference(q.float(), k.float(), v.float(),
                                           True, scale, window=window)
    ACCEL.synchronize()
    err = (o.float() - o32).abs().max().item()
    lse_err = (lse - lse32).abs().max().item()
    del o32, lse32
    log(f"[flash_fwd window repeat] B{B} S{S} window {window}: two launches "
        f"bitwise equal {same}; lse err {lse_err:.2e} (tol 1e-3)")
    if not same or not lse_err <= 1e-3:
        raise AssertionError("flash_fwd window: launches differ or lse off")
    tol = BF16_REL_TOL * max(1.0, o.float().abs().max().item())
    ms = time_ms(lambda i: kernels.flash_fwd(*sets[i % 2], True, scale,
                                             window=window), 20)
    causal_ms = time_ms(lambda i: kernels.flash_fwd(*sets[i % 2], True,
                                                    scale), 20)
    plain_ms = time_ms(lambda i: flash_attention_reference(
        *sets[i % 2], True, scale, window=window), 3)
    mask = _option_mask(torch.arange(S, device="cuda")[None], S,
                        torch.bfloat16, window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda i: sdpa(*(t.transpose(1, 2) for t in sets[i % 2]),
                                    attn_mask=mask), 10)
    pairs = B * H * sum(min(i + 1, window) for i in range(S))
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4
    row = _report("flash_fwd[window]",
                  f"B{B} S{S} H{H} D{D} bf16 causal window {window}", err,
                  tol, ms, plain_ms, lib_ms, nbytes, 4 * D * pairs)
    row.update(unbanded_ms=causal_ms, vs_unbanded=ms / causal_ms)
    log(f"[flash_fwd window] B{B} S{S} H{H} D{D} window {window}: "
        f"{ms:.4f} ms against the causal kernel's {causal_ms:.4f} ms "
        f"({ms / causal_ms:.3f}x; at most {BAND_SKIP_RATIO}x)")
    if not ms <= BAND_SKIP_RATIO * causal_ms:
        raise AssertionError("flash_fwd window: the band is not skipped")
    return row


def check_flash_bwd_window(B=8, S=2048, H=16, D=128, window=OPTION_WINDOW):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` with a window at GPT-Neo
    1.3B's training shape (micro-batch 8 at seq 2048) against the fp32
    plain backward, from bf16 q, k, v (views of [B, S, 3, H, D]), dO and
    the windowed forward's O and lse; two launches of each bitwise equal;
    beside the causal kernels at the same shape (each windowed kernel at
    most ``BAND_SKIP_RATIO`` of its causal kernel's time: the tiles outside
    the band are skipped, not masked) and SDPA's backward with the band as
    a float mask.  Plain ms is the whole plain backward (dq, dk and dv)."""
    gen = torch.Generator(device="cuda").manual_seed(S + 3 * window)
    scale = 1.0 / math.sqrt(D)
    sets, causal_sets = [], []
    for q, k, v in _qkv_views(2, B, S, H, D, gen):
        do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        for out, w in ((sets, window), (causal_sets, None)):
            o, lse = kernels.flash_fwd(q, k, v, True, scale, window=w)
            out.append((q, k, v, do, o, lse,
                        aligned_do_and_delta(do, o)[1]))
    q, k, v, do, o, lse, delta = sets[0]
    bwd = (q, k, v, do, lse, delta, True, scale)
    dq = kernels.flash_bwd_dq(*bwd, window=window)
    dk, dv = kernels.flash_bwd_dkv(*bwd, window=window)
    dk2, dv2 = kernels.flash_bwd_dkv(*bwd, window=window)
    same = {"flash_bwd_dq": bool(torch.equal(
                dq, kernels.flash_bwd_dq(*bwd, window=window))),
            "flash_bwd_dkv": bool(torch.equal(dk, dk2)
                                  and torch.equal(dv, dv2))}
    del dk2, dv2
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), True,
        scale, window=window)
    ACCEL.synchronize()
    errs = [(a.float() - r).abs().max().item() for a, r in zip((dq, dk, dv), ref)]
    tols = [BF16_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
    del ref
    log(f"[flash_bwd window repeat] B{B} S{S} window {window}: two launches "
        f"give bitwise equal dq {same['flash_bwd_dq']}, dk and dv "
        f"{same['flash_bwd_dkv']}")
    if not all(same.values()):
        raise AssertionError(f"flash backward window: launches differ {same}")

    def kernel(fn, group, w):
        def run(i):
            q_, k_, v_, do_, _, lse_, delta_ = group[i % 2]
            return fn(q_, k_, v_, do_, lse_, delta_, True, scale, window=w)
        return run

    ms = {name: time_ms(kernel(getattr(kernels, name), sets, window), 10)
          for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    causal_ms = {name: time_ms(kernel(getattr(kernels, name), causal_sets,
                                      None), 10)
                 for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    plain_ms = eager_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, True, scale, window=window), 2, warmup=1)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    mask = _option_mask(torch.arange(S, device="cuda")[None], S,
                        torch.bfloat16, window)
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           attn_mask=mask)
    gout = do.transpose(1, 2)
    lib_ms = eager_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                  retain_graph=True), 5)
    del out, leaves
    # the live band's pairs (62,930,944 at the default shape), not the
    # causal triangle's
    pairs = B * H * sum(min(i + 1, window) for i in range(S))
    elem = B * S * H * D * 2                          # one bf16 [B, S, H, D]
    stats = 2 * B * H * S * 4                         # lse and delta, fp32
    shape = f"B{B} S{S} H{H} D{D} bf16 causal window {window}"
    rows = [_report("flash_bwd_dq[window]", shape, errs[0], tols[0],
                    ms["flash_bwd_dq"], plain_ms, lib_ms, 5 * elem + stats,
                    6 * D * pairs),
            _report("flash_bwd_dkv[window]", shape, max(errs[1:]),
                    min(tols[1:]), ms["flash_bwd_dkv"], plain_ms, lib_ms,
                    6 * elem + stats, 8 * D * pairs)]
    causal_pairs = B * H * S * (S + 1) // 2
    for row, name, per_pair in zip(rows, ("flash_bwd_dq", "flash_bwd_dkv"),
                                   (6, 8)):
        c_ms = causal_ms[name]
        c_bound = per_pair * D * causal_pairs / BF16_FLOPS * 1e3
        row.update(unbanded_ms=c_ms, vs_unbanded=row["ms"] / c_ms,
                   live_pairs=pairs, unbanded_bound_ms=c_bound)
        log(f"[{name} window] B{B} S{S} H{H} D{D} window {window}: "
            f"{row['ms']:.4f} ms against the causal kernel's {c_ms:.4f} ms "
            f"at the same shape ({row['ms'] / c_ms:.3f}x; at most "
            f"{BAND_SKIP_RATIO}x); {pairs} visible pairs; causal bound "
            f"{c_bound:.4f} ms (operations)")
        if not row["ms"] <= BAND_SKIP_RATIO * c_ms:
            raise AssertionError(f"{name} window: the band is not skipped")
    return rows


def check_decode_option(option, int8=False):
    """``decode_attn`` (or with ``int8`` its int8-cache variant) with one
    option, two launches bitwise equal, against the fp32 plain version,
    SDPA under the option as a float mask as yardstick: ``"window"`` at
    GPT-Neo 1.3B's heads (B8 S_max 2048 H16 D128, window 256), every row
    within 64 slots of S_max, beside the unbanded kernel at the same
    positions (at most ``BAND_SKIP_RATIO`` of its time); ``"alibi"`` at
    BLOOM-560m's heads (B8 S_max 1024 H16 D64) at ragged positions."""
    B, Smax, H, D = (8, 2048, 16, 128) if option == "window" else \
        (8, 1024, 16, 64)
    gen = torch.Generator(device="cuda").manual_seed(13)
    ck, cv, _ = _caches(B, Smax, H, D, gen)
    rng = np.random.default_rng(4)
    host = rng.integers(Smax - 64, Smax, B) if option == "window" else \
        rng.integers(0, Smax, B)
    pos = torch.as_tensor(host.astype(np.int32)).cuda()
    q = _qkv_views(1, B, 1, H, D, gen)[0][0]
    window = OPTION_WINDOW if option == "window" else None
    slopes = gpt.alibi_slopes(H, "cuda") if option == "alibi" else None
    mask = _option_mask(pos.long()[:, None], Smax, q.dtype, window, slopes)
    cache = _int8_cache(ck, cv) if int8 else (ck, cv)
    base = "decode_attn_int8" if int8 else "decode_attn"
    kernel = getattr(kernels, base)
    row = _cache_check(f"{base}[{option}]", kernel, q, cache, pos, mask, 1,
                       repeat=True, window=window, slopes=slopes)
    if option == "window":
        _band_ratio(row, kernel, q, cache, pos)
    return row


def _band_ratio(row, kernel, q, cache, pos, gate=True):
    """Time the unbanded kernel on the row's inputs; with ``gate``, fail
    unless the banded one took at most ``BAND_SKIP_RATIO`` of it."""
    kv = cache[2:] if len(cache) == 6 else cache
    L, scale = kv[0].shape[0], 1.0 / math.sqrt(q.shape[-1])

    def run(i):
        layer = [t[i % L] for t in kv]
        return kernel(q, *layer[:2], pos, scale, *layer[2:])

    full_ms = time_ms(run, 50)
    row.update(unbanded_ms=full_ms, vs_unbanded=row["ms"] / full_ms)
    log(f"[{row['name']}] {row['ms']:.4f} ms against the unbanded kernel's "
        f"{full_ms:.4f} ms at the same positions ({row['ms'] / full_ms:.3f}x"
        + (f"; at most {BAND_SKIP_RATIO}x)" if gate else "; reported)"))
    if gate and not row["ms"] <= BAND_SKIP_RATIO * full_ms:
        raise AssertionError(f"{row['name']}: the band is not skipped")


def check_chunk_option(option, int8=False, Sq=128):
    """``chunk_attn`` (or its int8-cache variant) with one option: an
    ``extend`` chunk of 128 at the serving ticks' head shapes, ``"window"``
    at S_max 2048 H16 D128 pos 1500 (beside the unbanded kernel, reported:
    32 units of a few k-tiles each, the launch's fixed latency is most of
    either time), ``"alibi"`` at S_max 1024 H16 D64 pos 640; two launches
    bitwise equal."""
    Smax, H, D, pos = (2048, 16, 128, 1500) if option == "window" else \
        (1024, 16, 64, 640)
    gen = torch.Generator(device="cuda").manual_seed(pos)
    ck, cv, _ = _caches(1, Smax, H, D, gen)
    q = _qkv_views(1, 1, Sq, H, D, gen)[0][0]
    window = OPTION_WINDOW if option == "window" else None
    slopes = gpt.alibi_slopes(H, "cuda") if option == "alibi" else None
    q_abs = (pos + torch.arange(Sq, device="cuda"))[None]
    mask = _option_mask(q_abs, Smax, q.dtype, window, slopes)
    cache = _int8_cache(ck, cv) if int8 else (ck, cv)
    base = "chunk_attn_int8" if int8 else "chunk_attn"
    kernel = getattr(kernels, base)
    row = _cache_check(f"{base}[{option}]", kernel, q, cache, pos, mask, Sq,
                       repeat=True, window=window, slopes=slopes)
    if option == "window":
        _band_ratio(row, kernel, q, cache, pos, gate=False)
    return row


#: the sweep's windows: the diagonal only, the edges of a 64-key tile, the
#: model's, and one past every position (plain causal)
SWEEP_WINDOWS = (1, 63, 64, 65, OPTION_WINDOW, None)
#: the flash sweep's lengths: the edges of the 64-key and 128-query tiles
#: (and of dK/dV's 128-key and 32- or 64-query tiles)
OPTION_FLASH_S = (63, 64, 65, 127, 129, 257)
#: the flash sweep's cross-length shapes (Sq, Sk), Sq < Sk: a band that
#: starts inside the first tile, and one whose rows all sit past a tile
OPTION_FLASH_CROSS = ((65, 129), (100, 257))
#: the option sweep's chunk lengths
OPTION_CHUNK_SQ = (7, 65, 129)


def check_option_sweep(Smax=300, B=3):
    """The band and ALiBi options at every dtype and head dim the kernels
    take: ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at each
    tile-edge length and at ``OPTION_FLASH_CROSS`` with each window of
    ``SWEEP_WINDOWS`` (None: Sk + 5, past every row; O, lse, dq, dk and
    dv, the backward from the kernel's own O and lse), and
    ``decode_attn``, ``chunk_attn`` (Sq 7, 65, 129) and their int8-cache
    variants at ragged positions (row 0 at pos 0, one at the cache's end)
    with each window, and with the slopes of 6 and of 16 heads; against
    the fp32 plain version.  Returns the worst relative error per dtype."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        err = torch.zeros((), device="cuda")
        lse_err = 0.0
        rnd = lambda *shape: torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)

        def track(out, ref):
            nonlocal err
            err = torch.maximum(err, (out.float() - ref).abs().max()
                                / ref.abs().max().clamp(min=1.0))

        for D in HEAD_DIMS:
            scale = 1.0 / math.sqrt(D)
            for Sq, Sk in [(S, S) for S in OPTION_FLASH_S] + \
                    list(OPTION_FLASH_CROSS):
                q, do = rnd(2, Sq, 2, D), rnd(2, Sq, 2, D)
                k, v = rnd(2, Sk, 2, D), rnd(2, Sk, 2, D)
                for w in SWEEP_WINDOWS:
                    w = w or Sk + 5
                    o, lse = kernels.flash_fwd(q, k, v, True, scale, window=w)
                    ref, rl = flash_attention_reference(
                        q.float(), k.float(), v.float(), True, scale,
                        window=w)
                    track(o, ref)
                    lse_err = max(lse_err, (lse - rl).abs().max().item())
                    do_, delta = aligned_do_and_delta(do, o)
                    grads = _backward_kernels(q, k, v, do_, lse, delta, True,
                                              scale, window=w)
                    for g, r in zip(grads, flash_attention_backward_reference(
                            q.float(), k.float(), v.float(), o.float(), lse,
                            do.float(), True, scale, window=w)):
                        track(g, r)
            for H, opts in ((2, [{"window": w or Smax + 5}
                                 for w in SWEEP_WINDOWS]),
                            (6, [{"slopes": gpt.alibi_slopes(6, "cuda")}]),
                            (16, [{"slopes": gpt.alibi_slopes(16, "cuda")},
                                  {"slopes": gpt.alibi_slopes(16, "cuda"),
                                   "window": 65}])):
                ck, cv = rnd(B, Smax, H, D), rnd(B, Smax, H, D)
                (kq, ks), (vq, vs) = quantize_kv(ck), quantize_kv(cv)
                k8, v8 = (dequantize_kv(kq, ks, torch.float32),
                          dequantize_kv(vq, vs, torch.float32))
                for Sq in (1,) + OPTION_CHUNK_SQ:
                    q = rnd(B, Sq, H, D)
                    pos = torch.tensor([0, Smax - Sq, (Smax - Sq) // 2 + 3],
                                       dtype=torch.int32, device="cuda")
                    pair = (kernels.decode_attn, kernels.decode_attn_int8) \
                        if Sq == 1 else (kernels.chunk_attn,
                                         kernels.chunk_attn_int8)
                    for opt in opts:
                        track(pair[0](q, ck, cv, pos, scale, **opt),
                              cached_attention_reference(
                                  q.float(), ck.float(), cv.float(), pos,
                                  scale, **opt))
                        track(pair[1](q, kq, vq, pos, scale, ks, vs, **opt),
                              cached_attention_reference(
                                  q.float(), k8, v8, pos, scale, **opt))
        worst[str(dt)[6:]] = err.item()
        log(f"[option sweep] {str(dt)[6:]} D{HEAD_DIMS}: flash_fwd, "
            f"flash_bwd_dq and flash_bwd_dkv at S {OPTION_FLASH_S} and "
            f"(Sq, Sk) {OPTION_FLASH_CROSS} x window {SWEEP_WINDOWS} (None: "
            f"past every row); decode/chunk Sq {(1,) + OPTION_CHUNK_SQ} S_max {Smax} "
            f"ragged pos, bf16 and int8 cache, each window, ALiBi at H 6 and "
            f"16 (and with window 65): worst relative err {err.item():.3e} "
            f"(tol {tol:.0e}), flash lse err {lse_err:.2e} (tol 1e-3)")
        if not (err.item() <= tol and lse_err <= 1e-3):
            raise AssertionError(f"option sweep {dt}: err {err.item()}, "
                                 f"lse err {lse_err}")
    return worst



#: (Sq, Sk, causal) of the backward sweep: odd, cross-length, Sq > Sk
#: (rows with no visible key), full; then the edges of the tensor-core
#: kernels' tiles (64 keys, 128 queries in the forward and flash_bwd_dq;
#: 128 keys, 64 or 32 queries in flash_bwd_dkv), Sq > Sk by more than a
#: tile, and the edges of the second 128-query tile (Sq 255, 257)
BWD_SWEEP = ((77, 77, True), (40, 100, True), (100, 40, True),
             (77, 77, False), (63, 63, True), (64, 64, False),
             (65, 65, True), (127, 127, True), (129, 129, False),
             (129, 129, True), (65, 129, True), (129, 63, True),
             (255, 255, True), (257, 257, True), (257, 255, False))


def _backward_kernels(q, k, v, do, lse, delta, causal, scale, **kw):
    """(dq, dk, dv) from the backward pair, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``, at every head dim (the fused kernel is swept by
    ``check_bwd_fused_sweep``)."""
    return (kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, **kw),
            *kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                   **kw))


def _bwd_sweep_err(rnd, Sq, Sk, D, causal, B=2, H=3):
    """Worst relative error of O, dq, dk, dv against the fp32 plain
    forward and backward; raises on an lse off by more than 1e-3, a
    non-finite gradient or a non-zero gradient of a row that sees no
    key."""
    q, do = rnd(B, Sq, H, D), rnd(B, Sq, H, D)
    k, v = rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    scale = 1.0 / math.sqrt(D)
    o, lse = kernels.flash_fwd(q, k, v, causal, scale)
    o32, lse32 = flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal, scale)
    fin = torch.isfinite(lse32)
    if not (torch.equal(torch.isfinite(lse), fin) and
            (lse[fin] - lse32[fin]).abs().max().item() <= 1e-3):
        raise AssertionError(f"flash_fwd Sq{Sq} Sk{Sk} D{D}: lse off")
    fwd_err = ((o.float() - o32).abs().max()
               / o32.abs().max().clamp(min=1.0)).item()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = _backward_kernels(q, k, v, do, lse, delta, causal, scale)
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal,
        scale)
    if not all(torch.isfinite(t).all() for t in (dq, dk, dv)):
        raise AssertionError(f"flash backward Sq{Sq} Sk{Sk} D{D}: non-finite")
    if causal and Sq > Sk and dq[:, :Sq - Sk].any():
        raise AssertionError("flash backward: a row with no key has dq != 0")
    return max(fwd_err, *(((a.float() - r).abs().max()
                           / r.abs().max().clamp(min=1.0)).item()
                          for a, r in zip((dq, dk, dv), ref)))


# ----------------------------------------------- the fused backward

#: ``flash_bwd_fused`` may take at most this share of the pair's time
#: (``flash_bwd_dq`` + ``flash_bwd_dkv``) at the shapes where it replaces
#: the pair on a main path: GPT-2 350M's step and GPT-Neo 1.3B's global
#: and local layers
FUSED_BWD_RATIO = 1.0
#: its check shapes (B, S, H, D, causal, window, ragged kv_lens, gated by
#: FUSED_BWD_RATIO): GPT-2 350M's step, GPT-Neo 1.3B's global and local
#: layers, the dense comparison at seq 4096, BERT-large's ragged batch
FUSED_BWD_SHAPES = ((16, 1024, 16, 64, True, None, False, True),
                    (8, 2048, 16, 128, True, None, False, True),
                    (8, 2048, 16, 128, True, OPTION_WINDOW, False, True),
                    (4, 4096, 16, 64, True, None, False, False),
                    (64, 128, 16, 64, False, None, True, False))
#: launches held bitwise equal at GPT-2 350M's and GPT-Neo 1.3B's global
#: layers' shapes (B, S, H, D, causal, window; two elsewhere)
FUSED_REPEATS = 20
FUSED_REPEAT_SHAPES = ((16, 1024, 16, 64, True, None),
                       (8, 2048, 16, 128, True, None))


def _batch_rows(fn, *args, **kw):
    """``fn(*args, **kw)`` one batch row at a time, its outputs
    concatenated: every tensor argument is batch-first and is cut to the
    row, the others pass as they are (one row's fp32 scores at S 4096 H
    16 are 1 GiB)."""
    def cut(a, i):
        return a[i:i + 1] if isinstance(a, torch.Tensor) else a
    B = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    parts = [fn(*(cut(a, i) for a in args),
                **{name: cut(a, i) for name, a in kw.items()})
             for i in range(B)]
    return [torch.cat(p) for p in zip(*parts)]


def _plain_bwd(q, k, v, o, lse, do, causal, scale, lens=None, window=None):
    """The fp32 plain flash backward of bf16 inputs, row by row."""
    return _batch_rows(flash_attention_backward_reference, q.float(),
                       k.float(), v.float(), o.float(), lse, do.float(),
                       causal, scale, kv_lens=lens, window=window)


def _sm_clock_hz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def check_flash_bwd_fused(B, S, H, D, causal, window, ragged, gated):
    """``flash_bwd_fused`` at one of ``FUSED_BWD_SHAPES`` against the fp32
    plain backward, from bf16 q, k, v (views of [B, S, 3, H, D]), dO and
    the forward kernel's O and lse; ``FUSED_REPEATS`` launches bitwise
    equal at ``FUSED_REPEAT_SHAPES``, two elsewhere; the padding keys' dk
    and dv exactly 0 under ``kv_lens``.  Times the pair (``flash_bwd_dq`` +
    ``flash_bwd_dkv``) on the same inputs, in turns with the fused kernel,
    and SDPA's backward (causal, the band as a float mask, or the
    key-padding mask) as the library yardstick; with ``gated``, fails
    unless the fused kernel takes at most ``FUSED_BWD_RATIO`` of the
    pair's time.  One launch sums the cycles its
    CTAs waited for their turn in the ordered dq sum; their share of the
    kernel's SM-cycles (SMs x top clock x kernel time) is reported.  Plain
    ms is the whole plain backward, row by row."""
    gen = torch.Generator(device="cuda").manual_seed(11 * B + S + (window or 0))
    scale = 1.0 / math.sqrt(D)
    lens = None
    if ragged:
        lens = torch.as_tensor(bert_seq_lens(B, S, np.random.default_rng(0)),
                               dtype=torch.int32, device="cuda")
    n = max(2, min(8, (120 << 20) // (4 * B * S * H * D * 2)))
    sets = []
    for q, k, v in _qkv_views(n, B, S, H, D, gen):
        do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        o, lse = kernels.flash_fwd(q, k, v, causal, scale, lens, window)
        sets.append((q, k, v, do, o, lse, aligned_do_and_delta(do, o)[1]))
    q, k, v, do, o, lse, delta = sets[0]
    kw = {"kv_lens": lens, "window": window}
    bwd = (q, k, v, do, lse, delta, causal, scale)
    wait = torch.zeros(1, dtype=torch.int64, device="cuda")
    grads = kernels.flash_bwd_fused(*bwd, wait_cycles=wait, **kw)
    repeats = FUSED_REPEATS if (B, S, H, D, causal, window) in \
        FUSED_REPEAT_SHAPES else 2
    same = all(all(torch.equal(a, b) for a, b in zip(
        grads, kernels.flash_bwd_fused(*bwd, **kw))) for _ in range(repeats - 1))
    ref = _plain_bwd(q, k, v, o, lse, do, causal, scale, lens, window)
    ACCEL.synchronize()
    errs = [(a.float() - r).abs().max().item() for a, r in zip(grads, ref)]
    tols = [BF16_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
    del ref
    pad_zero = True
    if ragged:
        pad = torch.arange(S, device="cuda")[None, :] >= lens[:, None]
        pad_zero = not (grads[1][pad].any() or grads[2][pad].any())
    shape = (f"B{B} S{S} H{H} D{D} bf16 "
             + ("causal" if causal else "non-causal")
             + (f" window {window}" if window else "")
             + (", ragged kv_lens" if ragged else ""))
    log(f"[flash_bwd_fused repeat] {shape}: {repeats} launches bitwise equal "
        f"{same}" + (f"; padding keys' dk and dv exactly 0 {pad_zero}"
                     if ragged else ""))
    if not (same and pad_zero):
        raise AssertionError(f"flash_bwd_fused {shape}: launches differ, or "
                             "padding keys' gradients are not 0")

    def run(fn, i):
        q_, k_, v_, do_, _, lse_, delta_ = sets[i % n]
        return fn(q_, k_, v_, do_, lse_, delta_, causal, scale, **kw)

    # in turns (fused, pair, pair, fused), each the mean of its two turns,
    # so that both see the card in the same state
    turns = {"fused": [], "dq": [], "dkv": []}
    for order in (("fused", "pair"), ("pair", "fused")):
        for which in order:
            if which == "fused":
                turns["fused"].append(time_ms(lambda i: run(kernels.flash_bwd_fused, i), 10))
            else:
                turns["dq"].append(time_ms(lambda i: run(kernels.flash_bwd_dq, i), 10))
                turns["dkv"].append(time_ms(lambda i: run(kernels.flash_bwd_dkv, i), 10))
    ms = sum(turns["fused"]) / 2
    ms_dq, ms_dkv = (sum(turns[k]) / 2 for k in ("dq", "dkv"))
    plain_ms = eager_ms(lambda: _plain_bwd(q, k, v, o, lse, do, causal,
                                           scale, lens, window), 1, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    if window:
        out = sdpa(*leaves, attn_mask=_option_mask(
            torch.arange(S, device="cuda")[None], S, torch.bfloat16, window))
    elif ragged:
        out = sdpa(*leaves, attn_mask=(torch.arange(S, device="cuda")[None, :]
                                       < lens[:, None])[:, None, None, :])
    else:
        out = sdpa(*leaves, is_causal=causal)
    lib_ms = eager_ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                  retain_graph=True), 5)
    del out, leaves
    elem = B * S * H * D * 2                          # one bf16 [B, S, H, D]
    stats = 2 * B * H * S * 4                         # lse and delta, fp32
    if ragged:
        live = int(lens.sum().item())
        pairs = H * S * live                          # every row sees its row's keys
        nbytes = 5 * elem + 2 * live * H * D * 2 + stats
    else:
        per_row = [min(i + 1, window) for i in range(S)] if window else \
            (range(1, S + 1) if causal else [S] * S)
        pairs = B * H * sum(per_row)
        nbytes = 7 * elem + stats
    name = "flash_bwd_fused[window]" if window else "flash_bwd_fused"
    row = _report(name, shape, max(errs), min(tols), ms, plain_ms, lib_ms,
                  nbytes, 10 * D * pairs)
    pair = ms_dq + ms_dkv
    share = wait.item() / (torch.cuda.get_device_properties(0).multi_processor_count
                           * _sm_clock_hz() * ms * 1e-3)
    row.update(pair_ms=pair, pair_dq_ms=ms_dq, pair_dkv_ms=ms_dkv,
               vs_pair=ms / pair, vs_library=ms / lib_ms,
               vs_bound=ms / row["bound_ms"], errs_dq_dk_dv=errs,
               tols_dq_dk_dv=tols, wait_cycles=wait.item(), wait_share=share,
               pairs=pairs, bitwise_repeats=repeats)
    against = (f"against the pair's {ms_dq:.4f} + {ms_dkv:.4f} = {pair:.4f} ms "
               f"({ms / pair:.3f}x" + (f"; at most {FUSED_BWD_RATIO}x)" if gated
                                      else "; reported)"))
    log(f"[{name}] {shape}: {ms:.4f} ms {against}; {ms / lib_ms:.3f}x SDPA's "
        f"backward ({lib_ms:.4f} ms), {ms / row['bound_ms']:.2f}x the bound "
        f"({row['bound_ms']:.4f} ms); dq, dk, dv errs "
        f"{[f'{e:.3e}' for e in errs]}; the ordered dq sum waited "
        f"{wait.item()} cycles in all CTAs, {share:.4f} of the kernel's "
        f"SM-cycles")
    if gated and not ms <= FUSED_BWD_RATIO * pair:
        raise AssertionError(f"{name} {shape}: {ms} ms > {FUSED_BWD_RATIO} x "
                             f"the pair's {pair} ms")
    return row


# ------------------------------------------------ head dims 80 and 96

#: GPT-2 760M's and 2.7B's attention heads (model, training micro-batch,
#: heads, head dim); seq 1024.  Their D 96 and 80 run in the tile of D 128
#: (``csrc/common.cuh`` ``tile_dim``)
HEAD_DIM_SHAPES = (("GPT-2 760M", 16, 16, 96), ("GPT-2 2.7B", 8, 32, 80))
#: the backward pair's rows at seq 4096, past which GPT-2 760M and 2.7B
#: train on it (B, H, D), and the block-sparse trio's under the Fixed
#: layout at block 64 (the sparse training slice's shape)
HEAD_DIM_LONG_S = 4096
PAIR_HEAD_DIM_SHAPES = (("GPT-2 760M", 4, 16, 96), ("GPT-2 2.7B", 2, 32, 80))
SPARSE_HEAD_DIM_SHAPES = (("GPT-2 760M", 4, 16, 96), ("GPT-2 2.7B", 4, 32, 80))
#: the serving rows' batches: 8 decode slots over S_max 1024 at ragged
#: positions, one 128-token extend chunk at pos 640
HEAD_DIM_DECODE_B, HEAD_DIM_SMAX, HEAD_DIM_CHUNK = 8, 1024, (128, 640)
#: a D 80 or 96 kernel may take at most this share of its D 128
#: instantiation's time at the same B, S, H: it does the same work or less
HEAD_DIM_RATIO = 1.05


def _head_dim_runner(kind, B, H, D, gen, S=HEAD_DIM_SMAX):
    """``fn(i)`` for ``time_ms``: one launch of ``kind`` at head dim ``D``
    on the row's shape (flash: B x S, causal; block-sparse: B x S under
    the Fixed layout at block 64; decode: the serving slots at ragged
    positions over S_max 1024; chunk: one extend chunk), rotating over
    input sets (cache layers) that keep each launch's reads out of L2."""
    scale = 1.0 / math.sqrt(D)
    n = max(2, min(8, (120 << 20) // (4 * B * S * H * D * 2)))
    if kind.startswith("block_sparse"):
        cfg = fixed_layout_config(H)
        plan = sparse_plan(cfg.make_layout(S), cfg.block, True, "cuda")
        sets = _sparse_sets(n, B, S, H, D, gen)
        if kind == "block_sparse_fwd":
            return lambda i: kernels.block_sparse_fwd(*sets[i % n][:3], plan,
                                                      scale)
        stats = _forward_stats(kernels.block_sparse_fwd, sets, plan, scale)
        return _bwd_runner(getattr(kernels, kind), sets, stats, plan, scale)
    if kind.startswith("flash"):
        sets = []
        for q, k, v in _qkv_views(n, B, S, H, D, gen):
            if kind == "flash_fwd":
                sets.append((q, k, v))
                continue
            do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                             dtype=torch.float32).to(torch.bfloat16)
            o, lse = kernels.flash_fwd(q, k, v, True, scale)
            sets.append((q, k, v, do, lse, aligned_do_and_delta(do, o)[1]))
        kernel = getattr(kernels, kind)
        return lambda i: kernel(*sets[i % n], True, scale)
    S = HEAD_DIM_SMAX
    int8 = kind.endswith("_int8")
    kernel = getattr(kernels, kind)
    if kind.startswith("decode"):
        Sq = 1
        pos = torch.as_tensor(np.random.default_rng(3).integers(0, S, B)
                              .astype(np.int32)).cuda()
    else:
        Sq, pos = HEAD_DIM_CHUNK
    ck, cv, L = _caches(B, S, H, D, gen)
    kv = _int8_cache(ck, cv)[2:] if int8 else (ck, cv)
    q = _qkv_views(1, B, Sq, H, D, gen)[0][0]
    return lambda i: kernel(q, *(t[i % L] for t in kv[:2]), pos, scale,
                            *(t[i % L] for t in kv[2:]))


def _vs_d128(row, kind, B, H, D, n, S=HEAD_DIM_SMAX):
    """Time ``kind`` at head dim D and at D 128 on the same B, S, H in
    turns (D, 128, 128, D; each the mean of its two turns), put both in
    ``row`` (its ``ms`` becomes the in-turns time) and fail unless D takes
    at most ``HEAD_DIM_RATIO`` of D 128's time."""
    gen = torch.Generator(device="cuda").manual_seed(D)
    runs = {D: _head_dim_runner(kind, B, H, D, gen, S),
            128: _head_dim_runner(kind, B, H, 128, gen, S)}
    turns = {D: [], 128: []}
    for order in ((D, 128), (128, D)):
        for d in order:
            turns[d].append(time_ms(runs[d], n))
    ms, twin = sum(turns[D]) / 2, sum(turns[128]) / 2
    row.update(ms=ms, d128_ms=twin, vs_d128=ms / twin, head_dim=D)
    log(f"[head dim] {kind} {row['shape']}: {ms:.4f} ms against D128's "
        f"{twin:.4f} ms at the same B, S, H ({ms / twin:.3f}x; at most "
        f"{HEAD_DIM_RATIO}x)")
    if not ms <= HEAD_DIM_RATIO * twin:
        raise AssertionError(f"{kind} D{D} {row['shape']}: {ms} ms > "
                             f"{HEAD_DIM_RATIO} x D128's {twin} ms")
    del runs
    torch.cuda.empty_cache()
    return row


def check_head_dims():
    """The attention kernels at GPT-2 760M's (D 96) and 2.7B's (D 80)
    shapes: ``flash_fwd`` and ``flash_bwd_fused`` at the training
    micro-batch, seq 1024, causal; ``decode_attn(_int8)`` over the 8
    serving slots at ragged positions and ``chunk_attn(_int8)`` on a
    128-token chunk at pos 640 (S_max 1024); the backward pair at
    ``PAIR_HEAD_DIM_SHAPES`` and the block-sparse trio at
    ``SPARSE_HEAD_DIM_SHAPES`` (seq 4096); each against its plain version
    and SDPA as the other rows, then timed in turns with its D 128
    instantiation at the same B, S, H (``HEAD_DIM_RATIO``); and
    ``flash_attention_backward`` at D 80 past Sk 4096 must run the pair,
    one launch of each, and match the plain backward."""
    rows = []
    Sq, pos = HEAD_DIM_CHUNK
    for model, B, H, D in HEAD_DIM_SHAPES:
        log(f"[head dim] {model}: B{B} S{HEAD_DIM_SMAX} H{H} D{D}")
        rows.append(_vs_d128(check_flash(B, HEAD_DIM_SMAX, H, D), "flash_fwd",
                             B, H, D, 20))
        rows.append(_vs_d128(check_flash_bwd_fused(
            B, HEAD_DIM_SMAX, H, D, True, None, False, False),
            "flash_bwd_fused", B, H, D, 10))
        for int8 in (False, True):
            name = "decode_attn" + ("_int8" if int8 else "")
            rows.append(_vs_d128(check_decode(
                B=HEAD_DIM_DECODE_B, Smax=HEAD_DIM_SMAX, H=H, D=D, int8=int8,
                kind="ragged"), name, HEAD_DIM_DECODE_B, H, D, 50))
            name = "chunk_attn" + ("_int8" if int8 else "")
            rows.append(_vs_d128(check_chunk(pos, Sq=Sq, Smax=HEAD_DIM_SMAX,
                                             H=H, D=D, int8=int8),
                                 name, 1, H, D, 50))
    S = HEAD_DIM_LONG_S
    for model, B, H, D in PAIR_HEAD_DIM_SHAPES:
        log(f"[head dim] {model}: the backward pair at B{B} S{S} H{H} D{D}")
        for row in check_flash_bwd(B, S, H, D):
            rows.append(_vs_d128(row, row["name"], B, H, D, 10, S))
    for model, B, H, D in SPARSE_HEAD_DIM_SHAPES:
        log(f"[head dim] {model}: the block-sparse trio at B{B} S{S} H{H} "
            f"D{D}, Fixed block 64")
        for row in check_block_sparse(B, S, H, D):
            rows.append(_vs_d128(row, row["name"], B, H, D,
                                 20 if row["name"].endswith("fwd") else 10, S))
    # past Sk 4096 the backward takes the pair, at D 80 as at every D
    gen = torch.Generator(device="cuda").manual_seed(4097)
    q, k, v, do = (torch.randn((1, 4097, 2, 80), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = kernels.flash_fwd(q, k, v, True, 0.1)
    before = kernels.launch_counts()
    grads = kernels.flash_attention_backward(q, k, v, o, lse, do, True, 0.1)
    took = {name: kernels.launch_counts()[name] - before[name]
            for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")}
    ref = flash_attention_backward_reference(q.float(), k.float(), v.float(),
                                             o.float(), lse, do.float(), True,
                                             0.1)
    err = max(((g.float() - r).abs().max() / r.abs().max().clamp(min=1.0))
              .item() for g, r in zip(grads, ref))
    tol = SWEEP_TOL[torch.bfloat16]
    log(f"[head dim] flash_attention_backward at B1 Sk 4097 H2 D80 (the "
        f"pair's route): launches {took}, worst relative err {err:.3e} (tol "
        f"{tol:.0e})")
    if took != {"flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_bwd_fused": 0} \
            or not err <= tol:
        raise AssertionError(f"flash_attention_backward at D80 Sk 4097: "
                             f"launches {took}, err {err}")
    return rows


#: the fused sweep's key lengths at Sk 300: one key, one short of, on and
#: one past the 128-key tile, and every key
FUSED_SWEEP_LENS = (1, 127, 128, 129, 300)


def check_bwd_fused_sweep(B=2, H=3):
    """``flash_bwd_fused`` at every dtype and head dim it is built for:
    ``BWD_SWEEP``'s shapes, the option sweep's windows (``SWEEP_WINDOWS``,
    None: Sk + 5) at ``OPTION_FLASH_S`` and ``OPTION_FLASH_CROSS``, key
    lengths ``FUSED_SWEEP_LENS`` at Sk 300 (Sq 300 and 77, causal and not),
    and causal Sq 300 over Sk 129, whose first 171 rows (q-tiles no key
    tile walks) see no key, with and without a window of 65; against the
    fp32 plain backward from the forward kernel's O and lse, within
    ``SWEEP_TOL``, rows without keys exactly 0, padding keys' dk and dv
    exactly 0, two launches bitwise equal.  Returns the worst relative
    error per (dtype, D)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = ([(Sq, Sk, c, None, False) for Sq, Sk, c in BWD_SWEEP]
             + [(S, S, True, w or S + 5, False) for S in OPTION_FLASH_S
                for w in SWEEP_WINDOWS]
             + [(Sq, Sk, True, w or Sk + 5, False)
                for Sq, Sk in OPTION_FLASH_CROSS for w in SWEEP_WINDOWS]
             + [(Sq, 300, c, None, True) for Sq in (300, 77)
                for c in (False, True)]
             + [(300, 129, True, None, False), (300, 129, True, 65, False)])
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        for D in HEAD_DIMS:
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device="cuda").to(dt)
            scale = 1.0 / math.sqrt(D)
            err = 0.0
            for Sq, Sk, causal, window, ragged in cases:
                # a row per key length under kv_lens
                Bc = len(FUSED_SWEEP_LENS) if ragged else B
                q, do = rnd(Bc, Sq, H, D), rnd(Bc, Sq, H, D)
                k, v = rnd(Bc, Sk, H, D), rnd(Bc, Sk, H, D)
                lens = torch.tensor(FUSED_SWEEP_LENS, dtype=torch.int32,
                                    device="cuda") if ragged else None
                o, lse = kernels.flash_fwd(q, k, v, causal, scale, lens, window)
                do_, delta = aligned_do_and_delta(do, o)
                bwd = (q, k, v, do_, lse, delta, causal, scale)
                kw = {"kv_lens": lens, "window": window}
                grads = kernels.flash_bwd_fused(*bwd, **kw)
                again = kernels.flash_bwd_fused(*bwd, **kw)
                ref = flash_attention_backward_reference(
                    q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                    causal, scale, lens, window)
                tag = f"{str(dt)[6:]} D{D} Sq{Sq} Sk{Sk} causal {causal} " \
                      f"window {window} kv_lens {ragged}"
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"fused sweep {tag}: launches differ")
                if not all(torch.isfinite(g).all() for g in grads):
                    raise AssertionError(f"fused sweep {tag}: non-finite")
                if causal and Sq > Sk and grads[0][:, :Sq - Sk].any():
                    raise AssertionError(f"fused sweep {tag}: a row with no "
                                         "key has dq != 0")
                if ragged:
                    pad = torch.arange(Sk, device="cuda")[None, :] >= lens[:, None]
                    if grads[1][pad].any() or grads[2][pad].any():
                        raise AssertionError(f"fused sweep {tag}: padding "
                                             "keys' dk/dv != 0")
                err = max(err, *(((g.float() - r).abs().max()
                                  / r.abs().max().clamp(min=1.0)).item()
                                 for g, r in zip(grads, ref)))
            worst[f"{str(dt)[6:]} D{D}"] = err
            log(f"[fused sweep] {str(dt)[6:]} D{D}: {len(cases)} cases "
                f"(BWD_SWEEP, windows {SWEEP_WINDOWS} at S {OPTION_FLASH_S} "
                f"and {OPTION_FLASH_CROSS}, kv_lens {FUSED_SWEEP_LENS} at Sk "
                f"300, causal Sq 300 Sk 129): worst relative err {err:.3e} "
                f"(tol {tol:.0e}), two launches bitwise equal, rows without "
                f"keys and padding keys zero")
            if not err <= tol:
                raise AssertionError(f"fused sweep {dt} D{D}: err {err}")
    return worst


# ------------------------------------------------------- block-sparse

def fixed_layout_config(heads=16, block=64):
    """The sparse training slice's layout: Fixed, 4 local blocks, 1 global,
    unidirectional, a different layout per head, 4 global patterns."""
    return FixedSparsityConfig(num_heads=heads, block=block,
                               num_local_blocks=4, num_global_blocks=1,
                               attention="unidirectional",
                               different_layout_per_head=True,
                               num_different_global_patterns=4)


def _sparse_sets(n, B, S, H, D, gen, dtype=torch.bfloat16):
    """``n`` sets of (q, k, v) strided views of [B, S, 3, H, D] and a dO."""
    sets = []
    for _ in range(n):
        qkv = torch.randn((B, S, 3, H, D), generator=gen, device="cuda",
                          dtype=torch.float32).to(dtype)
        do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        sets.append((qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do))
    return sets


def _bwd_runner(fn, sets, stats, *args):
    """``run(i)``: the backward kernel ``fn`` on set ``i`` of
    (q, k, v, dO) and its (O, lse, delta)."""
    def run(i):
        q, k, v, do = sets[i % len(sets)]
        _, lse, delta = stats[i % len(sets)]
        return fn(q, k, v, do, lse, delta, *args)
    return run


def _forward_stats(fwd, sets, *args):
    """(O, lse, delta) of the forward kernel ``fwd`` on each set."""
    stats = []
    for q, k, v, do in sets:
        o, lse = fwd(q, k, v, *args)
        stats.append((o, lse, aligned_do_and_delta(do, o)[1]))
    return stats


def check_block_sparse(B=4, S=4096, H=16, D=64):
    """The three block-sparse kernels at the sparse training slice's shape
    (GPT-2 350M's heads, seq 4096, the Fixed layout at block 64), bf16,
    against the fp32 plain versions on the same inputs (the forward
    kernel's O and lse feed the backward pair).  Plain ms is the plain
    forward, or the whole plain backward, both one batch row at a time
    (``_batch_rows``); library ms is
    ``scaled_dot_product_attention`` with the expanded [H, S, S] boolean
    mask, forward or its backward (dq, dk, dv together).  Also times the
    port's dense causal flash trio at the same shape, and its plain
    versions row by row: what the sparsity buys."""
    cfg = fixed_layout_config(H)
    # a plan of its own, not the cache's: the plain versions cache the
    # [H, S, S] mask on it (0.5 GiB at H 32), freed when this returns
    plan = SparsePlan(cfg.make_layout(S), cfg.block, True, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    n = 4                                   # 200 MB of inputs: past the L2
    sets = _sparse_sets(n, B, S, H, D, gen)
    scale = 1.0 / math.sqrt(D)
    stats = _forward_stats(kernels.block_sparse_fwd, sets, plan, scale)
    q, k, v, do = sets[0]
    o, lse, delta = stats[0]
    dq = kernels.block_sparse_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    dk, dv = kernels.block_sparse_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    o2, lse2 = kernels.block_sparse_fwd(q, k, v, plan, scale)
    dq2 = kernels.block_sparse_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    dk2, dv2 = kernels.block_sparse_bwd_dkv(q, k, v, do, lse, delta, plan,
                                            scale)
    ACCEL.synchronize()
    repeat = {"block_sparse_fwd": bool(torch.equal(o, o2)
                                       and torch.equal(lse, lse2)),
              "block_sparse_bwd_dq": bool(torch.equal(dq, dq2)),
              "block_sparse_bwd_dkv": bool(torch.equal(dk, dk2)
                                           and torch.equal(dv, dv2))}
    log(f"[block_sparse repeat] B{B} S{S}: two launches give bitwise equal O "
        f"and lse {repeat['block_sparse_fwd']}, dq "
        f"{repeat['block_sparse_bwd_dq']}, dk and dv "
        f"{repeat['block_sparse_bwd_dkv']}")
    if not all(repeat.values()):
        raise AssertionError(f"block-sparse: two launches differ {repeat}")
    del o2, lse2, dq2, dk2, dv2

    def plain_fwd_fn(q, k, v):
        return _batch_rows(block_sparse_attention_reference, q, k, v, plan,
                           scale)

    def plain_bwd_fn(q, k, v, o, lse, do):
        return _batch_rows(block_sparse_attention_backward_reference, q, k,
                           v, o, lse, do, plan, scale)

    o32, lse32 = plain_fwd_fn(q.float(), k.float(), v.float())
    fwd_err = (o.float() - o32).abs().max().item()
    fwd_tol = BF16_REL_TOL * max(1.0, o32.abs().max().item())
    lse_err = (lse - lse32).abs().max().item()
    del o32, lse32
    ref = plain_bwd_fn(q.float(), k.float(), v.float(), o.float(), lse,
                       do.float())
    ACCEL.synchronize()
    errs = [(a.float() - r).abs().max().item() for a, r in zip((dq, dk, dv), ref)]
    tols = [BF16_REL_TOL * max(1.0, r.abs().max().item()) for r in ref]
    del ref
    if not lse_err <= 1e-3:
        raise AssertionError(f"block_sparse_fwd lse err {lse_err} > 1e-3")

    ms_fwd = time_ms(lambda i: kernels.block_sparse_fwd(*sets[i % n][:3],
                                                        plan, scale), 20)
    ms_dq = time_ms(_bwd_runner(kernels.block_sparse_bwd_dq, sets, stats,
                                plan, scale), 10)
    ms_dkv = time_ms(_bwd_runner(kernels.block_sparse_bwd_dkv, sets, stats,
                                 plan, scale), 10)
    plain_fwd = eager_ms(lambda: plain_fwd_fn(q, k, v), 2, 1)
    plain_bwd = eager_ms(lambda: plain_bwd_fn(q, k, v, o, lse, do), 2, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bmask = plan.mask()[None]
    lib_fwd = time_ms(lambda i: sdpa(*(t.transpose(1, 2) for t in sets[i % n][:3]),
                                     attn_mask=bmask), 10)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=bmask)
    lib_bwd = eager_ms(lambda: torch.autograd.grad(out, leaves,
                                                   do.transpose(1, 2),
                                                   retain_graph=True), 5)
    del out, leaves
    dense_stats = _forward_stats(kernels.flash_fwd, sets, True, scale)
    dense = {"flash_fwd": time_ms(lambda i: kernels.flash_fwd(
        *sets[i % n][:3], True, scale), 5),
        "flash_bwd_dq": time_ms(_bwd_runner(kernels.flash_bwd_dq, sets,
                                            dense_stats, True, scale), 3),
        "flash_bwd_dkv": time_ms(_bwd_runner(kernels.flash_bwd_dkv, sets,
                                             dense_stats, True, scale), 3)}
    pairs = B * plan.live_pairs
    elem = B * S * H * D * 2                          # one bf16 [B, S, H, D]
    stat_bytes = B * H * S * 4
    # the dense trio's yardsticks and bounds (operations: 4, 6, 8 D FLOPs
    # per causal pair) at the same shape
    dense_pairs = B * H * S * (S + 1) // 2
    dense["sdpa_fwd"] = time_ms(lambda i: sdpa(
        *(t.transpose(1, 2) for t in sets[i % n][:3]), is_causal=True), 5)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=True)
    dense["sdpa_bwd"] = eager_ms(lambda: torch.autograd.grad(
        out, leaves, do.transpose(1, 2), retain_graph=True), 5)
    del out, leaves
    # the dense trio's plain versions, one batch row at a time
    o_dense, lse_dense, _ = dense_stats[0]
    dense["plain_fwd"] = eager_ms(lambda: _batch_rows(
        flash_attention_reference, q, k, v, True, scale), 1, 1)
    dense["plain_bwd"] = eager_ms(lambda: _plain_bwd(
        q, k, v, o_dense, lse_dense, do, True, scale), 1, 1)
    for name, per_pair in (("flash_fwd", 4), ("flash_bwd_dq", 6),
                           ("flash_bwd_dkv", 8)):
        dense[f"{name}_bound_ms"] = per_pair * D * dense_pairs / BF16_FLOPS * 1e3
    shape = (f"B{B} S{S} H{H} D{D} bf16 causal, Fixed block {cfg.block} "
             f"({plan.live_blocks} live blocks, {plan.live_pairs} pairs per "
             f"row)")
    log(f"[block-sparse] {shape}: lse err {lse_err:.2e} (tol 1e-3); dense "
        f"causal flash at the same shape: flash_fwd {dense['flash_fwd']:.4f} "
        f"ms (bound {dense['flash_fwd_bound_ms']:.4f}), flash_bwd_dq "
        f"{dense['flash_bwd_dq']:.4f} ms (bound "
        f"{dense['flash_bwd_dq_bound_ms']:.4f}), flash_bwd_dkv "
        f"{dense['flash_bwd_dkv']:.4f} ms (bound "
        f"{dense['flash_bwd_dkv_bound_ms']:.4f}), all bound by operations; "
        f"SDPA causal forward {dense['sdpa_fwd']:.4f} ms, its backward "
        f"{dense['sdpa_bwd']:.4f} ms ({dense_pairs} pairs); the plain "
        f"forward {dense['plain_fwd']:.4f} ms, backward "
        f"{dense['plain_bwd']:.4f} ms, row by row")
    rows = [_report("block_sparse_fwd", shape, fwd_err, fwd_tol, ms_fwd,
                    plain_fwd, lib_fwd, 4 * elem + stat_bytes, 4 * D * pairs),
            _report("block_sparse_bwd_dq", shape, errs[0], tols[0], ms_dq,
                    plain_bwd, lib_bwd, 5 * elem + 2 * stat_bytes,
                    6 * D * pairs),
            _report("block_sparse_bwd_dkv", shape, max(errs[1:]),
                    min(tols[1:]), ms_dkv, plain_bwd, lib_bwd,
                    6 * elem + 2 * stat_bytes, 8 * D * pairs)]
    for row in rows:
        row["dense_flash_ms_same_shape"] = dense
    return rows


def _sparse_errs(q, k, v, do, plan, causal_rows_empty=()):
    """Worst relative error of the three kernels (O, dq, dk, dv) against
    the fp32 plain versions, and the lse error; raises on a non-finite
    output or a non-zero output or dq on a row with no live block."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ((o, lse, delta),) = _forward_stats(kernels.block_sparse_fwd,
                                        [(q, k, v, do)], plan, scale)
    dq = kernels.block_sparse_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    dk, dv = kernels.block_sparse_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    o32, lse32 = block_sparse_attention_reference(q.float(), k.float(),
                                                  v.float(), plan, scale)
    ref = block_sparse_attention_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), plan,
        scale)
    outs = (o, dq, dk, dv)
    if not all(torch.isfinite(t).all() for t in outs):
        raise AssertionError(f"block-sparse {tuple(q.shape)} block "
                             f"{plan.block}: non-finite output")
    for lo, hi in causal_rows_empty:
        if o[:, lo:hi].any() or dq[:, lo:hi].any():
            raise AssertionError("block-sparse: a row with no live block has "
                                 "O or dq != 0")
    fin = torch.isfinite(lse32)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError("block-sparse: lse = -inf on other rows than "
                             "the plain version's")
    lse_err = (lse[fin] - lse32[fin]).abs().max().item() if fin.any() else 0.0
    err = max(((a.float() - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
              for a, r in zip(outs, (o32, *ref)))
    return err, lse_err


#: (block, S) of the sparse sweep: every block at S 256, and S 80 at block
#: 16 and 96 at block 32, which end inside a 64-wide tile
SPARSE_SWEEP_SHAPES = ((16, 256), (16, 80), (32, 256), (32, 96), (64, 256),
                       (128, 256))


def check_sparse_sweep(B=2, H=2):
    """Every layout block {16, 32, 64, 128} x head dim x dtype x causal, at
    S 256 and at S 80 (block 16) and 96 (block 32), on a random half-full
    layout whose second block row and the row that starts the second
    64-wide tile are empty, within the sweep's relative tolerance; then the
    Fixed, BigBird, Variable (with an emptied row), BSLongformer and Dense
    layouts in bf16, and the Dense layout against the dense
    ``flash_fwd``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(4)
    worst = {}
    for dt, tol in SWEEP_TOL.items():
        for D in KERNEL_HEAD_DIMS["block_sparse_fwd"]:
            errs = []
            for block, S in SPARSE_SWEEP_SHAPES:
                n = S // block
                edge = max(1, 64 // block)              # starts a 64-tile
                lay = rng.integers(0, 2, (H, n, n))
                lay[:, 0, 0] = 1
                lay[:, 1] = 0                           # empty rows
                lay[:, edge] = 0
                for causal in (True, False):
                    plan = sparse_plan(lay, block, causal, "cuda")
                    q, k, v, do = _sparse_sets(1, B, S, H, D, gen, dt)[0]
                    errs.append(_sparse_errs(
                        q, k, v, do, plan,
                        [(block, 2 * block), (edge * block, (edge + 1) * block)]))
            err, lse_err = max(e for e, _ in errs), max(l for _, l in errs)
            worst[f"{str(dt)[6:]} D{D}"] = err
            log(f"[sparse sweep] {str(dt)[6:]} D{D}: (block, S) "
                f"{SPARSE_SWEEP_SHAPES} x causal/not, empty rows (one at a "
                f"64-tile edge): worst relative err {err:.3e} (tol "
                f"{tol:.0e}), lse err {lse_err:.2e} (tol 1e-3), empty rows "
                f"zero")
            if not (err <= tol and lse_err <= 1e-3):
                raise AssertionError(f"sparse sweep {dt} D{D}: err {err}, "
                                     f"lse err {lse_err}")
    S, H, block, D = 512, 4, 32, 64
    var = VariableSparsityConfig(num_heads=H, block=block, num_random_blocks=1,
                                 local_window_blocks=[2, 4],
                                 global_block_indices=[3],
                                 different_layout_per_head=True)
    var_lay = var.make_layout(S)
    var_lay[:, 5] = 0                                   # an empty row
    layouts = {
        "fixed": fixed_layout_config(H, block).make_layout(S),
        "bigbird": BigBirdSparsityConfig(
            num_heads=H, block=block, num_random_blocks=2,
            different_layout_per_head=True).make_layout(S),
        "variable_empty_row": var_lay,
        "bslongformer": BSLongformerSparsityConfig(
            num_heads=H, block=block, num_sliding_window_blocks=3,
            global_block_indices=[0, 9]).make_layout(S),
        "dense": DenseSparsityConfig(num_heads=H, block=block).make_layout(S)}
    for name, lay in layouts.items():
        for causal in (True, False):
            plan = sparse_plan(lay, block, causal, "cuda")
            q, k, v, do = _sparse_sets(1, B, S, H, D, gen)[0]
            err, lse_err = _sparse_errs(q, k, v, do, plan,
                                        [(5 * block, 6 * block)]
                                        if name == "variable_empty_row" else [])
            msg = ""
            if name == "dense":
                scale = 1.0 / math.sqrt(D)
                o = kernels.block_sparse_fwd(q, k, v, plan, scale)[0].float()
                of = kernels.flash_fwd(q, k, v, causal, scale)[0].float()
                rel = ((o - of).abs().max() / of.abs().max().clamp(min=1.0)).item()
                msg = f", vs flash_fwd {rel:.3e}"
                err = max(err, rel)
            worst[f"{name} {'causal' if causal else 'full'}"] = err
            log(f"[sparse sweep] {name} S{S} H{H} D{D} block {block} bf16 "
                f"{'causal' if causal else 'full'}: relative err {err:.3e} "
                f"(tol 1e-02), lse err {lse_err:.2e}{msg}")
            if not (err <= SWEEP_TOL[torch.bfloat16] and lse_err <= 1e-3):
                raise AssertionError(f"sparse sweep {name}: err {err}, lse "
                                     f"err {lse_err}")
    return worst


# ------------------------------------------------------------- models

def scaled_params(cfg, seed, device, std_factor):
    """``gpt.init`` weights with every matrix scaled by ``std_factor`` so a
    tiny model's greedy output is not one repeated token."""
    params = gpt.init(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)
    for name in ("wqkv", "wo", "wi", "wo_mlp"):
        params["blocks"][name] *= std_factor
    params["wte"] *= std_factor
    params["wpe"] *= std_factor
    return params


def check_tiny_end_to_end():
    """The whole path in fp32 on the card (kernels) vs on the host
    (plain versions), same weights and prompts."""
    cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=4,
                        d_model=256, dtype=torch.float32)
    params = scaled_params(cfg, 5, "cpu", 15.0)
    conf = {"dtype": "float32"}
    dev = deepspeed_tpu_torch.init_inference((cfg, params), conf)
    host = deepspeed_tpu_torch.init_inference((cfg, params), conf,
                                              device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, (3, 40))
    lens = [40, 23, 9]
    a = dev.generate(toks, max_new_tokens=24, prompt_lens=lens).cpu().numpy()
    b = host.generate(toks, max_new_tokens=24, prompt_lens=lens).numpy()
    err = (dev.forward(toks).cpu() - host.forward(toks)).abs().max().item()
    log(f"[tiny fp32] greedy tokens equal: {bool((a == b).all())}, "
        f"forward max_abs_err {err:.3e} (tol 1e-3), distinct tokens per row "
        f"{[len(set(r)) for r in a.tolist()]}")
    if not (a == b).all() or not err <= 1e-3:
        raise AssertionError("tiny fp32 model: card and host disagree")


def check_tiny_int8():
    """int8 weights and an int8 KV cache on the card (the quantizer and
    both int8 attention kernels) against the same model on the host
    (plain versions), in fp32 compute: ``dtype="int8"`` computes in bf16,
    so each side quantizes its fp32 engine's weights with
    ``quantize_params_int8``.  Equal codes and scales, equal greedy
    tokens through ``generate`` and through a ``SlotBatcher`` with chunked
    prefill, forward logits within 1e-3."""
    cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=256, n_layer=2, n_head=4,
                        d_model=256, dtype=torch.float32)
    params = scaled_params(cfg, 5, "cpu", 15.0)
    conf = {"dtype": "float32", "kv_cache_dtype": "int8"}
    dev = deepspeed_tpu_torch.init_inference((cfg, params), conf)
    host = deepspeed_tpu_torch.init_inference((cfg, params), conf,
                                              device="cpu")
    dev.params = quantize_params_int8(dev.params)[0]
    host.params = quantize_params_int8(host.params)[0]
    for name, w in dev.params["blocks"].items():
        if isinstance(w, Int8Param):
            h = host.params["blocks"][name]
            if not (torch.equal(w.q.cpu(), h.q)
                    and torch.equal(w.scale.cpu(), h.scale)):
                raise AssertionError(f"tiny int8: {name} codes or scales "
                                     "differ between card and host")
    toks = np.random.default_rng(9).integers(0, 512, (3, 40))
    lens = [40, 23, 9]
    a = dev.generate(toks, max_new_tokens=24, prompt_lens=lens).cpu().numpy()
    b = host.generate(toks, max_new_tokens=24, prompt_lens=lens).numpy()
    err = (dev.forward(toks).cpu() - host.forward(toks)).abs().max().item()
    served = []
    for eng in (dev, host):
        bat = SlotBatcher(eng, ServingConfig(slots=2, max_len=128,
                                             prefill_chunk=16))
        bat.admit(1, toks[0], None, True, 1.0)
        served.append([int(bat.tick()[1]) for _ in range(12)])
    log(f"[tiny int8] int8 weights + int8 cache, fp32 compute: codes and "
        f"scales equal, greedy tokens equal: {bool((a == b).all())}, "
        f"batcher (chunk 16) tokens equal: {served[0] == served[1]}, forward "
        f"max_abs_err {err:.3e} (tol 1e-3), distinct tokens per row "
        f"{[len(set(r)) for r in a.tolist()]}")
    if not (a == b).all() or served[0] != served[1] or not err <= 1e-3:
        raise AssertionError("tiny int8 model: card and host disagree")


def run_generate(engine, cfg, label="bf16", model="GPT-2 350M",
                 lens=(512, 384, 200, 77), new=64):
    """Phase 3: 4 ragged prompts right-padded to 512, ``new`` greedy
    tokens."""
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (4, 512))
    lens = list(lens)
    engine.generate(toks, max_new_tokens=2, prompt_lens=lens)   # warm-up

    def timed(n):
        ACCEL.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(toks, max_new_tokens=n, prompt_lens=lens)
        out = out.cpu()
        return time.perf_counter() - t0, out

    t1 = min(timed(1)[0] for _ in range(3))
    tn, out = timed(new)
    if out.shape != (4, new) or out.min() < 0 or \
            out.max() >= cfg.vocab_size:
        raise AssertionError(f"generate output {out.shape} out of range")
    res = {"prefill_ms": t1 * 1e3,
           "decode_ms_per_token": (tn - t1) / (new - 1) * 1e3,
           "tokens_per_s": 4 * new / tn, "total_ms": tn * 1e3,
           "distinct_tokens_per_row": [len(set(r)) for r in out.tolist()],
           "tokens": out.tolist()}
    log(f"[generate] {model} {label}, 4 prompts (lens {lens}) x {new} greedy "
        f"tokens: prefill_ms {res['prefill_ms']:.2f}, decode_ms_per_token "
        f"{res['decode_ms_per_token']:.3f}, tokens_per_s "
        f"{res['tokens_per_s']:.1f}")
    return res


def run_serving(engine, cfg, n_req=16, budget=(32, 129), model="GPT-2 350M"):
    """Phase 4: ``n_req`` requests through 8 slots, admitted as slots free
    up; greedy and sampled (top_p 0.9) mixed."""
    bat = SlotBatcher(engine, ServingConfig(slots=8, max_len=1024,
                                            prefill_chunk=128, top_p=0.9))
    bat.prewarm()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),))
               for n in rng.integers(32, 769, n_req)]
    budgets = [int(b) for b in rng.integers(*budget, n_req)]
    greedy = [i % 2 == 0 for i in range(n_req)]
    outs = {i: [] for i in range(n_req)}
    ttft, ticks = {}, []
    queue, free, running = list(range(n_req)), list(range(bat.slots)), {}
    kernels.reset_launch_counts()
    ACCEL.synchronize()
    t0 = time.perf_counter()
    while queue or running:
        while queue and free:
            i, row = queue.pop(0), free.pop(0)
            gen = None if greedy[i] else \
                torch.Generator(device="cuda").manual_seed(1000 + i)
            bat.admit(row, prompts[i], gen, greedy[i], 1.0)
            running[row] = i
        ts = time.perf_counter()
        toks = bat.tick()
        now = time.perf_counter()
        ticks.append(now - ts)
        for row, i in list(running.items()):
            outs[i].append(int(toks[row]))
            ttft.setdefault(i, now - t0)
            if len(outs[i]) == budgets[i]:
                bat.release(row)
                free.append(row)
                del running[row]
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_tok = sum(budgets)
    res = {"requests": n_req, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ticks": len(ticks),
           "tick_ms_mean": 1e3 * sum(ticks) / len(ticks),
           "tick_ms_p50": 1e3 * pct(ticks, 50),
           "ttft_ms_p50": 1e3 * pct(list(ttft.values()), 50),
           "ttft_ms_p99": 1e3 * pct(list(ttft.values()), 99),
           "prompt_lens": [len(p) for p in prompts], "budgets": budgets}
    log(f"[serving] {model}: {n_req} requests, 8 slots, chunk 128: TTFT p50 "
        f"{res['ttft_ms_p50']:.1f} ms p99 {res['ttft_ms_p99']:.1f} ms, tick "
        f"mean {res['tick_ms_mean']:.2f} ms, tokens_per_s "
        f"{res['tokens_per_s']:.1f}")

    # consistency: each greedy request alone through the same batcher
    margins_at_div = []
    for i in (i for i in range(n_req) if greedy[i]):
        bat.admit(0, prompts[i], None, True, 1.0)
        alone, margins = [], []
        for _ in range(budgets[i]):
            top2 = torch.topk(bat._last[0, :cfg.vocab_size], 2).values
            margins.append(top2[0] - top2[1])
            alone.append(int(bat.tick()[0]))
        bat.release(0)
        diff = [t for t, (x, y) in enumerate(zip(alone, outs[i])) if x != y]
        if diff:
            m = float(margins[diff[0]])
            margins_at_div.append(m)
            log(f"[serving] request {i}: diverges at step {diff[0]}, top-2 "
                f"margin {m:.4f} (tie tol {TIE_TOL})")
            if not m < TIE_TOL:
                raise AssertionError(f"request {i}: batched and alone differ "
                                     f"at step {diff[0]} with margin {m}")
    res["greedy_divergences"] = len(margins_at_div)
    res["margins_at_divergence"] = margins_at_div
    n_greedy = sum(greedy)
    log(f"[serving] {model} batched vs alone: "
        f"{n_greedy - len(margins_at_div)}/{n_greedy} greedy requests "
        f"identical; margins at divergence {margins_at_div}")
    return res, counts


def check_full_width_logits(engine, cfg, params_fp32, label="bf16"):
    """The card's logits vs an fp32 forward on the host of
    ``params_fp32``, one short prompt; returns (result, card logits)."""
    toks = np.random.default_rng(33).integers(0, cfg.vocab_size, (1, 32))
    host = deepspeed_tpu_torch.init_inference(
        (cfg, params_fp32), {"dtype": "float32"}, device="cpu")
    ref = host.forward(toks)[..., :cfg.vocab_size]
    del host
    out = engine.forward(toks).cpu()[..., :cfg.vocab_size]
    rel = ((out - ref).norm() / ref.norm()).item()
    agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[generate] full-width logits {label} card vs fp32 host: finite "
        f"{bool(torch.isfinite(out).all())}, rel_l2_err {rel:.4f} (tol "
        f"0.05), argmax agreement {agree:.3f}")
    if not torch.isfinite(out).all() or not rel <= 0.05:
        raise AssertionError(f"full-width logits disagree: rel err {rel}")
    return {"rel_l2_err": rel, "argmax_agreement": agree}, out


# ------------------------------------------- GPT-Neo and BLOOM serving

#: the published widths of the two families (HF ``config.json`` of
#: EleutherAI/gpt-neo-1.3B and bigscience/bloom-560m), weights random
GPT_NEO_1_3B = gpt.GPTConfig(
    vocab_size=50257, max_seq_len=2048, n_layer=24, n_head=16, d_model=2048,
    d_ff=8192, attn_softmax_scale=1.0, local_attention_window=256,
    local_attention_alternating=True)
BLOOM_560M = gpt.GPTConfig(
    vocab_size=250880, max_seq_len=2048, n_layer=24, n_head=16, d_model=1024,
    pos_embed="alibi", embed_layernorm=True)
#: the families' generate: 4 prompts right-padded to 512, every one longer
#: than GPT-Neo's window, and 32 new tokens
FAMILY_LENS = (512, 448, 384, 300)
FAMILY_NEW = 32
#: the families' logits check: one prompt past GPT-Neo's window, against
#: an fp32 forward on the host of the same weights; the card's fp32
#: engine within FAMILY_FP32_TOL (relative L2), its bf16 engine within
#: FAMILY_BF16_TOL (GPT-2 350M's 0.05), or for GPT-Neo within
#: FAMILY_SENSITIVITY times the bf16 error of the same weights with every
#: layer global (the causal kernel): its unscaled softmax (scale 1.0) at
#: random init puts q.k at about 9 standard deviations, so bf16's rounding
#: of q and k moves the attention weights by several percent a layer,
#: window or not (about 0.31 either way on an H100, 0.013 with the
#: 1/sqrt(D) scale; PERF.md §6)
FAMILY_LOGITS_LEN = 320
FAMILY_FP32_TOL = 1e-3
FAMILY_BF16_TOL = 0.05
FAMILY_SENSITIVITY = 1.5
#: the option launches each family's path must make
FAMILY_OPTIONS = {"window": ("flash_fwd[window]", "decode_attn[window]",
                             "chunk_attn[window]",
                             "decode_attn_int8[window]",
                             "chunk_attn_int8[window]"),
                  "alibi": ("decode_attn[alibi]", "chunk_attn[alibi]",
                            "decode_attn_int8[alibi]",
                            "chunk_attn_int8[alibi]")}


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def _rel_agree(out, ref):
    return (((out - ref).norm() / ref.norm()).item(),
            (out.argmax(-1) == ref.argmax(-1)).float().mean().item())


@torch.no_grad()
def family_logits(engine, cfg, params_host, model):
    """The bf16 engine's logits, and an fp32 engine's on the card (the
    same weights), against an fp32 forward on the host, on one prompt of
    ``FAMILY_LOGITS_LEN`` tokens (past GPT-Neo's window); a banded model's
    bf16 tolerance from its weights with every layer global."""
    toks = np.random.default_rng(33).integers(0, cfg.vocab_size,
                                              (1, FAMILY_LOGITS_LEN))
    host = deepspeed_tpu_torch.init_inference(
        (cfg, params_host), {"dtype": "float32"}, device="cpu")
    V = cfg.vocab_size
    ref = host.forward(toks)[..., :V]
    res, bf16_tol = {}, FAMILY_BF16_TOL
    if cfg.local_attention_window > 0:
        unbanded = {"local_attention_window": 0,
                    "local_attention_alternating": False}
        ref_g = gpt.apply(host.params, host._tokens(toks),
                          dataclasses.replace(host.model_config,
                                              **unbanded))[..., :V]
        out_g = gpt.apply(engine.params, engine._tokens(toks),
                          dataclasses.replace(engine.model_config,
                                              **unbanded)).cpu()[..., :V]
        rel_g, agree_g = _rel_agree(out_g, ref_g)
        bf16_tol = max(bf16_tol, FAMILY_SENSITIVITY * rel_g)
        res["bf16_every_layer_global"] = {"rel_l2_err": rel_g,
                                          "argmax_agreement": agree_g}
        log(f"[{model}] the same weights with every layer global, bf16 card "
            f"vs fp32 host: rel_l2_err {rel_g:.3e}, argmax agreement "
            f"{agree_g:.3f}; the banded model's bf16 tol "
            f"{FAMILY_SENSITIVITY} x that = {bf16_tol:.3e}")
        del ref_g, out_g
    del host
    fp32 = deepspeed_tpu_torch.init_inference((cfg, params_host),
                                              {"dtype": "float32"})
    for label, eng, tol in (("bf16", engine, bf16_tol),
                            ("fp32", fp32, FAMILY_FP32_TOL)):
        out = eng.forward(toks).cpu()[..., :V]
        rel, agree = _rel_agree(out, ref)
        res[label] = {"rel_l2_err": rel, "argmax_agreement": agree,
                      "tol": tol}
        log(f"[{model}] full-width logits {label} card vs fp32 host, "
            f"{FAMILY_LOGITS_LEN} tokens: finite "
            f"{bool(torch.isfinite(out).all())}, rel_l2_err {rel:.3e} (tol "
            f"{tol}), argmax agreement {agree:.3f}")
        if not torch.isfinite(out).all() or not rel <= tol:
            raise AssertionError(f"{model} {label} logits: rel err {rel}")
    del fp32
    torch.cuda.empty_cache()
    return res


def run_family(model, cfg, seed, option):
    """One family at its published widths in bf16 (random weights from
    ``seed``) through ``init_inference``: phase 3's ``generate``
    (``FAMILY_LENS`` x ``FAMILY_NEW`` tokens) and a ``SlotBatcher`` of 6
    requests (greedy ones equal to themselves alone), full-width logits
    of the bf16 engine and of an fp32 one against an fp32 host forward
    (``family_logits``), peak memory above the weights and a profile;
    then the same ``generate`` and a 4-request batcher with an
    int8 KV cache (greedy agreement with bf16 reported).  Every launch
    count is 0 before each engine's run and read after it; the runs must
    launch every kernel of ``FAMILY_OPTIONS[option]``."""
    params = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                {"dtype": "bfloat16"})
    params_host = _host_tree(params)
    del params
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = {"generate": run_generate(engine, cfg, "bf16", model, FAMILY_LENS,
                                    FAMILY_NEW)}
    counts = kernels.launch_counts()
    res["serving"], serve_counts = run_serving(engine, cfg, n_req=6,
                                               budget=(16, 33), model=model)
    counts = _add(counts, serve_counts)
    res["peak_above_resident_gib"] = \
        (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    res["resident_gib"] = resident / 2 ** 30
    log(f"[{model}] bf16 weights resident {res['resident_gib']:.3f} GiB, "
        f"generate and serving peak above them "
        f"{res['peak_above_resident_gib']:.3f} GiB")
    res["full_width_logits"] = family_logits(engine, cfg, params_host, model)
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (4, 512))
    res["profile"] = device_profile(
        f"{model} generate 4x{FAMILY_NEW} tokens",
        lambda: engine.generate(toks, max_new_tokens=FAMILY_NEW,
                                prompt_lens=list(FAMILY_LENS)).cpu())
    del engine
    torch.cuda.empty_cache()

    engine = deepspeed_tpu_torch.init_inference(
        (cfg, params_host), {"dtype": "bfloat16", "kv_cache_dtype": "int8"})
    del params_host
    kernels.reset_launch_counts()
    res["int8_cache_generate"] = run_generate(
        engine, cfg, "bf16, int8 KV cache", model, FAMILY_LENS, FAMILY_NEW)
    counts = _add(counts, kernels.launch_counts())
    res["int8_cache_serving"], serve8 = run_serving(
        engine, cfg, n_req=4, budget=(16, 33),
        model=f"{model} int8 KV cache")
    counts = _add(counts, serve8)
    a = np.asarray(res["int8_cache_generate"]["tokens"])
    b = np.asarray(res["generate"]["tokens"])
    res["int8_cache_agreement"] = float((a == b).mean())
    log(f"[{model}] int8 KV cache vs bf16 greedy token agreement "
        f"{res['int8_cache_agreement']:.3f} (reported)")
    del engine
    torch.cuda.empty_cache()
    res["launches"] = counts
    log(f"[{model}] launches {counts}")
    missing = [k for k in FAMILY_OPTIONS[option] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{model}: option kernels never launched: "
                             f"{missing}")
    return res, counts



# ---------------------------------- GPT-2 760M and 2.7B (head dims 96, 80)

#: the JAX package's GPT-2 presets whose heads are 96 (760M: d 1536, 16
#: heads) and 80 (2.7B: d 2560, 32 heads) wide, at full width and depth,
#: random weights from a seed: (result key, model, config, seed, int8
#: serving too, training micro-batch, training row check's tokens)
WIDE_MODELS = (("gpt2_760m", "GPT-2 760M", gpt.GPT2_760M, 760, True, 16, 1024),
               ("gpt2_2_7b", "GPT-2 2.7B", gpt.GPT2_2_7B, 2700, False, 8, 256))


def run_wide_serving(model, cfg, seed, int8):
    """GPT-2 760M's or 2.7B's serving path in bf16 through
    ``init_inference``: ``generate`` (760M: phase 3's 4 ragged prompts x
    64 tokens and phase 4's 16 requests over 8 slots; 2.7B: the families'
    ``FAMILY_LENS`` x ``FAMILY_NEW`` and 6 requests), exact launches of
    the generate (``flash_fwd`` once a layer per prefill, 5 prefills;
    ``decode_attn`` once a layer per token; no chunk), batched = alone,
    full-width logits of a 32-token prompt within 5% of an fp32 forward
    on the host, peak memory above the weights, a profile; with ``int8``
    phase 5's int8 weights and cache on the same weights, decode timed in
    turns against bf16.  Counts at 0 before the engine's runs.  Returns
    (results, counts)."""
    L = cfg.n_layer
    params = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda")
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                {"dtype": "bfloat16"})
    params_host = _host_tree(params)
    del params
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lens, new, n_req, budget = ((512, 384, 200, 77), 64, 16, (32, 129)) \
        if int8 else (FAMILY_LENS, FAMILY_NEW, 6, (16, 33))
    kernels.reset_launch_counts()
    res = {"head_dim": cfg.head_dim,
           "generate": run_generate(engine, cfg, "bf16", model, lens, new)}
    gen_counts = kernels.launch_counts()
    want = {"flash_fwd": 5 * L, "decode_attn": new * L, "chunk_attn": 0,
            "flash_bwd_fused": 0}
    log(f"[{model}] D{cfg.head_dim} generate launches: "
        + ", ".join(f"{k} {gen_counts[k]} (want {n})" for k, n in want.items()))
    if any(gen_counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{model} generate launches {gen_counts}, want "
                             f"{want}")
    res["serving"], serve_counts = run_serving(engine, cfg, n_req, budget,
                                               model)
    res["resident_gib"] = resident / 2 ** 30
    res["peak_above_resident_gib"] = \
        (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    log(f"[{model}] bf16 weights resident {res['resident_gib']:.3f} GiB, "
        f"generate and serving peak above them "
        f"{res['peak_above_resident_gib']:.3f} GiB")
    res["full_width_logits"], logits = check_full_width_logits(
        engine, cfg, params_host, f"{model} bf16")
    res["profile"] = profile_generate(engine, cfg,
                                      f"{model} generate 4x16 tokens")
    counts = _add(gen_counts, serve_counts)
    if int8:
        bf16 = {"engine": engine, "param_bytes": param_bytes(engine.params),
                "logits": logits, "tokens": res["generate"]["tokens"]}
        res["int8"], int8_counts = run_int8_serving(cfg, params_host, bf16,
                                                    model)
        counts = _add(counts, int8_counts)
        del bf16
    del engine, params_host
    torch.cuda.empty_cache()
    res["launches"] = counts
    return res, counts


#: the two models' timed training steps after 2 warm-up ones: 5, not
#: phase 6's 10, to keep the whole run near 550 s of command time
WIDE_TRAIN_STEPS = 5
#: GPT-2 2.7B past four key blocks of 1024, where the backward takes the
#: pair: seq 8192 at micro-batch 1 (8192 tokens a step, as micro-batch 8
#: at seq 1024)
LONG_SEQ, LONG_MICRO_BATCH = 8192, 1


def run_wide_training(model, base, micro, row_seq, warmup=2,
                      steps=WIDE_TRAIN_STEPS, seq=1024):
    """GPT-2 760M's or 2.7B's training path at phase 6's setup (bf16, remat
    ``attn_out``, Adam lr 1e-4 wd 0.01, ZeRO 1, gas 1) at seq ``seq`` and
    micro-batch ``micro``, through the D 96 or 80 kernels: each step
    launches ``flash_fwd`` once a layer, and the backward as the JAX
    package routes it: ``flash_bwd_fused`` once a layer up to four key
    blocks of 1024 (seq 1024: one), past them the pair, ``flash_bwd_dq``
    and ``flash_bwd_dkv`` once a layer each; the row check at ``row_seq``
    tokens (a one-row fp32 host forward of 2.7B is about 5 TFLOP and 10.6
    GB at 1024); then a profile of 2 steps.  Returns (results, counts)."""
    cfg = dataclasses.replace(base, max_seq_len=seq, dtype=torch.bfloat16,
                              remat=True, remat_policy="attn_out")
    L = cfg.n_layer
    fused = kernels.fused_backward(seq)
    want = {"flash_fwd": L, "flash_bwd_fused": L if fused else 0,
            "flash_bwd_dq": 0 if fused else L,
            "flash_bwd_dkv": 0 if fused else L, "fused_adam": 1}
    label = f"{model} train" + ("" if seq == 1024 else f" seq {seq}")
    res, counts, engine, batch = _train_full_width(
        label, model, cfg, micro, want, warmup, steps, row_seq)
    res["head_dim"] = cfg.head_dim
    res["profile"] = device_profile(
        f"{label} 2 steps", lambda: [engine.train_batch_fused(batch)
                                     for _ in range(2)], FLASH_KERNELS)
    del engine, batch
    torch.cuda.empty_cache()
    return res, counts


#: the flash trio's kernels, by a substring of their names in a profile
FLASH_KERNELS = ("flash_fwd_tc", "flash_bwd_dkv_tc", "flash_bwd_dq_tc",
                 "flash_bwd_fused_tc")
#: the block-sparse trio as the sparse step's profile names them
SPARSE_KERNELS = ("block_sparse_fwd_tc", "block_sparse_bwd_dq_tc",
                  "block_sparse_bwd_dkv_tc")


def device_profile(label, run, shares=()):
    """``run()`` under ``torch.profiler``: kernel time on the card, by
    kernel, against the host's wall time of the same run (profiler
    overhead included); ``shares``: name substrings whose share of the
    kernel time is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        ACCEL.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in device}
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    res = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "device_kernels": sum(e.count for e in device),
           "top_kernels_ms": [[k[:80], v] for k, v in top]}
    for sub in shares:
        res[f"ms_{sub}"] = sum(ms for k, ms in by_kernel.items() if sub in k)
        res[f"share_{sub}"] = res[f"ms_{sub}"] / device_ms
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, kernel time on the card "
        f"{device_ms:.1f} ms (busy share {res['device_busy_share']:.3f}), "
        f"{res['device_kernels']} kernels"
        + "".join(f", {sub} {res[f'ms_{sub}']:.3f} ms (share "
                  f"{res[f'share_{sub}']:.4f})" for sub in shares))
    for name, ms in res["top_kernels_ms"]:
        log(f"[profile]   {ms:8.3f} ms  {name}")
    return res


def profile_generate(engine, cfg, label="generate 4x16 tokens"):
    """Where ``generate``'s time goes: a 16-token run of phase 3's batch,
    and the device kernels a decode step launches: those of the 16-token
    run less those of a 1-token run of the same batch, over 15."""
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (4, 512))
    lens = [512, 384, 200, 77]

    def run(n):
        return lambda: engine.generate(toks, max_new_tokens=n,
                                       prompt_lens=lens).cpu()

    res = device_profile(label, run(16))
    one = device_profile(label.replace("16 tokens", "1 token"), run(1))
    res["kernels_per_decode_step"] = (res["device_kernels"]
                                      - one["device_kernels"]) / 15
    log(f"[profile] {label}: {res['kernels_per_decode_step']:.1f} device "
        f"kernels per decode step")
    return res


def kv_bytes_per_token(model_config, kv_dtype=None):
    """KV-cache bytes per token per row: every buffer of a one-row cache
    (K, V and, int8, their scales) over its slots."""
    cache = gpt_inference.init_cache(model_config, 1, 16, device="cuda",
                                     kv_dtype=kv_dtype)
    return sum(b.numel() * b.element_size() for b in cache.buffers()) // 16


def _dequantized_host(params):
    """The engine's weights as fp32 on the host, int8 leaves dequantized."""
    return {k: _dequantized_host(v) if isinstance(v, dict)
            else v.to(torch.float32).cpu() for k, v in params.items()}


def compare_decode(engines, cfg, rounds=4, n=33):
    """Decode ms per token of each engine in ``engines`` (label →
    engine) on phase 3's batch, timed in turns (a, b, b, a, ...) so that
    the host's drift between runs falls on both; returns every sample."""
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (4, 512))
    lens = [512, 384, 200, 77]

    def per_token(engine):
        ACCEL.synchronize()
        t0 = time.perf_counter()
        engine.generate(toks, max_new_tokens=1, prompt_lens=lens).cpu()
        t1 = time.perf_counter()
        engine.generate(toks, max_new_tokens=n, prompt_lens=lens).cpu()
        t2 = time.perf_counter()
        return ((t2 - t1) - (t1 - t0)) / (n - 1) * 1e3

    items = list(engines.items())
    samples = {label: [] for label in engines}
    for r in range(rounds):
        for label, engine in (items if r % 2 == 0 else items[::-1]):
            samples[label].append(per_token(engine))
    return samples


def run_int8_serving(cfg, params_host, bf16, model="GPT-2 350M"):
    """Phase 5: the int8 slice at full width, every launch count at 0
    before the engine is built: ``init_inference(..., dtype="int8",
    kv_cache_dtype="int8")`` (4 quantizer launches), then phase 3's
    ``generate`` and phase 4's ``SlotBatcher``; bytes against the bf16
    engine, logits against an fp32 host forward of the same dequantized
    weights, agreement with the bf16 run and decode ms per token against
    the bf16 engine timed in turns (``bf16``: its engine, tokens and
    logits).  Returns (results, counts)."""
    kernels.reset_launch_counts()
    engine = deepspeed_tpu_torch.init_inference(
        (cfg, params_host), {"dtype": "int8", "kv_cache_dtype": "int8"})
    init_counts = kernels.launch_counts()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = {"param_bytes": param_bytes(engine.params),
           "param_bytes_bf16": bf16["param_bytes"],
           "kv_bytes_per_token": kv_bytes_per_token(engine.model_config,
                                                    "int8"),
           "kv_bytes_per_token_bf16": kv_bytes_per_token(engine.model_config)}
    log(f"[int8] {model} int8 weights: {res['param_bytes']:,} parameter "
        f"bytes against {res['param_bytes_bf16']:,} in bf16 "
        f"({res['param_bytes'] / res['param_bytes_bf16']:.3f}x); KV cache "
        f"{res['kv_bytes_per_token']:,} bytes per token per row against "
        f"{res['kv_bytes_per_token_bf16']:,} "
        f"({res['kv_bytes_per_token'] / res['kv_bytes_per_token_bf16']:.3f}"
        f"x); quantizer launches at init {init_counts['quantizer']}")
    kernels.reset_launch_counts()
    res["generate"] = run_generate(engine, cfg, "int8 weights + int8 cache",
                                   model)
    gen_counts = kernels.launch_counts()
    res["serving"], serve_counts = run_serving(engine, cfg, model=model)
    res["serving"]["peak_above_resident_gib"] = \
        (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    counts = {k: init_counts[k] + gen_counts[k] + serve_counts[k]
              for k in init_counts}
    res["launches"] = {"init": init_counts, "generate": gen_counts,
                       "serving": serve_counts}
    res["full_width_logits"], logits = check_full_width_logits(
        engine, cfg, _dequantized_host(engine.params),
        "int8 (fp32 host on the dequantized weights)")
    a = np.asarray(res["generate"]["tokens"])
    b = np.asarray(bf16["tokens"])
    res["vs_bf16"] = {
        "greedy_token_agreement": float((a == b).mean()),
        "first_divergence_per_row": [
            int(np.argmax(r != s)) if (r != s).any() else None
            for r, s in zip(a, b)],
        "max_abs_logit_diff": (logits - bf16["logits"]).abs().max().item(),
        "argmax_agreement": (logits.argmax(-1) == bf16["logits"].argmax(-1))
        .float().mean().item()}
    log(f"[int8] {model} vs bf16 (report only): greedy token agreement "
        f"{res['vs_bf16']['greedy_token_agreement']:.3f}, first divergence "
        f"per row {res['vs_bf16']['first_divergence_per_row']}, largest "
        f"logit difference {res['vs_bf16']['max_abs_logit_diff']:.4f}, "
        f"argmax agreement {res['vs_bf16']['argmax_agreement']:.3f}; "
        f"generate and serving peak memory above the resident "
        f"{res['serving']['peak_above_resident_gib']:.3f} GiB (KV caches, "
        f"activations, dequantized weights); launches generate "
        f"{gen_counts}, serving {serve_counts}")
    # generate: 5 prefills and 64 decode steps (run_generate), each
    # writing K and V into every layer's int8 cache with one
    # quantize_kv_append launch; decode_attn_int8 once a layer per step;
    # the quantizer only at init, the bf16-cache kernels never
    L = cfg.n_layer
    want = {"quantizer": 0, "quantize_kv_append": L * (5 + 64),
            "decode_attn_int8": L * 64, "decode_attn": 0, "chunk_attn": 0}
    bad = [k for k, n in want.items() if gen_counts[k] != n]
    if init_counts["quantizer"] != 4 or bad or serve_counts["decode_attn"] \
            or serve_counts["chunk_attn"] or serve_counts["quantizer"] \
            or not serve_counts["chunk_attn_int8"] \
            or not serve_counts["quantize_kv_append"]:
        raise AssertionError(f"int8 launches: init {init_counts}, generate "
                             f"{gen_counts} (want {want}), serving "
                             f"{serve_counts}")
    res["profile"] = profile_generate(engine, cfg,
                                      f"{model} int8 generate 4x16 tokens")
    turns = compare_decode({"bf16": bf16["engine"], "int8": engine}, cfg)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    res["decode_ms_per_token_in_turns"] = {"samples": turns, "median": med}
    log(f"[int8] {model} decode ms per token in turns (bf16, int8, int8, bf16, "
        f"...; 4 ragged rows, 32 steps): bf16 "
        f"{[round(x, 3) for x in turns['bf16']]} median {med['bf16']:.3f}, "
        f"int8 {[round(x, 3) for x in turns['int8']]} median "
        f"{med['int8']:.3f} ({med['int8'] / med['bf16']:.2f}x)")
    return res, counts


# ------------------------------------------------------------- training

#: the full-width training configuration: bench.py:515-611 (GPT-2 350M,
#: seq 1024, bf16, remat attn_out, Adam lr 1e-4 wd 0.01, ZeRO 1 on one
#: device, gas 1), at bench.py's smallest micro-batch candidate
TRAIN_MICRO_BATCH = 16
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_MICRO_BATCH,
                "gradient_accumulation_steps": 1,
                "steps_per_print": 1 << 30,
                "optimizer": {"type": "Adam",
                              "params": {"lr": 1e-4, "weight_decay": 0.01}},
                "zero_optimization": {"stage": 1},
                "bf16": {"enabled": True}}


def _train_tiny(spec, batches, device, optimizer=None):
    """5 steps of ``train_batch_fused``; (losses, final fp32 master)."""
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=spec, device=device,
        config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 4,
                "gradient_clipping": 1.0, "bf16": {"enabled": False},
                **({"optimizer": optimizer} if optimizer else {})})
    losses = [engine.train_batch_fused(b) for b in batches]
    master = torch.cat([t.detach().reshape(-1).cpu() for t in
                        _leaves(engine.state["master"])])
    return torch.stack(losses).cpu(), master


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def check_tiny_training(sparse=False, bert_model=False, neo=False):
    """The training path in fp32 on the card (kernels) vs on the host
    (plain versions) from the same params and batches; then a second card
    run, bitwise equal to the first.  ``sparse``: GPT under a Fixed
    block-sparse layout (block 16) at seq 128.  ``bert_model``: BERT MLM
    at seq 64 on right-padded batches (``seq_lens``) under the tutorial's
    LAMB with lr 1e-3.  ``neo``: GPT-Neo's attention (global and local
    layers in turn, unscaled softmax) with a window of 40, not a multiple
    of any tile, at seq 97."""
    rng = np.random.default_rng(10)
    optimizer = None
    if bert_model:
        cfg = bert.BertConfig(vocab_size=512, max_seq_len=64, n_layer=2,
                              n_head=4, d_model=256, dtype=torch.float32,
                              remat=True)
        spec = dataclasses.replace(
            from_bert(cfg), params=bert.init(cfg, torch.Generator().manual_seed(8)))
        batches = [mlm_batch(4, 64, cfg.vocab_size, rng) for _ in range(5)]
        optimizer = {"type": "Lamb", "params": {**LAMB_PARAMS, "lr": 1e-3}}
    else:
        band = dict(local_attention_window=40,
                    local_attention_alternating=True,
                    attn_softmax_scale=1.0) if neo else {}
        cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=128, n_layer=2,
                            n_head=4, d_model=256, dtype=torch.float32,
                            remat=True, remat_policy="attn_out",
                            sparse_attention=FixedSparsityConfig(
                                num_heads=4, block=16, num_local_blocks=2,
                                attention="unidirectional") if sparse else None,
                            **band)
        spec = dataclasses.replace(
            from_gpt(cfg), params=gpt.init(cfg, torch.Generator().manual_seed(8)))
        seq = 129 if sparse else 97
        batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, seq))}
                   for _ in range(5)]
    before = kernels.launch_counts()
    dev_losses, dev_master = _train_tiny(spec, batches, "cuda", optimizer)
    took = {k: kernels.launch_counts()[k] - before[k]
            for k in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
    if not sparse and not (took["flash_bwd_fused"] > 0
                           and took["flash_bwd_dq"] == took["flash_bwd_dkv"] == 0):
        raise AssertionError(f"tiny training: the backward did not take the "
                             f"fused form: {took}")
    host_losses, host_master = _train_tiny(spec, batches, "cpu", optimizer)
    again_losses, again_master = _train_tiny(spec, batches, "cuda", optimizer)
    loss_rel = ((dev_losses - host_losses).abs() / host_losses.abs()).max().item()
    param_err = (dev_master - host_master).abs().max().item()
    bitwise = torch.equal(dev_losses, again_losses) and \
        torch.equal(dev_master, again_master)
    label = ("tiny train bert lamb" if bert_model else
             "tiny train sparse" if sparse else
             "tiny train neo" if neo else "tiny train")
    log(f"[{label}] backward launches on the card {took}")
    log(f"[{label}] fp32, 5 steps, card vs host: losses "
        f"{dev_losses.tolist()} vs {host_losses.tolist()}, max relative "
        f"loss err {loss_rel:.3e} (tol 1e-5), master max_abs_err "
        f"{param_err:.3e} (tol 1e-4); second card run bitwise equal "
        f"{bitwise}")
    if not (loss_rel <= 1e-5 and param_err <= 1e-4 and bitwise):
        raise AssertionError(f"{label}: card and host disagree, or two "
                             "card runs differ")
    return {"loss_rel_err": loss_rel, "master_max_abs_err": param_err,
            "bitwise_repeat": bitwise}


#: the sparse training slice: the same model and optimizer at seq 4096
#: under the Fixed layout (block 64), micro-batch 4: 16,384 tokens per step
SPARSE_MICRO_BATCH = 4
SPARSE_SEQ = 4096


def run_training(warmup=2, steps=10):
    """Phase 6: the full-width training path at bench.py's configuration;
    every launch count is reset before it and read after it: each step
    launches ``flash_bwd_fused`` on every layer (seq 1024 is one key block
    of 1024) and the pair never.  Returns (results, counts, engine,
    batch)."""
    cfg = dataclasses.replace(gpt.GPT2_350M, max_seq_len=1024,
                              dtype=torch.bfloat16, remat=True,
                              remat_policy="attn_out")
    want = {"flash_fwd": cfg.n_layer, "flash_bwd_fused": cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "fused_adam": 1}
    return _train_full_width("train", "GPT-2 350M", cfg, TRAIN_MICRO_BATCH,
                             want, warmup, steps, row_seq=cfg.max_seq_len)


# ------------------------------------------------------------ the preemptible run

#: the preemptible run's straight runs, in steps, and its token set: rows
#: of seq + 1 tokens, enough for the runs' batches within one epoch
PREEMPT_STEPS = 8
PREEMPT_ROWS = 256
#: where phase 6b delivers SIGTERM, and the step its NaN window poisons:
#: one step past the verified tag of step 2
PREEMPT_AT = 3
NAN_AT = 3
#: the watchdog's deadline for a step in the straight run it watches
#: (steps take ~0.25 s), and the longest the injected hang may block
HANG_DEADLINE_S = 3.0
HANG_MAX_S = 60.0
#: the spans a fused training step records
STEP_SPANS = {"train.step", "train.fwd", "train.bwd", "train.optimizer",
              "train.host_sync"}
#: every span of the phase: a step's, the runner's, the checkpoints'
RUN_SPANS = STEP_SPANS | {"train.data_fetch", "ckpt.save", "ckpt.commit",
                          "ckpt.load", "elastic.resume", "elastic.rollback"}


class _CkptTimers:
    """Seconds spent in the checkpoint path's parts, timed by wrapping the
    functions the save and load call: the host snapshot, the npz writes,
    the manifest, the verification, the npz reads and the copy into the
    engine's buffers.  Only the outermost call of a recursive part counts,
    and only calls on the thread that opened the timers (an async save's
    writers are timed as the caller's wait)."""

    PARTS = ((native_checkpoint_engine, "snapshot_host", "snapshot"),
             (async_checkpoint_engine, "snapshot_host", "snapshot"),
             (native_checkpoint_engine, "atomic_write_npz", "write"),
             (native_checkpoint_engine, "write_manifest", "manifest"),
             (native_checkpoint_engine, "verify_tag", "verify"),
             (native_checkpoint_engine.NativeCheckpointEngine, "load", "read"),
             (native_checkpoint_engine, "_copy_into", "copy"))

    def __init__(self):
        self.seconds = {}
        self._saved = []
        self._depth = 0
        self._thread = threading.get_ident()

    def _wrap(self, fn, part):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if threading.get_ident() != self._thread or self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ACCEL.synchronize()
                self.seconds[part] = self.seconds.get(part, 0.0) + \
                    time.perf_counter() - t0
                self._depth -= 1
        return timed

    def __enter__(self):
        for owner, name, part in self.PARTS:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, part))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        return False


class _LogLines(logging.Handler):
    """Collects the port logger's messages while it is attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _engine_state(engine):
    """Every piece of training state, cloned on the card: the flat
    buffers, the optimizer's tensors and step, the scale state, the
    counters."""
    tensors = {f"flat/{k}": v.clone() for k, v in engine._flat.items()}
    for k, v in engine.state["opt_state"].items():
        if torch.is_tensor(v):
            tensors[f"opt/{k}"] = v.clone()
    for k, v in engine.state["scale"].items():
        tensors[f"scale/{k}"] = v.clone()
    host = (engine.state["opt_state"]["step"], engine.micro_steps,
            engine.global_steps, engine.global_samples, engine.skipped_steps)
    return tensors, host


def _state_diff(got, want):
    """The names of the state pieces that differ bitwise."""
    (gt, gh), (wt, wh) = got, want
    bad = [k for k in wt if not torch.equal(gt[k], wt[k])]
    if gh != wh:
        bad.append(f"counters {gh} != {wh}")
    return bad


class _TokenRows:
    """The phase's dataset: seeded rows of tokens, one sample a row."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return {"tokens": self.rows[i]}


def _synced_timer(fn, seconds):
    """``fn`` timed to the end of the device work it queued: a barrier
    before the clock is read; each call's seconds go to ``seconds``."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            ACCEL.synchronize()
            seconds.append(time.perf_counter() - t0)
    return timed


def _span_seconds(tracer, name):
    return [r.dur for r in tracer.spans() if r.name == name]


def _events(save_dir, kind=None):
    return read_events(os.path.join(save_dir, "events.jsonl"), kind=kind)


def run_preemptible(smi):
    """Phase 6b (module docstring): the preemptible run at bench.py's
    training configuration, full width and depth, through
    ``initialize(training_data=...)`` → the ``ResumableDataLoader`` →
    ``ElasticTrainRunner.run``; ``smi`` is the card's name and power
    limit, printed beside the timings.  Returns (results, counts)."""
    cfg = dataclasses.replace(gpt.GPT2_350M, max_seq_len=1024,
                              dtype=torch.bfloat16, remat=True,
                              remat_policy="attn_out")
    rows = np.random.default_rng(19).integers(
        0, cfg.vocab_size, (PREEMPT_ROWS, cfg.max_seq_len + 1),
        dtype=np.int32)
    data = _TokenRows(rows)
    seed, other_seed = 2024, 77
    N = PREEMPT_STEPS
    work = tempfile.mkdtemp(prefix="ds_torch_preempt_")

    def engine(seed_, **extra):
        e, _, loader, _ = deepspeed_tpu_torch.initialize(
            model=from_gpt(cfg), training_data=data,
            config={**TRAIN_CONFIG,
                    "data": {"resumable": True, "shuffle": True, "seed": 19},
                    **extra},
            generator=torch.Generator(device="cuda").manual_seed(seed_))
        if not isinstance(loader, ResumableDataLoader) or \
                e.data_iterator is not loader:
            raise AssertionError("preemptible: initialize(training_data) "
                                 "did not register a ResumableDataLoader")
        return e, loader

    def check(label, got, want, extra=()):
        bad = _state_diff(got, want) + list(extra)
        log(f"[preemptible] {label}: bitwise equal {not bad}"
            + (f" (differ: {bad})" if bad else ""))
        if bad:
            raise AssertionError(f"preemptible {label}: {bad}")

    def same(name, got, want):
        return [] if got == want else [f"{name} {got} != {want}"]

    def telemetry(name):
        return {"telemetry": {"enabled": True, "metrics": {
            "path": os.path.join(work, f"metrics_{name}.jsonl")}}}
    kernels.reset_launch_counts()
    t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase

    lines = _LogLines()
    port_logger.addHandler(lines)
    try:
        disk = shutil.disk_usage(work)
        log(f"[preemptible] tags under {work}: {disk.free / 1e9:.1f} GB "
            f"free of {disk.total / 1e9:.1f} GB")
        # two straight runs, no saves; the second under a step watchdog
        # whose first step hangs past the deadline until on_expire ends it
        a, loader = engine(seed)
        straight_res = ElasticTrainRunner(
            a, os.path.join(work, "straight"), save_interval=1 << 30).run(
                loader, max_steps=N, resume=False)
        straight = _engine_state(a)
        straight_loader = loader.state_dict()
        straight_losses = straight_res["losses"]
        del a
        mark("straight")
        a2, loader2 = engine(seed)
        wd_dir = os.path.join(work, "watchdog")
        runner = ElasticTrainRunner(
            a2, wd_dir, save_interval=1 << 30,
            supervision={"step_deadline_s": HANG_DEADLINE_S})
        hang = fault_injection.HangFor(HANG_MAX_S)
        expired = []

        def on_expire(rec):
            expired.append(time.perf_counter())
            hang.release()

        runner.watchdog.on_expire = on_expire
        t0 = time.perf_counter()
        with fault_injection.inject("train.step_begin", hang):
            res2 = runner.run(loader2, max_steps=N, resume=False)
        hang_s = (expired[0] - t0) if expired else None
        check(f"two straight runner runs of {N} steps (the second under the "
              f"watchdog)", _engine_state(a2), straight,
              same("losses", res2["losses"], straight_losses)
              + same("loader", loader2.state_dict(), straight_loader))
        del a2
        torch.cuda.empty_cache()
        wd = _events(wd_dir, "watchdog.expired")
        threads = sorted(set(re.findall(r"--- Thread (\S+)",
                                        wd[0]["stacks"]))) if wd else []
        log(f"[preemptible] watchdog: deadline {HANG_DEADLINE_S} s, hang "
            f"released by on_expire {hang_s} s after the run began; "
            f"{len(wd)} watchdog.expired event(s), label "
            f"{wd[0]['label'] if wd else None}, stacks of threads {threads}; "
            f"watchdog thread alive after the run "
            f"{runner.watchdog._thread.is_alive()}")
        if len(wd) != 1 or wd[0]["label"] != "train.step" or \
                "MainThread" not in threads or "step-watchdog" not in threads \
                or hang.fired != 1 or runner.watchdog._thread.is_alive():
            raise AssertionError("preemptible: the watchdog did not fire "
                                 "once with every thread's stack, or did not "
                                 "stop")
        del runner      # it holds the engine
        mark("watchdog")

        # preempted: the async engine saves at step 2 (save_interval 2),
        # SIGTERM at step 3 drains into a tag the runner waits for
        ck = os.path.join(work, "ck")
        sup = {"preempt_save_deadline_s": 600.0,
               "rollback": {"max_rollbacks": 2}}
        p, ploader = engine(seed, checkpoint={"async_save": True},
                            **telemetry("preempted"))
        with fault_injection.inject("train.step",
                                    fault_injection.SignalAtStep(PREEMPT_AT)):
            pres = ElasticTrainRunner(p, ck, save_interval=2,
                                      supervision=sup).run(
                ploader, max_steps=N, resume=False)
        save_spans = _span_seconds(p.tracer, "ckpt.save")
        commit_spans = _span_seconds(p.tracer, "ckpt.commit")
        p_spans = set(p.tracer.span_inventory())
        del p
        torch.cuda.empty_cache()
        signals = _events(ck, "preempt.signal")
        drains = _events(ck, "ckpt.preempt_save")
        drain_tag = f"elastic_step{PREEMPT_AT}"
        tag_bytes = _dir_bytes(os.path.join(ck, drain_tag))
        # committed and published (the resume below verifies the hashes)
        with open(os.path.join(ck, "latest")) as f:
            ok_drain = f.read().strip() == drain_tag and all(
                os.path.exists(os.path.join(ck, drain_tag, name))
                for name in ("commit.json", "manifest.json"))
        log(f"[preemptible] SIGTERM at step {PREEMPT_AT}: preempted "
            f"{pres['preempted']} after {pres['steps']} steps; journal "
            f"preempt.signal {[(e['signum'], e['step']) for e in signals]}, "
            f"ckpt.preempt_save {[(e['step'], e['tag'], e['elapsed_s']) for e in drains]}; "
            f"the drain's tag committed and latest {ok_drain}")
        if not (pres["preempted"] and pres["steps"] == PREEMPT_AT
                and len(signals) == 1 and len(drains) == 1
                and drains[0]["tag"] == drain_tag and ok_drain):
            raise AssertionError("preemptible: no drain into a committed tag "
                                 "on SIGTERM")
        mark("preempted")

        # corrupt the drain's tag; another seed's engine resumes: the
        # fallback lands on the step-2 tag and the loader on batch 2
        corrupt = fault_injection.CorruptRandomBytes(match="model_states.npz")
        corrupt.fire("ckpt.post_write",
                     path=os.path.join(ck, drain_tag, "model_states.npz"))
        bad_ok, _ = verify_tag(ck, drain_tag)
        r, rloader = engine(other_seed, wall_clock_breakdown=True,
                            steps_per_print=4, **telemetry("resumed"))
        del lines.lines[:]
        load_s = []
        r.load_checkpoint = _synced_timer(r.load_checkpoint, load_s)
        with _CkptTimers() as timers:
            rres = ElasticTrainRunner(r, ck, save_interval=1 << 30,
                                      supervision=sup).run(
                rloader, max_steps=N - 2)
        load_parts = dict(timers.seconds)
        said = [m for m in lines.lines if "FELL BACK to tag elastic_step2" in m]
        breakdown = [m.split("time (ms) | ", 1)[1] for m in lines.lines
                     if "time (ms) | " in m]
        restores = _events(ck, "data.iterator_restore")
        resume_s = _span_seconds(r.tracer, "elastic.resume")
        log(f"[preemptible] after CorruptRandomBytes on {drain_tag} "
            f"(verify_tag {bad_ok}): resume fell back to elastic_step2 "
            f"{bool(said)}; the loader restored to "
            f"{[(e['step'], e['epoch'], e['batch_index']) for e in restores]}")
        check(f"{PREEMPT_AT - 1} steps + async save + a step + SIGTERM drain, "
              f"corrupt drain tag, fallback resume from another seed + "
              f"{N - 2} steps vs straight", _engine_state(r), straight,
              same("losses", pres["losses"][:2] + rres["losses"],
                   straight_losses)
              + same("loader", rloader.state_dict(), straight_loader)
              + ([] if said and not bad_ok else ["no fallback"])
              + ([] if [e["step"] for e in restores] == [2] else
                 ["loader not on batch 2"]))
        # one step's spans: those inside the last train.step
        recs = r.tracer.spans()
        last = max((x for x in recs if x.name == "train.step"),
                   key=lambda x: x.t0)
        step_spans = {x.name for x in recs
                      if x.tid == last.tid and last.t0 <= x.t0
                      and x.t0 + x.dur <= last.t0 + last.dur}
        trace_problems = validate_trace(trace_events(r.tracer))
        # every row after the run's first step has a window to rate
        rows_m = read_metrics(r.metrics_sampler.path)
        sampled = [x["m"] for x in rows_m if x.get("step")]
        log(f"[preemptible] a step's spans {sorted(step_spans)}; "
            f"wall_clock_breakdown lines {breakdown}; trace problems "
            f"{trace_problems}; last metrics row tokens_per_s "
            f"{sampled[-1].get('train.tokens_per_s') if sampled else None}, "
            f"mfu {sampled[-1].get('train.mfu') if sampled else None}")
        if step_spans != STEP_SPANS or not breakdown or trace_problems or \
                not sampled or not all(
                    x.get("train.tokens_per_s", 0) > 0
                    and x.get("train.mfu", 0) > 0 for x in sampled[1:]):
            raise AssertionError("preemptible: spans, breakdown, trace or "
                                 "metrics rows wrong")
        # step ms with telemetry (spans, the metrics stream) off and on,
        # in turns; reported, held to nothing
        path = r.metrics_sampler.path
        turns = {"off": [], "on": []}
        for on in (False, True, True, False):
            r.tracer.enabled = on
            r.metrics_sampler.path = path if on else None
            for _ in range(2):
                batch = next(rloader)
                ACCEL.synchronize()
                t0 = time.perf_counter()
                r.train_batch_fused(batch)
                ACCEL.synchronize()
                turns["on" if on else "off"].append(time.perf_counter() - t0)
        step_ms = {k: 1e3 * sum(v) / len(v) for k, v in turns.items()}
        log(f"[preemptible] step ms with telemetry off {step_ms['off']:.2f}, "
            f"on (unsynced spans + metrics stream) {step_ms['on']:.2f}, "
            f"4 steps each in turns off, on, on, off; each step: "
            + ", ".join(f"{k} {[round(1e3 * x, 2) for x in v]}"
                        for k, v in turns.items()))
        r_spans = set(r.tracer.span_inventory())
        del r
        torch.cuda.empty_cache()
        mark("resumed")

        # the NaN window: one step past the verified step-2 tag; the
        # rollback reloads it (past the corrupt step-3 tag), quarantines
        # [restored, divergence + skip_batches) and the run goes on to N,
        # where a save proves the recovery
        q, qloader = engine(seed, **telemetry("rollback"))
        q_load_s = []
        q.load_checkpoint = _synced_timer(q.load_checkpoint, q_load_s)
        nan = fault_injection.NaNLossWindow(NAN_AT, NAN_AT + 1)
        with _CkptTimers() as timers, \
                fault_injection.inject("train.loss", nan):
            qres = ElasticTrainRunner(q, ck, save_interval=N,
                                      nan_abort_threshold=1,
                                      supervision=sup).run(
                qloader, max_steps=N, resume=False)
        q_parts = dict(timers.seconds)
        rollback_s = _span_seconds(q.tracer, "elastic.rollback")
        q_save_s = _span_seconds(q.tracer, "ckpt.save")
        q_spans = set(q.tracer.span_inventory())
        q_state = _engine_state(q)
        q_loader_state = qloader.state_dict()
        del q
        torch.cuda.empty_cache()
        jr = _events(ck)
        rb = [e for e in jr if e["kind"] == "rollback"]
        dq = [e for e in jr if e["kind"] == "data.quarantine"]
        rec = [e for e in jr if e["kind"] == "rollback.recovered"]
        window = [dq[0]["from_step"], dq[0]["to_step"]] if dq else None
        log(f"[preemptible] NaN at step {NAN_AT}: rollbacks "
            f"{qres['rollbacks']}; journal rollback "
            f"{[(e['from_step'], e['to_step'], e['quarantine']) for e in rb]}, "
            f"data.quarantine {window} (divergence step "
            f"{dq[0]['divergence_step'] if dq else None}), rollback.recovered "
            f"{[(e['step'], e['rollbacks']) for e in rec]}; rollback "
            f"{rollback_s} s, the recovery save {q_save_s} s")
        if not (qres["rollbacks"] == 1 and len(rb) == 1 and len(rec) == 1
                and window == [NAN_AT - 1, NAN_AT] and nan.fired == 1
                and rb[0]["to_step"] == NAN_AT - 1):
            raise AssertionError("preemptible: no rollback with the exact "
                                 "quarantine window and recovery")
        qr, qrloader = engine(seed)
        qrloader.quarantine(NAN_AT - 1, NAN_AT)
        qrres = ElasticTrainRunner(qr, os.path.join(work, "quarantined"),
                                   save_interval=1 << 30).run(
            qrloader, max_steps=N, resume=False)
        replay = qres["losses"][:NAN_AT - 1] + qres["losses"][NAN_AT:]
        # the rollback's reset_loss_scale restarts the scaler's good-step
        # count at the reload: it counts the steps since, not all of them
        qr_state = _engine_state(qr)
        good = int(q_state[0]["scale/good_steps"])
        qr_state[0]["scale/good_steps"] = q_state[0]["scale/good_steps"]
        check(f"the rollback's replay vs a straight run with the window "
              f"[{NAN_AT - 1}, {NAN_AT}) installed from the start",
              q_state, qr_state,
              same("losses", replay, qrres["losses"])
              + same("loader", q_loader_state, qrloader.state_dict())
              + same("good steps since the loss-scale reset", good,
                     N - (NAN_AT - 1)))
        del qr, qr_state
        torch.cuda.empty_cache()
        mark("rollback")

        # the rollback run's recovery save, a sync tag, verifies and loads
        # back bitwise into an engine from another seed, its loader on the
        # rollback run's position
        rec_tag = f"elastic_step{N}"
        rec_ok, rec_problems = verify_tag(ck, rec_tag)
        f, floader = engine(other_seed)
        rec_load_s = []
        f.load_checkpoint = _synced_timer(f.load_checkpoint, rec_load_s)
        got_dir, _ = f.load_checkpoint(ck, tag=rec_tag)
        check(f"the recovery save's tag {rec_tag} (sync) loaded into an "
              f"engine from another seed vs the rollback run's end",
              _engine_state(f), q_state,
              same("loader", floader.state_dict(), q_loader_state)
              + ([] if rec_ok else [f"verify_tag {rec_problems}"])
              + ([] if got_dir == ck else ["nothing loaded"]))
        log(f"[preemptible] the recovery tag {rec_tag}: verify_tag {rec_ok}, "
            f"load {rec_load_s[0]:.2f} s")
        del f, q_state
        torch.cuda.empty_cache()
        mark("recovery load")
        spans = p_spans | r_spans | q_spans
        log(f"[preemptible] span inventory over the telemetry runs "
            f"{sorted(spans)}")
        if spans != RUN_SPANS:
            raise AssertionError(f"preemptible: span inventory {sorted(spans)}"
                                 f" != {sorted(RUN_SPANS)}")
    finally:
        port_logger.removeHandler(lines)
        fault_injection.clear()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()

    counts = kernels.launch_counts()
    n_steps = 2 * N + PREEMPT_AT + (N - 2) + 8 + (N + 1) + N
    want = {"flash_fwd": cfg.n_layer, "flash_bwd_fused": cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "fused_adam": 1}
    wrong = {k: counts[k] for k, n in want.items()
             if counts[k] != n * n_steps}
    gb = tag_bytes / 1e9
    drain_s = drains[0]["elapsed_s"]
    res = {"config": f"GPT-2 350M seq {cfg.max_seq_len} bf16 remat attn_out, "
                     f"Adam lr 1e-4 wd 0.01, ZeRO 1, micro "
                     f"{TRAIN_MICRO_BATCH}, gas 1; ResumableDataLoader over "
                     f"{PREEMPT_ROWS} seeded rows, shuffled",
           "tag_bytes": tag_bytes, "async_save_block_s": save_spans[0],
           "drain_save_s": save_spans[1], "drain_s": drain_s,
           "commit_s": commit_spans, "resume_load_s": load_s[0],
           "resume_s": resume_s[0], "resume_load_parts_s": load_parts,
           "rollback_s": rollback_s[0], "rollback_load_s": q_load_s[0],
           "recovery_save_s": q_save_s[0],
           "recovery_load_s": rec_load_s[0],
           "rollback_run_parts_s": q_parts, "watchdog_hang_s": hang_s,
           "step_ms_telemetry": step_ms,
           "step_ms_telemetry_each": {k: [1e3 * x for x in v]
                                      for k, v in turns.items()},
           "losses": straight_losses,
           "breakdown": breakdown, "steps": n_steps, "launches": counts,
           "marks_s": marks, "phase_s": time.perf_counter() - t_phase}
    log(f"[preemptible] on {smi}: {res['config']}: one tag {tag_bytes} bytes")
    log(f"[preemptible] async save at step 2: caller blocked "
        f"{save_spans[0]:.2f} s; the drain's save {save_spans[1]:.2f} s, "
        f"signal to the tag landed (the step-2 writers' end included) "
        f"{drain_s:.2f} s; "
        f"commit spans {[round(x, 2) for x in commit_spans]} s")
    log(f"[preemptible] resume (fallback past the corrupt tag) load "
        f"{load_s[0]:.2f} s ({gb / load_s[0]:.2f} GB/s), elastic.resume "
        f"{resume_s[0]:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in load_parts.items()))
    log(f"[preemptible] rollback (reload past the corrupt tag + quarantine) "
        f"{rollback_s[0]:.2f} s, its load {q_load_s[0]:.2f} s; the recovery "
        f"save {q_save_s[0]:.2f} s, its load {rec_load_s[0]:.2f} s; "
        f"that run's checkpoint parts: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in q_parts.items()))
    log(f"[preemptible] {n_steps} steps, launches {counts}; phase "
        f"{res['phase_s']:.1f} s, cumulative at each part's end "
        + ", ".join(f"{k} {v:.1f} s" for k, v in marks.items()))
    if wrong:
        raise AssertionError(f"preemptible: launches per step off {want}: "
                             f"{wrong} over {n_steps} steps")
    return res, counts


#: the GPT-Neo training slice: GPT-Neo 1.3B at its published context of
#: 2048, micro-batch 8: 16,384 tokens per step, as GPT-2 350M's
NEO_MICRO_BATCH = 8


def run_neo_training(warmup=2, steps=10):
    """The GPT-Neo 1.3B training path: its published widths at seq 2048
    (bf16, remat ``attn_out``, random weights from a seed) under the GPT
    step's optimizer (Adam lr 1e-4 wd 0.01, ZeRO 1, gas 1), micro-batch 8;
    counts reset before and read after.  Each step launches ``flash_fwd``
    and ``flash_bwd_fused`` causal on the 12 even (global) layers and with
    their window option on the 12 odd (local) ones.  The one-row bf16-vs-fp32 host check runs at seq
    1024, past the window; MFU uses the JAX package's count, and the
    attention FLOPs of the live band are reported beside it."""
    cfg = dataclasses.replace(GPT_NEO_1_3B, max_seq_len=2048,
                              dtype=torch.bfloat16, remat=True,
                              remat_policy="attn_out")
    L, n_band = cfg.n_layer, cfg.n_layer // 2
    want = {"flash_fwd": L, "flash_fwd[window]": n_band, "flash_bwd_fused": L,
            "flash_bwd_fused[window]": n_band, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "fused_adam": 1}
    res, counts, engine, batch = _train_full_width(
        "neo train", "GPT-Neo 1.3B", cfg, NEO_MICRO_BATCH, want, warmup,
        steps, row_seq=1024)
    S, D, H = cfg.max_seq_len, cfg.head_dim, cfg.n_head
    causal_pairs = S * (S + 1) // 2
    band_pairs = sum(min(i + 1, cfg.local_attention_window) for i in range(S))
    # attention FLOPs per step on live pairs: forward 4·D, dq 6·D, dk/dv
    # 8·D per pair (remat attn_out runs the forward once)
    live = NEO_MICRO_BATCH * H * 18 * D * (
        (L - n_band) * causal_pairs + n_band * band_pairs)
    dense_term = 12.0 * L * cfg.d_model * S * NEO_MICRO_BATCH * S
    step_s = res["step_ms_mean"] / 1e3
    tokens = NEO_MICRO_BATCH * S
    res.update({"band_pairs_per_row": band_pairs,
                "causal_pairs_per_row": causal_pairs,
                "attention_flops_per_step_live_pairs": live,
                "attention_flops_per_step_dense_term": dense_term,
                "mfu_live_pairs": (res["flops_per_token"] * tokens
                                   - dense_term + live) / step_s / BF16_FLOPS})
    log(f"[neo train] attention FLOPs per step on live pairs {live:.4e} "
        f"(12 causal layers of {causal_pairs} pairs a row, 12 banded of "
        f"{band_pairs}) vs the dense term of flops_per_token "
        f"{dense_term:.4e}; MFU with the live pairs in place of the dense "
        f"term {res['mfu_live_pairs']:.4f}")
    return res, counts, engine, batch


def run_sparse_training(warmup=2, steps=10, model="GPT-2 350M",
                        base=gpt.GPT2_350M, label="sparse train"):
    """Phase 7: the sparse training slice, GPT-2 350M (or, phase 7b, GPT-2
    760M through the D 96 kernels) at seq 4096 under the Fixed
    block-sparse layout, micro-batch 4; counts reset before and read
    after: the block-sparse trio once a layer per step, no flash kernel.
    The one-row bf16-vs-fp32 host check runs at seq 1024 under the same
    layout config (the host's plain attention at 4096 would take
    minutes)."""
    cfg = dataclasses.replace(base, max_seq_len=SPARSE_SEQ,
                              dtype=torch.bfloat16, remat=True,
                              remat_policy="attn_out",
                              sparse_attention=fixed_layout_config(base.n_head))
    want = {"block_sparse_fwd": cfg.n_layer, "block_sparse_bwd_dq": cfg.n_layer,
            "block_sparse_bwd_dkv": cfg.n_layer, "fused_adam": 1,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": 0}
    res, counts, engine, batch = _train_full_width(
        label, model, cfg, SPARSE_MICRO_BATCH, want, warmup, steps,
        row_seq=1024)
    plan = kernels.config_plan(cfg.sparse_attention, SPARSE_SEQ, True, "cuda")
    D, n = cfg.head_dim, SPARSE_SEQ // plan.block
    # attention FLOPs per step on live pairs: forward 4·D, dq 6·D, dk/dv
    # 8·D per pair (remat attn_out runs the forward once)
    live = cfg.n_layer * SPARSE_MICRO_BATCH * plan.live_pairs * 18 * D
    dense_term = 12.0 * cfg.n_layer * cfg.d_model * cfg.max_seq_len * \
        SPARSE_MICRO_BATCH * cfg.max_seq_len
    res.update({"live_blocks_per_row": plan.live_blocks,
                "live_pairs_per_row": plan.live_pairs,
                "attention_flops_per_step_live_pairs": live,
                "attention_flops_per_step_dense_term": dense_term,
                "causal_block_density": plan.live_blocks / (
                    cfg.n_head * n * (n + 1) / 2)})
    res["head_dim"] = D
    log(f"[{label}] {plan.live_blocks} live blocks per row "
        f"({res['causal_block_density']:.3f} of the causal triangle), "
        f"attention FLOPs per step on live pairs {live:.4e} vs the dense "
        f"term of flops_per_token {dense_term:.4e}")
    return res, counts, engine, batch


def run_dense_at_sparse_shape(warmup=1, steps=3):
    """The same model, seq and micro-batch with dense causal flash: what
    the sparse layout buys end to end.  Not a main path; its launches are
    not counted, but each step must take the fused backward on every
    layer (seq 4096 is the longest that does)."""
    cfg = dataclasses.replace(gpt.GPT2_350M, max_seq_len=SPARSE_SEQ,
                              dtype=torch.bfloat16, remat=True,
                              remat_policy="attn_out")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg),
        config={**TRAIN_CONFIG,
                "train_micro_batch_size_per_gpu": SPARSE_MICRO_BATCH},
        generator=torch.Generator(device="cuda").manual_seed(2024))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SPARSE_MICRO_BATCH, cfg.max_seq_len + 1))}
    before = kernels.launch_counts()
    losses, times = _timed_steps(engine, batch, warmup, steps)
    took = {k: (kernels.launch_counts()[k] - before[k]) / (warmup + steps)
            for k in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"[dense train] backward launches per step {took} (seq 4096: four "
        f"key blocks of 1024, the fused form)")
    if took != {"flash_bwd_fused": cfg.n_layer, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}:
        raise AssertionError(f"dense train at seq 4096: backward launches "
                             f"per step {took}")
    res = {"step_ms_p50": 1e3 * pct(times, 50),
           "step_ms_mean": 1e3 * sum(times) / len(times),
           "tokens_per_s": SPARSE_MICRO_BATCH * SPARSE_SEQ * len(times)
           / sum(times), "losses": losses}
    log(f"[dense train] same model at seq {SPARSE_SEQ}, micro-batch "
        f"{SPARSE_MICRO_BATCH}, dense causal flash: step_ms p50 "
        f"{res['step_ms_p50']:.2f} mean {res['step_ms_mean']:.2f}, "
        f"tokens_per_s {res['tokens_per_s']:.0f}")
    del engine
    torch.cuda.empty_cache()
    return res


def _host_tree(tree):
    """A copy of a tree of (device) tensors on the host."""
    return {k: _host_tree(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


#: the BERT slice: micro-batch 64 of right-padded MLM rows at seq 128
BERT_MICRO_BATCH = 64


def run_bert_training(warmup=2, steps=10):
    """The BERT slice's main path: ``initialize(model=from_bert(BERT-large
    seq 128, bf16, remat), config=<the tutorial's LAMB, clip 1.0,
    micro-batch 64, bf16>)`` → ``train_batch_fused``, ``warmup`` + ``steps``
    timed steps on one seeded right-padded MLM batch; every launch count is
    reset before and read after.  One row's bf16 loss is held against the
    fp32 host loss before the first step.  Returns (results, counts,
    engine, batch)."""
    cfg = BERT_LARGE_128
    ACCEL.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_bert(cfg),
        config={"train_micro_batch_size_per_gpu": BERT_MICRO_BATCH,
                "gradient_accumulation_steps": 1,
                "steps_per_print": 1 << 30,
                "optimizer": {"type": "Lamb", "params": LAMB_PARAMS},
                "gradient_clipping": 1.0, "bf16": {"enabled": True}},
        generator=torch.Generator(device="cuda").manual_seed(2024))
    if list(engine.state["opt_state"]["segments"]) != bert_segments(cfg)[0]:
        raise AssertionError("the engine's LAMB segments are not BERT-large's "
                             "24 leaves")
    batch = mlm_batch(BERT_MICRO_BATCH, cfg.max_seq_len, cfg.vocab_size,
                      np.random.default_rng(0))
    row = {k: v[:1] for k, v in batch.items()}
    card_row = float(engine.eval_loss(row))
    host_params = _host_tree(engine.state["master"])
    host_cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    with torch.no_grad():
        host_row = float(bert.loss_fn(
            host_params, {k: torch.from_numpy(np.asarray(v)) for k, v in row.items()},
            host_cfg))
    del host_params
    row_rel = abs(card_row - host_row) / abs(host_row)
    log(f"[bert train] one row ({int(row['seq_lens'][0])} tokens, "
        f"{int((row['mlm_labels'] >= 0).sum())} labelled) before the first "
        f"step: bf16 card loss {card_row:.5f}, fp32 host loss {host_row:.5f}, "
        f"relative diff {row_rel:.4f} (tol 0.02)")
    if not row_rel <= 0.02:
        raise AssertionError(f"bert train: full-width bf16 loss off the fp32 "
                             f"host: {row_rel}")

    kernels.reset_launch_counts()
    losses, times = _timed_steps(engine, batch, warmup, steps)
    counts = kernels.launch_counts()
    n_steps = warmup + steps
    live = int(batch["seq_lens"].sum())
    padded = BERT_MICRO_BATCH * cfg.max_seq_len
    mean_s = sum(times) / len(times)
    flops_tok = bert.flops_per_token(cfg)
    res = {"config": "BERT-large seq 128 bf16 remat, flash with per-row "
                     "kv_lens, LAMB lr 11e-3 wd 0.01 no bias correction "
                     "clamp [0.01, 0.3], clip 1.0, micro 64, gas 1",
           "losses": losses, "step_ms_p50": 1e3 * pct(times, 50),
           "step_ms_mean": 1e3 * mean_s,
           "samples_per_s": BERT_MICRO_BATCH / mean_s,
           "tokens_per_s_live": live / mean_s,
           "tokens_per_s_padded": padded / mean_s,
           "live_tokens_per_step": live, "padded_tokens_per_step": padded,
           "mfu": padded / mean_s * flops_tok / BF16_FLOPS,
           "flops_per_token": flops_tok,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": {k: v / n_steps for k, v in counts.items()},
           "row_loss_card_bf16": card_row, "row_loss_host_fp32": host_row}
    log(f"[bert train] BERT-large seq {cfg.max_seq_len} bf16 remat, LAMB, "
        f"micro-batch {BERT_MICRO_BATCH} ({live} live of {padded} tokens), "
        f"{warmup} warm-up + {steps} timed steps: step_ms p50 "
        f"{res['step_ms_p50']:.2f} mean {res['step_ms_mean']:.2f}, "
        f"samples_per_s {res['samples_per_s']:.2f}, tokens_per_s live "
        f"{res['tokens_per_s_live']:.0f} padded "
        f"{res['tokens_per_s_padded']:.0f}, MFU {res['mfu']:.4f} (of 989 "
        f"TFLOP/s, flops_per_token {flops_tok:.4e}, padded tokens), "
        f"max_memory_allocated {res['max_memory_allocated_gib']:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[bert train] launches per step {res['launches_per_step']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bert train: losses not finite and falling: "
                             f"{losses}")
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_bwd_fused": cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "fused_lamb_phase1": 1,
            "fused_lamb_phase2": 1, "fused_adam": 0, "block_sparse_fwd": 0}
    wrong = {k: counts[k] for k, n in want.items() if counts[k] != n * n_steps}
    if wrong:
        raise AssertionError(f"bert train: launches per step off {want}: "
                             f"{wrong} over {n_steps} steps")
    return res, counts, engine, batch


#: the route check's sequence: five key blocks of 1024, past
#: MAX_FUSED_BWD_NK, where the JAX package takes the two-kernel backward
ROUTE_SEQ = 5120


def run_route_check():
    """One step of a tiny-width GPT (2 layers, d 128, 2 heads of 64, GPT-Neo's
    alternating window 256, bf16, remat ``attn_out``) at seq 5120,
    micro-batch 1, through ``initialize`` → ``train_batch_fused``, counts
    reset before and read after: past four key blocks of 1024 the backward
    takes the pair, ``flash_bwd_dq`` and ``flash_bwd_dkv`` once a layer (the
    local layer's with the window), and ``flash_bwd_fused`` never.  Returns
    (results, counts)."""
    cfg = gpt.GPTConfig(vocab_size=512, max_seq_len=ROUTE_SEQ, n_layer=2,
                        n_head=2, d_model=128, dtype=torch.bfloat16,
                        remat=True, remat_policy="attn_out",
                        local_attention_window=OPTION_WINDOW,
                        local_attention_alternating=True)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg),
        config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 1},
        generator=torch.Generator(device="cuda").manual_seed(77))
    batch = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, ROUTE_SEQ + 1))}
    kernels.reset_launch_counts()
    loss = float(engine.train_batch_fused(batch))
    ACCEL.synchronize()
    counts = kernels.launch_counts()
    want = {"flash_fwd": 2, "flash_fwd[window]": 1, "flash_bwd_dq": 2,
            "flash_bwd_dkv": 2, "flash_bwd_dq[window]": 1,
            "flash_bwd_dkv[window]": 1, "flash_bwd_fused": 0, "fused_adam": 1}
    got = {k: counts[k] for k in want}
    log(f"[route] tiny GPT (2 layers, d 128, window 256 on the odd layer) at "
        f"seq {ROUTE_SEQ}, one step: loss {loss:.4f}, launches {got} "
        f"(want {want})")
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"route check at seq {ROUTE_SEQ}: launches {got}, "
                             f"loss {loss}")
    del engine
    torch.cuda.empty_cache()
    return {"seq": ROUTE_SEQ, "loss": loss, "launches": got}, counts


#: the full-width training paths' numbers when their backward ran the
#: two-kernel pair (this script on an NVIDIA H100 80GB HBM3 at 700.00 W),
#: printed beside this run's: step ms p50, step ms mean, MFU, peak GiB,
#: busy share
PAIR_BACKWARD_TRAINING = {"train": (242.79, 242.85, 0.1658, 24.00, 0.960),
                 "neo train": (567.04, 567.17, 0.2659, 41.83, 0.983),
                 "bert train": (158.78, 158.01, 0.1076, 11.87, 0.472)}


def vs_pair_backward(label, res, profile):
    """Log a training path's step ms p50 and mean, MFU, peak memory and
    busy share beside ``PAIR_BACKWARD_TRAINING``'s."""
    now = (res["step_ms_p50"], res["step_ms_mean"], res["mfu"],
           res["max_memory_allocated_gib"], profile["device_busy_share"])
    old = PAIR_BACKWARD_TRAINING[label]
    names = ("step_ms p50", "step_ms mean", "MFU", "peak GiB", "busy share")
    log(f"[{label} vs the pair backward] " + ", ".join(
        f"{k} {a:.4f} (pair {b}, {a / b:.4f}x)" for k, a, b in zip(names, now, old)))
    return dict(zip(names, now))


def _timed_steps(engine, batch, warmup, steps):
    losses, times = [], []
    for i in range(warmup + steps):
        ACCEL.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch_fused(batch)
        ACCEL.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        losses.append(loss)
    return [float(x) for x in losses], times


def _train_full_width(label, model, cfg, micro, want, warmup, steps, row_seq):
    """``initialize`` → ``train_batch_fused`` at full width on one batch:
    one row's bf16 loss against the fp32 host before the first step, then
    ``warmup`` + ``steps`` timed steps with every launch count reset before
    and read after; checks finite, falling losses and the launches per
    step in ``want``.  The row's loss is held to 0.02 relative, or, for a
    banded model (GPT-Neo) where that fails, to ``FAMILY_SENSITIVITY``
    times the same row's error with every layer global (the unscaled
    softmax at random init, as for the family's logits).  Returns
    (results, counts, engine, batch)."""
    ACCEL.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=from_gpt(cfg),
        config={**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": micro},
        generator=torch.Generator(device="cuda").manual_seed(2024))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (micro, cfg.max_seq_len + 1))}
    row = {"tokens": batch["tokens"][:1, :row_seq + 1]}
    card_row = float(engine.eval_loss(row))
    host_cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    host_params = _host_tree(engine.state["master"])
    host_tokens = {"tokens": torch.from_numpy(row["tokens"])}
    t_host = time.perf_counter()
    with torch.no_grad():
        host_row = float(gpt.loss_fn(host_params, host_tokens, host_cfg))
    host_s = time.perf_counter() - t_host
    row_rel = abs(card_row - host_row) / abs(host_row)
    log(f"[{label}] one row of {row_seq} tokens before the first step: bf16 "
        f"card loss {card_row:.5f}, fp32 host loss {host_row:.5f} ({host_s:.1f} "
        f"s on the host), relative diff {row_rel:.4f} (tol 0.02)")
    row_res = {"row_loss_card_bf16": card_row, "row_loss_host_fp32": host_row,
               "row_rel_diff": row_rel, "row_rule": "0.02", "row_seq": row_seq,
               "row_host_s": host_s}
    if not row_rel <= 0.02 and cfg.local_attention_window > 0:
        unbanded = {"local_attention_window": 0,
                    "local_attention_alternating": False}
        with torch.no_grad():
            card_g = float(gpt.loss_fn(
                engine.state["params"],
                {"tokens": host_tokens["tokens"].cuda()},
                dataclasses.replace(cfg, **unbanded)))
            host_g = float(gpt.loss_fn(host_params, host_tokens,
                                       dataclasses.replace(host_cfg,
                                                           **unbanded)))
        global_rel = abs(card_g - host_g) / abs(host_g)
        tol = FAMILY_SENSITIVITY * global_rel
        row_res.update(row_rel_diff_every_layer_global=global_rel,
                       row_rule=f"{FAMILY_SENSITIVITY} x every layer global",
                       row_tol=tol)
        log(f"[{label}] 0.02 fails; the same row with every layer global: "
            f"bf16 card {card_g:.5f}, fp32 host {host_g:.5f}, relative diff "
            f"{global_rel:.4f}; the banded row's tol {FAMILY_SENSITIVITY} x "
            f"that = {tol:.4f}, its diff {row_rel:.4f}")
        if not row_rel <= tol:
            raise AssertionError(f"{label}: full-width bf16 loss off the "
                                 f"fp32 host: {row_rel} > {tol}")
    elif not row_rel <= 0.02:
        raise AssertionError(f"{label}: full-width bf16 loss off the fp32 "
                             f"host: {row_rel}")
    del host_params

    kernels.reset_launch_counts()
    losses, times = _timed_steps(engine, batch, warmup, steps)
    counts = kernels.launch_counts()
    n_steps = warmup + steps
    tokens = micro * cfg.max_seq_len
    mean_s = sum(times) / len(times)
    layout = "" if cfg.sparse_attention is None else \
        ", Fixed block-sparse block 64"
    res = {"config": f"{model} seq {cfg.max_seq_len} bf16 remat attn_out"
                     f"{layout}, Adam lr 1e-4 wd 0.01, ZeRO 1, micro {micro}, "
                     f"gas 1",
           "losses": losses, "step_ms_p50": 1e3 * pct(times, 50),
           "step_ms_mean": 1e3 * mean_s, "samples_per_s": micro / mean_s,
           "tokens_per_s": tokens / mean_s,
           "mfu": tokens / mean_s * gpt.flops_per_token(cfg) / BF16_FLOPS,
           "flops_per_token": gpt.flops_per_token(cfg),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": {k: v / n_steps for k, v in counts.items()},
           # what remat "attn_out" keeps per layer: the block input x and
           # the attention's O (bf16 [B, S, d]) and lse (fp32 [B, H, S])
           "remat_bytes_per_layer": (2 * micro * cfg.max_seq_len
                                     * cfg.d_model * 2 + micro
                                     * cfg.n_head * cfg.max_seq_len * 4),
           **row_res}
    log(f"[{label}] {model} seq {cfg.max_seq_len}{layout} bf16, "
        f"micro-batch {micro}, {warmup} warm-up + {steps} timed steps: "
        f"step_ms p50 {res['step_ms_p50']:.2f} mean "
        f"{res['step_ms_mean']:.2f}, samples_per_s {res['samples_per_s']:.2f}, "
        f"tokens_per_s {res['tokens_per_s']:.0f}, MFU {res['mfu']:.4f} (of "
        f"989 TFLOP/s, flops_per_token {res['flops_per_token']:.4e}), "
        f"max_memory_allocated {res['max_memory_allocated_gib']:.2f} GiB, "
        f"remat keeps {res['remat_bytes_per_layer']} bytes per layer; "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[{label}] launches per step {res['launches_per_step']}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite and falling: "
                             f"{losses}")
    wrong = {k: counts[k] for k, n in want.items() if counts[k] != n * n_steps}
    if wrong:
        raise AssertionError(f"{label}: launches per step off {want}: {wrong} "
                             f"over {n_steps} steps")
    return res, counts, engine, batch


# ------------------------------------------------------------ diffusion

#: the spatial kernel's shapes on the diffusion path: 320 channels at
#: 64x64 (the UNet's first level), the 8x8x1280 calls (18 of 66 per UNet
#: forward), the VAE's 512x512x128, a 4-channel output conv
SPATIAL_SHAPES = ((1, 64, 64, 320), (1, 8, 8, 1280), (1, 512, 512, 128),
                  (1, 64, 64, 4))
#: variant name and its extra operands (other, other_bias)
SPATIAL_VARIANTS = (("nhwc_bias_add", 0), ("nhwc_bias_add_add", 1),
                    ("nhwc_bias_add_bias_add", 2))
#: the variants no path of the JAX package calls: held in the check phase
#: only, and kept out of the never-launched assert
CHECK_ONLY = ("nhwc_bias_add_add", "nhwc_bias_add_bias_add")


def _spatial_operands(shape, extra, dtype, gen, offset=0, bias_offset=0):
    """x [shape], bias [C] (, other [shape] (, other_bias [C])) on the
    card; ``offset`` starts x and other that many elements into their
    buffers, so their rows are not 16-byte aligned (the scalar path);
    ``bias_offset`` does the same to the biases (aligned rows with the
    scalar bias walk)."""
    n, C = math.prod(shape), shape[-1]

    def rows():
        buf = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
        return buf[offset:].view(shape)

    def bias():
        buf = torch.randn(C + bias_offset, generator=gen,
                          device="cuda").to(dtype)
        return buf[bias_offset:]

    ops = [rows(), bias()]
    if extra >= 1:
        ops.append(rows())
    if extra >= 2:
        ops.append(bias())
    return ops


def _library_sum(ops):
    """The PyTorch yardstick: ``x + b`` (``+ other``, ``+ other_bias``),
    one call per add, each rounding to x's dtype."""
    out = ops[0] + ops[1]
    for t in ops[2:]:
        out = out + t
    return out


def spatial_edge_cases():
    """(shape, x offset, bias offset) of the spatial kernel's launch and
    bias paths beyond the diffusion shapes: C = 3 from unaligned rows (the
    scalar walk), SD's first level with its bias one element into its
    buffer (aligned rows, scalar biases), C = 12 (not a multiple of bf16's
    8-wide vector) and a [1, 1, SMs, 1280] tensor (one row per SM: the
    one-vector-per-thread launch)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (((1, 33, 17, 3), 1, 0), ((1, 64, 64, 320), 0, 1),
            ((1, 16, 16, 12), 0, 0), ((1, 1, sms, 1280), 0, 0))


def check_spatial():
    """The three NHWC bias-add variants, bitwise against the plain version
    in bf16 and fp32 at every shape of ``SPATIAL_SHAPES`` and at
    :func:`spatial_edge_cases`; timed in bf16 (kernel, plain version,
    ``_library_sum``) at each shape of ``SPATIAL_SHAPES``."""
    gen = torch.Generator(device="cuda").manual_seed(61)
    rows = []
    edges = spatial_edge_cases()
    cases = [(s, d, 0, 0) for s in SPATIAL_SHAPES
             for d in (torch.bfloat16, torch.float32)]
    cases += [(s, d, off, boff) for s, off, boff in edges
              for d in (torch.bfloat16, torch.float32)]
    for name, extra in SPATIAL_VARIANTS:
        fn = getattr(kernels, name)
        for shape, dtype, off, boff in cases:
            ops = _spatial_operands(shape, extra, dtype, gen, off, boff)
            if not torch.equal(fn(*ops), kernels.nhwc_bias_add_reference(*ops)):
                raise AssertionError(f"{name} {shape} {dtype} offset {off} "
                                     f"bias offset {boff}: kernel differs "
                                     "from the plain version")
        log(f"[spatial] {name}: bitwise equal to the plain version in bf16 "
            f"and fp32 at {list(SPATIAL_SHAPES)} and at (shape, x offset, "
            f"bias offset) {list(edges)}")
        for shape in SPATIAL_SHAPES:
            numel, C = math.prod(shape), shape[-1]
            per_set = (2 + (extra >= 1)) * numel * 2
            n = max(1, min(8, (256 << 20) // per_set))
            sets = [_spatial_operands(shape, extra, torch.bfloat16, gen)
                    for _ in range(n)]
            ops = sets[0]
            ref = kernels.nhwc_bias_add_reference(*[t.float() for t in ops])
            err = (fn(*ops).float() - ref).abs().max().item()
            tol = 2.0 ** -8 * max(1.0, ref.abs().max().item())
            ms = time_ms(lambda i: fn(*sets[i % n]), 50)
            plain_ms = time_ms(
                lambda i: kernels.nhwc_bias_add_reference(*sets[i % n]), 10)
            lib_ms = time_ms(lambda i: _library_sum(sets[i % n]), 50)
            nbytes = per_set + (1 + (extra >= 2)) * C * 2
            rows.append(_report(name, f"{list(shape)} bf16", err, tol, ms,
                                plain_ms, lib_ms, nbytes, (1 + extra) * numel,
                                FP32_FLOPS))
    return rows


#: the bias-GeLU kernels' shape: GPT-2 350M's MLP hidden at micro-batch 16,
#: seq 1024
BG_SHAPE = (16 * 1024, 4096)
#: FLOPs per element counted for the bound: the fp32 arithmetic of the
#: Pallas source (tanh as one), forward and backward
BG_FLOPS = (20, 30)


def check_bias_gelu():
    """``bias_gelu_fwd``/``bias_gelu_bwd`` at [16384, 4096]: the dropout
    mask bitwise equal to the plain version's (inputs with x + b > 0, so
    y and dx are 0 exactly where dropped) at rate 0.1 and 0.4; values
    against the fp32 plain versions in bf16 (``BF16_REL_TOL``) and fp32
    (1e-5 relative) at rate 0.1 and 0; two backward runs bitwise equal;
    timed in bf16 against the plain versions and ``F.gelu(x + b,
    approximate="tanh")`` (its autograd backward for the backward)."""
    gen = torch.Generator(device="cuda").manual_seed(62)
    R, C = BG_SHAPE
    xpos = (torch.rand(R, C, generator=gen, device="cuda") + 0.1).to(
        torch.bfloat16)
    zero_b = torch.zeros(C, device="cuda", dtype=torch.bfloat16)
    for rate, seed in ((0.1, 5), (0.4, 6)):
        dropped = kernels.keep_mask(R, C, rate, seed, "cuda") == 0.0
        y = kernels.bias_gelu_fwd(xpos, zero_b, rate, seed)
        dx, _ = kernels.bias_gelu_bwd(xpos, zero_b, torch.ones_like(xpos),
                                      rate, seed)
        if not (torch.equal(y == 0, dropped) and torch.equal(dx == 0, dropped)):
            raise AssertionError(f"bias_gelu rate {rate}: the kernels' mask "
                                 "differs from the plain version's")
        log(f"[bias_gelu] rate {rate}: forward and backward masks bitwise "
            f"equal to the plain version's, dropped share "
            f"{dropped.float().mean().item():.5f}")
    del xpos
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
        b = torch.randn(C, generator=gen, device="cuda").to(dtype)
        g = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
        for rate in (0.1, 0.0):
            y = kernels.bias_gelu_fwd(x, b, rate, 11)
            dx, db = kernels.bias_gelu_bwd(x, b, g, rate, 11)
            dx2, db2 = kernels.bias_gelu_bwd(x, b, g, rate, 11)
            if not (torch.equal(dx, dx2) and torch.equal(db, db2)):
                raise AssertionError("bias_gelu_bwd: two runs differ")
            x32, b32, g32 = x.float(), b.float(), g.float()
            ry = kernels.bias_gelu_forward_reference(x32, b32, rate, 11)
            rdx, rdb = kernels.bias_gelu_backward_reference(x32, b32, g32,
                                                            rate, 11)
            rel = BF16_REL_TOL if dtype == torch.bfloat16 else 1e-5
            errs, tols = [], []
            for got, ref in ((y, ry), (dx, rdx), (db, rdb)):
                errs.append((got.float() - ref).abs().max().item())
                tols.append(rel * max(1.0, ref.abs().max().item()))
            del ry, rdx, rdb
            label = f"[{R}, {C}] {str(dtype)[6:]} rate {rate}"
            log(f"[bias_gelu] {label}: max_abs_err y {errs[0]:.3e} dx "
                f"{errs[1]:.3e} db {errs[2]:.3e} (tol {tols[0]:.3e}, "
                f"{tols[1]:.3e}, {tols[2]:.3e}); two backward runs bitwise "
                "equal")
            if not all(e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"bias_gelu {label}: errors {errs} > "
                                     f"tols {tols}")
            if dtype == torch.float32:
                continue
            n = R * C
            ms_f = time_ms(lambda i: kernels.bias_gelu_fwd(x, b, rate, i), 10)
            ms_b = time_ms(
                lambda i: kernels.bias_gelu_bwd(x, b, g, rate, i), 10)
            plain_f = eager_ms(lambda: kernels.bias_gelu_forward_reference(
                x, b, rate, 11), 3)
            plain_b = eager_ms(lambda: kernels.bias_gelu_backward_reference(
                x, b, g, rate, 11), 3)
            gelu = torch.nn.functional.gelu
            lib_f = time_ms(lambda i: gelu(x + b, approximate="tanh"), 10)
            xl, bl = x.detach().requires_grad_(True), \
                b.detach().requires_grad_(True)
            out = gelu(xl + bl, approximate="tanh")
            lib_b = eager_ms(lambda: torch.autograd.grad(
                out, (xl, bl), g, retain_graph=True), 5)
            del out
            parts = -(-R // kernels.fused_bias_gelu.BLOCK_ROWS) * C * 4
            rows.append(_report("bias_gelu_fwd", label, errs[0], tols[0],
                                ms_f, plain_f, lib_f, 2 * n * 2 + C * 2,
                                BG_FLOPS[0] * n, FP32_FLOPS))
            rows.append(_report("bias_gelu_bwd", label, errs[1], tols[1],
                                ms_b, plain_b, lib_b,
                                3 * n * 2 + parts + 2 * C * 2,
                                BG_FLOPS[1] * n, FP32_FLOPS))
        del x, b, g, y, dx, db, dx2, db2
    torch.cuda.empty_cache()
    return rows


#: the SD-1.5-shaped tiny configuration of the JAX package's
#: test_full_sd15_shaped_conversion_and_denoise, fp32
TINY_UNET = diffusion.UNetConfig(
    in_channels=4, out_channels=4, block_channels=(8, 16, 32, 32),
    layers_per_block=2, cross_attn_dim=16, n_head=2, groups=4,
    attn_levels=(True, True, True, False))
TINY_VAE = diffusion.VAEConfig(in_channels=3, latent_channels=4,
                               block_channels=(8, 8, 16, 32),
                               layers_per_block=2, groups=4)


def _noisy(tree, gen, std=0.1):
    """Seeded noise on every leaf (no bias zero, no norm the identity)."""
    if isinstance(tree, dict):
        return {k: _noisy(v, gen, std) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_noisy(v, gen, std) for v in tree]
    return tree + std * torch.randn(tree.shape, generator=gen)


def check_tiny_diffusion():
    """The diffusion serving path in fp32 on the card (kernels) vs on the
    host (plain versions): the same diffusers state dicts through
    ``init_inference``, a guided 2-step DDIM and VAE decode to 64x64 from
    the same noise; then a second card run, bitwise equal."""
    gen = torch.Generator().manual_seed(71)
    usd = export_unet_sd(_noisy(diffusion.unet_init(TINY_UNET, gen), gen))
    vsd = export_vae_sd(_noisy(diffusion.vae_init(TINY_VAE, gen), gen))
    ctx = torch.randn((1, 5, 16), generator=gen)
    conf = {"dtype": "float32", "n_head": 2, "groups": 4}

    def image(device):
        unet = deepspeed_tpu_torch.init_inference(usd, conf, device=device)
        vae = deepspeed_tpu_torch.init_inference(vsd, conf, device=device)
        c = ctx.to(device)
        return DiffusionPipeline(unet, vae)(
            c, torch.zeros_like(c), steps=2, guidance_scale=7.5, height=64,
            width=64, generator=torch.Generator().manual_seed(3)).cpu()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card, host, again = image("cuda"), image("cpu"), image("cuda")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    err = (card - host).abs().max().item()
    tol = 1e-4 * host.abs().max().item()
    bitwise = torch.equal(card, again)
    log(f"[tiny diffusion] fp32, guided 2 DDIM steps + decode to "
        f"{list(card.shape)}, card vs host: max_abs_err {err:.3e} (tol "
        f"{tol:.3e}); second card run bitwise equal {bitwise}")
    if not (err <= tol and bitwise and torch.isfinite(card).all()):
        raise AssertionError("tiny diffusion: card and host disagree, or two "
                             "card runs differ")
    return {"max_abs_err": err, "tol": tol, "bitwise_repeat": bitwise}


DIFFUSION_STEPS = 50
GUIDANCE = 7.5
#: tensors of a diffusers state dict and parameters, SD-1.5's own
SD15_SIZES = {"unet": (686, 859_520_964), "vae": (248, 83_653_863)}
#: nhwc_bias_add launches per SD-1.5 UNet forward and per VAE decode
UNET_BIAS_ADDS, VAE_BIAS_ADDS = 66, 36


def _rel_l2(out, ref):
    return ((out.float() - ref).norm() / ref.norm()).item()


def _timed(fn, n):
    """Mean host ms of ``fn()`` over ``n`` synchronised calls."""
    ACCEL.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ACCEL.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def run_diffusion():
    """Phase 10: Stable Diffusion 1.5 at its published widths (random
    weights from a seed, bf16) through ``init_inference`` on diffusers
    state dicts → ``DSUNet``/``DSVAE`` → ``DiffusionPipeline``: one prompt,
    guided 50-step DDIM, 512x512; counts reset before the image and read
    after it.  Then launches per UNet forward and VAE decode, their times,
    the fp32 attention scores, FLOPs and MFU, the card's bf16 UNet forward
    and VAE decode against fp32 on the host, and a profile."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    served, host = {}, {}
    for kind, cfg, init, export in (
            ("unet", diffusion.SD15_UNET, diffusion.unet_init,
             export_unet_sd),
            ("vae", diffusion.SD15_VAE, diffusion.vae_init, export_vae_sd)):
        n_tensors, n_params = SD15_SIZES[kind]
        tree = init(cfg, gen)
        sd = export(tree)
        count = diffusion.param_count(tree)
        if len(sd) != n_tensors or count != n_params:
            raise AssertionError(f"SD-1.5 {kind}: {len(sd)} tensors and "
                                 f"{count} parameters, want {n_tensors} and "
                                 f"{n_params}")
        served[kind] = deepspeed_tpu_torch.init_inference(
            model=sd, config={"dtype": "bfloat16"})
        host[kind] = diffusion.cast_params(tree, torch.float32, "cpu")
        del tree, sd
    unet, vae = served["unet"], served["vae"]
    if not (isinstance(unet, DSUNet) and isinstance(vae, DSVAE)
            and dataclasses.replace(unet.config, sample_size=64)
            == diffusion.SD15_UNET and vae.config == diffusion.SD15_VAE):
        raise AssertionError("init_inference did not serve SD-1.5's UNet "
                             "and VAE at their published widths")
    (ut, up), (vt, vp) = SD15_SIZES["unet"], SD15_SIZES["vae"]
    log(f"[diffusion] SD-1.5 UNet ({ut} state-dict tensors, {up:,} "
        f"parameters) and VAE ({vt}, {vp:,}) served in bf16 through "
        "init_inference")
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    pipe = DiffusionPipeline(unet, vae)
    egen = torch.Generator(device="cuda").manual_seed(77)
    embeds = torch.randn((1, 77, 768), generator=egen, device="cuda")
    uncond = torch.zeros_like(embeds)

    def image(steps):
        return pipe(embeds, uncond, steps=steps, guidance_scale=GUIDANCE,
                    height=512, width=512,
                    generator=torch.Generator().manual_seed(7))

    image(2)                                   # warm-up
    ACCEL.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    img = image(DIFFUSION_STEPS)
    ACCEL.synchronize()
    image_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    want = 2 * DIFFUSION_STEPS * UNET_BIAS_ADDS + VAE_BIAS_ADDS
    others = {k: n for k, n in counts.items()
              if n and k != "nhwc_bias_add"}
    finite = bool(torch.isfinite(img).all())
    log(f"[diffusion] guided {DIFFUSION_STEPS}-step DDIM + VAE decode, "
        f"512x512: {image_s:.3f} s per image, {1 / image_s:.4f} images/s, "
        f"image {list(img.shape)} finite {finite}, std "
        f"{img.float().std().item():.4f}; nhwc_bias_add launches "
        f"{counts['nhwc_bias_add']} (want {want}), other kernels {others}; "
        f"peak {peak:.3f} GiB above the resident weights")
    if counts["nhwc_bias_add"] != want or others or not finite or \
            tuple(img.shape) != (1, 512, 512, 3):
        raise AssertionError("diffusion image: wrong launches, shape or "
                             "values")

    lat = torch.randn((1, 64, 64, 4), generator=egen, device="cuda")
    per = {}
    for kind, fn in (("unet", lambda: unet(lat, 500.0, embeds)),
                     ("vae", lambda: vae.decode(lat))):
        kernels.reset_launch_counts()
        fn()
        per[kind] = kernels.launch_counts()["nhwc_bias_add"]
    if per != {"unet": UNET_BIAS_ADDS, "vae": VAE_BIAS_ADDS}:
        raise AssertionError(f"nhwc_bias_add launches per UNet forward and "
                             f"VAE decode {per}")
    unet_ms = _timed(lambda: unet(lat, 500.0, embeds), 5)
    decode_ms = _timed(lambda: vae.decode(lat), 3)
    step_ms = (image_s * 1e3 - decode_ms) / DIFFUSION_STEPS
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        unet(lat, 500.0, embeds)
    flops = fc.get_total_flops()
    mfu = flops / (unet_ms / 1e3) / BF16_FLOPS
    q, k = (torch.randn((1, 8, 4096, 40), generator=egen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    scores_ms = time_ms(lambda i: torch.softmax(
        torch.matmul(q.float(), k.float().transpose(-1, -2))
        / math.sqrt(40), dim=-1).to(torch.bfloat16), 10)
    log(f"[diffusion] UNet forward {unet_ms:.2f} ms ({UNET_BIAS_ADDS} "
        f"nhwc_bias_add launches), DDIM step {step_ms:.2f} ms (two forwards "
        f"and the update), VAE decode {decode_ms:.2f} ms ({VAE_BIAS_ADDS} "
        f"launches); {flops / 1e9:.1f} GFLOP per UNet forward (convolutions "
        f"and matmuls, counted from shapes), MFU {mfu:.4f}; fp32 scores and "
        f"softmax of one 4096-token self-attention (8 heads, d 40) "
        f"{scores_ms:.3f} ms, 5 per forward")

    t = torch.tensor(500.0)
    t0 = time.perf_counter()
    ref = diffusion.unet_apply(host["unet"], lat.cpu(), t, embeds.cpu(),
                               dataclasses.replace(unet.config,
                                                   dtype=torch.float32))
    host_unet_s = time.perf_counter() - t0
    unet_rel = _rel_l2(unet(lat, 500.0, embeds)["sample"].cpu(), ref)
    t0 = time.perf_counter()
    ref = diffusion.vae_decode(host["vae"], lat.cpu(),
                               dataclasses.replace(vae.config,
                                                   dtype=torch.float32))
    host_vae_s = time.perf_counter() - t0
    vae_rel = _rel_l2(vae.decode(lat)["sample"].cpu(), ref)
    del host, ref
    log(f"[diffusion] full-width bf16 card vs fp32 host: UNet forward "
        f"rel_l2_err {unet_rel:.4f}, VAE decode (64x64 latents, 512x512 "
        f"image) rel_l2_err {vae_rel:.4f} (tol 0.05; host {host_unet_s:.1f} "
        f"s and {host_vae_s:.1f} s)")
    if not (unet_rel <= 0.05 and vae_rel <= 0.05):
        raise AssertionError(f"full-width diffusion disagrees with the fp32 "
                             f"host: UNet {unet_rel}, VAE {vae_rel}")
    prof = device_profile("diffusion guided 4 steps + decode 512x512",
                          lambda: image(4).cpu(), shares=("spatial_kernel",))
    res = {"image_s": image_s, "images_per_s": 1 / image_s,
           "unet_forward_ms": unet_ms, "ddim_step_ms": step_ms,
           "vae_decode_ms": decode_ms, "peak_above_resident_gib": peak,
           "unet_flops": flops, "mfu": mfu, "attn_scores_ms": scores_ms,
           "unet_rel_l2_err": unet_rel, "vae_rel_l2_err": vae_rel,
           "profile": prof}
    return res, counts


#: the op phase's activation: GPT-2 350M's MLP hidden, micro-batch 16
BG_OP_SHAPE = (16, 1024, 4096)


def run_bias_gelu_op(calls=3):
    """Phase 11: ``bias_gelu_dropout`` forward and backward through
    autograd at ``BG_OP_SHAPE`` bf16, rate 0.1; counts reset before the
    calls and read after: exactly one launch of each kernel per call; y
    and dx zero wherever the mask drops, dx zero wherever y is (but at
    x + b = 0)."""
    gen = torch.Generator(device="cuda").manual_seed(81)
    shape = BG_OP_SHAPE
    x = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    b = torch.randn(shape[-1], generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    kernels.bias_gelu_dropout(x, b, 0.1, 0).backward(g)      # warm-up
    kernels.reset_launch_counts()
    times, shares = [], []
    for i in range(calls):
        x.grad = b.grad = None
        ACCEL.synchronize()
        t0 = time.perf_counter()
        y = kernels.bias_gelu_dropout(x, b, 0.1, seed=100 + i)
        y.backward(g)
        ACCEL.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        y, dx = y.detach(), x.grad
        # gelu(0) = 0 with gelu'(0) = 1/2: where x + b is exactly 0 (bf16
        # ties) y is zero and dx is not
        zero = (y == 0) & (x.detach().float() + b.detach().float() != 0)
        dropped = kernels.keep_mask(math.prod(shape[:-1]), shape[-1], 0.1,
                                    100 + i, "cuda").view(shape) == 0
        if not ((dx[zero] == 0).all() and (y[dropped] == 0).all()
                and (dx[dropped] == 0).all()):
            raise AssertionError("bias_gelu_dropout: dx is not zero where y "
                                 "is, or a dropped element is not zero")
        shares.append(dropped.float().mean().item())
    counts = kernels.launch_counts()
    others = {k: n for k, n in counts.items()
              if n and k not in ("bias_gelu_fwd", "bias_gelu_bwd")}
    log(f"[bias_gelu op] {calls} calls at {list(shape)} bf16 rate 0.1 "
        f"through autograd: launches fwd {counts['bias_gelu_fwd']} bwd "
        f"{counts['bias_gelu_bwd']} (want {calls} and {calls}), others "
        f"{others}; dropped share {[round(s, 5) for s in shares]}, y and "
        f"dx zero where dropped, dx zero wherever y is (x + b != 0); ms per "
        f"call (host clock) "
        f"{[round(t, 3) for t in times]}")
    if counts["bias_gelu_fwd"] != calls or counts["bias_gelu_bwd"] != calls \
            or others or not all(abs(s - 0.1) < 0.01 for s in shares):
        raise AssertionError("bias_gelu_dropout op: wrong launches or mask")
    return {"ms_per_call": times, "dropped_share": shares}, counts


def main() -> int:
    if not ACCEL.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; host CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} "
        f"threads")
    result = {"nvidia_smi": smi, "torch": torch.__version__}

    t_build = build.build_all()
    log(f"[build] kernels {build.sources()} ready in {t_build:.1f} s")
    log("[build] seconds per source (nvcc in parallel, from the build's "
        "start): " + ", ".join(f"{k} {v:.1f}" for k, v in
                               sorted(build.build_seconds.items(),
                                      key=lambda kv: -kv[1])))
    for name, rep in build.ptxas_reports.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                  rep))
        log(f"[ptxas] {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
            f"{spills} bytes")
    result["build_s"] = t_build
    result["build_s_per_source"] = dict(build.build_seconds)
    result["ptxas_tensor_core"] = check_ptxas_tc()
    result["sass_tensor_core"] = check_sass()
    result["decode_build"] = check_decode_build()
    log(f"[time] build and build checks done at {time.perf_counter() - T0:.1f} s")

    checks = [check_flash(4, 512), check_flash(1, 128), check_flash(16, 1024),
              *[check_decode(B=B, kind=kind) for B, kind in DECODE_CASES],
              check_chunk(128), check_chunk(640),
              *check_flash_bwd(16, 1024), *check_flash_bwd(1, 128),
              check_fused_adam(), *check_block_sparse(), *check_fused_lamb(),
              *check_flash_kv_lens(), *check_quantizer(),
              *[check_decode(B=B, int8=True, kind=kind)
                for B, kind in DECODE_CASES],
              *check_kv_append(), check_chunk(128, int8=True),
              check_chunk(640, int8=True), *check_spatial(),
              *check_bias_gelu(), check_flash_window(),
              *check_flash_bwd_window(),
              *[check_flash_bwd_fused(*shape) for shape in FUSED_BWD_SHAPES],
              *[check_decode_option(opt, int8) for opt in ("window", "alibi")
                for int8 in (False, True)],
              *[check_chunk_option(opt, int8) for opt in ("window", "alibi")
                for int8 in (False, True)],
              *check_head_dims(),
              *[row for _, _, H, D in HEAD_DIM_SHAPES
                for row in check_kv_append(H=H, D=D)]]
    log(f"[time] kernel checks done at {time.perf_counter() - T0:.1f} s")
    check_adam_skip()
    check_lamb_skip()
    result["quantizer_sweep"] = check_quantizer_sweep()
    result["sweep_worst_rel_err"] = check_sweep()
    result["chunk_sweep_worst_rel_err"] = check_chunk_sweep()
    result["sparse_sweep_worst_rel_err"] = check_sparse_sweep()
    result["kv_lens_sweep_worst_rel_err"] = check_kv_lens_sweep()
    result["option_sweep_worst_rel_err"] = check_option_sweep()
    result["fused_sweep_worst_rel_err"] = check_bwd_fused_sweep()
    check_tiny_end_to_end()
    check_tiny_int8()
    result["tiny_training"] = check_tiny_training()
    result["tiny_training_sparse"] = check_tiny_training(sparse=True)
    result["tiny_training_bert"] = check_tiny_training(bert_model=True)
    result["tiny_training_neo"] = check_tiny_training(neo=True)
    result["tiny_diffusion"] = check_tiny_diffusion()
    log(f"[time] sweeps and tiny models done at {time.perf_counter() - T0:.1f} s")

    cfg = gpt.GPT2_350M
    params = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(1234),
                      device="cuda")
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                {"dtype": "bfloat16"})
    params_host = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.cpu())
                   for k, v in params.items()}
    del params
    kernels.reset_launch_counts()
    # read once, after every path: the profiled runs and logits checks,
    # which the launch counts leave out, count here too
    kernels.reset_head_dim_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result["generate"] = run_generate(engine, cfg)
    gen_counts = kernels.launch_counts()
    result["serving"], serve_counts = run_serving(engine, cfg)
    result["serving"]["peak_above_resident_gib"] = \
        (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    log(f"[serving] bf16 generate and serving peak memory above the "
        f"resident {result['serving']['peak_above_resident_gib']:.3f} GiB "
        f"(KV caches, activations)")
    counts = {k: gen_counts[k] + serve_counts[k] for k in gen_counts}
    result["launches"] = {"generate": gen_counts, "serving": serve_counts}
    result["full_width_logits"], bf16_logits = check_full_width_logits(
        engine, cfg, params_host)
    result["profile"] = profile_generate(engine, cfg)
    bf16 = {"engine": engine, "param_bytes": param_bytes(engine.params),
            "logits": bf16_logits, "tokens": result["generate"]["tokens"]}
    del engine

    result["int8_serving"], int8_counts = run_int8_serving(cfg, params_host,
                                                           bf16)
    result["launches"]["int8_serving"] = int8_counts
    counts = {k: counts[k] + int8_counts[k] for k in counts}
    del params_host, bf16
    torch.cuda.empty_cache()

    for key, model, cfg, seed, option in (
            ("gpt_neo", "GPT-Neo 1.3B", GPT_NEO_1_3B, 4321, "window"),
            ("bloom", "BLOOM-560m", BLOOM_560M, 5678, "alibi")):
        result[key], family_counts = run_family(model, cfg, seed, option)
        result["launches"][key] = family_counts
        counts = _add(counts, family_counts)

    for key, model, cfg, seed, int8, _, _ in WIDE_MODELS:
        result[key], wide_counts = run_wide_serving(model, cfg, seed, int8)
        result["launches"][key] = wide_counts
        counts = _add(counts, wide_counts)

    log(f"[time] serving paths done at {time.perf_counter() - T0:.1f} s")
    result["training"], train_counts, trainer, batch = run_training()
    result["launches"]["training"] = train_counts
    counts = {k: counts[k] + train_counts[k] for k in counts}
    result["training_profile"] = device_profile(
        "train 2 steps", lambda: [trainer.train_batch_fused(batch)
                                  for _ in range(2)], FLASH_KERNELS)
    result["training_vs_pair_backward"] = vs_pair_backward(
        "train", result["training"], result["training_profile"])
    del trainer
    torch.cuda.empty_cache()
    result["preemptible_run"], preempt_counts = run_preemptible(smi)
    result["launches"]["preemptible_run"] = preempt_counts
    counts = _add(counts, preempt_counts)
    log(f"[time] preemptible run done at {time.perf_counter() - T0:.1f} s")

    result["neo_training"], neo_counts, trainer, batch = run_neo_training()
    result["launches"]["neo_training"] = neo_counts
    counts = {k: counts[k] + neo_counts[k] for k in counts}
    result["neo_training_profile"] = device_profile(
        "neo train 2 steps", lambda: [trainer.train_batch_fused(batch)
                                      for _ in range(2)], FLASH_KERNELS)
    result["neo_training_vs_pair_backward"] = vs_pair_backward(
        "neo train", result["neo_training"], result["neo_training_profile"])
    del trainer
    torch.cuda.empty_cache()

    for key, model, cfg, _, _, micro, row_seq in WIDE_MODELS:
        result[f"{key}_training"], wide_counts = run_wide_training(
            model, cfg, micro, row_seq)
        result["launches"][f"{key}_training"] = wide_counts
        counts = _add(counts, wide_counts)
    result["gpt2_2_7b_long_training"], long_counts = run_wide_training(
        "GPT-2 2.7B", gpt.GPT2_2_7B, LONG_MICRO_BATCH, row_seq=256,
        seq=LONG_SEQ)
    result["launches"]["gpt2_2_7b_long_training"] = long_counts
    counts = _add(counts, long_counts)
    log(f"[time] wide training paths done at {time.perf_counter() - T0:.1f} s")

    result["sparse_training"], sparse_counts, trainer, batch = \
        run_sparse_training()
    result["launches"]["sparse_training"] = sparse_counts
    counts = {k: counts[k] + sparse_counts[k] for k in counts}
    result["sparse_training_profile"] = device_profile(
        "sparse train 2 steps", lambda: [trainer.train_batch_fused(batch)
                                         for _ in range(2)], SPARSE_KERNELS)
    del trainer
    torch.cuda.empty_cache()
    result["gpt2_760m_sparse_training"], wide_counts, trainer, batch = \
        run_sparse_training(model="GPT-2 760M", base=gpt.GPT2_760M,
                            label="760M sparse train",
                            steps=WIDE_TRAIN_STEPS)
    result["launches"]["gpt2_760m_sparse_training"] = wide_counts
    counts = _add(counts, wide_counts)
    result["gpt2_760m_sparse_training_profile"] = device_profile(
        "760M sparse train 2 steps", lambda: [trainer.train_batch_fused(batch)
                                              for _ in range(2)],
        SPARSE_KERNELS)
    del trainer
    torch.cuda.empty_cache()
    result["dense_at_sparse_shape"] = run_dense_at_sparse_shape()
    log(f"[time] sparse training paths done at {time.perf_counter() - T0:.1f} s")

    result["bert_training"], bert_counts, trainer, batch = run_bert_training()
    result["launches"]["bert_training"] = bert_counts
    counts = {k: counts[k] + bert_counts[k] for k in counts}
    result["bert_training_profile"] = device_profile(
        "bert train 2 steps", lambda: [trainer.train_batch_fused(batch)
                                       for _ in range(2)], FLASH_KERNELS)
    result["bert_training_vs_pair_backward"] = vs_pair_backward(
        "bert train", result["bert_training"], result["bert_training_profile"])
    del trainer
    torch.cuda.empty_cache()

    result["route_check"], route_counts = run_route_check()
    result["launches"]["route_check"] = route_counts
    counts = {k: counts[k] + route_counts[k] for k in counts}

    log(f"[time] BERT training and the route check done at "
        f"{time.perf_counter() - T0:.1f} s")
    result["diffusion"], diffusion_counts = run_diffusion()
    result["launches"]["diffusion"] = diffusion_counts
    counts = {k: counts[k] + diffusion_counts[k] for k in counts}
    torch.cuda.empty_cache()
    result["bias_gelu_op"], op_counts = run_bias_gelu_op()
    result["launches"]["bias_gelu_op"] = op_counts
    counts = {k: counts[k] + op_counts[k] for k in counts}

    dims = kernels.head_dim_launches()
    result["head_dim_launches"] = dims
    log(f"[head dims] main-path launches by head dim: {dims}")
    first = {}
    for row in checks:
        first.setdefault(row["name"], row)
    line = []
    for name, row in first.items():
        base = name.split("[")[0]        # an option's row: kernel[option]
        src, replaces = SOURCES[base]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
        if base in TC_ENTRY:
            line[-1]["bf16_fp16_kernel"] = TC_ENTRY[base]
        if base in dims:
            line[-1]["head_dims"] = {str(D): n for D, n in dims[base].items()}
        if name in CHECK_ONLY:
            line[-1]["paths"] = ("none: no path of the JAX package calls it; "
                                 "held in the check phase only")
    result["kernel_checks"] = checks
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(smi)
    log(f"[launches] generate {gen_counts}, serving {serve_counts}, int8 "
        f"serving {int8_counts}, GPT-Neo {result['launches']['gpt_neo']}, "
        f"BLOOM {result['launches']['bloom']}, GPT-2 760M "
        f"{result['launches']['gpt2_760m']}, GPT-2 2.7B "
        f"{result['launches']['gpt2_2_7b']}, GPT-2 760M training "
        f"{result['launches']['gpt2_760m_training']}, GPT-2 2.7B training "
        f"{result['launches']['gpt2_2_7b_training']}, GPT-2 2.7B training at "
        f"seq {LONG_SEQ} {long_counts}, GPT-2 760M sparse training "
        f"{result['launches']['gpt2_760m_sparse_training']}, training "
        f"{train_counts}, preemptible run {preempt_counts}, "
        f"GPT-Neo training {neo_counts}, sparse training "
        f"{sparse_counts}, bert training {bert_counts}, route check at seq "
        f"{ROUTE_SEQ} {route_counts}, diffusion "
        f"{diffusion_counts}, bias-GeLU op {op_counts}")
    missing = [k for k, n in counts.items() if n <= 0 and k not in CHECK_ONLY]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(f"[time] whole run {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ACCEL.device_name(0),
        "count": ACCEL.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
