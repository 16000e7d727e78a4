#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout (the CUDA libraries in
parallel), checks each against its plain PyTorch version at the main
paths' shapes and times it, then drives six paths through the port's
Server at full width with random seeded weights, and a training path:

* minitron-4b (32 layers, d_model 3072, vocab 256k): serve, parity of a
  kernel prefill with a plain one, the same prefill through the
  pipelined tile kernels, and a profiler trace;
* mamba2-1.3b (48 layers, d_model 2048, 64 SSD heads): serve, parity of
  a kernel prefill and two decode ticks fed from its state with the
  plain versions, the pipelined prefill, and a trace;
* zamba2-2.7b (54 Mamba2 layers of 80 SSD heads at N 64, d_model 2560,
  one shared attention+MLP block of 32 heads at head_dim 80 after every
  6): serve, parity of a prefill and two decode ticks in f32, a trace;
* dbrx-132b at full width (d_model 6144, 48/8 heads, 16 experts of d_ff
  10752, top 4, vocab 100,352) and 4 of its 40 layers, the depth one
  80 GB card holds: serve, parity of a prefill and two decode ticks of
  its first 2 layers in f32, the pipelined prefill, a trace;
* qwen2-vl-2b (28 layers, d_model 1536, 12/2 heads of 128, M-RoPE):
  serve, a prefill with per-batch vision positions (the rotary kernel on
  one cos/sin table per batch row) checked against the plain path,
  parity of that prefill and two decode ticks in f32, a trace;
* whisper-small (12 encoder + 12 decoder layers, d_model 768, 12 heads
  of 64, LayerNorm + GELU; the encoder and cross-attention non-causal):
  serve, parity of a prefill and two decode ticks in f32, the pipelined
  prefill, a trace;
* granite-8b (36 layers, d_model 4096, 32/8 heads, tied embeddings),
  mistral-nemo-12b (40 layers, d_model 5120, q_dim 4096),
  mistral-large-123b (12 of its 88 layers, d_model 12288, 96/8 heads) and
  arctic-480b (2 of its 35 layers, d_model 7168, 56/8 heads, 128 experts
  top 2 beside a dense residual MLP): serve, and parity of a prefill and
  two decode ticks in f32 (mistral-large at 2 layers, arctic at 1, after
  its server is freed);
* minitron-4b training at full width and 16 of its 32 layers (bf16,
  remat, B 2 x S 4096, 8 steps of the trainer's step function: LM.loss,
  its gradient through the flash backward kernel and the tile ops'
  backwards, AdamW through the adamw and l2_clip kernels), its launches
  per step asserted; the same step's gradients and update on 2 layers in
  f32 against the plain versions; the same run through the multi-device
  layer on a one-rank NCCL (1, 1) mesh, every parameter and moment a
  DTensor (``sharded_train``: each step's loss and launches the
  unsharded step's, ms/step and peak memory beside them); the smoke
  trainer through
  build_trainer with an injected host loss, whose losses equal a clean
  run's; a trace of one step; the same training, 8 steps, with its
  gradients compressed as ``--compress int8_ef`` does (``train_compress``:
  the loss gate, the launches, each leaf's int8 round trip within half
  its row's scale, the wire bytes of each mode); the step counted on
  ``meta`` by the dry run (``dryrun``: FLOPs, bytes, the three roofline
  terms and the predicted peak memory) against the card's device ms and
  peak memory for the same step, and minitron-4b's ``train_4k`` counted
  per device on the 16x16 and 2x16x16 meshes in two child processes
  (``dryrun_16x16``, ``dryrun_2x16x16``: each its own fake process
  group);
* mamba2-1.3b (all 48 layers) and zamba2-2.7b (all 54) training at full
  width the same way (the SSD scan's forward with its chunk states and
  its backward, both their wgmma kinds at B 2, rmsnorm_gated's kernel
  forward), their launches per
  step asserted, each step's gradients and update on 2 (zamba2: 6, one
  group with its shared block) f32 layers against the plain versions; a
  trace of one step of each.
* whisper-small (12 + 12 layers), dbrx-132b (2 of its 40 layers,
  bf16 moments), qwen2-vl-2b (28 layers, each batch row opening with an
  image: M-RoPE's per-batch tables through rotary and its -sin backward)
  and mistral-large-123b (3 of its 88 layers, f32 moments, 12 steps:
  flash at GQA group 12, rmsnorm at d 12288, swiglu at d_ff 28672)
  training at full width the same way (layernorm, gelu
  and the router softmax kernels under autograd with their analytic
  backwards, the flash backward non-causal at head_dim 64, the MoE
  dispatch's torch backward, the optimizer in leading-axis chunks on
  dbrx's expert and embedding leaves), their launches per step asserted,
  each step's gradients and update in f32 (whisper at full depth, dbrx
  at 1 layer, qwen2-vl and mistral-large at 2) against the plain
  versions; a trace of one step of each;
* the latency model's calibration lane (``calibrate``,
  tools/calibrate.py at fewer reps): the 13 tile programs under each
  statement order at 32 M elements an array, checked against their
  plain versions, timed in turns and refitted, beside the committed
  H100 profile (experiments/device_profiles_torch/), which must re-score
  clean; its cost orders built and checked;
* the bridge (``bridge``): the example's my_fn and a function with
  remainder, where, pow and a 0-d scalar bridged by saturate_torch_fn to
  one generated Triton kernel each, at (8192, 4096) in f32 and bf16 on
  operands of both signs, checked against the eager function and the
  plain version, timed in turns against the eager function, and
  torch.sort's fallback counted;
* the ops residual_scale, softmax and ssd_gate (``ops``) through their
  entry points at their kernel rows' shapes, each against its plain
  version, with a gradient through each;
* the paper's five saturation modes (``modes``): the 13 tile programs
  under baseline, cse, cse_sat, cse_bulk and accsat at one path shape
  each (and five of them pipelined), each kernel against its plain
  version (a bf16 case also in f32 at 2e-5), timed in turns, with its
  extraction's ops, loads and FMAs,
  its PTX's global loads, registers and spills;
* the port's four examples (``examples``) run on the card as child
  processes, each exiting 0 (serve_decode_torch's report, its decode
  tokens/s saturated and plain and its cold and warm saturation, in the
  phase's line).

Every tile op of the run builds through a fresh saturation cache and is
audited by the static verifier (phase ``saturation``): each launch
layout is certified at its first compile, each compiled binary's
registers, spills and shared memory held against the card's limits.
After the serve phases, ``cache`` rebuilds every tile-op configuration
of the run in a child process under another hash seed from the same
cache (each an exact hit, its sources byte-identical), replays the tile
kernels on this process's inputs and serves minitron-4b at 4 of its 32
layers, all bitwise equal to this process's; a second child with the
cache off counts the programs whose sources then differ. ``verify``,
last, certifies the flash and SSD launches at the paths' shapes and
fails on any error finding of the run.

Each path's launch counts are zeroed just before it and read just after,
and split by the step (prefill or decode) that launched them. The tile
kernels on the paths also report their launch plan (rows and column
pieces a program, grid, warps), shared memory, registers and the width
of each global load, store and async copy in their PTX, and each is
checked and timed at its decode shape too (rotary also at k in prefill
and at a 510-token prompt; the router also at arctic's 128 experts, on
the path of arctic-480b). Each phase prints one JSON line;
the line before the last lists every kernel, and the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

TILE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
# flash's output and the backward's gradients, norm-relative (whole
# tensor and each 64-row block): bf16 rounds P (and dS) for the tensor
# cores, a few 1e-3
FLASH_REL_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
SSD_TOL = 2e-4                            # f32, as tests/test_kernels.py
CUDA_SOURCES = ("flash_attention.cu", "ssd_scan.cu")
# the kernels of a library that a row of the kernels line launches
SASS_PREFIX = {"flash_attention": "flash_fwd_",
               "flash_attention_bwd": "flash_bwd_",
               "flash_attention_f32": "flash_fwd_sm90_f32",
               "flash_attention_bwd_f32": ("flash_bwd_prep_f32",
                                           "flash_bwd_dkdv_sm90_f32",
                                           "flash_bwd_dq_sm90_f32")}
PIPELINED = "triton_pipelined"
# the tile ops whose pipelined kernels a path drives (the minitron,
# mamba2, dbrx and whisper prefills under ops.set_tile_emitter)
PIPELINED_OPS = ("rmsnorm", "rotary", "swiglu", "rmsnorm_gated",
                 "moe_router", "layernorm", "gelu")
# Last-position logits of the full-width prefill, kernels vs plain
# versions. Both run the same bf16 model; they differ only where values
# are rounded to bf16 (the kernels compute in f32 and round once; the
# plain swiglu rounds after every op, plain attention normalises before
# rounding). The logits have a std near 1 (unit-variance hidden state
# times an unembedding of std d^-0.5); a wrong head mapping, mask or
# rotation moves them by O(1), bf16 rounding over 32 layers by far less.
PARITY_TOL = 0.5
# Mamba2-1.3B, kernels vs plain versions: last-position logits of a
# 4 x 510 prefill, then of two decode ticks fed the same tokens, each
# from its own prefill's state, with the served weights in f32. In bf16
# the two paths round at different places (the rmsnorm_gated kernel
# computes in f32 and rounds once, its plain version rounds after every
# bf16 op, ~1 % apart), and 48 layers of random weights amplify that,
# on an H100, past the 0.5 that bounds the minitron comparison: as large
# as a fault. In f32 they differ only in summation order (~1e-6
# relative), which the same amplification leaves far below 0.02; a wrong
# state handed to decode, a wrong chunk carry or a mask error moves the
# logits by O(1).
MAMBA_PARITY_TOL = 0.02
# zamba2-2.7b, the same comparison for the same reason: its 54 Mamba2
# layers amplify bf16 rounding as mamba2's 48 do, so it runs in f32 (the
# f32 flash kernel at head_dim 80 included).
ZAMBA_PARITY_TOL = 0.02
# dbrx-132b's first 2 served layers in f32, kernels vs plain versions:
# logits of a 4 x 510 prefill and two decode ticks. In bf16 a rounding
# difference can flip a token's top-4 experts and move the logits by
# O(1); in f32 the two paths differ in summation order only (the router
# softmax, swiglu, flash, and the combine's index_add_, whose atomics on
# the card add in varying order), ~1e-6 relative, and the same 0.02 holds.
# A wrong expert, weight, capacity drop or combine moves them by O(1).
DBRX_PARITY_TOL = 0.02
DBRX_LAYERS = 4           # of 40: 14.3 B parameters, 28.6 GB in bf16
DBRX_PARITY_LAYERS = 2    # f32 copy of 2 layers and the embeddings, ~31 GB
# qwen2-vl-2b and whisper-small in f32, kernels vs plain versions, for
# the reason of the Mamba2 paths: in f32 the two paths differ in summation
# order only (~1e-6 relative), and 28 (or 12 + 12) layers of random
# weights leave that far below 0.02; a wrong per-batch cos/sin row, a
# causal mask on the encoder or a wrong cross-attention k/v moves the
# logits by O(1). qwen2-vl's runs with the vision positions below.
QWEN_PARITY_TOL = 0.02
WHISPER_PARITY_TOL = 0.02
# Stand-in for Qwen2-VL's vision frontend, one image per batch row: an
# image of one temporal frame and gh x gw patches opens the row (t 0,
# h the patch row, w its column), text follows with t = h = w running on
# from max(gh, gw). Each row has its own grid, so each has its own table.
VISION_GRIDS = ((16, 16), (8, 32), (32, 8), (12, 20))

# Training: minitron-4b at full width, 16 of its 32 layers (bf16 weights,
# grads and f32 moments of 32 layers would be 61 GB before any
# activation or update transient), B 2 x S 4096, 8 steps.
TRAIN = dict(arch="minitron-4b", layers=16, batch=2, seq=4096, steps=8,
             seed=0)
# The kernel path's training step against the plain versions on the card,
# 2 layers at full width in f32: gradients within flash's f32 2e-3 of each
# leaf's max |g| (every gradient passes through the attention of the
# layers above it), the loss within 2e-5 relative, and one AdamW step
# from the same gradients within the tile ops' 2e-5 of each leaf's max |p|.
PARITY_TRAIN = dict(layers=2, batch=1, seq=512)
PARITY_TRAIN_TOL = {"grads": 2e-3, "loss": 2e-5, "update": 2e-5}
# mamba2-1.3b and zamba2-2.7b train at full width and full depth (bf16
# weights and grads, f32 moments: 15.6 GB and 32.2 GB before activations),
# B 2 x S 4096, remat on, 6 steps. Their parity runs mamba2 at 2 layers and
# zamba2 at 6, the least depth its shared block (applied after every 6
# Mamba2 layers) allows. mamba2's gradients pass through no attention:
# the SSD's f32 2e-4 bounds them (3xTF32 products); zamba2's pass through
# the shared block's f32 flash, 2e-3 as minitron's.
TRAIN_MAMBA = dict(arch="mamba2-1.3b", layers=48, batch=2, seq=4096,
                   steps=6, seed=0)
TRAIN_ZAMBA = dict(TRAIN_MAMBA, arch="zamba2-2.7b", layers=54)
PARITY_TRAIN_MAMBA = dict(layers=2, batch=1, seq=512)
PARITY_TRAIN_ZAMBA = dict(layers=6, batch=1, seq=512)
PARITY_TRAIN_TOL_MAMBA = dict(PARITY_TRAIN_TOL, grads=2e-4)
# whisper-small trains at full width and depth (12 encoder + 12 decoder
# layers; bf16 weights and grads, f32 moments: 0.26 B parameters) on the
# trainer's frames (launch.train.encdec_frames, tokens-long); dbrx-132b at
# full width and 2 of its 40 layers (7.75 B parameters: bf16 weights 15.5
# GB, bf16 grads 15.5 GB), B 2 x S 4096, remat on, 6 steps. dbrx's moments
# are bf16 (31 GB), not the int8 that default_opt_config picks for its
# 131.6 B: the reference's int8 moments round a second moment below 1/254
# of its row's largest to 0 and the next update divides by eps alone
# (ROADMAP C4); on the card its loss then ends above step 1's at every lr
# tried (12.0 -> 79.1 at 3e-4, -> 14.8 at 5e-5) where bf16 moments train
# (tools/train_warmup.py --moment-dtype int8). Its lr is 5e-5: the
# first Adam step moves every element by the full lr and nearly doubles
# the loss (12.0 -> 22.8 at 5e-5, 24.2 at 1e-4), and at 1e-4 six steps
# (or eight) end above step 1's loss (12.78, 12.14). Its step peaks at
# 74 GB in the backward; the update's chunks (optim.adamw.update_chunks)
# keep the embeddings' and experts' f32 transients to a few GB. Their
# parity: whisper at full depth, dbrx at 1 layer (18 GB of f32 weights,
# 18 GB for each gradient tree), f32, B 1 x S 512, at PARITY_TRAIN_TOL
# (every gradient passes through f32 flash). dbrx's update check leaves
# out the embeddings and two of the three expert leaves (each f32 expert
# leaf's moments hold 8.5 GB a run): it covers the attention, the
# router, the norms and the experts' wg.
TRAIN_WHISPER = dict(TRAIN_MAMBA, arch="whisper-small", layers=12)
TRAIN_DBRX = dict(TRAIN_MAMBA, arch="dbrx-132b", layers=2,
                  moment_dtype="bf16", lr=5e-5)
PARITY_TRAIN_WHISPER = dict(layers=12, batch=1, seq=512)
PARITY_TRAIN_DBRX = dict(layers=1, batch=1, seq=512)
# qwen2-vl-2b trains at full width and depth (28 layers; bf16 weights and
# grads, f32 moments: 1.54 B parameters, ~19 GB) on batches whose rows
# each open with an image (VISION_GRIDS' first grids): M-RoPE's per-batch
# tables through the rotary kernel forward and, with -sin, backward.
# mistral-large-123b trains at full width and 3 of its 88 layers, the
# depth one 80 GB card holds with f32 moments: 1.384 B parameters a layer
# and 0.805 B in the embeddings, 4.96 B at 12 bytes each (bf16 weights and
# grads, f32 moments) is 59.5 GB before activations; a fourth layer would
# make it 76 GB. It runs flash forward and backward at GQA group 12 (96/8
# heads), rmsnorm at d 12288 (two column pieces), swiglu at d_ff 28672 and
# the optimizer's leading-axis chunks of its 12288 x 28672 leaves. It
# takes 12 steps at the default lr 3e-4 and the reference trainer's
# schedule (warmup max(steps // 10, 1), cosine over the steps): Adam's
# first step moves every element by about the lr and nearly triples the
# loss at this width (10.93 -> 30.58); six steps end above step 1's loss
# at every lr and warmup tried but one (5e-5, warmup 1), twelve fall to
# 7.33 and pass the gate at 1e-4, 2e-4 and 4e-4 too (6e-4, 5e-5 and
# 2.5e-5 do not end at their lowest loss; tools/train_warmup.py --arch
# mistral-large-123b --lr LR --warmup 1). Their parity: 2 layers at full
# width in f32, B 1 x S 512 (qwen2-vl with one image per row), at
# PARITY_TRAIN_TOL (every gradient passes through f32 flash).
TRAIN_QWEN = dict(TRAIN_MAMBA, arch="qwen2-vl-2b", layers=28)
TRAIN_LARGE = dict(TRAIN_MAMBA, arch="mistral-large-123b", layers=3,
                   steps=12)
PARITY_TRAIN_QWEN = dict(layers=2, batch=1, seq=512)
PARITY_TRAIN_LARGE = dict(layers=2, batch=1, seq=512)
PARITY_UPDATE_SKIP = ("embed", "unembed")
PARITY_UPDATE_SKIP_DBRX = PARITY_UPDATE_SKIP + ("wu", "wd")
# the train phase's run with its gradients compressed as --compress int8_ef
# does (int8, per-row scales; the error-feedback state discarded, as the
# JAX step discards it), 8 steps as train's: minitron's loss peaks at step
# 4 (the first full-lr Adam steps' overshoot), which 6 steps would put
# past the first half that phase_train's gate allows
TRAIN_COMPRESS = dict(TRAIN, compress="int8_ef")
# the dry run's count of the train phase's step against the card: the
# predicted peak memory over the measured one must fall inside this
DRYRUN_MEMORY_RATIO = (0.8, 1.2)
# the generator of the ops residual_scale, softmax and ssd_gate's inputs
# (the kernels and ops phases)
OPS_SEED = 29
# the training path's kernels, whose launches each step is read for
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_gated", "layernorm", "rotary", "swiglu",
                 "gelu", "moe_router", "adamw", "l2_clip", "flash_attention",
                 "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")

SERVE = dict(arch="minitron-4b", max_batch=4, requests=6, prompt_len=512,
             max_new=32, seed=0)
SERVE_MAMBA = dict(SERVE, arch="mamba2-1.3b")
SERVE_ZAMBA = dict(SERVE, arch="zamba2-2.7b")
SERVE_DBRX = dict(SERVE, arch="dbrx-132b")
SERVE_QWEN = dict(SERVE, arch="qwen2-vl-2b")
SERVE_WHISPER = dict(SERVE, arch="whisper-small")
# The last four configs, served as dbrx is: granite-8b (16.1 GB in bf16)
# and mistral-nemo-12b (24.5 GB) at full depth; mistral-large-123b at 12 of
# its 88 layers (1.38 B parameters a layer: 17.4 B with the embeddings,
# 34.8 GB) and arctic-480b at 2 of its 35 (13.6 B a layer, nearly all in
# its 128 experts: 27.7 B, 55 GB). Their f32 parity, kernels vs plain
# versions, differs in summation order only, as the other f32 paths'
# (0.02): granite's from its served weights at full depth, nemo's from a
# fresh f32 model of the same seed after its server is freed (the f32
# copy beside the bf16 one would be 73.5 GB), mistral-large's from its
# first 2 served layers, arctic's from a fresh 1-layer f32 model (54 GB)
# after its server is freed.
SERVE_GRANITE = dict(SERVE, arch="granite-8b")
SERVE_NEMO = dict(SERVE, arch="mistral-nemo-12b")
SERVE_LARGE = dict(SERVE, arch="mistral-large-123b")
SERVE_ARCTIC = dict(SERVE, arch="arctic-480b")
LARGE_LAYERS, LARGE_PARITY_LAYERS = 12, 2
ARCTIC_LAYERS, ARCTIC_PARITY_LAYERS = 2, 1
NEW_PARITY_TOL = 0.02

# The saturation cache and the static verifier: every tile op of the run
# builds through a fresh cache under the git-ignored _build/ and is
# audited at VERIFY_LEVEL; the cache phase then rebuilds every
# configuration in a child process under another hash seed
# (CACHE_CHILD_SEED), replays the tile kernels on the parent's inputs at
# the CACHE_TILES serve shapes, and serves minitron-4b at CACHE_SERVE's
# cut depth: all bitwise equal to the parent's.
SAT_CACHE_DIR = os.path.join(SRC, "repro_torch", "_build", "sat_cache")
CACHE_PHASE_DIR = os.path.join(SRC, "repro_torch", "_build", "cache_phase")
VERIFY_LEVEL = "cheap"
CACHE_CHILD_SEED = "1"
CACHE_SERVE = dict(SERVE, layers=4)
CACHE_TILES = {
    "rmsnorm": ([(2048, 3072), (3072,)], "float32", None),
    "rotary": ([(4, 24, 512, 128), (1, 1, 512, 128), (1, 1, 512, 128)],
               "bfloat16", None),
    "swiglu": ([(2048, 9216)] * 2, "bfloat16", None),
    "rmsnorm_gated": ([(2048, 4096), (2048, 4096), (4096,)], "bfloat16",
                      None),
    "moe_router": ([(32, 64, 16)], "float32", None),
    "layernorm": ([(2048, 768), (768,), (768,)], "float32", None),
    "gelu": ([(2048, 3072)], "bfloat16", None),
    "adamw": ([(3072, 9216)] * 4, "float32", None),
    "l2_clip": ([(3072, 9216)], "bfloat16", "float32"),
}
CACHE_SCALARS = {"eps": 1e-6, "lr": 1e-3, "b1": 0.9, "b2": 0.95, "wd": 0.1,
                 "inv_bc1": 1.3, "inv_bc2": 1.1, "norm": 3.0,
                 "max_norm": 1.0}
# every verification report of the run (the phases reset the telemetry
# the reports also go to), and the build walls of the cache's outcomes
VERIFY_TALLY = {"report": None, "compiled_checked": 0, "build_s": {}}


_T0 = time.perf_counter()


# each phase's line, by phase, for the phases that compare with another's
RECORDS = {}


def emit(obj):
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, so that consecutive lines time each
    phase."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
        RECORDS[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


def vision_positions(S, grids):
    """(3, B, S) M-RoPE positions for ``VISION_GRIDS``-style images (see
    there), as a numpy array."""
    import numpy as np
    pos = np.zeros((3, len(grids), S), np.int64)
    for b, (gh, gw) in enumerate(grids):
        n = gh * gw
        pos[1, b, :n] = np.arange(n) // gw
        pos[2, b, :n] = np.arange(n) % gw
        pos[:, b, n:] = max(gh, gw) + np.arange(S - n)
    return pos


class Timer:
    """CUDA-event timing of one callable: median of ``iters`` launches,
    each after a write that evicts the 50 MB L2 (the path's operands
    arrive from other kernels, not from a warm cache of this one) and a
    1 ms device sleep, so that the host has enqueued the callable's
    kernels before the device reaches them and the events time the
    device, not the host's launch path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")
        self.profiler = {"sessions": 0, "empty": 0, "launches_made": 0,
                         "launches_recorded": 0, "seen_when_empty": []}

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def device_ms(self, fn, kernel, iters=10, sessions=3):
        """Device time per call of ``fn`` in the kernels whose name
        contains ``kernel`` (summed over names where a call launches
        several, as the SSD scan's two), each call after the L2 flush,
        from torch.profiler: the kernels alone, without the launch and
        event costs that ``ms`` includes. A profiler session can lose some
        or all of a kernel's records, so each name's time is averaged over
        the launches it recorded, and a session that recorded none is
        repeated, up to ``sessions`` sessions; ``self.profiler`` counts
        the sessions, the launches made and recorded, and keeps what the
        first few empty sessions saw."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        log = self.profiler
        fn()
        torch.cuda.synchronize()
        for _ in range(sessions):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            avg = prof.key_averages()
            evs = [e for e in avg if kernel in e.key and e.count]
            log["sessions"] += 1
            log["launches_made"] += iters
            log["launches_recorded"] += min((e.count for e in evs),
                                            default=0)
            if evs:
                return sum(getattr(e, "self_device_time_total", 0.0)
                           / e.count for e in evs) / 1e3
            log["empty"] += 1
            if len(log["seen_when_empty"]) < 3:
                log["seen_when_empty"].append(
                    {"kernel": kernel, "keys": {e.key: e.count for e in avg}})
        return None


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    from repro_torch.kernels.cuda_build import nvcc as nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton_version,
          "nvcc": nvcc.splitlines()[-1],
          "allow_tf32": {"matmul": False, "cudnn": False}})
    return smi


_KERNEL_NAME = (r"\S*?\d((?:flash_fwd|flash_bwd|ssd)_[a-z0-9_]+?_kernel)"
                r"(?:ILi(\d+)E)?")


def _kernel_name(mangled):
    """A kernel's name in a library, with its head_dim template argument
    where there is one (``flash_bwd_dkdv_sm90_kernel<128>``)."""
    import re
    m = re.match(_KERNEL_NAME, mangled)
    if m is None:
        return mangled
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def _tensor_core_counts(lib):
    """Tensor-core instructions in each kernel of a library, from
    ``cuobjdump -sass``, by kernel name: HMMA (``mma.sync``) and HGMMA
    (``wgmma``)."""
    import re
    from repro_torch.kernels.cuda_build import nvcc
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        counts[_kernel_name(body.split()[0])] = {
            "HMMA": len(re.findall(r"\bHMMA\b", body)),
            "HGMMA": len(re.findall(r"\bHGMMA\b", body))}
    return counts


def _ptxas_by_kernel(log):
    """Registers and spill bytes of each kernel from ptxas's ``-v``
    report: ``{name: {"registers", "spill_stores", "spill_loads"}}``, and
    ``"wgmma_serialized": code`` where ptxas serialized its wgmma
    instructions (a "Potential Performance Loss" note: C7512 for
    register resources, C7520 for a wait in a divergent path, and the
    like; each product then waits for the one before)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\)[^']*?serialized.*?function '([^']+)'",
                      line)
        if m:
            out.setdefault(_kernel_name(m.group(2)), {})[
                "wgmma_serialized"] = m.group(1)
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    """Both CUDA libraries, one nvcc each, all started together. The
    wgmma kernels (``*_sm90_kernel``) must hold HGMMA instructions, spill
    nothing and keep their wgmma pipelined (no ptxas C7512; the flash
    kernels no serialization note at all, C7520 included), and the
    SSD's hold no HMMA; the SSD forward's and backward's kernels'
    registers, spills and HMMA / HGMMA counts are reported on their own
    (``ssd_fwd``, ``ssd_bwd``)."""
    from repro_torch.kernels.cuda_build import build
    t0 = time.perf_counter()
    libs = build(*CUDA_SOURCES)
    secs = time.perf_counter() - t0
    ptxas, tc = {}, {}
    for src, lib in zip(CUDA_SOURCES, libs):
        with open(f"{lib}.log") as f:
            ptxas[src] = _ptxas_by_kernel(f.read())
        tc[src] = _tensor_core_counts(lib)
    emit({"phase": "build", "nvcc_s": secs,
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs],
          "ptxas": ptxas, "tensor_core": tc,
          **{key: {name: {**info, **tc["ssd_scan.cu"].get(name, {})}
                   for name, info in ptxas["ssd_scan.cu"].items()
                   if name.startswith(f"{key}_")}
             for key in ("ssd_fwd", "ssd_bwd")}})
    wgmma = {name: (tc[src][name], ptxas[src][name])
             for src in CUDA_SOURCES for name in tc[src] if "_sm90_" in name}
    # C7512 refused everywhere; any serialization in the flash kernels
    # (the SSD kernels' other notes, such as C7520, are reported)
    bad = [name for name, (n, info) in wgmma.items()
           if n["HGMMA"] == 0 or info.get("spill_stores", 0)
           or info.get("spill_loads", 0)
           or info.get("wgmma_serialized") == "C7512"
           or (name.startswith("flash_") and info.get("wgmma_serialized"))
           or (name.startswith("ssd_") and n["HMMA"])]
    if not wgmma or bad:
        raise AssertionError(f"wgmma kernels without HGMMA, with spills, "
                             f"with serialized wgmma or (the SSD's) with "
                             f"HMMA: {bad or 'none built'}")
    return tc


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, tol, checks):
    """abs error and whether |got - want| <= tol * (1 + |want|)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, ok = 0.0, True
    for g, w in zip(got, want, strict=True):
        err = max(err, _err(g, w))
        ok &= bool(((g.float() - w.float()).abs()
                    <= tol * (1 + w.float().abs())).all())
        ok &= bool(g.isfinite().all())
    checks.append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok})
    return err


def _ptx_counts(ptx):
    """Bytes per thread of each global load, store and global-to-shared
    async copy in a PTX listing (``ld.global.v4.b32`` is 16), counted by
    width."""
    import re
    counts = {"ld": {}, "st": {}, "cp.async": {}}
    for m in re.finditer(r"\b(ld|st)\.global((?:\.[\w:]+)+)", ptx):
        parts = m.group(2).split(".")
        vec = next((int(p[1:]) for p in parts if p in ("v2", "v4", "v8")), 1)
        bits = next((int(p[1:]) for p in parts
                     if re.fullmatch(r"[bfsu](8|16|32|64)", p)), 0)
        key = f"{vec * bits // 8}B"
        counts[m.group(1)][key] = counts[m.group(1)].get(key, 0) + 1
    # the divisions and MUFU approximations the kernel issues
    counts["math"] = {op: len(re.findall(rf"\b{re.escape(op)}\b", ptx))
                      for op in ("div.rn.f32", "div.full.f32",
                                 "ex2.approx", "rcp.approx",
                                 "tanh.approx")}
    for m in re.finditer(r"\bcp\.async\.c[ag]\.shared\.global[\w.:]*\s+"
                         r"\[[^\]]*\],\s*\[[^\]]*\],\s*(0x[0-9a-fA-F]+|\d+)",
                         ptx):
        key = f"{int(m.group(1), 0)}B"
        counts["cp.async"][key] = counts["cp.async"].get(key, 0) + 1
    return counts


def _kernel_info(ck):
    """Shared memory, registers and the PTX's global access widths of a
    Triton compiled kernel (after its first launch)."""
    return {"shared_bytes": ck.metadata.shared,
            "registers": getattr(ck, "n_regs", None),
            "spills": getattr(ck, "n_spills", None),
            **_ptx_counts(ck.asm["ptx"])}


def _tile_plan(op, args, out_dtype=None):
    """The launch plan of a tile op's call on these operands."""
    from repro_torch.core.tritongen import plan_tile_call
    return plan_tile_call(op.tk, [a.shape for a in args],
                          [a.dtype for a in args], out_dtype)


def _plan_dict(plan):
    return {"block_r": plan.block_r, "block_d": plan.block_d,
            "pieces": list(plan.pieces), "grid": list(plan.grid),
            "num_warps": plan.num_warps, "persistent": plan.persistent,
            "flat": dataclasses.asdict(plan.flat) if plan.flat else None}


def _compiled_info(op, args, sc):
    """``_kernel_info`` of the tile kernel compiled for these operands'
    layout: one launch, outside the op's counter. The kernel's registers,
    spills and shared memory are held against the card's limits
    (``verify.check_compiled``, into the verifier's tally)."""
    from repro_torch.core.tritongen import (launch_tile_kernel,
                                            prepare_tile_call)
    from repro_torch.verify import VerifyReport, check_compiled, record
    plan, ins, outs = prepare_tile_call(op.tk, args, op.name)
    info = _kernel_info(launch_tile_kernel(
        op.tk.compiled(plan.layout), plan, ins, outs,
        [float(sc[s]) for s in op.tk.scalars]))
    rep = VerifyReport()
    rep.extend(check_compiled(op.name, info["registers"], info["spills"],
                              info["shared_bytes"], plan.num_warps))
    record(rep)
    VERIFY_TALLY["compiled_checked"] += 1
    return info


# (B, S, H, P, N), chunk: mamba2-1.3b's and zamba2-2.7b's train shapes
# (timed: the row and its "zamba2" shape), a ragged S at full width, one
# step, and small edges (N != P, P not a multiple of 8)
SSD_BWD_CASES = [((2, 4096, 64, 64, 128), 128), ((2, 4096, 80, 64, 64), 128),
                 ((2, 4001, 64, 64, 128), 128), ((1, 1, 64, 64, 128), 128),
                 ((2, 100, 3, 16, 8), 32), ((1, 50, 2, 6, 5), 16)]
SSD_BWD_TIMED = {(2, 4096, 64, 64, 128): None,
                 (2, 4096, 80, 64, 64): "zamba2"}
SSD_GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd")
# the backward at a chunk over 128 steps (B, S, H, P, N), chunk -> its key
# under the row's "shapes": mamba2-1.3b's train shape at chunk 256, which
# the kernels run at 128-step sub-chunks from states the forward kernels
# recompute; timed in turns against the same inputs at chunk 128
SSD_BWD_LONG = {((2, 4096, 64, 64, 128), 256): "mamba2_chunk256"}
# the SSD forward with chunk states at mamba2-1.3b's and zamba2-2.7b's
# train shapes (B, S, H, P, N), by their key under ssd_scan's "shapes"
SSD_FWD_TRAIN = {(2, 4096, 64, 64, 128): "mamba2_train_with_states",
                 (2, 4096, 80, 64, 64): "zamba2_train_with_states"}


def _ssd_launched(torch, fn, want):
    """The SSD kernels a call of ``fn`` launches, by name, from the
    profiler: the union over up to three sessions of a few calls each,
    stopping once every name of ``want`` was seen (a session can lose
    some of its records)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names |= {m.group(1) for e in prof.key_averages()
                  for m in [re.search(r"(ssd_[a-z0-9_]+?_kernel)", e.key)]
                  if m and e.count}
        if want <= names:
            break
    return names


def _ssd_build(*prefixes):
    """Registers, spilled bytes and tensor-core instruction counts (HMMA,
    HGMMA) of the SSD kernels whose names start with one of ``prefixes``,
    from the build's ptxas report and ``cuobjdump -sass``."""
    from repro_torch.kernels.cuda_build import build
    lib = build("ssd_scan.cu")[0]
    with open(f"{lib}.log") as f:
        ptxas = _ptxas_by_kernel(f.read())
    tc = _tensor_core_counts(lib)
    return {name: {**info, **tc.get(name, {})}
            for name, info in ptxas.items() if name.startswith(prefixes)}


def _tf32_unit(torch, g, checks):
    """One 3xTF32 k-tile (64 x 32 by 32 x 64) through the SSD backward's
    wgmma building blocks against the f64 product (norm-relative within
    1e-6: 3xTF32 keeps ~21 bits of each operand), and one TF32 product of
    the unsplit f32 operands against two models of the tensor core's read
    of an f32 operand, truncation to tf32's 10 mantissa bits and rounding
    to nearest: the nearer one says which the card does."""
    from repro_torch.kernels.ssd_scan import tf32_unit
    a = torch.randn((64, 32), generator=g, device="cuda")
    b = torch.randn((64, 32), generator=g, device="cuda")
    want = a.double() @ b.double().T

    def rel(x):
        return ((x.double() - want).norm() / want.norm()).item()

    def tf32(x, rounding):
        bits = x.view(torch.int32)
        if rounding:
            bits = bits + 0x1000
        return (bits & -0x2000).view(torch.float32).double()

    err3 = rel(tf32_unit(a, b))
    raw = tf32_unit(a, b, raw=True).double()
    models = {m: ((raw - tf32(a, r) @ tf32(b, r).T).norm()
                  / want.norm()).item()
              for m, r in (("truncates", False), ("rounds", True))}
    checks.append({"name": "ssd_tf32_unit/3xtf32", "norm_rel_err": err3,
                   "tol": 1e-6, "ok": err3 <= 1e-6})
    return {"norm_rel_err_3xtf32": err3, "raw_norm_rel_err": rel(raw),
            "raw_vs_model": models,
            "f32_operand": min(models, key=models.get)}


def _ssd_bwd_inputs(torch, g, b, s, h, p, n):
    """The SSD's six inputs (x, dt, a_log, B, C, D) and an output gradient
    dy on the card, drawn from ``g`` in that order."""
    args = (torch.randn((b, s, h, p), generator=g, device="cuda"),
            torch.rand((b, s, h), generator=g, device="cuda") * 0.29 + 0.01,
            torch.log(torch.arange(1, h + 1, device="cuda",
                                   dtype=torch.float32)),
            torch.randn((b, s, n), generator=g, device="cuda") * 0.3,
            torch.randn((b, s, n), generator=g, device="cuda") * 0.3,
            torch.randn((h,), generator=g, device="cuda"))
    return args, torch.randn((b, s, h, p), generator=g, device="cuda")


def _ssd_bwd_rows(torch, F, timer, g, checks, timed=True):
    """The SSD backward kernels against their plain version at
    ``SSD_BWD_CASES``: the kind each case takes (``ssd_bwd_kind``) and the
    kernels one call launches (a case that launches another kind's, or
    misses one, fails), the forward's chunk states element-wise, all six
    gradients norm-relative (whole tensor and worst 64-step block) within
    the SSD's f32 2e-4, two calls bitwise equal, each launch's device ms
    by name. At the timed shapes (with ``timed``) also: the kernel within
    2e-4 of the plain version in f64 (the f32 plain version's distance
    from it beside); the ``mma_sync`` kind on the same inputs, checked
    against the plain version and the dispatched kind (2e-4) and timed in
    turns beside it; the call's time, the workspace's bytes, bound and
    the plain version's time (no PyTorch call computes it). The build's
    registers, spills, HMMA and HGMMA of the backward's kernels are in
    ``build``."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.ssd_scan import (
        SSD_BWD_LAUNCHES, ssd_bwd_kind, ssd_chunks_plain, ssd_scan_bwd,
        ssd_scan_bwd_plain, ssd_scan_bwd_scratch_bytes, ssd_scan_with_states)

    def rel_of(got, want, b, s):
        # each gradient as (B, S, ...) rows, (H,) ones as one row; an
        # element rms floor of 1, as tol (1 + |want|) holds an element
        return {name: _norm_rel(torch, F, *(t.reshape(
            (b, s, -1) if t.dim() > 1 else (1, 1, -1)) for t in (x, w)), 1.0)
            for name, x, w in zip(SSD_GRADS, got, want, strict=True)}

    out, cases = {}, []
    for (b, s, h, p, n), chunk in SSD_BWD_CASES:
        args, dy = _ssd_bwd_inputs(torch, g, b, s, h, p, n)
        tag = f"ssd_scan_bwd/{b}x{s}x{h}x{p}x{n}/chunk{chunk}"
        L = min(chunk, s)
        kind = ssd_bwd_kind(L, p, n)
        states = ssd_scan_with_states(*args, chunk=chunk)[2]
        _check(f"{tag}/chunk_states", states,
               ssd_chunks_plain(*args, chunk=chunk)[1], SSD_TOL, checks)

        def run(args=args, dy=dy, states=states, chunk=chunk, kind=None):
            return ssd_scan_bwd(*args, dy, states, chunk=chunk, kind=kind)

        want_names = set(SSD_BWD_LAUNCHES[kind])
        if kind == "mma_sync" and L >= s:  # one chunk: no local launch
            want_names.discard("ssd_bwd_local_kernel")
        launched = _ssd_launched(torch, run, want_names)
        checks.append({"name": f"{tag}/kind", "kind": kind,
                       "launched": sorted(launched),
                       "ok": launched == want_names})
        got = run()
        want = ssd_scan_bwd_plain(*args, dy, chunk=chunk)
        err = max(_err(a, w) for a, w in zip(got, want))
        rel = rel_of(got, want, b, s)
        bitwise = all(torch.equal(x, y) for x, y in zip(got, run()))
        checks.append({"name": f"{tag}/norm_rel", "kind": kind,
                       "norm_rel_err": rel, "tol": SSD_TOL,
                       "bitwise_repeat": bitwise,
                       "ok": bitwise and all(
                           bool(a.isfinite().all()) for a in got)
                       and max(max(r) for r in rel.values()) <= SSD_TOL})
        case = {"shape": [b, s, h, p, n], "chunk": chunk, "kind": kind,
                "launched": sorted(launched), "max_abs_err": err,
                "norm_rel_max": max(max(r) for r in rel.values()),
                "bitwise_repeat": bitwise,
                "device_ms_by_kernel": {
                    k_: timer.device_ms(run, k_)
                    for k_ in sorted(want_names)}}
        cases.append(case)
        key = SSD_BWD_TIMED.get((b, s, h, p, n), "untimed")
        if key == "untimed" or not timed:
            del got, want
            continue
        # at the timed shapes, the kernel and the f32 plain version each
        # against the plain version in f64 on the same inputs: which of
        # the two carries the f32 difference above
        want64 = ssd_scan_bwd_plain(*(t.double() for t in args),
                                    dy.double(), chunk=chunk)
        rel64 = {side: rel_of(grads, want64, b, s)
                 for side, grads in (("kernel", got), ("plain_f32", want))}
        checks.append({"name": f"{tag}/norm_rel_f64", "kind": kind,
                       "norm_rel_err": rel64["kernel"],
                       "plain_f32_norm_rel_err": rel64["plain_f32"],
                       "tol": SSD_TOL,
                       "ok": max(max(r) for r in rel64["kernel"].values())
                       <= SSD_TOL})
        del want64
        # the mma_sync kind on the same inputs: checked, timed in turns
        yard = {}
        if kind != "mma_sync":
            def run_ms(run=run):
                return run(kind="mma_sync")

            got_ms = run_ms()
            rel_ms = rel_of(got_ms, want, b, s)
            rel_kinds = rel_of(got, got_ms, b, s)
            checks.append({"name": f"{tag}/mma_sync", "norm_rel_err": rel_ms,
                           "vs_wgmma_norm_rel_err": rel_kinds,
                           "tol": SSD_TOL,
                           "ok": max(max(r) for r in rel_ms.values())
                           <= SSD_TOL
                           and max(max(r) for r in rel_kinds.values())
                           <= SSD_TOL})
            del got_ms
            turns = _in_turns(timer, run, run_ms)
            yard = {"in_turns": {f"{kind}_ms": turns["kernel_ms"],
                                 "mma_sync_ms": turns["library_ms"],
                                 f"{kind}_over_mma_sync":
                                     turns["kernel_over_library"]},
                    "mma_sync_device_ms_by_kernel": {
                        k_: timer.device_ms(run_ms, k_)
                        for k_ in SSD_BWD_LAUNCHES["mma_sync"]}}
        del got, want
        nbytes, flops = kernel_work.ssd_bwd_work(b, s, h, p, n, chunk)
        bound, by = kernel_work.bound_ms(flops, nbytes, "tf32x3")
        out[key] = {
            "shape": [b, s, h, p, n], "chunk": chunk, "dtype": "float32",
            "kind": kind, "max_abs_err": err, "norm_rel_err": rel,
            "norm_rel_tol": SSD_TOL, "norm_rel_err_vs_f64": rel64,
            "bitwise_repeat": bitwise, "bytes": nbytes, "flops": flops,
            "ms": timer.ms(run),
            # the call's six launches (SSD_BWD_LAUNCHES[kind]): C·Bᵀ, the
            # local state gradients, their passing, the chunks, dB and
            # dC, the sums over chunks
            "device_ms": timer.device_ms(run, "ssd_"),
            "device_ms_by_kernel": case["device_ms_by_kernel"],
            **yard,
            "scratch_bytes": ssd_scan_bwd_scratch_bytes(b, s, h, p, n,
                                                        chunk),
            "plain_ms": timer.ms(lambda: ssd_scan_bwd_plain(
                *args, dy, chunk=chunk), iters=3),
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None}
        del states
    for ((b, s, h, p, n), chunk), key in SSD_BWD_LONG.items():
        if timed:
            out[key] = _ssd_bwd_long(torch, timer, g, checks, b, s, h, p, n,
                                     chunk, rel_of)
    row = {"route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:140 (ssd_scan_jnp "
                       "under jax.grad; no TPU kernel)",
           "cases": cases,
           "build": _ssd_build("ssd_bwd_", "ssd_tf32_"),
           "tf32_unit": _tf32_unit(torch, g, checks)}
    if None in out:
        row.update(out.pop(None))
    return {**row, "shapes": out}


def _ssd_bwd_long(torch, timer, g, checks, b, s, h, p, n, chunk, rel_of):
    """One ``SSD_BWD_LONG`` case: ssd_scan_bwd at a chunk over 128 steps,
    which launches the forward kernels at 128 (the sub-chunks' states) and
    the backward kernels at 128. Checked: the kernels it launches (those
    of both kinds at 128), one forward and one backward call counted,
    every gradient norm-relative within 2e-4 of the plain backward at the
    long chunk, two calls bitwise equal. Timed in turns against the call
    at chunk 128 on the same inputs (its own chunk states); each launch's
    device ms by name; the bound is the backward's work at the kernels'
    128 steps (the recomputed forward is the design's extra)."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.ssd_scan import (
        SSD_BWD_LAUNCHES, SSD_FWD_LAUNCHES, bwd_chunk, ssd_bwd_kind,
        ssd_fwd_kind, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain,
        ssd_scan_bwd_scratch_bytes, ssd_scan_with_states)
    args, dy = _ssd_bwd_inputs(torch, g, b, s, h, p, n)
    tag = f"ssd_scan_bwd/{b}x{s}x{h}x{p}x{n}/chunk{chunk}"
    sub = bwd_chunk(chunk, s)
    kinds = {"forward": ssd_fwd_kind(sub, p, n, b * h),
             "backward": ssd_bwd_kind(sub, p, n)}
    states = ssd_scan_with_states(*args, chunk=chunk)[2]
    states_sub = ssd_scan_with_states(*args, chunk=sub)[2]

    def run():
        return ssd_scan_bwd(*args, dy, states, chunk=chunk)

    def run_sub():
        return ssd_scan_bwd(*args, dy, states_sub, chunk=sub)

    want_names = set(SSD_FWD_LAUNCHES[kinds["forward"]]) \
        | set(SSD_BWD_LAUNCHES[kinds["backward"]])
    launched = _ssd_launched(torch, run, want_names)
    calls = (ssd_scan.launches, ssd_scan_bwd.launches)
    got = run()
    calls = (ssd_scan.launches - calls[0], ssd_scan_bwd.launches - calls[1])
    want = ssd_scan_bwd_plain(*args, dy, chunk=chunk)
    rel = rel_of(got, want, b, s)
    bitwise = all(torch.equal(x, y) for x, y in zip(got, run()))
    worst = max(max(r) for r in rel.values())
    checks.append({"name": f"{tag}/sub_chunks", "kinds": kinds,
                   "launched": sorted(launched), "calls": calls,
                   "norm_rel_err": rel, "tol": SSD_TOL,
                   "bitwise_repeat": bitwise,
                   "ok": launched == want_names and calls == (1, 1)
                   and bitwise and worst <= SSD_TOL
                   and all(bool(a.isfinite().all()) for a in got)})
    err = max(_err(a, w) for a, w in zip(got, want))
    del got, want
    turns = _in_turns(timer, run, run_sub)
    nbytes, flops = kernel_work.ssd_bwd_work(b, s, h, p, n, sub)
    bound, by = kernel_work.bound_ms(flops, nbytes, "tf32x3")
    # device ms per launch, by name: C·Bᵀ (ssd_cb_kernel) launches twice a
    # call, once for each direction
    by_kernel = {k_: timer.device_ms(run, k_) for k_ in sorted(want_names)}
    return {
        "shape": [b, s, h, p, n], "chunk": chunk, "sub_chunk": sub,
        "dtype": "float32", "kinds": kinds, "launched": sorted(launched),
        "max_abs_err": err, "norm_rel_err": rel, "norm_rel_tol": SSD_TOL,
        "bitwise_repeat": bitwise, "bytes": nbytes, "flops": flops,
        "ms": timer.ms(run),
        "in_turns": {f"chunk{chunk}_ms": turns["kernel_ms"],
                     f"chunk{sub}_ms": turns["library_ms"],
                     f"chunk{chunk}_over_chunk{sub}":
                         turns["kernel_over_library"]},
        "device_ms": sum(v or 0.0 for v in by_kernel.values())
        + (by_kernel["ssd_cb_kernel"] or 0.0),
        "device_ms_by_kernel": by_kernel,
        "scratch_bytes": ssd_scan_bwd_scratch_bytes(b, s, h, p, n, chunk),
        "plain_ms": timer.ms(lambda: ssd_scan_bwd_plain(
            *args, dy, chunk=chunk), iters=3),
        "bound_ms": bound, "bound_by": by, "library_ms": None}


# (B, S, H, P, N), chunk: the serve shapes (the path; timed: the row and
# its "zamba2_n64" shape), ragged S and S below a chunk at full width, the
# tile edges (one step, one chunk, five chunks) at full width, a small case
# (the mma_sync kind), zamba2's 80 heads at N 64 (its prefill, a ragged S,
# one step)
SSD_FWD_CASES = [((4, 512, 64, 64, 128), 128), ((4, 510, 64, 64, 128), 128),
                 ((4, 100, 64, 64, 128), 128), ((1, 1, 64, 64, 128), 128),
                 ((1, 128, 64, 64, 128), 128), ((1, 640, 64, 64, 128), 128),
                 ((2, 64, 2, 16, 16), 16), ((4, 512, 80, 64, 64), 128),
                 ((4, 510, 80, 64, 64), 128), ((1, 1, 80, 64, 64), 128)]
SSD_FWD_TIMED = {(4, 512, 64, 64, 128): None,
                 (4, 512, 80, 64, 64): "zamba2_n64"}


def _ssd_fwd_case(torch, timer, checks, tag, args, chunk, train, timed):
    """One SSD forward case: each kind that takes its widths (wgmma and
    mma_sync where ``ssd_fwd_kind`` allows wgmma, else mma_sync), held
    against the plain versions within the SSD's 2e-4 — y and the final
    state (``ssd_scan``, a serve call; not at a train shape) and y, the
    final state and the chunk states (``ssd_scan_with_states``, training's
    forward) — repeated bitwise, and the kernels it launches, from the
    profiler (another kind's, or a missing one, fails), also for a call
    that leaves the kind to the dispatch (``ssd_fwd_kind`` at B·H). With
    ``timed`` also the dispatched call's card and device ms, each kind's
    device ms by launch, the two kinds in turns, the scratch, bound and
    the plain version's time."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.ssd_scan import (
        SSD_FWD_LAUNCHES, fwd_work_floats, ssd_chunks_plain, ssd_fwd_kind,
        ssd_scan, ssd_scan_plain, ssd_scan_with_states)
    b, s, h, p = args[0].shape
    n = args[3].shape[-1]
    L = min(chunk, s)
    kind = ssd_fwd_kind(L, p, n, b * h)
    kinds = ("wgmma", "mma_sync") if ssd_fwd_kind(L, p, n) == "wgmma" \
        else ("mma_sync",)

    def run(kind=None):
        if train:
            return ssd_scan_with_states(*args, chunk=chunk, kind=kind)
        return ssd_scan(*args, chunk=chunk, return_state=True, kind=kind)

    def run_states(kind=None):
        return ssd_scan_with_states(*args, chunk=chunk, return_state=True,
                                    kind=kind)

    _, want_st, want_y, want_h = ssd_chunks_plain(*args, chunk=chunk)
    serve_want = None if train else ssd_scan_plain(*args, chunk=chunk,
                                                   return_state=True)
    errs = {}
    for k in kinds:
        err = _check(f"{tag}/{k}/states", run_states(k),
                     (want_y, want_h, want_st), SSD_TOL, checks)
        if serve_want is not None:
            err = max(err, _check(f"{tag}/{k}", run(k), serve_want, SSD_TOL,
                                  checks))
        bitwise = all(torch.equal(a, b_) for a, b_ in
                      zip(run_states(k), run_states(k)))
        checks.append({"name": f"{tag}/{k}/bitwise_repeat", "ok": bitwise})
        errs[k] = err
    del want_st, want_y, want_h, serve_want
    for k, name in [(k, f"{tag}/{k}/launched") for k in kinds] \
            + [(None, f"{tag}/kind")]:
        want_names = set(SSD_FWD_LAUNCHES[k or kind])
        launched = _ssd_launched(torch, lambda k=k: run(k), want_names)
        checks.append({"name": name, "kind": k or kind,
                       "launched": sorted(launched),
                       "ok": launched == want_names})
    if not timed:
        return None
    nbytes, flops = kernel_work.ssd_work(b, s, h, p, n, chunk)
    if train:   # and the chunk states written, (B, chunks, H, N, P) f32
        nbytes += 4 * b * -(-s // chunk) * h * n * p
    bound, by = kernel_work.bound_ms(flops, nbytes, "tf32x3")
    row = {"shape": [b, s, h, p, n], "chunk": chunk, "dtype": "float32",
           "kind": kind, "max_abs_err": errs[kind], "bytes": nbytes,
           "flops": flops, "ms": timer.ms(run),
           # every launch of a call (SSD_FWD_LAUNCHES[kind])
           "device_ms": timer.device_ms(run, "ssd_"),
           "device_ms_by_kernel": {k_: timer.device_ms(run, k_)
                                   for k_ in SSD_FWD_LAUNCHES[kind]},
           "scratch_bytes": 4 * fwd_work_floats(b, s, h, p, n, chunk, kind,
                                                train)}
    if train:
        row["with_states"] = True
    for other in kinds:
        if other == kind:
            continue
        turns = _in_turns(timer, lambda: run("wgmma"),
                          lambda: run("mma_sync"))
        row.update({
            f"{other}_max_abs_err": errs[other],
            "in_turns": {"wgmma_ms": turns["kernel_ms"],
                         "mma_sync_ms": turns["library_ms"],
                         "wgmma_over_mma_sync": turns["kernel_over_library"]},
            f"{other}_device_ms_by_kernel": {
                k_: timer.device_ms(lambda: run(other), k_)
                for k_ in SSD_FWD_LAUNCHES[other]},
            f"{other}_scratch_bytes": 4 * fwd_work_floats(
                b, s, h, p, n, chunk, other, train)})
    plain = (lambda: ssd_chunks_plain(*args, chunk=chunk)) if train else \
        (lambda: ssd_scan_plain(*args, chunk=chunk, return_state=True))
    row.update({"plain_ms": timer.ms(plain, iters=3 if train else 20),
                "bound_ms": bound, "bound_by": by,
                # the first kernel's reckoning: f32 on the CUDA cores
                "bound_cuda_core_ms": kernel_work.bound_ms(
                    flops, nbytes, "float32")[0],
                "library_ms": None})
    return row


def _ssd_fwd_rows(torch, timer, randn, checks, timed=True):
    """The SSD forward's row: every case of ``SSD_FWD_CASES`` (inputs from
    ``randn`` and its generator) and of ``SSD_FWD_TRAIN`` (mamba2-1.3b's
    and zamba2-2.7b's train shapes with the chunk states, inputs from a
    generator of their own) through ``_ssd_fwd_case``, timed at
    ``SSD_FWD_TIMED`` and the train shapes (with ``timed``); the build's
    registers, spills, HMMA and HGMMA of the forward's kernels."""
    g = randn.gen
    timed_rows = {}
    for (b, s, h, p, n), chunk in SSD_FWD_CASES:
        sx, sb, sc_ = randn(b, s, h, p), randn(b, s, n) * 0.3, \
            randn(b, s, n) * 0.3
        sdt = torch.rand((b, s, h), generator=g, device="cuda") * 0.29 + 0.01
        sa = torch.log(torch.arange(1, h + 1, device="cuda",
                                    dtype=torch.float32))
        sd = randn(h)
        key = SSD_FWD_TIMED.get((b, s, h, p, n), "untimed")
        row = _ssd_fwd_case(torch, timer, checks,
                            f"ssd_scan/{b}x{s}x{h}x{p}x{n}/chunk{chunk}",
                            (sx, sdt, sa, sb, sc_, sd), chunk, False,
                            timed and key != "untimed")
        if row is not None:
            timed_rows[key] = row
    # the forward with chunk states at the training paths' shapes,
    # mamba2-1.3b's and zamba2-2.7b's, inputs from a generator of their own
    rn_s = _randn_from(torch, 31)
    for (b, s, h, p, n), key in SSD_FWD_TRAIN.items():
        args = (rn_s(b, s, h, p),
                torch.rand((b, s, h), generator=rn_s.gen, device="cuda")
                * 0.29 + 0.01,
                torch.log(torch.arange(1, h + 1, device="cuda",
                                       dtype=torch.float32)),
                rn_s(b, s, n) * 0.3, rn_s(b, s, n) * 0.3, rn_s(h))
        row = _ssd_fwd_case(torch, timer, checks,
                            f"ssd_scan/{b}x{s}x{h}x{p}x{n}/chunk128/train",
                            args, 128, True, timed)
        if row is not None:
            timed_rows[key] = row
        del args
    out = {"route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:127",
           "build": _ssd_build("ssd_fwd_", "ssd_scan_", "ssd_cb_")}
    if None in timed_rows:
        out.update(timed_rows.pop(None))
    return {**out, "shapes": timed_rows}


def _in_turns(timer, kernel, library, iters=10):
    """A kernel and its library call timed in turns in one call (kernel,
    library, library, kernel): each side's two medians, and the ratio of
    their sums."""
    k1 = timer.ms(kernel, iters=iters)
    l1 = timer.ms(library, iters=iters)
    l2 = timer.ms(library, iters=iters)
    k2 = timer.ms(kernel, iters=iters)
    return {"kernel_ms": [k1, k2], "library_ms": [l1, l2],
            "kernel_over_library": (k1 + k2) / (l1 + l2)}


def _update_chunk_shape(torch, leaf):
    """The shape of the first chunk ``apply_updates`` updates a leaf of
    shape ``leaf`` by (the whole leaf if it takes one)."""
    from repro_torch.optim.adamw import update_chunks
    p = torch.empty(leaf, device="meta")
    return tuple(p[update_chunks(p)[0]].shape)


def _optimizer_row(torch, timer, name, shape, checks):
    """One optimizer tile kernel at one f32 leaf shape: checked against
    its plain version, timed, its bound (each input read once, each
    output written once)."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.tile_programs import get_tile_op
    op = get_tile_op(name)
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(shape, generator=g, device="cuda")
          for _ in op.tk.in_arrays]
    if name == "adamw":
        xs[3] = xs[3].abs() * 0.01          # v >= 0
        sc = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1,
              "inv_bc1": 10.0, "inv_bc2": 20.0}
    else:
        sc = {"norm": 3.0, "max_norm": 1.0, "eps": 1e-9}
    tag = f"{name}/float32/{'x'.join(map(str, shape))}"
    err = _check(tag, op.apply(*xs, **sc), op.torch_ref(*xs, **sc),
                 TILE_TOL["float32"], checks)
    bound, by = kernel_work.tile_bound(op, xs)
    row = {"shape": list(shape), "dtype": "float32", "max_abs_err": err,
           "ms": timer.ms(lambda: op.apply(*xs, **sc), iters=10),
           "device_ms": timer.device_ms(lambda: op.apply(*xs, **sc),
                                        op.tk.kernel_name, iters=5),
           "plain_ms": timer.ms(lambda: op.torch_ref(*xs, **sc), iters=5),
           "bound_ms": bound, "bound_by": by}
    if name == "l2_clip":
        scale = min(1.0, sc["max_norm"] / (sc["norm"] + sc["eps"]))
        row["library_ms"] = timer.ms(lambda: torch.mul(xs[0], scale),
                                     iters=10)
        row["in_turns"] = _in_turns(timer, lambda: op.apply(*xs, **sc),
                                    lambda: torch.mul(xs[0], scale))
    else:
        row["library_ms"] = None
        p = xs[0].clone().requires_grad_()
        p.grad = xs[1]
        opt = torch.optim.AdamW([p], lr=sc["lr"], betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
        row["nearest_call_ms"] = {
            "torch.optim.AdamW(fused=True).step": timer.ms(opt.step,
                                                           iters=10)}
        del opt, p
    return row


def _l2_clip_bf16_row(torch, timer, shape, checks):
    """l2_clip of a bf16 gradient into f32, as the optimizer runs it:
    the kernel reads the gradient in bf16 and writes f32. Checked
    bitwise against ``g.float()`` times the kernel's own scale (its
    result on a one) and against its plain version; timed beside its
    bound (2 bytes read and 4 written an element), the library's two
    calls ``g.float().mul_(scale)`` and the two launches it replaces
    (the cast, then the f32 kernel)."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.tile_programs import get_tile_op
    op = get_tile_op("l2_clip")
    g = torch.randn(shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").bfloat16()
    sc = {"norm": 3.0, "max_norm": 1.0, "eps": 1e-9}
    f32 = torch.float32

    def run():
        return op.apply(g, out_dtype=f32, **sc)

    def lib():
        return g.float().mul_(scale)

    tag = f"l2_clip/bfloat16_to_float32/{'x'.join(map(str, shape))}"
    got = run()
    one = op.apply(torch.ones(1, dtype=torch.bfloat16, device="cuda"),
                   out_dtype=f32, **sc)
    bitwise = got.dtype == f32 and torch.equal(got, g.float() * one)
    checks.append({"name": f"{tag}/bitwise", "ok": bitwise})
    err = _check(tag, got, op.torch_ref(g.float(), **sc),
                 TILE_TOL["float32"], checks)
    del got
    scale = min(1.0, sc["max_norm"] / (sc["norm"] + sc["eps"]))
    bound, by = kernel_work.tile_bound(op, [g], f32)
    return {"shape": list(shape), "dtype": "bfloat16", "out_dtype": "float32",
            "max_abs_err": err, "bitwise": bitwise,
            "plan": _plan_dict(_tile_plan(op, [g], f32)),
            "ms": timer.ms(run, iters=10),
            "device_ms": timer.device_ms(run, op.tk.kernel_name, iters=5),
            "plain_ms": timer.ms(lambda: op.torch_ref(g.float(), **sc),
                                 iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.ms(lib, iters=10),
            "library_call": "g.float().mul_(scale), two calls",
            "cast_then_f32_kernel_ms": timer.ms(
                lambda: op.apply(g.float(), **sc), iters=10),
            "in_turns": _in_turns(timer, run, lib)}


def _norm_rel(torch, F, got, want, floor, rows=64):
    """``||got - want|| / ||want||`` of an (..., S, D) gradient over the
    whole tensor and, the largest, over each 64-row block of each leading
    index. Each denominator is at least ``floor`` (an element rms) over as
    many elements: a gradient that is zero in exact arithmetic is held to
    that floor (flash's dq and dk of a query that sees one key; the SSD's
    da_log of one step)."""
    S, D = want.shape[-2:]
    pad = -S % rows
    nb = (S + pad) // rows
    d, w = (F.pad(t.float(), (0, 0, 0, pad)).reshape(-1, nb, rows * D)
            for t in (got.float() - want.float(), want))
    n = torch.full((nb,), float(rows * D), device=want.device)
    n[-1] = (S - (nb - 1) * rows) * D
    floor = torch.as_tensor(floor, dtype=torch.float32, device=want.device)
    whole = d.norm() / torch.maximum(w.norm(), floor * want.numel() ** 0.5)
    block = d.norm(dim=-1) / torch.maximum(w.norm(dim=-1), floor * n.sqrt())
    return [whole.item(), block.max().item()]


def _mma_sync_bwd(torch, q, k, v, o, lse, do, causal,
                  entry="flash_attention_bwd_bf16"):
    """A callable running the bf16 backward on the mma.sync kernels (the
    library's entry at every head_dim; the design the wgmma kernels
    replaced at head_dim 64, 80 and 128, their yardstick) on these
    operands; with ``entry`` ``flash_attention_bwd_f32``, the f32
    backward on the CUDA cores, the yardstick of the 3xTF32 kind."""
    from repro_torch.kernels.flash_attention import _load, _raise_on
    lib = _load()
    B, H, S, D = q.shape
    scratch = torch.empty(B * H * S, device="cuda")
    grads = [torch.empty_like(t) for t in (q, k, v)]

    def run():
        _raise_on(lib, getattr(lib, entry)(
            *(t.data_ptr() for t in (q, k, v, o, lse, do, scratch, *grads)),
            B, H, k.shape[1], S, D, D ** -0.5, int(causal),
            torch.cuda.current_stream().cuda_stream),
            "flash_attention_bwd_mma_sync")
        return grads

    return run


def _check_norm_rel(torch, F, tag, named, ref, dtype, checks):
    """``_norm_rel`` of each ``(name, got, want)`` against the dtype's
    ``FLASH_REL_TOL``, as one check: ``{name: [whole, worst block]}``.
    An element-wise limit of tol (1 + |want|) is as large as a typical
    value at S 4096 (an output's |o| ~ (e / keys) ** 0.5, a gradient's
    likewise), so this is the check that sees a wrong or missing tile.
    The floor is a thousandth of ``ref``'s rms."""
    floor = 1e-3 * ref.float().square().mean().sqrt()
    rel = {n: _norm_rel(torch, F, a, b, floor) for n, a, b in named}
    checks.append({"name": f"{tag}/norm_rel", "norm_rel_err": rel,
                   "tol": FLASH_REL_TOL[dtype],
                   "ok": max(max(r) for r in rel.values())
                   <= FLASH_REL_TOL[dtype]})
    return rel


# whisper-small's attention in training: (B, H, KH, S, D)
WHISPER_ATTN = (2, 12, 12, 4096, 64)
# the backward's timed shapes and causal flags, by their key under the
# row's "shapes" (None: the row itself, minitron-4b's train path;
# zamba2_train: the hybrid's shared block at head_dim 80, on zamba2's
# train path; whisper_train: whisper-small's decoder self-attention
# (causal) and its encoder and cross-attention (full), MHA at head_dim
# 64; d64: head_dim 64, on no path); each beside the mma.sync kernels,
# the design the wgmma ones replaced at head_dim 64, 80 and 128
FLASH_BWD_TIMED = {((2, 24, 8, 4096, 128), True): None,
                   ((4, 24, 8, 512, 128), True): "serve_shape",
                   ((2, 12, 2, 4096, 128), True): "qwen2vl",
                   ((2, 32, 32, 4096, 80), True): "zamba2_train",
                   (WHISPER_ATTN, True): "whisper_train",
                   (WHISPER_ATTN, False): "whisper_train_full",
                   ((2, 16, 16, 4096, 64), True): "d64"}
# two calls must give the same bits at these (the training shapes)
FLASH_BWD_BITWISE = ((2, 24, 8, 4096, 128), (2, 12, 2, 4096, 128),
                     (2, 32, 32, 4096, 80), WHISPER_ATTN)
# each backward route's launches, as the profiler names them
FLASH_BWD_LAUNCHES = {
    "wgmma": ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq"),
    "mma_sync": ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"),
    "wgmma_f32": ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq"),
    "cuda_cores": ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")}
# (B, H, KH, S, D), dtype, causal: the timed shapes; small f32 cases;
# the head_dim 80 and 64 tile edges; the wgmma kernels' edges at head_dim
# 128 (S around their 128-row work items and 64-row steps, a long ragged
# S, qwen2-vl's group of 6, MHA), causal and not
FLASH_BWD_CASES = [(shape, "bfloat16", causal)
                   for shape, causal in FLASH_BWD_TIMED] + [
    ((2, 4, 2, 128, 16), "float32", True),
    ((2, 4, 2, 128, 16), "float32", False)] + [
    ((2, 8, kh, s_, d), dt, True)
    for d in (80, 64) for dt in ("bfloat16", "float32") for kh in (8, 2)
    for s_ in (1, 63, 65, 129)] + [
    ((b, h, kh, s_, 128), "bfloat16", causal)
    for b, h, kh, s_ in ((1, 4, 2, 127), (1, 4, 2, 128), (1, 4, 2, 129),
                         (1, 4, 2, 255), (1, 4, 2, 257), (2, 6, 2, 1000),
                         (2, 12, 2, 1001), (1, 4, 4, 257))
    for causal in (True, False)]


# flash attention forward: full width causal (the path) and not, a ragged
# S, the mma.sync kernel's tile edges (one row, one past a 64-row tile,
# one past two), and a small f32 head_dim-16 case; zamba2's head_dim 80
# (its prefill in bf16 and, as its f32 parity runs it, in f32; the tile
# edges in both, MHA and GQA), dbrx's prefill, whisper's MHA at head_dim
# 64 (non-causal: the encoder and cross-attention; causal: the decoder)
# and qwen2-vl's GQA 12/2; then the last four configs' prefills: groups
# of 4 (granite, nemo), 12 (mistral-large) and 7 (arctic, the first odd
# group), and the odd group's tile edges. Inputs from the kernels phase's
# first generator, in this order.
FLASH_FWD_CASES = [
    ((4, 24, 8, 512, 128), "bfloat16", True),
    ((4, 24, 8, 512, 128), "bfloat16", False),
    ((4, 24, 8, 100, 128), "bfloat16", True),
    ((2, 8, 8, 1, 64), "bfloat16", True),
    ((2, 8, 8, 65, 64), "bfloat16", True),
    ((2, 8, 8, 129, 64), "bfloat16", True),
    ((2, 4, 2, 128, 16), "float32", True),
    ((2, 4, 2, 128, 16), "float32", False),
    ((4, 32, 32, 512, 80), "bfloat16", True),
    ((4, 32, 32, 510, 80), "float32", True),
    ((4, 32, 32, 512, 80), "bfloat16", False),
    ((4, 48, 8, 512, 128), "bfloat16", True),
    ((4, 12, 12, 512, 64), "bfloat16", False),
    ((4, 12, 12, 512, 64), "bfloat16", True),
    ((4, 12, 2, 512, 128), "bfloat16", True),
    ((4, 32, 8, 512, 128), "bfloat16", True),
    ((4, 96, 8, 512, 128), "bfloat16", True),
    ((4, 56, 8, 512, 128), "bfloat16", True),
    ((2, 14, 2, 65, 128), "bfloat16", True),
    ((2, 14, 2, 65, 128), "float32", True),
    ((2, 14, 2, 129, 128), "float32", True)] + [
    ((2, 8, kh, s, 80), dt, True)
    for dt in ("bfloat16", "float32") for kh in (8, 2)
    for s in (1, 63, 64, 65, 129)]
# the wgmma forward's edges: S around its 128-row work items and kv tiles
# and a long ragged S, causal and full, GQA 12 at head_dim 128, GQA 7 at
# 64 and MHA at 80 (inputs from a generator of their own, seed 29)
FLASH_FWD_EDGES = [((1, h, kh, s, d), "bfloat16", causal)
                   for s in (127, 128, 255, 257, 4095)
                   for causal in (True, False)
                   for h, kh, d in ((12, 1, 128), (14, 2, 64), (2, 2, 80))]
# the mma.sync forward, which bf16 keeps at head_dim 16 and 32: MHA and
# GQA, ragged S, causal and full, with the row lse (True) and without;
# inputs from the edges' generator, after them
FLASH_FWD_MMA_SYNC = [
    (((2, 4, 2, 128, 16), "bfloat16", True), False),
    (((2, 4, 2, 128, 16), "bfloat16", False), True),
    (((2, 4, 4, 65, 16), "bfloat16", True), True),
    (((2, 8, 2, 129, 32), "bfloat16", True), False),
    (((2, 8, 2, 129, 32), "bfloat16", False), False),
    (((1, 12, 4, 257, 32), "bfloat16", True), True),
    (((1, 14, 2, 1000, 32), "bfloat16", False), True)]
# the timed serve shapes, by their key under the row's "shapes" (None:
# the row itself, minitron-4b's prefill)
FLASH_FWD_TIMED = {
    ((4, 24, 8, 512, 128), "bfloat16", True): None,
    ((4, 32, 32, 512, 80), "bfloat16", True): "zamba2_d80",
    ((4, 48, 8, 512, 128), "bfloat16", True): "dbrx",
    ((4, 12, 12, 512, 64), "bfloat16", False): "whisper_d64_full",
    ((4, 12, 12, 512, 64), "bfloat16", True): "whisper_d64",
    ((4, 12, 2, 512, 128), "bfloat16", True): "qwen2vl",
    ((4, 32, 8, 512, 128), "bfloat16", True): "granite_g4",
    ((4, 96, 8, 512, 128), "bfloat16", True): "mistral_large_g12",
    ((4, 56, 8, 512, 128), "bfloat16", True): "arctic_g7"}
# the forward with the row lse at the training paths' shapes (the train
# step's launches: minitron-4b's GQA 24/8 at head_dim 128, zamba2-2.7b's
# shared block, MHA 32 at head_dim 80, and whisper-small's encoder and
# cross-attention, MHA 12 at head_dim 64, non-causal; whisper's from the
# second generator)
FLASH_FWD_TRAIN = (((2, 24, 8, 4096, 128), True, "train_with_lse"),
                   ((2, 32, 32, 4096, 80), True, "zamba2_train_with_lse"),
                   (WHISPER_ATTN, False, "whisper_train_with_lse_full"))


def _mma_sync_fwd(torch, q, k, v, causal, with_lse,
                  entry="flash_attention_fwd_bf16"):
    """A callable running the bf16 forward on the mma.sync kernel (the
    library's entry at every head_dim; the design the wgmma kernel
    replaced at head_dim 64, 80 and 128, its yardstick) on these
    operands; with ``entry`` ``flash_attention_fwd_f32``, the f32 forward
    on the CUDA cores, the yardstick of the 3xTF32 kind."""
    from repro_torch.kernels.flash_attention import _load, _raise_on
    lib = _load()
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), device="cuda") if with_lse else None

    def run():
        _raise_on(lib, getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, k.shape[1], S, D,
            D ** -0.5, int(causal), torch.cuda.current_stream().cuda_stream),
            "flash_attention_mma_sync")
        return o, lse

    return run


def _flash_build_info(prefix):
    """Registers, spills and tensor-core instruction counts of each kernel
    of the flash library whose name starts with ``prefix``."""
    from repro_torch.kernels.cuda_build import build
    lib = build("flash_attention.cu")[0]
    with open(f"{lib}.log") as f:
        ptxas = _ptxas_by_kernel(f.read())
    tc = _tensor_core_counts(lib)
    return {k: {**v, **tc.get(k, {})} for k, v in ptxas.items()
            if k.startswith(prefix)}


def _fwd_kernel_name(kind, d):
    return {"wgmma": "flash_fwd_sm90_kernel", "mma_sync":
            "flash_fwd_bf16_kernel", "cuda_cores": "flash_fwd_f32_kernel",
            "wgmma_f32": "flash_fwd_sm90_f32_kernel"}[kind] + f"<{d}>"


# each backward kind's kernels as the build names them (the prep and
# delta launches of f32 take no head_dim)
_BWD_KERNELS = {"wgmma": ("flash_bwd_prep_bf16_kernel<{d}>",
                          "flash_bwd_dkdv_sm90_kernel<{d}>",
                          "flash_bwd_dq_sm90_kernel<{d}>"),
                "wgmma_f32": ("flash_bwd_prep_f32_kernel",
                              "flash_bwd_dkdv_sm90_f32_kernel<{d}>",
                              "flash_bwd_dq_sm90_f32_kernel<{d}>"),
                "cuda_cores": ("flash_bwd_delta_f32_kernel",
                               "flash_bwd_dkdv_f32_kernel<{d}>",
                               "flash_bwd_dq_f32_kernel<{d}>")}


def _bwd_kernel_names(kind, d):
    return tuple(n.format(d=d) for n in _BWD_KERNELS[kind])


def _hold_fwd(torch, F, tag, got, want, dtype, checks):
    """A forward's ``(o, lse)`` against the plain version's: o
    element-wise and norm-relative, the lse (where not None) within
    2e-3. ``(max_abs_err, norm_rel, lse_err)``."""
    lse_err = None
    if got[1] is not None:
        lse_err = _err(got[1], want[1])
        checks.append({"name": f"{tag}/lse", "max_abs_err": lse_err,
                       "tol": 2e-3, "ok": lse_err <= 2e-3})
    err = _check(tag, got[0], want[0], FLASH_TOL[dtype], checks)
    rel = _check_norm_rel(torch, F, tag, [("o", got[0], want[0])], want[0],
                          dtype, checks)["o"]
    return err, rel, lse_err


def _flash_fwd_case(torch, F, randn, shape, dtype, causal, checks,
                    with_lse=False):
    """One forward case: the kernel against its plain version,
    element-wise and norm-relative (and the lse within 2e-3 where asked
    for). ``(operands, plain (o, lse), max_abs_err, norm_rel,
    lse_err)``."""
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, flash_attention, flash_attention_fwd_plain,
        flash_attention_plain)
    b, h, kh, s_, d = shape
    dt = getattr(torch, dtype)
    q, k, v = (randn(b, n, s_, d, dtype=dt) for n in (h, kh, kh))
    tag = f"flash_attention/{dtype}/{b}x{h}x{kh}x{s_}x{d}/" \
          f"{'causal' if causal else 'full'}" + ("/lse" if with_lse else "")
    if with_lse:
        got = _launch_fwd(q, k, v, causal, None, with_lse=True)
        want = flash_attention_fwd_plain(q, k, v, causal=causal)
    else:
        got = (flash_attention(q, k, v, causal=causal), None)
        want = (flash_attention_plain(q, k, v, causal=causal), None)
    err, rel, lse_err = _hold_fwd(torch, F, tag, got, want, dtype, checks)
    return (q, k, v), want, err, rel, lse_err


def _flash_fwd_rows(torch, F, timer, randn, randn_t, checks):
    """The forward kernels against their plain version at
    ``FLASH_FWD_CASES``, ``FLASH_FWD_EDGES``, ``FLASH_FWD_MMA_SYNC`` and,
    with the lse, ``FLASH_FWD_TRAIN`` (the row: minitron-4b's prefill).
    At the timed shapes: the kind of kernel, card and device time, two
    launches bitwise equal, the bound, the plain version's and the
    library's time (SDPA's forward), and for the wgmma kernel the
    mma.sync kernel, held against the plain version at the same limits
    and then timed in turns (``_in_turns``: wgmma, mma.sync, mma.sync,
    wgmma), with both kernels' registers, spills and tensor-core
    instruction counts."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, flash_attention_fwd_plain, flash_attention_plain,
        fwd_kernel)
    built = _flash_build_info("flash_fwd_")
    randn_e = _randn_from(torch, 29)
    timed = {}
    cases = [(c, randn, False, FLASH_FWD_TIMED.get(c, "untimed"))
             for c in FLASH_FWD_CASES] + \
        [(c, randn_e, False, "untimed") for c in FLASH_FWD_EDGES] + \
        [(c, randn_e, lse, "untimed") for c, lse in FLASH_FWD_MMA_SYNC] + \
        [(((shape, "bfloat16", causal)), randn_t if shape == WHISPER_ATTN
          else randn, True, key) for shape, causal, key in FLASH_FWD_TRAIN]
    for (shape, dtype, causal), rn, with_lse, key in cases:
        ops, want, err, rel, lse_err = _flash_fwd_case(
            torch, F, rn, shape, dtype, causal, checks, with_lse)
        if key == "untimed":
            continue
        b, h, kh, s_, d = shape
        q, k, v = ops
        kind = fwd_kernel(d, q.dtype)

        def run(ops=ops, causal=causal, with_lse=with_lse):
            return _launch_fwd(*ops, causal, None, with_lse=with_lse)

        first, again = run(), run()
        bitwise = all(x is None or torch.equal(x, y)
                      for x, y in zip(first, again))
        checks.append({"name": f"flash_attention/{dtype}/"
                       f"{'x'.join(map(str, shape))}/bitwise_repeat",
                       "ok": bitwise})
        del first, again
        flops, nbytes = kernel_work.flash_fwd_work(
            b, h, kh, s_, d, q.element_size(), causal, with_lse)
        bound, by = kernel_work.bound_ms(flops, nbytes, dtype)
        plain = flash_attention_fwd_plain if with_lse else \
            flash_attention_plain
        row = {"shape": list(shape), "dtype": dtype, "causal": causal,
               "with_lse": with_lse, "kernels": kind,
               "max_abs_err": err, "norm_rel_err": rel,
               "bitwise_repeat": bitwise, "flops": flops, "bytes": nbytes,
               "ms": timer.ms(run),
               "device_ms": timer.device_ms(run, "flash_fwd_"),
               "plain_ms": timer.ms(lambda: plain(q, k, v, causal=causal),
                                    iters=5 if with_lse else 20),
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer.ms(_sdpa(F, q, k, v, causal)),
               "build": {kind: built.get(_fwd_kernel_name(kind, d))}}
        if with_lse:
            row["lse_max_abs_err"] = lse_err
        if kind == "wgmma":
            mma = _mma_sync_fwd(torch, q, k, v, causal, with_lse)
            row["mma_sync_max_abs_err"], row["mma_sync_norm_rel_err"], _ = \
                _hold_fwd(torch, F, f"flash_attention_mma_sync/{dtype}/"
                          f"{'x'.join(map(str, shape))}/"
                          f"{'causal' if causal else 'full'}", mma(), want,
                          dtype, checks)
            turns = _in_turns(timer, run, mma)
            row["mma_sync_ms"] = sum(turns["library_ms"]) / 2
            row["in_turns_vs_mma_sync"] = {
                "wgmma_ms": turns["kernel_ms"],
                "mma_sync_ms": turns["library_ms"],
                "wgmma_over_mma_sync": turns["kernel_over_library"]}
            row["build"]["mma_sync"] = built.get(
                _fwd_kernel_name("mma_sync", d))
        timed[key] = row
        del ops, want, q, k, v
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:147",
            **timed.pop(None), "shapes": timed}


def _flash_bwd_case(torch, F, randn, shape, dtype, causal, checks,
                    repeat=False):
    """One backward case: the kernels against their plain version,
    element-wise and norm-relative, and at ``FLASH_BWD_BITWISE`` (bf16)
    or with ``repeat`` two calls bitwise equal. ``(operands, max_abs_err,
    norm_rel, bitwise)``, the operands ``(q, k, v, o, lse, dout)``,
    bitwise None where unchecked."""
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, flash_attention_bwd, flash_attention_bwd_plain)
    b, h, kh, s_, d = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (randn(b, n, s_, d, dtype=dt) for n in (h, kh, kh, h))
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    ops = (q, k, v, o, lse, do)
    tag = f"flash_attention_bwd/{dtype}/{b}x{h}x{kh}x{s_}x{d}/" \
          f"{'causal' if causal else 'full'}"
    got = flash_attention_bwd(*ops, causal=causal)
    want = flash_attention_bwd_plain(*ops, causal=causal)
    err = _check(tag, got, want, FLASH_TOL[dtype], checks)
    rel = _check_norm_rel(torch, F, tag, zip(("dq", "dk", "dv"), got, want),
                          want[2], dtype, checks)
    bitwise = None
    if repeat or (shape in FLASH_BWD_BITWISE and dtype == "bfloat16"):
        again = flash_attention_bwd(*ops, causal=causal)
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        checks.append({"name": f"{tag}/bitwise_repeat", "ok": bitwise})
    return ops, err, rel, bitwise


def _flash_bwd_rows(torch, F, timer, randn, randn_t, checks):
    """The backward kernels against their plain version at
    ``FLASH_BWD_CASES`` (the row: minitron-4b's training shape); times,
    bound, the mma.sync kernels' time (the earlier design) and the
    library's backward (autograd of scaled_dot_product_attention) at the
    timed shapes and causal flags. whisper's cases draw from ``randn_t``,
    the others from ``randn``."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.flash_attention import (
        bwd_kernel, flash_attention_bwd, flash_attention_bwd_plain)
    out = {}
    for shape, name, causal in FLASH_BWD_CASES:
        ops, err, rel, bitwise = _flash_bwd_case(
            torch, F, randn_t if shape == WHISPER_ATTN else randn, shape,
            name, causal, checks)
        key = FLASH_BWD_TIMED.get((shape, causal), "untimed")
        if key == "untimed" or name != "bfloat16":
            continue
        b, h, kh, s_, d = shape
        q, k, v, o, lse, do = ops
        flops, nbytes = kernel_work.flash_bwd_work(b, h, kh, s_, d, name,
                                                   causal)
        bound, by = kernel_work.bound_ms(flops, nbytes, name)

        def run(ops=ops, causal=causal):
            return flash_attention_bwd(*ops, causal=causal)

        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lo = _sdpa(F, lq, lk, lv, causal)()
        out[key] = {
            "shape": list(shape), "dtype": name, "causal": causal,
            "kernels": bwd_kernel(d, q.dtype), "max_abs_err": err,
            "norm_rel_err": rel, "norm_rel_tol": FLASH_REL_TOL[name],
            "bitwise_repeat": bitwise, "flops": flops, "bytes": nbytes,
            "ms": timer.ms(run), "device_ms": timer.device_ms(run,
                                                              "flash_bwd_"),
            "device_ms_by_kernel": {
                k_: timer.device_ms(run, k_)
                for k_ in FLASH_BWD_LAUNCHES[bwd_kernel(d, q.dtype)]},
            "mma_sync_ms": timer.ms(_mma_sync_bwd(torch, *ops, causal)),
            "plain_ms": timer.ms(lambda: flash_attention_bwd_plain(
                *ops, causal=causal), iters=5),
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": timer.ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), do, retain_graph=True))}
        del lo, lq, lk, lv
    row = out.pop(None)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/models/layers.py:151 (_flash_bwd, jnp; "
                        "no TPU kernel)", **row, "shapes": out}


# f32 at head_dim 64, 80 and 128: the 3xTF32 wgmma kind, each timed shape
# also on the CUDA-core kernels it replaced there (checked against the
# plain version and timed in turns: kind, CUDA cores, CUDA cores, kind).
# The forward at the f32 serve-parity prefills' attention (4 x 510: zamba2,
# dbrx, qwen2-vl, whisper's decoder (causal) and encoder / cross
# (full), granite and nemo's group of 4, mistral-large's 12, arctic's 7),
# by key under the flash_attention_f32 row's "shapes" (None: the row,
# zamba2's)
FLASH_F32_FWD = {((4, 32, 32, 510, 80), True): None,
                 ((4, 48, 8, 510, 128), True): "dbrx",
                 ((4, 12, 2, 510, 128), True): "qwen2vl",
                 ((4, 12, 12, 510, 64), True): "whisper_causal",
                 ((4, 12, 12, 510, 64), False): "whisper_full",
                 ((4, 32, 8, 510, 128), True): "granite_nemo",
                 ((4, 96, 8, 510, 128), True): "mistral_large",
                 ((4, 56, 8, 510, 128), True): "arctic"}
# the training-parity phases' attention (B 1 x S 512), the forward with
# the row lse and the backward, two calls of each bitwise equal; by key
# (None: the backward row, minitron-4b's; the forward's under
# "train_<key>")
FLASH_F32_TRAIN = {((1, 24, 8, 512, 128), True): None,
                   ((1, 32, 32, 512, 80), True): "zamba2",
                   ((1, 12, 12, 512, 64), True): "whisper_causal",
                   ((1, 12, 12, 512, 64), False): "whisper_full",
                   ((1, 48, 8, 512, 128), True): "dbrx",
                   ((1, 12, 2, 512, 128), True): "qwen2vl",
                   ((1, 96, 8, 512, 128), True): "mistral_large"}
# the kind's edges, forward (with the lse) and backward: S around its
# 32-row steps and 64- and 128-row items and a long ragged S, GQA and MHA
# at each head_dim, causal and full
FLASH_F32_EDGES = [((1, h, kh, s_, d), causal)
                   for s_ in (1, 31, 33, 64, 65, 127, 129, 257, 1000)
                   for causal in (True, False)
                   for h, kh, d in ((12, 2, 128), (6, 6, 64), (4, 2, 80))]


def _f32_fwd_row(torch, F, timer, randn, shape, causal, with_lse, checks,
                 built):
    """One timed f32 forward: the kind the dispatch picks against the
    plain version (and its lse), two calls bitwise equal, the CUDA-core
    kernel on the same inputs held to the same limits and timed in turns
    beside it, SDPA's f32 forward, the bound at 3xTF32 and by bytes with
    the f32 units' beside it."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, flash_attention_fwd_plain, flash_attention_plain,
        fwd_kernel)
    (q, k, v), want, err, rel, lse_err = _flash_fwd_case(
        torch, F, randn, shape, "float32", causal, checks, with_lse)
    b, h, kh, s_, d = shape
    kind = fwd_kernel(d, torch.float32)
    tag = f"flash_attention/float32/{'x'.join(map(str, shape))}/" \
          f"{'causal' if causal else 'full'}"

    def run():
        return _launch_fwd(q, k, v, causal, None, with_lse=with_lse)

    first, again = run(), run()
    bitwise = all(x is None or torch.equal(x, y)
                  for x, y in zip(first, again))
    checks.append({"name": f"{tag}/bitwise_repeat", "ok": bitwise})
    del first, again
    cores = _mma_sync_fwd(torch, q, k, v, causal, with_lse,
                          entry="flash_attention_fwd_f32")
    cores_err, cores_rel, _ = _hold_fwd(
        torch, F, f"flash_attention_cuda_cores/{tag[16:]}", cores(), want,
        "float32", checks)
    turns = _in_turns(timer, run, cores)
    flops, nbytes = kernel_work.flash_fwd_work(b, h, kh, s_, d, 4, causal,
                                               with_lse)
    bound, by = kernel_work.bound_ms(flops, nbytes, "tf32x3")
    plain = flash_attention_fwd_plain if with_lse else flash_attention_plain
    return {"shape": list(shape), "dtype": "float32", "causal": causal,
            "with_lse": with_lse, "kernels": kind, "max_abs_err": err,
            "norm_rel_err": rel, "lse_max_abs_err": lse_err,
            "bitwise_repeat": bitwise, "flops": flops, "bytes": nbytes,
            "ms": timer.ms(run),
            "device_ms": timer.device_ms(run, "flash_fwd_"),
            "plain_ms": timer.ms(lambda: plain(q, k, v, causal=causal),
                                 iters=5),
            "bound_ms": bound, "bound_by": by,
            "bound_cuda_core_ms": kernel_work.bound_ms(flops, nbytes,
                                                       "float32")[0],
            "library_ms": timer.ms(_sdpa(F, q, k, v, causal)),
            "cuda_cores_ms": sum(turns["library_ms"]) / 2,
            "cuda_cores_max_abs_err": cores_err,
            "cuda_cores_norm_rel_err": cores_rel,
            "in_turns_vs_cuda_cores": {
                "kind_ms": turns["kernel_ms"],
                "cuda_cores_ms": turns["library_ms"],
                "kind_over_cuda_cores": turns["kernel_over_library"]},
            "build": {k_: built.get(_fwd_kernel_name(k_, d))
                      for k_ in (kind, "cuda_cores")}}


def _f32_bwd_row(torch, F, timer, randn, shape, causal, checks, built):
    """One timed f32 backward: the kind the dispatch picks against the
    plain version, two calls bitwise equal, each launch's device ms, the
    CUDA-core kernels on the same operands (held to the same limits and
    timed in turns beside it), SDPA's f32 backward (autograd), the bound
    at 3xTF32 and by bytes with the f32 units' beside it."""
    from repro_torch.roofline import kernel_work
    from repro_torch.kernels.flash_attention import (
        bwd_kernel, flash_attention_bwd, flash_attention_bwd_plain)
    ops, err, rel, bitwise = _flash_bwd_case(
        torch, F, randn, shape, "float32", causal, checks, repeat=True)
    b, h, kh, s_, d = shape
    q, k, v, o, lse, do = ops
    kind = bwd_kernel(d, torch.float32)
    tag = f"flash_attention_bwd_cuda_cores/float32/" \
          f"{'x'.join(map(str, shape))}/{'causal' if causal else 'full'}"

    def run():
        return flash_attention_bwd(*ops, causal=causal)

    want = flash_attention_bwd_plain(*ops, causal=causal)
    cores = _mma_sync_bwd(torch, *ops, causal,
                          entry="flash_attention_bwd_f32")
    got = cores()
    cores_err = _check(tag, got, want, FLASH_TOL["float32"], checks)
    cores_rel = _check_norm_rel(torch, F, tag, zip(("dq", "dk", "dv"), got,
                                                   want),
                                want[2], "float32", checks)
    del got, want
    turns = _in_turns(timer, run, cores)
    flops, nbytes = kernel_work.flash_bwd_work(b, h, kh, s_, d, "float32",
                                               causal)
    bound, by = kernel_work.bound_ms(flops, nbytes, "tf32x3")
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lo = _sdpa(F, lq, lk, lv, causal)()
    row = {"shape": list(shape), "dtype": "float32", "causal": causal,
           "kernels": kind, "max_abs_err": err, "norm_rel_err": rel,
           "norm_rel_tol": FLASH_REL_TOL["float32"],
           "bitwise_repeat": bitwise, "flops": flops, "bytes": nbytes,
           "ms": timer.ms(run), "device_ms": timer.device_ms(run,
                                                             "flash_bwd_"),
           "device_ms_by_kernel": {k_: timer.device_ms(run, k_)
                                   for k_ in FLASH_BWD_LAUNCHES[kind]},
           "plain_ms": timer.ms(lambda: flash_attention_bwd_plain(
               *ops, causal=causal), iters=5),
           "bound_ms": bound, "bound_by": by,
           "bound_cuda_core_ms": kernel_work.bound_ms(flops, nbytes,
                                                      "float32")[0],
           "library_ms": timer.ms(lambda: torch.autograd.grad(
               lo, (lq, lk, lv), do, retain_graph=True)),
           "cuda_cores_ms": sum(turns["library_ms"]) / 2,
           "cuda_cores_max_abs_err": cores_err,
           "cuda_cores_norm_rel_err": cores_rel,
           "in_turns_vs_cuda_cores": {
               "kind_ms": turns["kernel_ms"],
               "cuda_cores_ms": turns["library_ms"],
               "kind_over_cuda_cores": turns["kernel_over_library"]},
           "build": {k_: {n: built.get(n) for n in _bwd_kernel_names(k_, d)}
                     for k_ in (kind, "cuda_cores")}}
    del lo, lq, lk, lv
    return row


def _flash_f32_rows(torch, F, timer, checks, timed=True,
                    ways=("forward", "backward")):
    """The f32 flash kernels of ``ways`` at ``FLASH_F32_EDGES`` (the
    forward with the lse, the backward, against the plain versions), then
    with ``timed`` at ``FLASH_F32_FWD`` and ``FLASH_F32_TRAIN``
    (``_f32_fwd_row``, ``_f32_bwd_row``): the rows ``flash_attention_f32``
    and ``flash_attention_bwd_f32``. Inputs from a generator of their own
    (seed 31), the backward's from another (seed 37)."""
    fwd_on, bwd_on = "forward" in ways, "backward" in ways
    randn, randn_b = _randn_from(torch, 31), _randn_from(torch, 37)
    for shape, causal in FLASH_F32_EDGES:
        if fwd_on:
            _flash_fwd_case(torch, F, randn, shape, "float32", causal,
                            checks, with_lse=True)
        if bwd_on:
            _flash_bwd_case(torch, F, randn_b, shape, "float32", causal,
                            checks)
    if not timed:
        return {}
    built = _flash_build_info("flash_")
    fwd, bwd = {}, {}
    for (shape, causal), key in FLASH_F32_FWD.items() if fwd_on else ():
        fwd[key] = _f32_fwd_row(torch, F, timer, randn, shape, causal, False,
                                checks, built)
    for (shape, causal), key in FLASH_F32_TRAIN.items():
        if fwd_on:
            fwd[f"train_{key or 'minitron'}"] = _f32_fwd_row(
                torch, F, timer, randn, shape, causal, True, checks, built)
        if bwd_on:
            bwd[key] = _f32_bwd_row(torch, F, timer, randn_b, shape, causal,
                                    checks, built)
    source = "src/repro_torch/kernels/csrc/flash_attention.cu"
    rows = {}
    if fwd_on:
        rows["flash_attention_f32"] = {
            "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/flash_attention.py:147 "
                        "(_attn_kernel, :66-120), f32 calls",
            **fwd.pop(None), "shapes": fwd}
    if bwd_on:
        rows["flash_attention_bwd_f32"] = {
            "route": "cuda", "source": source,
            "replaces": "src/repro/models/layers.py:151 (_flash_bwd, jnp; "
                        "no TPU kernel), f32 calls",
            **bwd.pop(None), "shapes": bwd}
    return rows


def _randn_from(torch, seed):
    """``randn(*shape, dtype=...)`` on the card from a generator of its
    own, seeded ``seed``, which is ``randn.gen``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    randn.gen = gen
    return randn


def _ops_cases(torch, randn):
    """The ops residual_scale, softmax and ssd_gate at their stated
    shapes: per op its first case, the others by name, each ``(args,
    scalars, library call or None)``. ssd_gate has no library call
    (softplus, then exp, is two)."""
    bf = torch.bfloat16
    x, y = randn(2048, 3072, dtype=bf), randn(2048, 3072, dtype=bf)
    xl, yl = randn(8192, 4096), randn(8192, 4096)
    scores = randn(49152, 512) * 4
    a_log = torch.log(torch.arange(1, 65, device="cuda",
                                   dtype=torch.float32))
    dt_s, dt_t = randn(4, 512, 64), randn(2, 4096, 64)
    return [
        ("residual_scale",
         ((x, y), {"alpha": 0.5}, lambda: torch.add(x, y, alpha=0.5)),
         {"f32_32M": ((xl, yl), {"alpha": 0.5},
                      lambda: torch.add(xl, yl, alpha=0.5))}),
        ("softmax", ((scores,), {}, lambda: torch.softmax(scores, -1)), {}),
        ("ssd_gate", ((dt_s, a_log), {"bias": 0.1}, None),
         {"train": ((dt_t, a_log), {"bias": 0.1}, None)})]


def phase_kernels(torch, timer):
    """Every kernel against its plain version on the card."""
    from repro_torch.roofline import kernel_work
    import torch.nn.functional as F
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

    checks, rows = [], {}
    randn = _randn_from(torch, 0)
    g = randn.gen
    # whisper's and dbrx's training shapes draw from a generator of their
    # own, so that every other case keeps the inputs it had before they
    # were added (the SSD backward's f32 check is marginal in da_log on
    # other draws: PERF.md §7)
    randn_t = _randn_from(torch, 23)

    # all 13 generated tile kernels, sync and pipelined, at a small,
    # ragged shape (37 x 200)
    scal = TILE_SCALARS

    def tile_inputs(name, rows_, d, dt):
        xs = []
        for a in PROGRAMS[name]().arrays.values():
            if a.role == "out":
                continue
            x = randn(d, dtype=dt) if a.shape == (1, 128) \
                else randn(rows_, d, dtype=dt)
            xs.append(x.abs() * 0.01 if a.name == "v" else x)
        return xs, {s: scal[s] for s in PROGRAMS[name]().scalars}

    for name in sorted(PROGRAMS):
        for emitter in (None, PIPELINED):
            op = get_tile_op(name, emitter=emitter)
            tag = name if emitter is None else f"{name}@{emitter}"
            for dt in (torch.float32, torch.bfloat16):
                xs, sc = tile_inputs(name, 37, 200, dt)
                _check(f"{tag}/{str(dt)[6:]}/37x200", op.apply(*xs, **sc),
                       op.torch_ref(*xs, **sc), TILE_TOL[str(dt)[6:]],
                       checks)

    # the main paths' shapes: B=4 requests x S=512 tokens of minitron-4b
    # (rmsnorm, rotary, swiglu), of mamba2-1.3b (rmsnorm_gated) and of
    # whisper-small (layernorm: f32 rows of 768; gelu: bf16 rows of 3072)
    B, S, D, H, KH, F_ = 4, 512, 3072, 24, 8, 9216
    DI = 4096
    x, gain = randn(B * S, D), randn(D)
    q, kk = randn(B, H, S, 128, dtype=torch.bfloat16), \
        randn(B, KH, S, 128, dtype=torch.bfloat16)
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    inv = 1.0 / (10_000.0 ** (torch.arange(0, 128, 2, device="cuda")
                              / 128.0))
    ang = pos[:, None] * inv
    ang = torch.cat([ang, ang], -1)[None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a_, b_ = randn(B * S, F_, dtype=torch.bfloat16), \
        randn(B * S, F_, dtype=torch.bfloat16)
    yg, zg, gg = randn(B * S, DI, dtype=torch.bfloat16), \
        randn(B * S, DI, dtype=torch.bfloat16), randn(DI, dtype=torch.bfloat16)

    def tile_row(tag, op, args, sc, lib, replaces=None):
        want = op.torch_ref(*(a.expand(args[0].shape) for a in args), **sc)
        err = _check(f"{tag}/path", op.apply(*args, **sc), want,
                     TILE_TOL[str(args[0].dtype)[6:]], checks)
        bound, by = kernel_work.tile_bound(op, args)
        dst = torch.empty_like(args[0])
        row = {
            "shape": [list(a.shape) for a in args],
            "dtype": str(args[0].dtype)[6:], "max_abs_err": err,
            # the launch: rows and column pieces a program (or the flat
            # plan's block of elements), grid, warps
            "plan": _plan_dict(_tile_plan(op, args)),
            "ms": timer.ms(lambda: op.apply(*args, **sc)),
            # the profiler's duration of the kernel itself
            "device_ms": timer.device_ms(lambda: op.apply(*args, **sc),
                                         op.tk.kernel_name),
            "plain_ms": timer.ms(lambda: op.torch_ref(
                *(a.expand(args[0].shape) for a in args), **sc)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.ms(lib) if lib is not None else None,
            # a yardstick, not the same function: Tensor.copy_ of the
            # lead (its bytes read and written once, no other operand)
            "copy_ms": timer.ms(lambda: dst.copy_(args[0])),
            "compiled": _compiled_info(op, args, sc)}
        if replaces is None:
            return row
        return {"route": "triton",
                "source": "src/repro_torch/core/tritongen.py",
                "replaces": replaces, **row}

    # dbrx-132b's router logits at its prefill: 32 groups of 64 tokens
    # (4 x 512) over 16 experts, f32
    logits = randn(32, 64, 16)
    xl, gl, bl = randn(B * S, 768), randn(768), randn(768)
    ag = randn(B * S, 3072, dtype=torch.bfloat16)
    cases = {
        "rmsnorm": ((x, gain), {"eps": 1e-6},
                    lambda: F.rms_norm(x, (D,), gain, 1e-6)),
        "rotary": ((q, cos, sin), {}, None),
        "swiglu": ((a_, b_), {}, None),
        "rmsnorm_gated": ((yg, zg, gg), {"eps": 1e-6}, None),
        "moe_router": ((logits,), {}, lambda: torch.softmax(logits, -1)),
        "layernorm": ((xl, gl, bl), {"eps": 1e-6},
                      lambda: F.layer_norm(xl, (768,), gl, bl, 1e-6)),
        "gelu": ((ag,), {}, lambda: F.gelu(ag, approximate="tanh")),
    }
    # the other shapes of the path's tile kernels: rotary's k in
    # prefill and its 510-token prompt (positions ragged against the
    # block), and every kernel's decode tick (batch 4, one token; rotary
    # with one broadcast cos/sin row), in the model's bf16; each with its
    # library call where there is one
    bf = torch.bfloat16
    cos1, sin1 = cos[:, :, 7:8].contiguous(), sin[:, :, 7:8].contiguous()
    xd, gd = randn(B, D, dtype=bf), randn(D, dtype=bf)
    # zamba2-2.7b (d_model 2560, d_inner 5120, d_ff 10240, 32 heads of
    # head_dim 80) and dbrx-132b (d_model 6144, 48/8 heads of 128; the
    # experts' swiglu on (E, G*C, d_ff): 16 experts x 32 groups x capacity
    # 20 in prefill, 4 groups x capacity 1 at a decode tick)
    cos80, sin80 = cos[..., :80].contiguous(), sin[..., :80].contiguous()
    xz, gz = randn(B * S, 2560), randn(2560)
    xb, gb = randn(B * S, 6144), randn(6144)
    ex_a, ex_b = randn(16, 640, 10752, dtype=bf), randn(16, 640, 10752,
                                                         dtype=bf)
    logits_d = randn(4, 1, 16)      # the router at a decode tick
    # arctic-480b's router: 128 experts, 32 groups of 64 tokens in prefill,
    # 4 groups of one token at a tick
    logits_a, logits_ad = randn(32, 64, 128), randn(4, 1, 128)
    # the last four configs' widths: rmsnorm at d_model 4096 (granite),
    # 5120 (nemo), 7168 (arctic: three powers of two, one masked block) and
    # 12288 (mistral-large: two pieces), f32 as norm_apply runs it; swiglu
    # at d_ff 14336, 28672 and arctic's 4864 (its residual MLP, and its
    # experts on (E, G*C, d_ff): 128 experts x 32 groups x capacity 2)
    wide = {name: (randn(B * S, d), randn(d)) for name, d in (
        ("granite", 4096), ("nemo", 5120), ("arctic", 7168),
        ("mistral_large", 12288))}
    # qwen2-vl-2b's M-RoPE with vision positions: one f32 cos/sin table
    # per batch row, (4, 1, 512, 128), against bf16 q (12 heads) and k (2)
    from repro_torch.models.common import mrope_cos_sin
    vcos, vsin = (t[:, None].contiguous() for t in mrope_cos_sin(
        torch.from_numpy(vision_positions(S, VISION_GRIDS)).cuda(), 128,
        1e6, (16, 24, 24)))
    # qwen2-vl-2b's rmsnorm (f32, as norm_apply runs it) and swiglu (bf16;
    # 8960 ends on a ragged column block) in prefill and at a decode tick
    xq, gq, xqd = randn(B * S, 1536), randn(1536), randn(B, 1536)
    # whisper-small's decode tick: 4 rows
    xld, gld, bld = randn(B, 768), randn(768), randn(768)
    agd = randn(B, 3072, dtype=bf)
    # the training path's shapes (minitron-4b, B 2 x S 4096): rmsnorm on
    # f32 (B, S, 3072) as norm_apply runs it, swiglu on bf16 (B, S, 9216),
    # rotary on bf16 q and k against one (1, 1, S, 128) f32 table, and
    # rotary's backward: the same kernel on a bf16 gradient with -sin
    TB, TS = TRAIN["batch"], TRAIN["seq"]
    angt = torch.arange(TS, device="cuda", dtype=torch.float32)[:, None] \
        * inv
    angt = torch.cat([angt, angt], -1)[None, None]
    cost, sint = torch.cos(angt), torch.sin(angt)
    xt = randn(TB, TS, D)
    # mamba2-1.3b's and zamba2-2.7b's training (B 2 x S 4096): rmsnorm on
    # f32 (B, S, 2048) and (B, S, 2560); zamba2's shared block: swiglu on
    # bf16 (B, S, 10240), rotary on bf16 q and k of 32 heads at head_dim 80
    # against one (1, 1, S, 80) f32 table, +sin forward, -sin backward
    inv80 = 1.0 / (10_000.0 ** (torch.arange(0, 80, 2, device="cuda")
                                / 80.0))
    ang80 = torch.arange(TS, device="cuda", dtype=torch.float32)[:, None] \
        * inv80
    ang80 = torch.cat([ang80, ang80], -1)[None, None]
    cost80, sint80 = torch.cos(ang80), torch.sin(ang80)
    xtm, gm = randn(TB, TS, 2048), randn(2048)
    xtz = randn(TB, TS, 2560)
    # whisper-small's training (B 2 x S 4096): layernorm on f32 (B, S,
    # 768), gelu on bf16 (B, S, 3072); dbrx-132b's: the router softmax on
    # f32 (32 groups, 256 tokens, 16 experts) and the experts' swiglu on
    # bf16 (E, G*C, d_ff): 16 experts x 32 groups x capacity 80
    xtw, gtw, btw = randn_t(TB, TS, 768), randn_t(768), randn_t(768)
    atw = randn_t(TB, TS, 3072, dtype=bf)
    logits_t = randn_t(32, TS * TB // 32, 16)
    other_shapes = {
        "rotary": {
            "k": ((kk, cos, sin), {}, None),
            "q_510": ((randn(B, H, S - 2, 128, dtype=bf),
                       cos[:, :, :S - 2].contiguous(),
                       sin[:, :, :S - 2].contiguous()), {}, None),
            "decode_q": ((randn(B, H, 1, 128, dtype=bf), cos1, sin1), {},
                         None),
            "decode_k": ((randn(B, KH, 1, 128, dtype=bf), cos1, sin1), {},
                         None),
            "zamba2_q": ((randn(B, 32, S, 80, dtype=bf), cos80, sin80), {},
                         None),
            "zamba2_decode_q": ((randn(B, 32, 1, 80, dtype=bf),
                                 cos80[:, :, 7:8].contiguous(),
                                 sin80[:, :, 7:8].contiguous()), {}, None),
            "dbrx_q": ((randn(B, 48, S, 128, dtype=bf), cos, sin), {},
                       None),
            "qwen2vl_q_per_batch": ((randn(B, 12, S, 128, dtype=bf), vcos,
                                     vsin), {}, None),
            "qwen2vl_k_per_batch": ((randn(B, 2, S, 128, dtype=bf), vcos,
                                     vsin), {}, None),
            "train_q": ((randn(TB, H, TS, 128, dtype=bf), cost, sint), {},
                        None),
            "train_k": ((randn(TB, KH, TS, 128, dtype=bf), cost, sint), {},
                        None),
            "train_q_backward": ((randn(TB, H, TS, 128, dtype=bf), cost,
                                  -sint), {}, None),
            "train_k_backward": ((randn(TB, KH, TS, 128, dtype=bf), cost,
                                  -sint), {}, None),
            "zamba2_train_q": ((randn(TB, 32, TS, 80, dtype=bf), cost80,
                                sint80), {}, None),
            "zamba2_train_q_backward": ((randn(TB, 32, TS, 80, dtype=bf),
                                         cost80, -sint80), {}, None)},
        "rmsnorm": {"decode": ((xd, gd), {"eps": 1e-6},
                               lambda: F.rms_norm(xd, (D,), gd, 1e-6)),
                    "zamba2": ((xz, gz), {"eps": 1e-6},
                               lambda: F.rms_norm(xz, (2560,), gz, 1e-6)),
                    "dbrx": ((xb, gb), {"eps": 1e-6},
                             lambda: F.rms_norm(xb, (6144,), gb, 1e-6)),
                    "qwen2vl": ((xq, gq), {"eps": 1e-6},
                                lambda: F.rms_norm(xq, (1536,), gq, 1e-6)),
                    "qwen2vl_decode": ((xqd, gq), {"eps": 1e-6},
                                       lambda: F.rms_norm(xqd, (1536,), gq,
                                                          1e-6)),
                    "train": ((xt, gain), {"eps": 1e-6},
                              lambda: F.rms_norm(xt, (D,), gain, 1e-6)),
                    "train_mamba2": ((xtm, gm), {"eps": 1e-6},
                                     lambda: F.rms_norm(xtm, (2048,), gm,
                                                        1e-6)),
                    "train_zamba2": ((xtz, gz), {"eps": 1e-6},
                                     lambda: F.rms_norm(xtz, (2560,), gz,
                                                        1e-6)),
                    **{name: ((xw, gw), {"eps": 1e-6},
                              functools.partial(F.rms_norm, xw, gw.shape,
                                                gw, 1e-6))
                       for name, (xw, gw) in wide.items()}},
        "swiglu": {"decode": ((randn(B, F_, dtype=bf), randn(B, F_, dtype=bf)),
                              {}, None),
                   "zamba2": ((randn(B * S, 10240, dtype=bf),
                               randn(B * S, 10240, dtype=bf)), {}, None),
                   "dbrx_experts": ((ex_a, ex_b), {}, None),
                   "dbrx_experts_decode": ((randn(16, 4, 10752, dtype=bf),
                                            randn(16, 4, 10752, dtype=bf)),
                                           {}, None),
                   "qwen2vl": ((randn(B * S, 8960, dtype=bf),
                                randn(B * S, 8960, dtype=bf)), {}, None),
                   "qwen2vl_decode": ((randn(B, 8960, dtype=bf),
                                       randn(B, 8960, dtype=bf)), {}, None),
                   "train": ((randn(TB, TS, F_, dtype=bf),
                              randn(TB, TS, F_, dtype=bf)), {}, None),
                   "train_zamba2": ((randn(TB, TS, 10240, dtype=bf),
                                     randn(TB, TS, 10240, dtype=bf)), {},
                                    None),
                   "train_dbrx_experts": ((randn_t(16, 2560, 10752, dtype=bf),
                                           randn_t(16, 2560, 10752,
                                                   dtype=bf)), {}, None),
                   **{name: ((randn(*lead, f, dtype=bf),
                              randn(*lead, f, dtype=bf)), {}, None)
                      for name, lead, f in (
                          ("granite", (B * S,), 14336),
                          ("mistral_large", (B * S,), 28672),
                          ("arctic_residual", (B * S,), 4864),
                          ("arctic_experts", (128, 64), 4864))}},
        "rmsnorm_gated": {"decode": ((randn(B, DI, dtype=bf),
                                      randn(B, DI, dtype=bf),
                                      randn(DI, dtype=bf)), {"eps": 1e-6},
                                     None),
                          "zamba2": ((randn(B * S, 5120, dtype=bf),
                                      randn(B * S, 5120, dtype=bf),
                                      randn(5120, dtype=bf)), {"eps": 1e-6},
                                     None),
                          # the train paths' (B 2 x S 4096 rows)
                          **{name: ((randn(TB * TS, di, dtype=bf),
                                     randn(TB * TS, di, dtype=bf),
                                     randn(di, dtype=bf)), {"eps": 1e-6},
                                    None)
                             for name, di in (("train_mamba2", 4096),
                                              ("train_zamba2", 5120))}},
        "moe_router": {"decode": ((logits_d,), {},
                                  lambda: torch.softmax(logits_d, -1)),
                       "arctic": ((logits_a,), {},
                                  lambda: torch.softmax(logits_a, -1)),
                       "arctic_decode": ((logits_ad,), {},
                                         lambda: torch.softmax(logits_ad,
                                                               -1)),
                       "train_dbrx": ((logits_t,), {},
                                      lambda: torch.softmax(logits_t, -1))},
        "layernorm": {"decode": ((xld, gld, bld), {"eps": 1e-6},
                                 lambda: F.layer_norm(xld, (768,), gld, bld,
                                                      1e-6)),
                      "train_whisper": ((xtw, gtw, btw), {"eps": 1e-6},
                                        lambda: F.layer_norm(xtw, (768,), gtw,
                                                             btw, 1e-6))},
        "gelu": {"decode": ((agd,), {},
                            lambda: F.gelu(agd, approximate="tanh")),
                 "train_whisper": ((atw,), {},
                                   lambda: F.gelu(atw, approximate="tanh"))}}
    for emitter, replaces in ((None, "src/repro/core/pallasgen.py:554"),
                              (PIPELINED, "src/repro/core/pallasgen.py:546")):
        for name, (args, sc, lib) in cases.items():
            if emitter == PIPELINED and name not in PIPELINED_OPS:
                continue
            tag = name if emitter is None else f"{name}@{emitter}"
            op = get_tile_op(name, emitter=emitter)
            rows[tag] = tile_row(tag, op, args, sc, lib, replaces)
            rows[tag]["shapes"] = {
                shape: tile_row(f"{tag}/{shape}", op, sargs, ssc, slib)
                for shape, (sargs, ssc, slib)
                in other_shapes[name].items()}

    # the ops residual_scale, softmax and ssd_gate (ops.residual_scale,
    # ops.softmax, ops.ssd_gate; on no model's path, driven by the ops
    # phase): residual_scale on bf16 (2048, 3072) and the calibration
    # lane's f32 (8192, 4096); softmax on the f32 score rows of a 4 x
    # 24-head x 512 prefill; ssd_gate on mamba2's f32 dt (serve (4, 512,
    # 64), train (2, 4096, 64)) against a_log (64,), a broadcast row. They
    # draw from a generator of their own, as whisper's and dbrx's shapes
    # do, so that every other case keeps its inputs
    for name, (args, sc, lib), shapes in _ops_cases(
            torch, _randn_from(torch, OPS_SEED)):
        op = get_tile_op(name)
        rows[name] = tile_row(name, op, args, sc, lib,
                              "src/repro/core/pallasgen.py:554")
        rows[name]["shapes"] = {
            shape: tile_row(f"{name}/{shape}", op, sargs, ssc, slib)
            for shape, (sargs, ssc, slib) in shapes.items()}

    # gelu against its library call in turns at whisper's prefill shape
    # (a gap of a few per cent between separate timings)
    gelu_op = get_tile_op("gelu")
    rows["gelu"]["in_turns"] = _in_turns(
        timer, lambda: gelu_op.apply(ag),
        lambda: F.gelu(ag, approximate="tanh"))
    on_a_path = set(cases)
    del cases, other_shapes, ex_a, ex_b
    torch.cuda.empty_cache()

    # the optimizer's tile kernels on the training path (f32, as
    # apply_updates runs them): a chunk of minitron's embedding, which the
    # update walks in leading-axis chunks (optim.adamw.update_chunks), and
    # an MLP weight (3072, 9216); l2_clip's library call is the same
    # function (a multiply by the host scale); adamw has none (torch's
    # fused AdamW decays before the moment step, another function: its
    # time stands beside as the nearest call)
    opt_shapes = (_update_chunk_shape(torch, (256000, 3072)), (3072, 9216))
    for name, replaces in (("adamw", "src/repro/core/pallasgen.py:554"),
                           ("l2_clip", "src/repro/core/pallasgen.py:554")):
        rows[name] = None
        for shape in opt_shapes:
            row = _optimizer_row(torch, timer, name, shape, checks)
            if rows[name] is None:
                rows[name] = {"route": "triton",
                              "source": "src/repro_torch/core/tritongen.py",
                              "replaces": replaces, **row, "shapes": {}}
            else:
                rows[name]["shapes"]["x".join(map(str, shape))] = row
            torch.cuda.empty_cache()
    # l2_clip of the bf16 gradients that training's autograd returns, into
    # f32, at the same two shapes
    for shape in opt_shapes:
        rows["l2_clip"]["shapes"]["bf16_to_f32_" + "x".join(
            map(str, shape))] = _l2_clip_bf16_row(torch, timer, shape,
                                                  checks)
        torch.cuda.empty_cache()

    # the tile programs on no path yet: kernel, plain and library times
    # beside the bound at one stated shape, f32 (2048, 4096)
    libs = {
        "layernorm": lambda xs, sc: F.layer_norm(
            xs[0], (xs[0].shape[-1],), xs[1], xs[2], sc["eps"]),
        "gelu": lambda xs, sc: F.gelu(xs[0], approximate="tanh"),
        "softmax": lambda xs, sc: torch.softmax(xs[0], -1),
        "moe_router": lambda xs, sc: torch.softmax(xs[0], -1),
        "residual_scale": lambda xs, sc: torch.add(xs[0], xs[1],
                                                   alpha=sc["alpha"]),
    }
    others = {}
    for name in sorted(set(PROGRAMS) - on_a_path - set(rows)):
        op = get_tile_op(name)
        xs, sc = tile_inputs(name, 2048, 4096, torch.float32)
        bound, by = kernel_work.tile_bound(op, xs)
        lib = libs.get(name)
        others[name] = {
            "shape": [list(a.shape) for a in xs], "dtype": "float32",
            "ms": timer.ms(lambda: op.apply(*xs, **sc)),
            "plain_ms": timer.ms(lambda: op.torch_ref(
                *(a.expand(xs[0].shape) for a in xs), **sc)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.ms(lambda: lib(xs, sc))
            if lib is not None else None}

    rows["flash_attention"] = _flash_fwd_rows(torch, F, timer, randn,
                                              randn_t, checks)
    rows["flash_attention_bwd"] = _flash_bwd_rows(torch, F, timer, randn,
                                                  randn_t, checks)
    torch.cuda.empty_cache()
    rows.update(_flash_f32_rows(torch, F, timer, checks))
    torch.cuda.empty_cache()
    rows["ssd_scan_bwd"] = _ssd_bwd_rows(torch, F, timer, g, checks)
    torch.cuda.empty_cache()

    rows["ssd_scan"] = _ssd_fwd_rows(torch, timer, randn, checks)
    # what one launch costs under this timer, whatever its bytes: a
    # one-element copy
    one = torch.zeros(1, device="cuda")
    floor = timer.ms(lambda: one.copy_(x[0, :1]))
    emit({"phase": "kernels", "checks": checks, "timings": rows,
          "other_programs": others, "timer_floor_ms": floor,
          "profiler": timer.profiler})
    bad = [c["name"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return rows


def phase_ops(torch):
    """The ops residual_scale, softmax and ssd_gate through their entry
    points (``repro_torch.kernels.ops``) at the kernels phase's shapes,
    each result against the op's plain version (``ops.set_impl("torch")``),
    then one gradient through each op's autograd Function (the kernel
    forward, the analytic backward) in f32 against autograd of the oracle
    (``set_impl("ref")``). Each op's count is zeroed just before and read
    just after: one launch a call, none in a backward. Returns the
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_programs import get_tile_op
    cases = _ops_cases(torch, _randn_from(torch, OPS_SEED))
    counters = {name: get_tile_op(name) for name, _, _ in cases}
    for c in counters.values():
        c.launches = 0
    checks, calls = [], dict.fromkeys(counters, 0)
    gen = torch.Generator(device="cuda").manual_seed(OPS_SEED + 1)
    for name, first, shapes in cases:
        fn = getattr(ops, name)
        for tag, (args, sc, _) in {"first": first, **shapes}.items():
            got = fn(*args, **sc)
            calls[name] += 1
            ops.set_impl("torch")
            try:
                want = fn(*args, **sc)
            finally:
                ops.set_impl(None)
            _check(f"ops.{name}/{tag}", got, want,
                   TILE_TOL[str(args[0].dtype)[6:]], checks)
        args, sc, _ = first
        grads = []
        for impl in (None, "ref"):
            leaves = [a.detach().float().requires_grad_() for a in args]
            ops.set_impl(impl)
            try:
                outs = fn(*leaves, **sc)
            finally:
                ops.set_impl(None)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if impl is None:
                calls[name] += 1
                cot = [torch.randn(o.shape, generator=gen, device="cuda")
                       for o in outs]
            torch.autograd.backward(list(outs), cot)
            grads.append(tuple(a.grad for a in leaves))
        _check(f"ops.{name}/grad", grads[0], grads[1], TILE_TOL["float32"],
               checks)
    launches = {n: c.launches for n, c in counters.items()}
    ok = launches == calls and all(c["ok"] for c in checks)
    emit({"phase": "ops", "checks": checks, "launches": launches,
          "calls": calls, "ok": ok})
    if not ok:
        raise AssertionError(f"ops: launches {launches} for calls {calls}, "
                             f"checks {[c for c in checks if not c['ok']]}")
    return launches


def _sdpa(F, q, k, v, causal=True):
    """PyTorch's fused attention on the same inputs (the yardstick; the
    port never calls it)."""
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:   # a torch without enable_gqa: repeat kv beforehand
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)


def _counters(arch):
    """The launch counters of one path's kernels."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.tile_programs import get_tile_op
    dense = ("rmsnorm", "rotary", "swiglu", "flash_attention")
    ssm = ("ssd_scan", "rmsnorm_gated", "rmsnorm")
    names = {"minitron-4b": dense, "granite-8b": dense,
             "mistral-nemo-12b": dense, "mistral-large-123b": dense,
             "qwen2-vl-2b": dense, "mamba2-1.3b": ssm,
             "zamba2-2.7b": ssm + dense[1:],
             "dbrx-132b": dense + ("moe_router",),
             "arctic-480b": dense + ("moe_router",),
             "whisper-small": ("layernorm", "gelu", "flash_attention")}[arch]
    structured = {"flash_attention": flash_attention, "ssd_scan": ssd_scan}
    return {n: structured[n] if n in structured else get_tile_op(n)
            for n in names}


def phase_serve(torch, serve, phase, cfg=None, reduced=None):
    """Serve the ``SERVE`` traffic at full width; ``cfg`` serves a given
    config in place of the arch's (a cut depth, listed in ``reduced``)."""
    import numpy as np
    from repro_torch.core.telemetry import reset_telemetry
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.common import tree_bytes

    t0 = time.perf_counter()
    srv = Server(serve["arch"], smoke=False, max_batch=serve["max_batch"],
                 seed=serve["seed"], cfg=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill_ms, decode_ms = [], []
    prefill, decode = srv._prefill_batch, srv._decode
    counters = _counters(serve["arch"])
    # each kernel's launches, split by the step that made them
    by_step = {"prefill": dict.fromkeys(counters, 0),
               "decode": dict.fromkeys(counters, 0)}

    def timed(fn, out, step):
        def run(*a):
            before = {n: c.launches for n, c in counters.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            for n, c in counters.items():
                by_step[step][n] += c.launches - before[n]
            return r
        return run

    srv._prefill_batch = timed(prefill, prefill_ms, "prefill")
    srv._decode = timed(decode, decode_ms, "decode")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, srv.cfg.vocab, size=serve["prompt_len"] - (i % 3)).astype(np.int32),
        max_new=serve["max_new"]) for i in range(serve["requests"])]
    reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = srv.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    guard = srv.metrics["saturation"]["guard"]
    levels = {n: c.sk.ladder_level for n, c in counters.items()
              if hasattr(c, "sk")}
    ok_tokens = all(len(out[r.rid]) == serve["max_new"]
                    and all(0 <= t < srv.cfg.vocab for t in out[r.rid])
                    for r in reqs)
    emit({"phase": phase, "config": srv.cfg.name,
          **({"reduced": reduced} if reduced else {}),
          "n_layers": srv.cfg.n_layers, "params": srv.cfg.param_count(),
          "param_bytes": tree_bytes(srv.params), "init_s": init_s, **serve,
          "wall_s": wall, "prefill_ms": prefill_ms,
          "decode_ms_per_token": statistics.median(decode_ms),
          "prefills": srv.metrics["prefills"],
          "decode_ticks": srv.metrics["decode_ticks"],
          "tokens": srv.metrics["tokens"] + len(reqs),
          "tokens_per_s": (srv.metrics["tokens"] + len(reqs)) / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_by_step": by_step,
          "ladder_levels": levels,
          "runtime_fallbacks": sum(guard["runtime_fallbacks"].values()),
          "degradations": guard["degradations"],
          "first_tokens": {r.rid: out[r.rid][:8] for r in reqs}})
    if not ok_tokens:
        raise AssertionError("served tokens are missing or out of range")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if guard["runtime_fallbacks"] or guard["degradations"] or \
            set(levels.values()) != {"cold"}:
        raise AssertionError(f"fallbacks/degradations on the card: {guard}")
    return srv, reqs, launches, by_step


def _expect_steps(arch, srv, by_step, per_prefill, per_tick):
    """Each kernel's launches in a serve run, per step: ``per_prefill``
    in every prefill batch and ``per_tick`` in every decode tick."""
    want = {"prefill": {n: c * srv.metrics["prefills"]
                        for n, c in per_prefill.items()},
            "decode": {n: c * srv.metrics["decode_ticks"]
                       for n, c in per_tick.items()}}
    if by_step != want:
        raise AssertionError(f"{arch} launched {by_step}, expected {want}")


def _prefill_tokens(torch, serve, reqs):
    import numpy as np
    prompts = np.stack([r.prompt[:serve["prompt_len"] - 2]
                        for r in reqs[:serve["max_batch"]]])
    return torch.as_tensor(prompts, dtype=torch.int64, device="cuda")


def _timed_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_parity(torch, srv, tokens):
    from repro_torch.kernels import ops

    def prefill():
        return srv.model.prefill(srv.params, tokens)[0]

    kern, kern_ms = _timed_ms(torch, prefill)  # warm: serve built all
    ops.set_impl("torch")
    try:
        plain, plain_ms = _timed_ms(torch, prefill)
    finally:
        ops.set_impl(None)
    err = _err(kern, plain)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    ok = err <= PARITY_TOL and bool(kern.isfinite().all())
    emit({"phase": "parity", "shape": list(tokens.shape),
          "prefill_ms": kern_ms, "plain_prefill_ms": plain_ms,
          "max_abs_logit_diff": err, "tol": PARITY_TOL,
          "logit_std": kern.float().std().item(), "argmax_agree": agree,
          "ok": ok})
    if not ok:
        raise AssertionError(f"kernel and plain prefill differ by {err}")
    return kern


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


# the 3xTF32 flash kernels' launches in the f32 parity phases (the
# kernels line's flash_attention_f32 and flash_attention_bwd_f32 rows)
F32_FLASH_LAUNCHES = {"flash_attention_f32": 0, "flash_attention_bwd_f32": 0}


def _f32_flash_reset():
    """Every flash kind's launch counts to 0, before a parity run."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches_by_kind = dict.fromkeys(fn.launches_by_kind, 0)


def _f32_flash_read(cfg, phase, backward=False):
    """The flash launches by kind since ``_f32_flash_reset``: an f32 model
    with attention at a head_dim of ``F32_WGMMA_HEAD_DIMS`` must have
    launched the wgmma_f32 kind, and no other, forward (and backward
    where asked); its launches join ``F32_FLASH_LAUNCHES``."""
    from repro_torch.kernels.flash_attention import (F32_WGMMA_HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_bwd)
    got = {"forward": dict(flash_attention.launches_by_kind),
           "backward": dict(flash_attention_bwd.launches_by_kind)}
    if cfg.n_heads and cfg.head_dim in F32_WGMMA_HEAD_DIMS:
        for way in ("forward", "backward")[:2 if backward else 1]:
            n = got[way]
            if n["wgmma_f32"] == 0 or sum(n.values()) != n["wgmma_f32"]:
                raise AssertionError(f"{phase}: the f32 flash {way} launched "
                                     f"{n}, expected the wgmma_f32 kind "
                                     f"only")
    F32_FLASH_LAUNCHES["flash_attention_f32"] += got["forward"]["wgmma_f32"]
    F32_FLASH_LAUNCHES["flash_attention_bwd_f32"] += \
        got["backward"]["wgmma_f32"]
    return got


def phase_parity_f32(torch, srv, tokens, phase, tol, n_layers=None,
                     prefill_arg=None, cfg=None):
    """A 4 x 510 prefill and two decode ticks of the served model with
    its weights in f32 (its first ``n_layers`` layers, where given),
    through the kernels, then through the plain versions with the same
    tokens; each decode starts from its own prefill's state, so the
    kernels' caches (the SSD scan's final state, the prefill's k/v, the
    encoder's cross-attention k/v) are checked, not only their outputs.
    ``prefill_arg`` is the prefill's third argument where the model takes
    one (vlm positions3, encdec frames). With ``srv`` None the served
    model's ``cfg`` is built afresh in f32 from the serve seed (where the
    f32 copy would not fit beside the bf16 server, which is freed
    first)."""
    from repro_torch.kernels import ops
    from repro_torch.models import get_model

    cfg = cfg or srv.cfg
    cut = n_layers or cfg.n_layers
    model = get_model(dataclasses.replace(cfg, dtype=torch.float32,
                                          n_layers=cut), device="cuda")
    params = model.init(SERVE["seed"]) if srv is None else \
        _f32({k: v[:cut] if k == "layers" else v
              for k, v in srv.params.items()})
    extra = () if prefill_arg is None else (prefill_arg,)
    feed = []

    def run():
        logits, cache = model.prefill(params, tokens, *extra)
        outs = [logits]
        for i in range(2):
            if len(feed) == i:
                feed.append(torch.argmax(outs[-1][:, -1], -1)[:, None])
            logits, cache = model.decode_step(params, cache, feed[i])
            outs.append(logits)
        return outs

    _f32_flash_reset()
    kern, kern_ms = _timed_ms(torch, run)
    flash = _f32_flash_read(cfg, phase)
    ops.set_impl("torch")
    try:
        plain, plain_ms = _timed_ms(torch, run)
    finally:
        ops.set_impl(None)
    del params, model
    errs = [_err(k, p) for k, p in zip(kern, plain, strict=True)]
    ok = max(errs) <= tol and all(bool(k.isfinite().all()) for k in kern)
    emit({"phase": phase, "shape": list(tokens.shape), "dtype": "float32",
          "n_layers": cut, "weights": "fresh f32, the serve seed"
          if srv is None else "the served weights in f32",
          "prefill_and_2_ticks_ms": kern_ms,
          "plain_prefill_and_2_ticks_ms": plain_ms,
          "flash_launches_by_kind": flash,
          "max_abs_logit_diff": {"prefill": errs[0], "tick1": errs[1],
                                 "tick2": errs[2]},
          "tol": tol,
          "logit_std": kern[0].float().std().item(),
          "argmax_agree": [(k.argmax(-1) == p.argmax(-1)).float().mean()
                           .item() for k, p in zip(kern, plain)],
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: kernel and plain logits differ by "
                             f"{errs}")


def phase_mrope(torch, srv, tokens, positions3, counters):
    """qwen2-vl's prefill at full width with per-batch vision positions:
    the rotary kernel reads one cos/sin table per batch row in place (the
    plan's ``bcycle`` layout), two launches per layer, and the logits
    agree with the plain path's on the same positions (bf16, as the
    served model; the tolerance of the dense parity phase). The plan
    kinds are those the prefill's rotary launches were made with."""
    from repro_torch.kernels import ops

    cfg = srv.cfg
    for c in counters.values():
        c.launches = 0
    counters["rotary"].launches_by_kinds.clear()
    kern, kern_ms = _timed_ms(torch, lambda: srv.model.prefill(
        srv.params, tokens, positions3)[0])
    launches = {n: c.launches for n, c in counters.items()}
    kinds = {",".join(k): n for k, n
             in counters["rotary"].launches_by_kinds.items()}
    ops.set_impl("torch")
    try:
        plain, plain_ms = _timed_ms(torch, lambda: srv.model.prefill(
            srv.params, tokens, positions3)[0])
        text = srv.model.prefill(srv.params, tokens)[0]
    finally:
        ops.set_impl(None)
    err = _err(kern, plain)
    want = {"rotary": 2 * cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1,
            "swiglu": cfg.n_layers, "flash_attention": cfg.n_layers}
    ok = (err <= PARITY_TOL and bool(kern.isfinite().all())
          and kinds == {"row,bcycle,bcycle": want["rotary"]}
          and launches == want)
    emit({"phase": "mrope_qwen2vl", "shape": list(tokens.shape),
          "grids": VISION_GRIDS, "rotary_launches_by_plan_kinds": kinds,
          "prefill_ms": kern_ms,
          "plain_prefill_ms": plain_ms, "launches": launches,
          "max_abs_logit_diff": err, "tol": PARITY_TOL,
          "logit_std": kern.float().std().item(),
          "argmax_agree": (kern.argmax(-1) == plain.argmax(-1)).float()
          .mean().item(),
          # the positions matter: against a text-position prefill
          "max_abs_diff_vs_text_positions": _err(plain, text), "ok": ok})
    if not ok:
        raise AssertionError(f"mrope_qwen2vl: plan {kinds}, launches "
                             f"{launches} (expected {want}), logits differ "
                             f"by {err}")


def phase_pipelined(torch, srv, tokens, sync_logits, names, phase):
    """The same prefill with the tile ops launching their persistent,
    pipelined kernels: the path of the pipelined emitter. Its logits
    equal the sync kernels' prefill up to the parity tolerance (the two
    run the same arithmetic in the same order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_programs import get_tile_op

    counters = {n: get_tile_op(n, emitter=PIPELINED) for n in names}
    ops.set_tile_emitter(PIPELINED)
    try:
        for c in counters.values():
            c.launches = 0
        logits, ms = _timed_ms(torch, lambda: srv.model.prefill(
            srv.params, tokens)[0])
        launches = {f"{n}@{PIPELINED}": c.launches
                    for n, c in counters.items()}
    finally:
        ops.set_tile_emitter(None)
    err = _err(logits, sync_logits)
    ok = err <= PARITY_TOL and all(launches.values())
    emit({"phase": phase, "shape": list(tokens.shape), "prefill_ms": ms,
          "launches": launches, "max_abs_logit_diff_vs_sync": err,
          "tol": PARITY_TOL, "ok": ok})
    if not ok:
        raise AssertionError(f"pipelined prefill: launches {launches}, "
                             f"logits differ from the sync kernels' by {err}")
    return launches


def _kernel_group(name: str) -> str:
    from repro_torch.kernels.tile_programs import PROGRAMS
    if "flash_fwd_" in name:            # flash_fwd_{bf16,f32}_kernel
        return "flash_attention"
    if "ssd_cb_kernel" in name or "ssd_scan_kernel" in name \
            or "ssd_fwd_" in name:     # either forward kind's launches
        return "ssd_scan"
    if any(name.startswith(f"{p}_kernel") for p in PROGRAMS):
        return "tile"
    if any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma",
                                        "cutlass")):
        return "matmul"
    return "other"


def phase_trace(torch, srv, tokens, phase):
    """Where the time goes: one warm prefill and three decode ticks under
    torch.profiler — device time by kernel group and the device's busy
    share of the host wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        groups, tiles, n_launch, top = {}, {}, 0, []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
            if g == "tile":
                tiles[e.key] = [us / 1e3, e.count]
            n_launch += e.count
            top.append((us / 1e3, e.count, g, e.key[:70]))
        busy = sum(groups.values())
        return out, {"wall_ms": wall_ms, "device_ms": busy,
                     "busy_share": busy / wall_ms, "device_launches": n_launch,
                     "device_ms_by_group": groups,
                     "tile_ms_and_launches": tiles,
                     "top_kernels": sorted(top, reverse=True)[:8]}

    (logits, cache), pre = profiled(
        lambda: srv.model.prefill(srv.params, tokens))
    tok = torch.argmax(logits[:, -1], -1)[:, None]

    def ticks():
        nonlocal tok
        c = cache
        for _ in range(3):
            out, c = srv.model.decode_step(srv.params, c, tok)
            tok = torch.argmax(out[:, -1], -1)[:, None]
        return c

    _, dec = profiled(ticks)
    emit({"phase": phase, "prefill": pre, "decode_3_ticks": dec})


def _train_counters():
    """The launch counters of the training paths' kernels."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.tile_programs import get_tile_op
    structured = {"flash_attention": flash_attention,
                  "flash_attention_bwd": flash_attention_bwd,
                  "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}
    return {n: structured.get(n) or get_tile_op(n) for n in TRAIN_KERNELS}


def _expected_train_launches(cfg, params):
    """Each kernel's launches in one train step, as the code implies:
    every layer runs its forward twice with ``cfg.remat`` (the step's
    forward and its recompute in the backward), the final norms once. An
    attention block (a dense or MoE layer, or an application of the
    hybrid's shared block after every ``shared_attn_every`` Mamba2 layers)
    launches 2 rmsnorm, 2 rotary (q, k), 1 flash forward and 1 swiglu (a
    MoE layer's experts, with 1 moe_router; arctic's residual MLP 1 swiglu
    more), and in the backward rotary once more for q and k (the same
    kernel with -sin) and the flash backward once. A Mamba2 layer launches
    1 rmsnorm, the SSD scan (with its chunk states) and rmsnorm_gated, and
    in the backward the SSD backward once. whisper's encoder layer
    launches 2 layernorm, 1 gelu and 1 flash (non-causal), its decoder
    layer 3 layernorm, 1 gelu and 2 flash (self causal, cross not), each
    flash one backward; the encoder's and the decoder's final norms are 2
    layernorm. The optimizer launches adamw on every leaf and l2_clip on
    the leaves of ndim >= 2 in the JAX package's stacked layout, once per
    leading-axis chunk of a leaf it updates in chunks."""
    from repro_torch import tree as T
    from repro_torch.models.common import reference_ndim
    from repro_torch.optim.adamw import update_chunks
    n = cfg.n_layers
    paths, leaves = T.flatten(params)
    fwd = 2 if cfg.remat else 1
    want = dict.fromkeys(TRAIN_KERNELS, 0)
    slices = [len(update_chunks(p)) for p in leaves]
    want.update(adamw=sum(slices),
                l2_clip=sum(k for pa, p, k in zip(paths, leaves, slices)
                            if reference_ndim(cfg, pa, p) >= 2))
    if cfg.family == "encdec":
        ne = cfg.n_enc_layers
        want.update(layernorm=fwd * (2 * ne + 3 * n) + 2,
                    gelu=fwd * (ne + n), flash_attention=fwd * (ne + 2 * n),
                    flash_attention_bwd=ne + 2 * n)
        return want
    attn = n
    if cfg.family in ("ssm", "hybrid"):
        want.update(rmsnorm=fwd * n, rmsnorm_gated=fwd * n, ssd_scan=fwd * n,
                    ssd_scan_bwd=n)
        attn = n // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    want["rmsnorm"] += fwd * 2 * attn + 1
    want.update(rotary=fwd * 2 * attn + 2 * attn, swiglu=fwd * attn,
                flash_attention=fwd * attn, flash_attention_bwd=attn)
    if cfg.family == "moe":
        want["moe_router"] = fwd * n
        if cfg.moe.residual_ffn_dim:
            want["swiglu"] += fwd * n
    return want


def _train_batch(cfg, pipe, i):
    """The pipeline's batch ``i`` as the trainer gives it to the step:
    with an encdec model, the frames of its tokens' shape
    (``launch.train.encdec_frames``) on the card; with a vlm, M-RoPE
    positions in which each row opens with an image of
    ``VISION_GRIDS``' grid of its index."""
    from repro_torch.launch.train import encdec_frames
    batch = pipe.batch_at(i)
    B, S = batch["tokens"].shape
    if cfg.family == "encdec":
        batch = {**batch, "frames": encdec_frames(cfg, B, S, "cuda")}
    if cfg.family == "vlm":
        batch = {**batch, "positions": vision_positions(
            S, VISION_GRIDS[:B])}
    return batch


def phase_train(torch, spec=TRAIN, phase="train"):
    """``spec``'s arch at full width and ``spec["layers"]`` layers (for
    minitron-4b 16 of its 32), bf16, seeded weights, remat on:
    ``spec["steps"]`` steps of B 2 x S 4096 from the ported pipeline,
    through the trainer's step function (``make_train_step``: the model's
    loss, its gradient, apply_updates at the default OptConfig with
    ``spec``'s moments, f32 unless named, and ``spec``'s gradient
    compression, none unless named). Each step's launches are read
    against what the code implies; returns the model, its parameters,
    moments and step, the next batch, the launches and the median
    ms/step from step 2.

    The loss must fall over the steps after its early peak, to the run's
    lowest at the last step, below the first step's. The peak is the
    first full-lr AdamW steps' overshoot: Adam's first step moves every
    element by about lr (m / sqrt(v) = +-1), and the phase reads the loss
    of step 1's own batch after that step to show it (it rises as much as
    the next batch's). The gradients' correctness is checked by the
    parity phases, not by this gate."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.telemetry import reset_telemetry, telemetry
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import batch_to_device, make_train_step
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_bytes
    from repro_torch.optim import OptConfig, init_opt_state

    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda")
    params = model.init(spec["seed"])
    steps = spec["steps"]
    ocfg = OptConfig(lr=spec.get("lr", OptConfig.lr),
                     warmup_steps=spec.get("warmup", max(steps // 10, 1)),
                     total_steps=steps,
                     moment_dtype=spec.get("moment_dtype", "f32"))
    state = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg,
                           compress=spec.get("compress", "none"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = ShardedTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=spec["seq"], global_batch=spec["batch"],
        seed=spec["seed"]))
    counters = _train_counters()
    want = _expected_train_launches(cfg, params)
    reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, ms, per_step = [], [], []
    for i in range(steps):
        before = {n: c.launches for n, c in counters.items()}
        batch = _train_batch(cfg, pipe, i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({n: c.launches - before[n]
                         for n, c in counters.items()})
        if i == 0:
            with torch.no_grad():
                same_batch = model.loss(params, batch_to_device(
                    batch, "cuda")).item()
    launches = {n: c.launches for n, c in counters.items()}
    guard = telemetry().snapshot()["guard"]
    step_ms = statistics.median(ms[1:])
    tokens = spec["batch"] * spec["seq"]
    peak = losses.index(max(losses))
    falls = (losses[-1] < losses[0] and losses[-1] == min(losses)
             and peak < steps // 2)
    ok = (all(math.isfinite(x) for x in losses) and falls
          and all(ps == want for ps in per_step)
          and not guard["runtime_fallbacks"] and not guard["degradations"])
    emit({"phase": phase, "config": cfg.name,
          **({"reduced": {"n_layers": [full.n_layers, cfg.n_layers]}}
             if cfg.n_layers != full.n_layers else {}),
          "dtype": "bfloat16", "remat": cfg.remat, "lr": ocfg.lr,
          "moment_dtype": ocfg.moment_dtype, **spec,
          "params": sum(p.numel() for p in T.leaves(params)),
          "param_bytes": tree_bytes(params), "init_s": init_s,
          "step_ms": ms, "ms_per_step_median_from_2": step_ms,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_ms * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "losses": losses, "warmup_steps": ocfg.warmup_steps,
          "loss_step1_batch_after_step1": same_batch,
          "peak_step": peak + 1, "loss_falls_after_peak": falls,
          "launches_per_step": per_step[-1],
          "launches_per_step_expected": want, "launches": launches,
          "runtime_fallbacks": sum(guard["runtime_fallbacks"].values()),
          "degradations": guard["degradations"], "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: losses {losses}, launches per step "
                             f"{per_step} (expected {want}), guard {guard}")
    return model, params, state, step, _train_batch(cfg, pipe, steps), \
        launches, step_ms


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded_train(torch):
    """The ``train`` phase's run (minitron-4b, 16 of 32 layers, B 2 x S
    4096, bf16, f32 moments, its seed and batches) through the
    multi-device layer: a one-rank NCCL process group, a (1, 1) ("data",
    "model") mesh, every parameter and moment a DTensor placed by
    ``param_specs`` (the dry run's FSDP policy) and ``opt_state_specs``,
    each batch by ``batch_specs``, ``ctx`` active, ``make_train_step``.
    Every kernel launches on the local shards (``local_map`` regions):
    each step's launches must equal the unsharded step's, each step's
    loss the ``train`` phase's, and the peak memory is reported beside
    it. The group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import batch_to_device, make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel import (batch_specs, ctx, distribute,
                                      opt_state_specs, param_specs)

    ref = RECORDS["train"]
    full = get_config(TRAIN["arch"])
    cfg = dataclasses.replace(full, n_layers=TRAIN["layers"])
    steps = TRAIN["steps"]
    ocfg = OptConfig(warmup_steps=ref["warmup_steps"], total_steps=steps)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1)
        model = get_model(cfg, device="cuda")
        params = model.init(TRAIN["seed"])
        want = _expected_train_launches(cfg, params)
        state = init_opt_state(params, ocfg)
        with ctx.activate(mesh):
            fsdp = cfg.param_count() > 6e9
            pspecs = param_specs(cfg, params, mesh, fsdp=fsdp)
            params = distribute(params, pspecs, mesh)
            state = distribute(state, opt_state_specs(cfg, state, pspecs,
                                                      mesh), mesh)
            placed = sum(ctx.is_dtensor(x) for x in T.leaves((params,
                                                              state)))
            step = make_train_step(model, ocfg)
            pipe = ShardedTokenPipeline(DataConfig(
                vocab=cfg.vocab, seq_len=TRAIN["seq"],
                global_batch=TRAIN["batch"], seed=TRAIN["seed"]))
            counters = _train_counters()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            losses, ms, per_step = [], [], []
            for i in range(steps):
                before = {n: c.launches for n, c in counters.items()}
                batch = batch_to_device(_train_batch(cfg, pipe, i), "cuda")
                batch = distribute(batch, batch_specs(cfg, batch, mesh),
                                   mesh)
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, state, loss = step(params, state, batch)
                losses.append(loss.item())
                ms.append((time.perf_counter() - t) * 1e3)
                per_step.append({n: c.launches - before[n]
                                 for n, c in counters.items()})
            launches = {n: c.launches for n, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
            kinds = sorted({str(tuple(p.placements))
                            for p in T.leaves(params)})
        del model, params, state, step
    finally:
        dist.destroy_process_group()
    step_ms = statistics.median(ms[1:])
    same = [f"{a:.6g}" == f"{b:.6g}" for a, b in zip(losses, ref["losses"])]
    ok = (all(same) and all(ps == want for ps in per_step)
          and per_step[-1] == ref["launches_per_step"] and placed > 0)
    emit({"phase": "sharded_train", "config": cfg.name,
          "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
          "mesh": {"data": 1, "model": 1}, "backend": "nccl",
          "fsdp": fsdp, "dtensors": placed, "placements": kinds,
          "init_s": init_s, "step_ms": ms,
          "ms_per_step_median_from_2": step_ms,
          "over_train": step_ms / ref["ms_per_step_median_from_2"],
          "peak_mem_gb": peak, "train_peak_mem_gb": ref["peak_mem_gb"],
          "peak_over_train_gb": peak - ref["peak_mem_gb"],
          "losses": losses, "train_losses": ref["losses"],
          "losses_equal_to_6_digits": same,
          "losses_bitwise_equal": losses == ref["losses"],
          "launches_per_step": per_step[-1],
          "launches_per_step_unsharded": ref["launches_per_step"],
          "ok": ok})
    if not ok:
        raise AssertionError(f"sharded_train: losses {losses} against "
                             f"{ref['losses']}, launches {per_step} against "
                             f"{want}")
    return launches


def _prune(tree, skip):
    """``tree`` without the entries whose key is in ``skip``."""
    if isinstance(tree, dict):
        return {k: _prune(v, skip) for k, v in tree.items() if k not in skip}
    if isinstance(tree, list):
        return [_prune(v, skip) for v in tree]
    return tree


def phase_parity_train(torch, arch=TRAIN["arch"], spec=PARITY_TRAIN,
                       tol=PARITY_TRAIN_TOL, phase="parity_train",
                       skip=PARITY_UPDATE_SKIP):
    """``spec["layers"]`` layers of ``arch`` at full width in f32 (for
    minitron-4b 2), B 1 x S 512: the loss and every gradient through the
    kernels against the plain versions on the card
    (``ops.set_impl("torch")``), then one apply_updates from the same
    gradients both ways, on every leaf but those keyed in ``skip``: by
    default the embeddings (the kernels phase checks the adamw kernel at
    the shape of an embedding's update chunk against its plain
    version)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import batch_to_device, value_and_grad
    from repro_torch.models import get_model
    from repro_torch.models.common import reference_ndim
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state

    cfg = dataclasses.replace(get_config(arch),
                              n_layers=spec["layers"],
                              dtype=torch.float32)
    model = get_model(cfg, device="cuda")
    params = model.init(TRAIN["seed"])
    batch = batch_to_device(_train_batch(cfg, ShardedTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=spec["seq"],
        global_batch=spec["batch"], seed=1)), 0), "cuda")
    # GB allocated on the card at each stage (the update check's reckoning)
    mem = {}

    def at(stage):
        mem[stage] = torch.cuda.memory_allocated() / 1e9

    at("model")
    _f32_flash_reset()
    t0 = time.perf_counter()
    loss_k, grads_k = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    flash = _f32_flash_read(cfg, phase, backward=True)
    at("grads")
    ops.set_impl("torch")
    try:
        loss_p, grads_p = value_and_grad(model, params, batch)
    finally:
        ops.set_impl(None)
    at("plain_grads")
    paths = ["/".join(map(str, pa)) for pa in T.flatten(params)[0]]
    rel = {pa: _err(a, b) / max(b.abs().max().item(), 1e-30)
           for pa, a, b in zip(paths, T.leaves(grads_k), T.leaves(grads_p))}
    del grads_k
    ocfg, ndim = OptConfig(warmup_steps=1), \
        functools.partial(reference_ndim, cfg)
    sub, sub_g = _prune(params, skip), _prune(grads_p, skip)
    del grads_p
    # the two gradient trees sit in reference cycles (the backward's
    # checkpoints): 36 GB of dbrx's stay allocated until a collection
    gc.collect()
    updated = T.tree_map(torch.clone, sub)
    at("update_inputs")
    apply_updates(updated, sub_g, init_opt_state(updated, ocfg), ocfg,
                  ndim=ndim)
    at("update")
    ops.set_impl("torch")
    try:
        apply_updates(sub, sub_g, init_opt_state(sub, ocfg), ocfg,
                      ndim=ndim)
    finally:
        ops.set_impl(None)
    at("plain_update")
    upd = {"/".join(map(str, pa)): _err(a, b) / max(b.abs().max().item(),
                                                    1e-30)
           for pa, a, b in zip(T.flatten(sub)[0], T.leaves(updated),
                               T.leaves(sub))}
    loss_err = abs(loss_k.item() - loss_p.item())
    ok = (max(rel.values()) <= tol["grads"]
          and max(upd.values()) <= tol["update"]
          and loss_err <= tol["loss"] * abs(loss_p.item())
          and math.isfinite(loss_k.item()))
    worst = max(rel, key=rel.get)
    emit({"phase": phase, "config": cfg.name, "dtype": "float32",
          "n_layers": cfg.n_layers, **spec,
          "loss": loss_k.item(), "plain_loss": loss_p.item(),
          "loss_abs_diff": loss_err, "tol": tol,
          "grad_rel_err_max": rel[worst], "grad_rel_err_worst_leaf": worst,
          "grad_rel_err_worst_6": dict(sorted(
              rel.items(), key=lambda kv: -kv[1])[:6]),
          "update_rel_err_max": max(upd.values()),
          "update_leaves": len(upd), "update_skips": list(skip),
          "grads_s": kern_s, "flash_launches_by_kind": flash,
          "mem_gb": mem, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: loss {loss_err}, grads "
                             f"{rel[worst]} ({worst}), update "
                             f"{max(upd.values())}")


def phase_elastic_train(torch):
    """The smoke minitron on the card through build_trainer, 8 steps with
    checkpoints every 2: a clean run, and a run that loses a host at step
    5 and recovers from the step-4 checkpoint. The recovered run's losses
    equal the clean run's."""
    import shutil
    from repro_torch.launch.train import build_trainer
    ckpt = os.path.join(SRC, "repro_torch", "_build", "elastic_ckpt")
    kw = dict(smoke=True, steps=8, batch=4, seq=64, device="cuda")
    try:
        t = time.perf_counter()
        clean = build_trainer("minitron-4b", ckpt_dir=f"{ckpt}/clean",
                              **kw).run()
        clean_s = time.perf_counter() - t
        t = time.perf_counter()
        failed = build_trainer("minitron-4b", ckpt_dir=f"{ckpt}/failed",
                               inject={5: ("node_loss", 1)}, **kw).run()
        failed_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    ok = (failed["losses"] == clean["losses"] and failed["recoveries"] == 1
          and clean["losses"][-1] < clean["losses"][0])
    emit({"phase": "elastic_train", "config": "minitron-4b-smoke", **kw,
          "clean_losses": clean["losses"], "losses": failed["losses"],
          "recoveries": failed["recoveries"],
          "elastic_events": failed["elastic_events"],
          "clean_s": clean_s, "recovered_s": failed_s, "ok": ok})
    if not ok:
        raise AssertionError(f"elastic_train: {failed['losses']} against "
                             f"{clean['losses']}")


def phase_train_compress(torch, train_ms):
    """``TRAIN_COMPRESS``: minitron-4b's training of the ``train`` phase,
    8 steps, through the trainer's step with its gradients compressed
    as ``--compress int8_ef`` does (``launch.steps.make_update``: each
    leaf int8 with per-row scales, decompressed to f32 before the
    update), under ``phase_train``'s loss gate and launch counts. Then,
    on one step's gradients, every leaf's int8 round trip stays within
    half its row's scale (with the f32 rounding of the value, 2^-22 of
    it), and the gradients' wire bytes in each mode. Returns the
    launches."""
    from repro_torch import tree as T
    from repro_torch.launch.steps import batch_to_device, value_and_grad
    from repro_torch.parallel import MODES, Compressor
    from repro_torch.parallel.compression import _dq8, _q8
    model, params, state, step, batch, launches, ms = phase_train(
        torch, TRAIN_COMPRESS, "train_compress")
    del state, step
    gc.collect()
    _, grads = value_and_grad(model, params, batch_to_device(batch, "cuda"))
    wire = {m: Compressor(m).wire_bytes(grads) for m in MODES}
    share = {}
    for path, g in zip(*T.flatten(grads)):
        q = _q8(g)
        rows = g.float().reshape(-1, g.shape[-1]) if g.dim() > 1 \
            else g.float().reshape(1, -1)
        err = (_dq8(q).reshape(rows.shape) - rows).abs()
        share["/".join(map(str, path))] = (
            err / (q["scale"] / 2 + rows.abs() * 2.0 ** -22)).max().item()
        del q, rows, err
    worst = max(share, key=share.get)
    ok = share[worst] <= 1.0
    emit({"phase": "train_compress_check", "mode": TRAIN_COMPRESS["compress"],
          "ms_per_step": ms, "train_ms_per_step": train_ms,
          "ms_over_train": ms / train_ms, "wire_bytes": wire,
          "wire_over_none": {m: wire[m] / wire["none"] for m in MODES},
          "leaves": len(share), "round_trip_of_half_scale_max": share[worst],
          "worst_leaf": worst, "ok": ok})
    if not ok:
        raise AssertionError(f"train_compress: {worst} round trip at "
                             f"{share[worst]} of half its row's scale")
    return launches


def phase_dryrun(torch):
    """The ``train`` phase's step (minitron-4b, 16 layers, B 2 x S 4096,
    bf16, f32 moments, mesh 1 x 1) counted on ``meta`` by the dry run
    (``launch.dryrun.count_cell``: every aten op, each kernel by its
    work, the live bytes), then run on the card: the peak of memory a
    step allocates above what the process held before the model
    (``max_memory_allocated`` over the second step) and its device ms
    from a profiler window as ``trace_train`` sums it (the third step).
    Fails where the counted bound (the largest of the three terms)
    exceeds the measured device time, or the predicted peak over the
    measured one falls outside ``DRYRUN_MEMORY_RATIO``. Then counts the
    production meshes in children (:func:`_start_dryrun_child`), started
    once the card's measurements are done, so that no timed phase shares
    the host with them."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, init_opt_state

    full = get_config(TRAIN["arch"])
    cfg = dataclasses.replace(full, n_layers=TRAIN["layers"])
    ocfg = OptConfig(warmup_steps=max(TRAIN["steps"] // 10, 1),
                     total_steps=TRAIN["steps"])
    shape = ShapeSpec(f"train_b{TRAIN['batch']}_s{TRAIN['seq']}",
                      TRAIN["seq"], TRAIN["batch"], "train")
    t = time.perf_counter()
    counted = count_cell(cfg, shape, accum=1, opt_cfg=ocfg)
    count_s = time.perf_counter() - t
    rf, mem = counted["roofline"], counted["memory_analysis"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = get_model(cfg, device="cuda")
    params = model.init(TRAIN["seed"])
    state = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg)
    pipe = ShardedTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
        seed=TRAIN["seed"]))
    params, state, loss = step(params, state, _train_batch(cfg, pipe, 0))
    loss.item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state, loss = step(params, state, _train_batch(cfg, pipe, 1))
    loss.item()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    # a profiler session can lose its device records (Timer.device_ms):
    # a step that recorded none is profiled again, up to 3 steps
    device_ms, sessions = 0.0, 0
    while not device_ms and sessions < 3:
        batch = _train_batch(cfg, pipe, 2 + sessions)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, loss = step(params, state, batch)
            loss.item()
            torch.cuda.synchronize()
        sessions += 1
        device_ms = sum(
            getattr(e, "self_device_time_total", 0.0)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in TRAIN_RANGES) / 1e3
    del model, params, state, step
    if not device_ms:
        raise AssertionError(f"dryrun: {sessions} profiler sessions "
                             "recorded no device time")
    bound_ms = rf["step_time_s"] * 1e3
    ratio = predicted / measured
    share = rf["model_flops"] / H100_SXM.peak_flops_bf16 / (device_ms / 1e3)
    lo, hi = DRYRUN_MEMORY_RATIO
    ok = bound_ms <= device_ms and lo <= ratio <= hi
    emit({"phase": "dryrun", "config": cfg.name,
          "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
          "shape": dataclasses.asdict(shape), "mesh": counted["mesh"],
          "count_s": count_s, "counted_flops": rf["flops"],
          "counted_hbm_bytes": rf["hbm_bytes"],
          "compute_ms": rf["compute_s"] * 1e3,
          "memory_ms": rf["memory_s"] * 1e3,
          "collective_ms": rf["collective_s"] * 1e3,
          "bound_ms": bound_ms, "dominant": rf["dominant"],
          "model_flops": rf["model_flops"],
          "counted_kernels": counted["kernels"],
          "measured_device_ms": device_ms, "profiler_sessions": sessions,
          "bound_over_measured": bound_ms / device_ms,
          "roofline_share": share,
          "memory_predicted_bytes": predicted, "memory_analysis": mem,
          "memory_measured_bytes": measured,
          "memory_predicted_over_measured": ratio,
          "memory_ratio_limits": [lo, hi], "ok": ok})
    if not ok:
        raise AssertionError(f"dryrun: bound {bound_ms} ms against "
                             f"{device_ms} measured, memory predicted over "
                             f"measured {ratio}")
    children = {name: _start_dryrun_child(name) for name in DRYRUN_MESHES}
    for name, child in children.items():
        _finish_dryrun_child(name, child)


# the production meshes the dryrun phase counts minitron-4b's train_4k on
DRYRUN_MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


def _start_dryrun_child(name):
    """A child process counting minitron-4b's train_4k on the mesh
    ``name`` in a fake process group of its own, on one CPU thread."""
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-child", name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    CHILDREN.append(child)
    return child


# every child process the run starts: stopped at its end, failed or not
CHILDREN = []


def _finish_dryrun_child(name, child):
    """The child's count of minitron-4b train_4k on the mesh ``name``:
    per device FLOPs, HBM bytes, wire bytes by collective, the three
    terms, argument and peak bytes."""
    try:
        out, err = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise AssertionError(f"dryrun child {name} timed out")
    lines = [ln for ln in out.splitlines() if ln.startswith("DRYRUN_CHILD:")]
    if child.returncode != 0 or not lines:
        sys.stderr.write(out[-4000:] + err[-8000:])
        raise AssertionError(f"dryrun child {name} failed")
    res = json.loads(lines[-1][len("DRYRUN_CHILD:"):])
    rf, mem = res["roofline"], res["memory_analysis"]
    n = rf["n_devices"]
    ok = (res["status"] == "ok" and res["mesh"] == name and rf["flops"] > 0
          and rf["wire_bytes"] > 0
          and 1.0 < rf["flops"] * n / rf["model_flops"] < 2.2)
    emit({"phase": f"dryrun_{name}", "config": res["arch"],
          "shape": res["shape"], "mesh": name, "devices": n,
          "count_s": res["compile_s"], "accum_steps": res["accum_steps"],
          "flops_per_device": rf["flops"],
          "hbm_bytes_per_device": rf["hbm_bytes"],
          "wire_bytes_per_device": rf["wire_bytes"],
          "wire_bytes_by_collective": rf["collective_breakdown"],
          "compute_ms": rf["compute_s"] * 1e3,
          "memory_ms": rf["memory_s"] * 1e3,
          "collective_ms": rf["collective_s"] * 1e3,
          "dominant": rf["dominant"], "model_flops": rf["model_flops"],
          "argument_bytes_per_device": mem["argument_bytes"],
          "peak_temp_bytes_per_device": mem["temp_bytes"],
          "bytes_per_device": rf["bytes_per_device"],
          "fits_hbm": rf["fits_hbm"], "ok": ok})
    if not ok:
        raise AssertionError(f"dryrun_{name}: {rf}")


def dryrun_child(name: str) -> int:
    """Count minitron-4b's train_4k on the production mesh ``name`` in
    this process's own fake process group; print the cell's dict."""
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.launch.dryrun import run_cell
    torch.set_num_threads(1)
    res = run_cell("minitron_4b", "train_4k", DRYRUN_MESHES[name],
                   verbose=False)
    print("DRYRUN_CHILD:" + json.dumps(res), flush=True)
    return 0 if res["status"] == "ok" else 1


# the record_function ranges a train step's backward runs under: the tile
# ops' analytic backwards (f32 torch) and the flash backward's launches
TRAIN_RANGES = ("rmsnorm_backward", "rmsnorm_gated_backward",
                "layernorm_backward", "swiglu_backward", "gelu_backward",
                "moe_router_backward", "flash_attention_causal_backward",
                "flash_attention_full_backward")
# torch ops whose kernels' device time a train trace reports: those of the
# MoE dispatch that no other op of a train step calls (top-k, the stable
# sort, counts, the index_add_ combine, the experts' batched products,
# forward and backward). Its gathers and indexing are left out: the
# embedding lookup, its backward and the loss's gold-label gather launch
# the same aten ops
DISPATCH_OPS = ("aten::topk", "aten::sort", "aten::bincount", "aten::cumsum",
                "aten::index_add_", "aten::bmm")


def _train_kernel_group(name: str) -> str:
    """A kernel of a training step by its name: the flash kernels, the SSD
    scan's (C·Bᵀ, launched by its forward and its backward, apart), the
    optimizer's and the other tile kernels, bf16 and f32 matmuls (the f32
    ones are the loss's: the rest of the step is bf16), other."""
    from repro_torch.kernels.tile_programs import PROGRAMS
    if "flash_bwd_" in name:
        return "flash_backward"
    if "flash_fwd_" in name:
        return "flash_forward"
    if "ssd_bwd_" in name:
        return "ssd_backward"
    if "ssd_scan_kernel" in name or "ssd_fwd_" in name:
        return "ssd_forward"
    if "ssd_cb_kernel" in name:
        return "ssd_cb"
    if name.startswith(("adamw_kernel", "l2_clip_kernel")):
        return "adamw_l2_clip"
    if any(name.startswith(f"{p}_kernel") for p in PROGRAMS):
        return "tile_kernels"
    if _kernel_group(name) == "matmul":
        low = name.lower()
        return "matmul_f32_xent" if any(t in low for t in (
            "sgemm", "f32f32_f32f32", "simt")) else "matmul"
    return "other"


def _cast_kernel_keys(torch):
    """``{kernel name: group}`` of the device kernels that cast bf16 to
    f32 (``Tensor.float()``) and f32 to bf16 (``Tensor.copy_``) on this
    card and torch, read from a profile of ten calls of each (a session
    of one short launch can record nothing, and any session can lose its
    records, so up to five): the trace groups a step's casts by them."""
    from torch.profiler import ProfilerActivity, profile
    keys_to_group = {}
    a = torch.ones(1 << 24, dtype=torch.bfloat16, device="cuda")
    b = torch.ones(1 << 24, device="cuda")
    for group, fn in (("cast_bf16_f32", a.float),
                      ("cast_f32_bf16", lambda: a.copy_(b))):
        fn()
        torch.cuda.synchronize()
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            keys = {e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.count}
            if keys:
                keys_to_group.update(dict.fromkeys(keys, group))
                break
        else:
            raise AssertionError(f"no device kernel recorded for {group}")
    return keys_to_group


def _kernels_before(torch, prof, prefix, keys):
    """How many launches of the kernels named ``prefix...`` a kernel of
    ``keys`` directly precedes on the device, and the launches."""
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.endswith("_backward")),
                 key=lambda e: e.time_range.start)
    hits = [i for i, e in enumerate(evs) if e.name.startswith(prefix)]
    return sum(i > 0 and evs[i - 1].name in keys for i in hits), len(hits)


def phase_trace_train(torch, step, params, state, batch,
                      phase="trace_train"):
    """One full-width train step under torch.profiler: host wall, device
    time, busy share, launches, and device ms by group; the tile ops'
    analytic backwards (torch, no kernel of their own) and the flash
    backward, causal and not, read from their record_function ranges
    (``TRAIN_RANGES``); the MoE dispatch's torch ops that nothing else
    calls (the ``index_add_`` combine, the experts' ``bmm``...) by the
    device time of the kernels each launched (``DISPATCH_OPS``). The bf16 <-> f32 casts
    are a group of their own, and no l2_clip launch may follow a bf16 ->
    f32 cast: the kernel reads the bf16 gradient itself."""
    from torch.profiler import ProfilerActivity, profile
    casts = _cast_kernel_keys(torch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, state, loss = step(params, state, batch)
        loss.item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, n_launch, top, ranges, by_op = {}, 0, [], {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.key in DISPATCH_OPS \
                and e.device_type == torch.autograd.DeviceType.CPU:
            by_op[e.key] = {"calls": e.count, "device_ms": us / 1e3}
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key in TRAIN_RANGES:
            # the ranges' spans on the device (their kernels are counted
            # under "other" by name)
            ranges[e.key] = {"calls": e.count, "device_ms": us / 1e3}
            continue
        g = casts.get(e.key) or _train_kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        n_launch += e.count
        top.append((us / 1e3, e.count, g, e.key[:70]))
    busy = sum(groups.values())
    up = {k for k, g in casts.items() if g == "cast_bf16_f32"}
    after_cast, clips = _kernels_before(torch, prof, "l2_clip_kernel", up)
    emit({"phase": phase, "wall_ms": wall_ms, "device_ms": busy,
          "busy_share": busy / wall_ms, "device_launches": n_launch,
          "device_ms_by_group": groups,
          "backward_ranges": ranges, "device_ms_by_torch_op": by_op,
          "l2_clip_launches": clips, "l2_clip_after_a_cast": after_cast,
          "top_kernels": sorted(top, reverse=True)[:10]})
    if after_cast:
        raise AssertionError(f"{phase}: {after_cast} of {clips} l2_clip "
                             f"launches follow a bf16 -> f32 cast")
    return params, state


def serve_last_four(torch):
    """granite-8b, mistral-nemo-12b, mistral-large-123b (12 layers) and
    arctic-480b (2 layers) served at full width, each step's launches
    asserted, then each one's f32 parity (see ``SERVE_GRANITE``). Returns
    the launches by config and by config and step."""
    from repro_torch.configs import get_config
    new_serves, new_steps = {}, {}
    for serve, name, layers, parity_layers, fresh in (
            (SERVE_GRANITE, "granite", None, None, False),
            (SERVE_NEMO, "nemo", None, None, True),
            (SERVE_LARGE, "mistral_large", LARGE_LAYERS, LARGE_PARITY_LAYERS,
             False),
            (SERVE_ARCTIC, "arctic", ARCTIC_LAYERS, ARCTIC_PARITY_LAYERS,
             True)):
        full = get_config(serve["arch"])
        cut = dataclasses.replace(full, n_layers=layers or full.n_layers)
        srv, reqs, got, by_step = phase_serve(
            torch, serve, f"serve_{name}", cfg=cut,
            reduced={"n_layers": [full.n_layers, layers]} if layers else None)
        n = cut.n_layers
        per = {"rmsnorm": 2 * n + 1, "rotary": 2 * n, "swiglu": n,
               "flash_attention": n}
        if cut.family == "moe":     # the experts' and the residual MLP's
            per.update(swiglu=2 * n, moe_router=n)
        _expect_steps(serve["arch"], srv, by_step, per,
                      dict(per, flash_attention=0))
        tokens = _prefill_tokens(torch, serve, reqs)
        if fresh:            # the f32 model would not fit beside the server
            del srv
            gc.collect()
            torch.cuda.empty_cache()
            srv = None
        phase_parity_f32(torch, srv, tokens, f"parity_{name}", NEW_PARITY_TOL,
                         n_layers=parity_layers, cfg=cut)
        new_serves[name], new_steps[name] = got, by_step
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    return new_serves, new_steps


def train_families(torch):
    """mamba2-1.3b and zamba2-2.7b trained at full width and depth
    (``TRAIN_MAMBA``), whisper-small at full depth and dbrx-132b at 2 of
    its 40 layers (``TRAIN_WHISPER``), qwen2-vl-2b at full depth and
    mistral-large-123b at 3 of its 88 layers (``TRAIN_QWEN``), a trace
    of one step of each, and each one's f32 parity of a step's gradients
    and update. Returns each train phase's launches."""
    trains = []
    for spec, name, pspec, ptol, skip in (
            (TRAIN_MAMBA, "mamba2", PARITY_TRAIN_MAMBA,
             PARITY_TRAIN_TOL_MAMBA, PARITY_UPDATE_SKIP),
            (TRAIN_ZAMBA, "zamba2", PARITY_TRAIN_ZAMBA, PARITY_TRAIN_TOL,
             PARITY_UPDATE_SKIP),
            (TRAIN_WHISPER, "whisper", PARITY_TRAIN_WHISPER, PARITY_TRAIN_TOL,
             ()),
            (TRAIN_DBRX, "dbrx", PARITY_TRAIN_DBRX, PARITY_TRAIN_TOL,
             PARITY_UPDATE_SKIP_DBRX),
            (TRAIN_QWEN, "qwen2vl", PARITY_TRAIN_QWEN, PARITY_TRAIN_TOL,
             PARITY_UPDATE_SKIP),
            (TRAIN_LARGE, "mistral_large", PARITY_TRAIN_LARGE,
             PARITY_TRAIN_TOL, PARITY_UPDATE_SKIP)):
        model, params, state, step, batch, got, _ = phase_train(
            torch, spec, f"train_{name}")
        trains.append(got)
        phase_trace_train(torch, step, params, state, batch,
                          f"trace_train_{name}")
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        phase_parity_train(torch, spec["arch"], pspec, ptol,
                           f"parity_train_{name}", skip)
        gc.collect()
        torch.cuda.empty_cache()
    return trains


def _tally_verify():
    """Collect every verification report and cache build wall of this
    process into ``VERIFY_TALLY`` (the serve and train phases reset the
    process telemetry, which also receives them)."""
    from repro_torch.core.telemetry import telemetry
    from repro_torch.verify import VerifyReport
    tel = telemetry()
    VERIFY_TALLY["report"] = VerifyReport()
    record_verify, record_cache = tel.record_verify, tel.record_cache

    def on_verify(rep):
        VERIFY_TALLY["report"].merge(rep)
        record_verify(rep)

    def on_cache(status, kernel, wall_s):
        walls = VERIFY_TALLY["build_s"]
        walls[status] = walls.get(status, 0.0) + wall_s
        record_cache(status, kernel, wall_s)
    tel.record_verify, tel.record_cache = on_verify, on_cache


def phase_saturation():
    """Point every tile op of the run at a fresh saturation cache and
    audit each build and launch plan at ``VERIFY_LEVEL``."""
    import shutil
    from repro_torch.kernels import ops
    shutil.rmtree(SAT_CACHE_DIR, ignore_errors=True)
    shutil.rmtree(CACHE_PHASE_DIR, ignore_errors=True)
    os.makedirs(CACHE_PHASE_DIR)
    ops.set_saturation_cache(SAT_CACHE_DIR)
    ops.set_saturation_verify(VERIFY_LEVEL)
    _tally_verify()
    emit({"phase": "saturation", "cache_dir": SAT_CACHE_DIR,
          "verify": VERIFY_LEVEL})


def _sha(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def _tensor_sha(torch, t) -> str:
    return _sha(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())


def _layout_doc(layout):
    kinds, pieces, persistent, flat = layout
    return [list(kinds), list(pieces), persistent,
            dataclasses.asdict(flat) if flat is not None else None]


def _layout_of(doc):
    from repro_torch.core.tritongen import FlatLayout
    kinds, pieces, persistent, flat = doc
    return (tuple(kinds), tuple(pieces), persistent,
            FlatLayout(**flat) if flat is not None else None)


def _op_sources(op):
    """The hashes of everything a tile op emitted: its torch source, its
    Triton source, each layout's rendered source (and the pipelined
    form's sync twin)."""
    tk = op.tk
    return {"torch": _sha(op.sk.kernel.source.encode()),
            "triton": _sha(op.source.encode()),
            "twin": _sha(tk.twin.source.encode()) if tk.twin else None,
            "layouts": {json.dumps(_layout_doc(lay)):
                        _sha(tk.render(*lay).encode())
                        for lay in sorted(tk._compiled, key=repr)}}


def _cache_tile_runs(torch, inputs=None):
    """Each ``CACHE_TILES`` program, sync and pipelined, on seeded inputs
    (or the given ones): ``(inputs, outputs)`` by ``name@emitter``."""
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
    g = torch.Generator(device="cuda").manual_seed(7)
    made, outs = {}, {}
    for name, (shapes, dt, out_dt) in CACHE_TILES.items():
        if inputs is None:
            xs = []
            for shp, a in zip(shapes, [a for a in PROGRAMS[name]()
                                       .arrays.values() if a.role != "out"]):
                x = torch.randn(shp, generator=g, device="cuda").to(
                    getattr(torch, dt))
                xs.append(x.abs() * 0.01 if a.name == "v" else x)
            made[name] = xs
        else:
            xs = [x.cuda() for x in inputs[name]]
        sc = {s: CACHE_SCALARS[s] for s in PROGRAMS[name]().scalars}
        for emitter in (None, PIPELINED):
            op = get_tile_op(name, emitter=emitter)
            out = op.apply(*xs, out_dtype=getattr(torch, out_dt)
                           if out_dt else None, **sc)
            outs[f"{name}@{emitter or 'triton'}"] = \
                [o.cpu() for o in (out if isinstance(out, tuple) else (out,))]
    return {k: [x.cpu() for x in v] for k, v in made.items()}, outs


def _cache_serve(torch):
    """minitron-4b at full width and ``CACHE_SERVE["layers"]`` of its
    layers, seeded: the served tokens and the hash of the first batch's
    prefill logits."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server
    full = get_config(CACHE_SERVE["arch"])
    cfg = dataclasses.replace(full, n_layers=CACHE_SERVE["layers"])
    srv = Server(CACHE_SERVE["arch"], smoke=False,
                 max_batch=CACHE_SERVE["max_batch"], seed=CACHE_SERVE["seed"],
                 cfg=cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab, size=CACHE_SERVE["prompt_len"] - (i % 3)).astype(
            np.int32), max_new=CACHE_SERVE["max_new"])
        for i in range(CACHE_SERVE["requests"])]
    out = srv.generate(reqs)
    with torch.no_grad():
        logits = srv.model.prefill(
            srv.params, _prefill_tokens(torch, CACHE_SERVE, reqs))[0]
    digest = _tensor_sha(torch, logits)
    del srv, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {str(k): v for k, v in sorted(out.items())}, digest


def _run_cache_child(spec_path, use_cache):
    env = dict(os.environ, PYTHONHASHSEED=CACHE_CHILD_SEED)
    env.pop("REPRO_SAT_CACHE", None)
    args = [sys.executable, os.path.abspath(__file__), "--cache-child",
            spec_path] + ([] if use_cache else ["--no-cache"])
    t = time.perf_counter()
    p = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=600)
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
        raise AssertionError(f"cache child (cache {use_cache}) failed")
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("CACHE_CHILD:")][-1]
    return json.loads(line[len("CACHE_CHILD:"):]), \
        time.perf_counter() - t


def phase_cache(torch):
    """The saturation cache across processes: a child under
    ``PYTHONHASHSEED=CACHE_CHILD_SEED`` on the same directory rebuilds
    every tile-op configuration this run built (each an exact hit, its
    sources byte-identical), replays the ``CACHE_TILES`` kernels on this
    process's inputs and serves the ``CACHE_SERVE`` cut of minitron-4b:
    outputs, tokens and prefill logits bitwise equal to this process's.
    A second child under the same seed with the cache off counts the
    programs whose sources then differ."""
    from repro_torch.kernels.tile_programs import built_tile_ops
    ops_ = built_tile_ops()
    inputs, outputs = _cache_tile_runs(torch)
    tokens, logits = _cache_serve(torch)
    torch.save({"inputs": inputs, "outputs": outputs},
               os.path.join(CACHE_PHASE_DIR, "parent.pt"))
    spec = {"configs": [[list(k), _op_sources(op)] for k, op in
                        sorted(ops_.items(), key=lambda kv: repr(kv[0]))],
            "tokens": tokens, "logits": logits,
            "tensors": os.path.join(CACHE_PHASE_DIR, "parent.pt")}
    spec_path = os.path.join(CACHE_PHASE_DIR, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cold_s = VERIFY_TALLY["build_s"].get("miss", 0.0)
    warm, warm_wall = _run_cache_child(spec_path, True)
    off, off_wall = _run_cache_child(spec_path, False)
    ok = (warm["misses"] == 0 and warm["invalid"] == 0
          and warm["hits"] == len(ops_) and not warm["source_diffs"]
          and all(warm["tiles_bitwise"].values())
          and warm["tokens_equal"] and warm["logits_equal"]
          and warm["verify_errors"] == 0)
    emit({"phase": "cache", "child_seed": int(CACHE_CHILD_SEED),
          "configs": len(ops_),
          "programs": sorted({k[0] for k in ops_}),
          "hits": warm["hits"], "misses": warm["misses"],
          "warm_starts": warm["warm"], "invalid": warm["invalid"],
          "sources_compared": warm["sources_compared"],
          "source_diffs": warm["source_diffs"],
          "tiles_bitwise": warm["tiles_bitwise"],
          "serve": {"config": "minitron-4b",
                    "reduced": {"n_layers": [32, CACHE_SERVE["layers"]]},
                    "requests": CACHE_SERVE["requests"],
                    "max_new": CACHE_SERVE["max_new"],
                    "tokens_equal": warm["tokens_equal"],
                    "prefill_logits_equal": warm["logits_equal"]},
          "cache_off": {"configs_differ": len(
                            {d.split(":")[0] for d in off["source_diffs"]}),
                        "programs_differ": sorted(
                            {d.split("@")[0] for d in off["source_diffs"]}),
                        "parts_differ": off["source_diffs"]},
          "cold_saturation_s": cold_s, "warm_saturation_s": warm["hit_s"],
          "speedup": cold_s / warm["hit_s"] if warm["hit_s"] else None,
          "child_verify_errors": warm["verify_errors"],
          "child_wall_s": warm_wall, "child_off_wall_s": off_wall,
          "ok": ok})
    if not ok:
        raise AssertionError("cache: the child did not replay the parent "
                             "bit for bit")


def cache_child(spec_path: str, use_cache: bool) -> int:
    """The cache phase's child process (see :func:`phase_cache`)."""
    import torch
    sys.path.insert(0, SRC)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        SRC, "repro_torch", "_build", "triton_cache"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.telemetry import telemetry
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_programs import get_tile_op
    with open(spec_path) as f:
        spec = json.load(f)
    if use_cache:
        ops.set_saturation_cache(SAT_CACHE_DIR)
        ops.set_saturation_verify(VERIFY_LEVEL)
    else:
        ops.set_saturation_cache(False)
    diffs, compared = [], 0
    for key, want in spec["configs"]:
        name, mode, schedule, emitter, cache_dir, verify, profile = key
        op = get_tile_op(name, mode=mode, schedule=schedule, emitter=emitter,
                         cache_dir=cache_dir if use_cache else False,
                         verify=verify if use_cache else None,
                         device_profile=profile)
        got = _op_sources(op)
        got["layouts"] = {lay: _sha(op.tk.render(*_layout_of(
            json.loads(lay))).encode()) for lay in want["layouts"]}
        for part in ("torch", "triton", "twin", "layouts"):
            compared += 1 if part != "layouts" else len(want["layouts"])
            if got[part] != want[part]:
                diffs.append(f"{name}@{emitter or 'triton'}:{part}")
    snap = telemetry().snapshot()
    out = {"hits": snap["cache_hits"], "misses": snap["cache_misses"],
           "warm": snap["cache_warm_starts"],
           "invalid": snap["cache_invalid"], "hit_s": snap["hit_wall_s"],
           "source_diffs": diffs, "sources_compared": compared}
    if use_cache:
        saved = torch.load(spec["tensors"])
        _, outs = _cache_tile_runs(torch, saved["inputs"])
        out["tiles_bitwise"] = {
            k: all(torch.equal(a, b) for a, b in zip(v, saved["outputs"][k]))
            for k, v in outs.items()}
        tokens, logits = _cache_serve(torch)
        out["tokens_equal"] = tokens == spec["tokens"]
        out["logits_equal"] = logits == spec["logits"]
        out["verify_errors"] = telemetry().snapshot()["verify"]["errors"]
    print("CACHE_CHILD:" + json.dumps(out), flush=True)
    return 0


# The calibration lane (tools/calibrate.py) at fewer reps: the 13 tile
# programs under each statement order at the tool's 32 M elements an
# array, checked, timed in turns, refitted; the committed H100 profile
# re-scored and its cost orders built and checked.
# The five saturation modes (phase ``modes``): each tile program at one
# shape, by input (shape, dtype): the training paths' shapes where a
# program is on one (rmsnorm at mistral-large's d_model 12288, two column
# pieces of 8192 + 4096; rmsnorm_gated at mamba2's, layernorm and gelu at
# whisper's, swiglu and rotary at minitron's, the router at dbrx's,
# adamw and l2_clip at minitron's MLP weight), the ops' rows otherwise
# (softmax's prefill scores, ssd_gate's train dt with a_log a broadcast
# row) and the calibration lane's 32 M elements for residual_scale and
# sgd_momentum. Inputs from a generator of their own, the scalars of the
# kernels phase.
MODE_CASES = {
    "rmsnorm": ([(8192, 12288), (12288,)], ["float32"] * 2),
    "rmsnorm_gated": ([(8192, 4096)] * 2 + [(4096,)], ["bfloat16"] * 3),
    "layernorm": ([(8192, 768), (768,), (768,)], ["float32"] * 3),
    "swiglu": ([(8192, 9216)] * 2, ["bfloat16"] * 2),
    "gelu": ([(8192, 3072)], ["bfloat16"]),
    "rotary": ([(2, 24, 4096, 128), (1, 1, 4096, 128), (1, 1, 4096, 128)],
               ["bfloat16", "float32", "float32"]),
    "residual_scale": ([(8192, 4096)] * 2, ["float32"] * 2),
    "softmax": ([(49152, 512)], ["float32"]),
    "adamw": ([(3072, 9216)] * 4, ["float32"] * 4),
    "sgd_momentum": ([(8192, 4096)] * 3, ["float32"] * 3),
    "ssd_gate": ([(2, 4096, 64), (64,)], ["float32"] * 2),
    "moe_router": ([(32, 256, 16)], ["float32"]),
    "l2_clip": ([(3072, 9216)], ["float32"]),
}
# the programs whose pipelined kernels a path drives, under every mode
MODES_PIPELINED = ("layernorm", "moe_router", "rmsnorm", "rotary", "swiglu")
MODES_REPS = 10
MODES_SEED = 31
# the tile programs' scalars (the kernels and modes phases)
TILE_SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
                "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
                "bias": 0.1, "norm": 3.0, "max_norm": 1.0}

# serve_decode_torch's report on the card (its tokens/s saturated and
# plain, its cold and warm saturation), which the examples phase prints
SERVE_DECODE_REPORT = os.path.join("src", "repro_torch", "_build",
                                   "serve_decode_report.json")
# The port's examples by name: the arguments they take on the card (phase
# ``examples``), those the CPU tests add to ``--device cpu``
# (tests/test_torch_examples.py), and the lines each must print on
# either, ``{device}`` standing for the device (train_lm_torch at 100 of
# its 300 default steps on the card: the 300 took 48 s of the run)
EXAMPLES = {
    "quickstart_torch": ([], [], [
        "all 5 modes match the reference interpreter",
        "rmsnorm under all 5 modes ran on {device}"]),
    "saturate_custom_kernel_torch": ([], [], [
        "on {device} == saturated torch function",
        "bridged function matches the original", "pipeline report:"]),
    "train_lm_torch": (["--steps", "100"], ["--tiny"], [
        "recoveries=1", "loss decreased across a simulated node failure"]),
    "serve_decode_torch": (["--out", SERVE_DECODE_REPORT], [], [
        "saturation ON : ", "the warm pass hit every lookup",
        "saturated and ref decoded the same number of tokens"]),
}
EXAMPLES_TIMEOUT_S = 300

CALIBRATE_REPS = 5
# The bridge: the example's my_fn (examples/saturate_custom_kernel.py)
# and a function with remainder, where, pow and a 0-d scalar, bridged
# to one generated Triton kernel each, at (8192, 4096) in f32 and bf16.
BRIDGE_SHAPE = (8192, 4096)


def _calibrate_tool():
    """tools/calibrate.py as a module (its main is not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "calibrate_tool", os.path.join(ROOT, "tools", "calibrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_calibrate(torch):
    """The 13 tile programs x 3 statement orders built through the run's
    cache and verifier, each launched on the card and held against its
    plain version (f32, 2e-5), timed in turns at ``CALIBRATE_REPS`` and
    refitted; the committed profile's ``check_profile`` must be empty;
    the 13 cost orders priced by the committed profile built and checked,
    and the programs whose order it moved against the analytic cost
    order named. Every op's count is zeroed before and read after."""
    from repro_torch.analysis import check_profile, load_profile
    from repro_torch.kernels.tile_programs import PROGRAMS
    tool = _calibrate_tool()
    committed = tool.committed_profile()
    if committed is None:
        raise AssertionError("calibrate: no committed H100 profile")
    prof = load_profile(committed)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows, moved, errs, launches = [], [], {}, {}
    t0 = time.perf_counter()
    for name in sorted(PROGRAMS):
        ops_ = tool.schedule_ops(name)
        cal = tool.schedule_ops(name, committed, ("cost",))["cost"]
        for op in (*ops_.values(), cal):
            op.launches = 0
        arrays, scalars = tool.tile_inputs(
            torch, ops_["cost"].sk.ssa.prog)
        got, _ = tool.check_and_compile(torch, ops_, arrays, scalars,
                                        hashes=False)
        outs, want = (o if isinstance(o, tuple) else (o,) for o in (
            cal.apply(*arrays, **scalars), cal.torch_ref(*arrays, **scalars)))
        got["profile"] = max(float((o - w).abs().max())
                             for o, w in zip(outs, want))
        errs[name] = got
        times = tool.time_in_turns(torch, ops_, arrays, scalars,
                                   CALIBRATE_REPS, flush)
        rows.append(tool.summarize(name, ops_, arrays, times))
        if cal.tk.source != ops_["cost"].tk.source:
            moved.append(name)
        launches[name] = {s: op.launches for s, op in
                          (*ops_.items(), ("profile", cal))}
        del arrays
    fresh, ok = tool.fit_rows(rows, torch.cuda.get_device_name(0))
    fails = check_profile(prof)
    worst = max(max(e.values()) for e in errs.values())
    ff, cf = fresh.fit, prof.fit
    emit({"phase": "calibrate", "programs": len(rows),
          "schedules": list(tool.SCHEDULES), "reps": CALIBRATE_REPS,
          "shape_elems": rows[0]["shape"][0] * rows[0]["shape"][1],
          "max_abs_err": worst, "tol": TILE_TOL["float32"],
          "refit": {"mape_pct": ff["mape_pct"], "spearman": ff["spearman"],
                    "uncalibrated_mape_pct": ff["uncalibrated_mape_pct"],
                    "uncalibrated_spearman": ff["uncalibrated_spearman"],
                    "would_promote": ok},
          "committed": {"path": os.path.relpath(committed, ROOT),
                        "mape_pct": cf["mape_pct"],
                        "spearman": cf["spearman"],
                        "uncalibrated_mape_pct": cf["uncalibrated_mape_pct"],
                        "uncalibrated_spearman": cf["uncalibrated_spearman"],
                        "check_profile": fails},
          "profile_moved_cost_order": moved,
          "cost_vs_bulk_paired_pct": {r["kernel"]:
                                      r["cost_vs_bulk_paired_pct"]
                                      for r in rows},
          "launches": launches, "wall_s": time.perf_counter() - t0})
    if worst > TILE_TOL["float32"]:
        raise AssertionError(f"calibrate: kernel vs plain {worst}")
    if fails:
        raise AssertionError(f"calibrate: committed profile fails {fails}")
    if any(n == 0 for ln in launches.values() for n in ln.values()):
        raise AssertionError(f"calibrate: an op never launched {launches}")


def phase_modes(torch):
    """The paper's five saturation modes on the card: each of the 13 tile
    programs at its ``MODE_CASES`` shape under ``baseline``, ``cse``,
    ``cse_sat``, ``cse_bulk`` and ``accsat`` (``get_tile_op(name,
    mode=...)``), the sync kernels, and the pipelined ones of
    ``MODES_PIPELINED``. Each kernel is held against its own plain
    version (the mode's torchgen function) at its dtype's ``TILE_TOL``,
    a program whose case is bf16 also on the same values in f32 at the f32
    2e-5 (``max_abs_err_f32``), timed in turns with the other
    modes of its program (``tools/calibrate.py``'s ``time_in_turns``:
    each launch after an L2 flush, the order rotating) beside its bound,
    and reported with its extraction's ops, loads and FMAs, the loads in
    its source, the global loads in its PTX and its registers and spills.
    A (program, mode) that raises fails the phase, named. Every op's
    count is zeroed before and read after."""
    from repro_torch.core import MODES
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
    from repro_torch.roofline import kernel_work
    tool = _calibrate_tool()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    randn = _randn_from(torch, MODES_SEED)
    checks, programs, launches = [], {}, {}
    t0 = time.perf_counter()
    for emitter in (None, PIPELINED):
        names = sorted(PROGRAMS) if emitter is None else MODES_PIPELINED
        for name in names:
            shapes, dtypes = MODE_CASES[name]
            args = []
            for a, shape, dt in zip((a for a in PROGRAMS[name]().arrays
                                     .values() if a.role != "out"),
                                    shapes, dtypes):
                x = randn(*shape, dtype=getattr(torch, dt))
                args.append(x.abs() * 0.01 if a.name == "v" else x)
            sc = {k: TILE_SCALARS[k] for k in PROGRAMS[name]().scalars}
            plain_args = [a.expand(args[0].shape) for a in args]
            # a bf16 case is also checked on the same values in f32
            args32 = None if dtypes == ["float32"] * len(dtypes) else \
                [a.float() for a in args]
            tag = name if emitter is None else f"{name}@{emitter}"
            ops_, rows = {}, {}
            for mode in MODES:
                try:
                    op = get_tile_op(name, mode=mode, emitter=emitter)
                    op.launches = 0
                    err = _check(f"{tag}/{mode}", op.apply(*args, **sc),
                                 op.torch_ref(*plain_args, **sc),
                                 TILE_TOL[dtypes[0]], checks)
                    err32 = err if args32 is None else _check(
                        f"{tag}/{mode}/f32", op.apply(*args32, **sc),
                        op.torch_ref(*(a.expand(args32[0].shape)
                                       for a in args32), **sc),
                        TILE_TOL["float32"], checks)
                    info = _compiled_info(op, args, sc)
                except Exception as e:
                    raise AssertionError(f"modes: {tag} under {mode} "
                                         f"raised") from e
                ops_[mode] = op
                st = op.sk.kernel.stats
                bound, by = kernel_work.tile_bound(op, args)
                rows[mode] = {
                    "max_abs_err": err, "max_abs_err_f32": err32,
                    "n_ops": st.n_ops, "n_loads": st.n_loads,
                    "n_fma": st.n_fma, "dag_cost": op.sk.extraction.dag_cost,
                    "kernel_ops": op.tk.stats.n_ops,
                    "source_loads": op.source.count("tl.load("),
                    "ptx_ld_global": sum(info["ld"].values()),
                    "ptx_ld_bytes": info["ld"], "registers":
                    info["registers"], "spills": info["spills"],
                    "plan": _plan_dict(_tile_plan(op, args)),
                    "bound_ms": bound, "bound_by": by}
            times = tool.time_in_turns(torch, ops_, args, sc, MODES_REPS,
                                       flush)
            for mode, ts in times.items():
                rows[mode]["ms"] = statistics.median(ts)
            launches[tag] = {m: op.launches for m, op in ops_.items()}
            programs[tag] = {"shape": [list(a.shape) for a in args],
                             "dtype": dtypes, "modes": rows}
            del args, plain_args, args32
            torch.cuda.empty_cache()
    bad = [c["name"] for c in checks if not c["ok"]]
    emit({"phase": "modes", "modes": list(MODES), "reps": MODES_REPS,
          "programs": programs, "launches": launches, "checks_failed": bad,
          "max_abs_err": max(c["max_abs_err"] for c in checks),
          "wall_s": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"modes: kernels disagree {bad}")
    if any(n == 0 for ln in launches.values() for n in ln.values()):
        raise AssertionError(f"modes: an op never launched {launches}")


def _bridge_fns(torch):
    def my_fn(a, b):
        t = a * b + a * b          # redundant on purpose
        return t * torch.sigmoid(t) + a * b

    def mod_pow(a, b, s):
        return (torch.where(a > b, torch.remainder(a, b), a ** 4) * s
                + b.abs() ** 1.5 - torch.pow(a, -2))

    return {"my_fn": (my_fn, False), "mod_pow": (mod_pow, True)}


def _finite_max_diff(torch, got, want, tol):
    """Where both are finite: max |got - want|, and the worst element's
    share of its allowance ``tol + tol * |want|`` (below 1 passes; the
    values of pow(a, -2) reach 1e14); and the count of places where
    either is not finite."""
    got, want = got.float(), want.float()
    ok = torch.isfinite(got) & torch.isfinite(want)
    diff = (got - want).abs()[ok]
    return {"max": float(diff.max()),
            "of_tol": float((diff / (tol + tol * want[ok].abs())).max()),
            "nonfinite": int((~ok).sum())}


def phase_bridge(torch, timer):
    """Plain torch functions bridged to one generated Triton kernel each
    (``saturate_torch_fn``): on operands of both signs at
    ``BRIDGE_SHAPE`` in f32 and bf16, each call is one launch, equal to
    the eager function and to the bridge's plain version (2e-5 f32,
    3e-2 bf16; in bf16 both evaluated in f32 on the same bf16 operands,
    since the kernel computes in f32 and rounds once, while eager bf16
    rounds after every op: its distance is reported), and is timed in
    turns against the eager function, which launches a kernel for each
    of its aten ops; ``maybe_saturate(torch.sort, ...)`` returns
    ``torch.sort`` and counts one fallback under ``aten.sort``. Returns
    the kernels line's rows."""
    from repro_torch.roofline import kernel_work
    from repro_torch.core import (maybe_saturate, saturate_torch_fn,
                                  telemetry)
    g = torch.Generator(device="cuda").manual_seed(11)
    a32, b32 = (torch.randn(BRIDGE_SHAPE, generator=g, device="cuda") * 3
                for _ in range(2))
    s = torch.tensor(0.75, device="cuda")
    rows, out = {}, {}
    for name, (fn, scalar) in _bridge_fns(torch).items():
        args32 = (a32, b32, s) if scalar else (a32, b32)
        bk = saturate_torch_fn(fn, args32, name=f"bridge_{name}")
        bk.op.launches = 0
        res = {}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            args = (a32.to(dt), b32.to(dt), s)[:len(args32)]
            before = bk.op.launches
            got = bk(*args)
            if bk.op.launches != before + 1:
                raise AssertionError(f"bridge {name}: "
                                     f"{bk.op.launches - before} launches")
            f32 = [x.float() for x in args[:2]]
            plain = bk.op.torch_ref(*f32, **({"s2": s} if scalar else {}))
            eager = fn(*f32, *args[2:])
            tol = TILE_TOL[dtype]
            errs = {}
            for ref_name, ref in (("plain", plain), ("eager", eager)):
                # an exact 0 in randn makes pow(a, -2) infinite: equal
                # infinities agree, and the error is over finite values
                if not bool(torch.isclose(got.float(), ref, rtol=tol,
                                          atol=tol, equal_nan=True).all()):
                    raise AssertionError(f"bridge {name} {dtype}: "
                                         f"{ref_name} disagrees")
                errs[ref_name] = _finite_max_diff(torch, got, ref, tol)
            del plain, eager
            eager_own = _finite_max_diff(torch, got, fn(*args), tol)
            turns = _in_turns(timer, lambda: bk(*args), lambda: fn(*args))
            bound, by = kernel_work.tile_bound(bk.op, list(args[:2]))
            res[dtype] = {"max_abs_err_plain": errs["plain"],
                          "max_abs_err_eager": errs["eager"],
                          "max_abs_diff_eager_in_dtype": eager_own,
                          "ms": statistics.median(turns["kernel_ms"]),
                          "eager_ms": statistics.median(turns["library_ms"]),
                          "kernel_over_eager": turns["kernel_over_library"],
                          "plain_ms": timer.ms(lambda: bk.op.torch_ref(
                              *args[:2], **({"s2": s} if scalar else {})),
                              iters=5),
                          "bound_ms": bound, "bound_by": by}
        out[name] = {"aten_ops": bk.n_eqns,
                     "saturated_ops": bk.sk.kernel.stats.n_ops,
                     "libdevice": bk.op.tk.libdevice,
                     "launches": bk.op.launches, **res}
        f32 = res["float32"]
        rows[f"bridge_{name}"] = {
            "route": "triton", "source": "src/repro_torch/core/fx_bridge.py",
            "replaces": "src/repro/core/jaxpr_bridge.py:145 "
                        "(saturate_jax_fn's replacement, jnp; no Pallas "
                        "kernel)",
            "launches": bk.op.launches,
            "max_abs_err": f32["max_abs_err_plain"]["max"],
            "max_err_of_tol": f32["max_abs_err_plain"]["of_tol"],
            "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "eager_ms": f32["eager_ms"], "shapes": {"bfloat16": res[
                "bfloat16"]}}
    before = dict(telemetry().snapshot()["bridge_fallbacks"])
    x = torch.randn(1024, device="cuda")
    fn, info = maybe_saturate(torch.sort, (x,), name="sort")
    after = telemetry().snapshot()["bridge_fallbacks"]
    fell = after.get("aten.sort", 0) - before.get("aten.sort", 0)
    ok = fn is torch.sort and info is None and fell == 1
    emit({"phase": "bridge", "shape": list(BRIDGE_SHAPE), "functions": out,
          "fallback": {"fn": "torch.sort", "returned_original":
                       fn is torch.sort, "counted": fell},
          "ok": ok})
    if not ok:
        raise AssertionError("bridge: torch.sort did not fall back counted")
    return rows


def phase_examples():
    """The port's examples (``examples/*_torch.py``) as a user runs them,
    on the card (no device named), as child processes started together:
    each must exit 0 within ``EXAMPLES_TIMEOUT_S`` and print what it
    checked."""
    env = {**os.environ, "PYTHONPATH": SRC}
    os.makedirs(os.path.dirname(os.path.join(ROOT, SERVE_DECODE_REPORT)),
                exist_ok=True)
    t0 = time.perf_counter()
    children = {}
    for name, (args, _, _) in EXAMPLES.items():
        child = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        CHILDREN.append(child)
        children[name] = child
    runs, ok = {}, True
    for name, child in children.items():
        try:
            out, err = child.communicate(timeout=max(
                1.0, EXAMPLES_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            child.kill()
            out, err = child.communicate()
        missing = [ln for ln in (said.format(device="cuda")
                                 for said in EXAMPLES[name][2])
                   if ln not in out]
        runs[name] = {"args": EXAMPLES[name][0], "rc": child.returncode,
                      "missing": missing, "wall_s": time.perf_counter() - t0,
                      "stdout_tail": out.splitlines()[-6:],
                      "stderr_tail": err.splitlines()[-12:]
                      if child.returncode else []}
        ok &= child.returncode == 0 and not missing
        if "--out" in EXAMPLES[name][0] and child.returncode == 0:
            args = EXAMPLES[name][0]
            with open(os.path.join(ROOT, args[args.index("--out") + 1])) as f:
                runs[name]["report"] = json.load(f)
    emit({"phase": "examples", "runs": runs, "ok": ok})
    if not ok:
        raise AssertionError(f"examples: {runs}")


def phase_verify(torch):
    """The verifier's tally over the run, with the CUDA kernels' launches
    certified at the paths' shapes: the flash forward's grid and the
    flash backward's work lists (at this card's SM count), the SSD
    scan's launches. Fails on any error finding."""
    from repro_torch.kernels.tile_programs import built_tile_ops
    from repro_torch.verify import (VerifyReport, check_flash_bwd_work,
                                    check_grid, flash_attention_model,
                                    record, ssd_scan_models)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rep = VerifyReport()
    attn = {  # (B, H, KH, S, D): the serve paths' prefill, then training
        "minitron": (4, 24, 8, 512, 128), "zamba2": (4, 32, 32, 512, 80),
        "dbrx": (4, 48, 8, 512, 128), "qwen2vl": (4, 12, 2, 512, 128),
        "whisper": (4, 12, 12, 512, 64), "granite": (4, 32, 8, 512, 128),
        "mistral_large": (4, 96, 8, 512, 128), "arctic": (4, 56, 8, 512, 128),
        "train_minitron": (2, 24, 8, 4096, 128),
        "train_zamba2": (2, 32, 32, 4096, 80),
        "train_whisper": (2, 12, 12, 4096, 64),
        "train_dbrx": (2, 48, 8, 4096, 128)}
    for B, H, KH, S, D in attn.values():
        for dt in (torch.bfloat16, torch.float32):
            res = check_grid(flash_attention_model(B, H, KH, S, D, dt,
                                                   programs=sms))
            rep.extend(res.findings)
            rep.grids_checked += 1
        for causal in (True, False):
            rep.extend(check_flash_bwd_work(B, H, KH, S, causal, sms))
            rep.grids_checked += 2
    # the f32 backward's lists at the f32 parity phases' shapes
    for (B, H, KH, S, D), causal in [*FLASH_F32_FWD, *FLASH_F32_TRAIN]:
        rep.extend(check_flash_bwd_work(B, H, KH, S, causal, sms,
                                        kind="wgmma_f32"))
        rep.grids_checked += 2
    ssd = {"mamba2": (4, 512, 64, 64, 128), "zamba2": (4, 512, 80, 64, 64),
           "train_mamba2": (2, 4096, 64, 64, 128),
           "train_zamba2": (2, 4096, 80, 64, 64)}
    for B, S, H, P, N in ssd.values():
        models, walk = ssd_scan_models(B, H, S, P, N, 128, sms)
        rep.extend(walk)
        for m in models:
            res = check_grid(m)
            rep.extend(res.findings)
            rep.grids_checked += 1
    record(rep)
    tally = VERIFY_TALLY["report"]
    ops_ = built_tile_ops().values()
    errors = [str(f) for f in tally.errors()]
    emit({"phase": "verify", "level": VERIFY_LEVEL,
          "by_pass": tally.by_pass(), "by_severity": tally.by_severity(),
          "codes": dict(sorted(collections.Counter(
              f"{f.pass_name}:{f.code}" for f in tally.findings).items())),
          "egraphs_checked": tally.egraphs_checked,
          "schedules_certified": tally.schedules_certified,
          "sources_checked": tally.sources_checked,
          "grids_checked": tally.grids_checked,
          "tile_layouts_certified": sum(len(op.certified) for op in ops_),
          "tile_binaries_checked": sum(len(op.binaries) for op in ops_),
          "compiled_info_checked": VERIFY_TALLY["compiled_checked"],
          "cuda_launch_grids": rep.grids_checked,
          "warnings": [str(f) for f in tally.findings
                       if f.severity == "warning"][:20],
          "errors": errors[:20], "n_errors": len(errors)})
    if errors:
        raise AssertionError(f"verify: {len(errors)} error finding(s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository (src/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        SRC, "repro_torch", "_build", "triton_cache"))
    t_start = time.perf_counter()
    launches = {}
    try:
        smi = phase_env(torch)
        phase_saturation()
        tensor_core = phase_build()
        timer = Timer(torch)
        rows = phase_kernels(torch, timer)
        del timer
        # residual_scale, softmax and ssd_gate through their entry points
        opsd = phase_ops(torch)
        # minitron-4b: the dense path
        srv, reqs, dense, dense_steps = phase_serve(torch, SERVE, "serve")
        tokens = _prefill_tokens(torch, SERVE, reqs)
        sync_logits = phase_parity(torch, srv, tokens)
        piped = phase_pipelined(torch, srv, tokens, sync_logits,
                                ("rmsnorm", "rotary", "swiglu"),
                                "pipelined_minitron")
        phase_trace(torch, srv, tokens, "trace")
        del srv, sync_logits
        gc.collect()    # the serve phase's timing wrappers hold a cycle
        torch.cuda.empty_cache()
        # mamba2-1.3b: the ssm path
        srv, reqs, ssm, ssm_steps = phase_serve(torch, SERVE_MAMBA,
                                                "serve_mamba2")
        if ssm["ssd_scan"] != srv.cfg.n_layers * 2:
            raise AssertionError(f"ssd_scan launched {ssm['ssd_scan']} "
                                 f"times, expected one per layer and "
                                 f"prefill batch")
        tokens = _prefill_tokens(torch, SERVE_MAMBA, reqs)
        phase_parity_f32(torch, srv, tokens, "parity_mamba2",
                         MAMBA_PARITY_TOL)
        sync_logits = srv.model.prefill(srv.params, tokens)[0]
        for name, n in phase_pipelined(
                torch, srv, tokens, sync_logits, ("rmsnorm", "rmsnorm_gated"),
                "pipelined_mamba2").items():
            piped[name] = piped.get(name, 0) + n
        phase_trace(torch, srv, tokens, "trace_mamba2")
        del srv, sync_logits
        gc.collect()
        torch.cuda.empty_cache()
        # zamba2-2.7b: the hybrid path
        srv, reqs, hybrid, hybrid_steps = phase_serve(torch, SERVE_ZAMBA,
                                                      "serve_zamba2")
        n_shared = srv.cfg.n_layers // srv.cfg.shared_attn_every
        want = {"ssd_scan": srv.cfg.n_layers * 2,
                "flash_attention": n_shared * 2}
        if {k: hybrid[k] for k in want} != want:
            raise AssertionError(f"zamba2 launched {hybrid}, expected "
                                 f"{want}: one scan per layer and one flash "
                                 f"per shared block, per prefill batch")
        tokens = _prefill_tokens(torch, SERVE_ZAMBA, reqs)
        phase_parity_f32(torch, srv, tokens, "parity_zamba2",
                         ZAMBA_PARITY_TOL)
        phase_trace(torch, srv, tokens, "trace_zamba2")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        # dbrx-132b at full width and 4 of its 40 layers: the moe path
        from repro_torch.configs import get_config
        full = get_config("dbrx-132b")
        srv, reqs, moe, moe_steps = phase_serve(
            torch, SERVE_DBRX, "serve_dbrx",
            cfg=dataclasses.replace(full, n_layers=DBRX_LAYERS),
            reduced={"n_layers": [full.n_layers, DBRX_LAYERS]})
        steps_run = srv.metrics["prefills"] + srv.metrics["decode_ticks"]
        want = {"moe_router": DBRX_LAYERS * steps_run,
                "flash_attention": DBRX_LAYERS * srv.metrics["prefills"]}
        if {k: moe[k] for k in want} != want:
            raise AssertionError(f"dbrx launched {moe}, expected {want}: "
                                 f"one router softmax per layer and step")
        tokens = _prefill_tokens(torch, SERVE_DBRX, reqs)
        phase_parity_f32(torch, srv, tokens, "parity_dbrx", DBRX_PARITY_TOL,
                         n_layers=DBRX_PARITY_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        sync_logits = srv.model.prefill(srv.params, tokens)[0]
        for name, n in phase_pipelined(
                torch, srv, tokens, sync_logits,
                ("rmsnorm", "rotary", "swiglu", "moe_router"),
                "pipelined_dbrx").items():
            piped[name] = piped.get(name, 0) + n
        del sync_logits
        phase_trace(torch, srv, tokens, "trace_dbrx")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        # qwen2-vl-2b: the vlm path (the dense stack with M-RoPE)
        srv, reqs, vlm, vlm_steps = phase_serve(torch, SERVE_QWEN,
                                                "serve_qwen2vl")
        n = srv.cfg.n_layers
        _expect_steps("qwen2-vl", srv, vlm_steps,
                      {"rmsnorm": 2 * n + 1, "rotary": 2 * n, "swiglu": n,
                       "flash_attention": n},
                      {"rmsnorm": 2 * n + 1, "rotary": 2 * n, "swiglu": n,
                       "flash_attention": 0})
        tokens = _prefill_tokens(torch, SERVE_QWEN, reqs)
        pos3 = torch.from_numpy(vision_positions(tokens.shape[1],
                                                 VISION_GRIDS)).cuda()
        phase_mrope(torch, srv, tokens, pos3, _counters("qwen2-vl-2b"))
        for name, c in _counters("qwen2-vl-2b").items():
            vlm[name] += c.launches
            vlm_steps["prefill"][name] += c.launches
        phase_parity_f32(torch, srv, tokens, "parity_qwen2vl",
                         QWEN_PARITY_TOL, prefill_arg=pos3)
        phase_trace(torch, srv, tokens, "trace_qwen2vl")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        # whisper-small: the encdec path
        srv, reqs, encdec, encdec_steps = phase_serve(torch, SERVE_WHISPER,
                                                      "serve_whisper")
        n, ne = srv.cfg.n_layers, srv.cfg.n_enc_layers
        _expect_steps("whisper", srv, encdec_steps,
                      {"layernorm": 2 * ne + 1 + 3 * n + 1, "gelu": ne + n,
                       "flash_attention": ne + 2 * n},
                      {"layernorm": 3 * n + 1, "gelu": n,
                       "flash_attention": 0})
        tokens = _prefill_tokens(torch, SERVE_WHISPER, reqs)
        frames = torch.randn((*tokens.shape, srv.cfg.d_model),
                             generator=torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
        phase_parity_f32(torch, srv, tokens, "parity_whisper",
                         WHISPER_PARITY_TOL, prefill_arg=frames)
        sync_logits = srv.model.prefill(srv.params, tokens)[0]
        for name, n in phase_pipelined(
                torch, srv, tokens, sync_logits, ("layernorm", "gelu"),
                "pipelined_whisper").items():
            piped[name] = piped.get(name, 0) + n
        del sync_logits
        phase_trace(torch, srv, tokens, "trace_whisper")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        # the last four configs: three dense and arctic's MoE
        new_serves, new_steps = serve_last_four(torch)
        # the saturation cache across processes and hash seeds
        phase_cache(torch)
        # minitron-4b training at full width, 16 of its 32 layers
        model, params, state, step, batch, train, train_ms = phase_train(
            torch)
        phase_trace_train(torch, step, params, state, batch)
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        # the same run through the multi-device layer on a (1, 1) mesh
        sharded = phase_sharded_train(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase_parity_train(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase_elastic_train(torch)
        gc.collect()
        torch.cuda.empty_cache()
        # the same training with its gradients compressed (int8, error
        # feedback), and its step counted on meta against the card
        compressed = phase_train_compress(torch, train_ms)
        gc.collect()
        torch.cuda.empty_cache()
        phase_dryrun(torch)
        gc.collect()
        torch.cuda.empty_cache()
        # mamba2-1.3b, zamba2-2.7b and whisper-small training at full width
        # and depth, dbrx-132b at full width and 2 of its 40 layers
        trains = [train, compressed, sharded, *train_families(torch)]
        # the latency model's calibration lane and the bridge
        phase_calibrate(torch)
        # the paper's five saturation modes, every tile program
        phase_modes(torch)
        gc.collect()
        torch.cuda.empty_cache()
        timer = Timer(torch)
        bridge_rows = phase_bridge(torch, timer)
        del timer
        phase_examples()
        phase_verify(torch)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.communicate()
    train = {}
    for paths in trains:
        for name, n in paths.items():
            train[name] = train.get(name, 0) + n
    steps = {"prefill": {}, "decode": {}, "train": train}
    for paths in (dense, ssm, hybrid, moe, piped, vlm, encdec, train,
                  opsd, *new_serves.values(), F32_FLASH_LAUNCHES):
        for name, n in paths.items():
            launches[name] = launches.get(name, 0) + n
    for paths in (dense_steps, ssm_steps, hybrid_steps, moe_steps,
                  {"prefill": piped}, vlm_steps, encdec_steps,
                  *new_steps.values()):
        for step, counts in paths.items():
            for name, n in counts.items():
                steps[step][name] = steps[step].get(name, 0) + n
    kernels = []
    extra = ("device_ms", "compiled", "shapes", "bound_cuda_core_ms",
             "nearest_call_ms", "mma_sync_ms", "device_ms_by_kernel",
             "bitwise_repeat", "norm_rel_err", "norm_rel_err_vs_f64",
             "scratch_bytes", "in_turns", "kernels", "in_turns_vs_mma_sync",
             "mma_sync_max_abs_err", "mma_sync_norm_rel_err", "build",
             "kind", "cases", "tf32_unit", "mma_sync_device_ms_by_kernel",
             "cuda_cores_ms", "in_turns_vs_cuda_cores",
             "cuda_cores_max_abs_err", "cuda_cores_norm_rel_err")
    for name, r in rows.items():
        src = os.path.basename(r["source"])
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches[name],
                        "launches_prefill": steps["prefill"].get(name, 0),
                        "launches_decode": steps["decode"].get(name, 0),
                        "launches_train": train.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        # tensor-core instructions by kernel (CUDA routes)
                        "sass": {k: n for k, n in tensor_core[src].items()
                                 if k.startswith(SASS_PREFIX.get(name, ""))}
                        if src in tensor_core else None,
                        **{k: r[k] for k in extra if k in r}})
    for name, r in bridge_rows.items():
        kernels.append({"name": name, **r,
                        "launches_prefill": 0, "launches_decode": 0,
                        "launches_train": 0, "sass": None})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--cache-child":
        sys.exit(cache_child(sys.argv[2], "--no-cache" not in sys.argv))
    if len(sys.argv) > 2 and sys.argv[1] == "--dryrun-child":
        sys.exit(dryrun_child(sys.argv[2]))
    # the saturator breaks ties between equal-cost terms in hash order, so
    # the emitted tile kernels (and their rounding) follow PYTHONHASHSEED:
    # one fixed seed gives every run the same kernels
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
