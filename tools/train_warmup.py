#!/usr/bin/env python3
"""Train one model on one NVIDIA GPU at several warmup lengths.

    python3 tools/train_warmup.py [--arch mamba2-1.3b] [--warmup 1 3 6]
        [--lr LR] [--moment-dtype f32|bf16|int8]

Runs ``chip_smoke.phase_train`` with the arch's train phase spec (full
width, B 2 x S 4096, bf16 weights, remat, 6 steps; minitron-4b 8 steps
at 16 layers, dbrx-132b at 2 layers, mistral-large-123b at 3 layers and
12 steps), its lr and moments unless ``--lr`` or ``--moment-dtype`` name
others, once per ``--warmup``, each from the same seeded weights and
batches, and prints each run's line:
its losses, the loss of step 1's batch after step 1, and whether the
loss falls after its peak (the phase's gate, reported here, not
enforced). Shows whether a warmup, an lr or a moment dtype removes the
early rise of the loss that the train phases show.

Prints the card's name and power limit, then one JSON object per run.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b",
                    choices=("minitron-4b", "mamba2-1.3b", "zamba2-2.7b",
                             "whisper-small", "dbrx-132b", "qwen2-vl-2b",
                             "mistral-large-123b"))
    ap.add_argument("--warmup", type=int, nargs="+", default=[1, 3, 6])
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--moment-dtype", default=None,
                    choices=("f32", "bf16", "int8"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_warmup: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        ROOT, "src", "repro_torch", "_build", "triton_cache"))
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    spec = {"minitron-4b": cs.TRAIN, "mamba2-1.3b": cs.TRAIN_MAMBA,
            "zamba2-2.7b": cs.TRAIN_ZAMBA, "whisper-small": cs.TRAIN_WHISPER,
            "dbrx-132b": cs.TRAIN_DBRX, "qwen2-vl-2b": cs.TRAIN_QWEN,
            "mistral-large-123b": cs.TRAIN_LARGE}[args.arch]
    if args.lr is not None:
        spec = dict(spec, lr=args.lr)
    if args.moment_dtype is not None:
        spec = dict(spec, moment_dtype=args.moment_dtype)
    for w in args.warmup:
        try:
            cs.phase_train(torch, dict(spec, warmup=w),
                           f"train_warmup_{w}")
        except AssertionError:
            pass        # the phase printed its line; the gate is reported
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    # as chip_smoke.py: a fixed seed, so the tile kernels are the same
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
