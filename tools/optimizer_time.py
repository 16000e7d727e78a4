#!/usr/bin/env python3
"""Time the port's optimizer step alone on one NVIDIA GPU, as a tree
runs it: ``apply_updates`` on minitron-4b's leaves at full width.

    python3 tools/optimizer_time.py [--src DIR] [--layers 16] [--steps 5]

The model is ``chip_smoke.py``'s train cut (16 of 32 layers, bf16 seeded
weights, the default OptConfig with f32 moments), its gradients bf16
(as autograd returns them for bf16 weights), seeded normal times 1e-3.
After two warm steps it times ``--steps`` steps with CUDA events (the
median) and traces one under torch.profiler: device ms by group (the
adamw and l2_clip kernels, the bf16 -> f32 and f32 -> bf16 casts, the
rest), launches, and how many l2_clip launches follow a bf16 -> f32 cast
directly. Run it on two trees in one call (``--src``) to compare them on
one card. Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("optimizer_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        ROOT, "src", "repro_torch", "_build", "triton_cache"))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (TRAIN, _cast_kernel_keys, _kernels_before,
                            _train_kernel_group)
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.common import reference_ndim
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=args.layers)
    params = LM(cfg, device="cuda").init(TRAIN["seed"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = T.tree_map(lambda p: (torch.randn(
        p.shape, generator=gen, device="cuda") * 1e-3).to(p.dtype), params)
    ocfg = OptConfig(warmup_steps=1, total_steps=100)
    state = init_opt_state(params, ocfg)

    def ndim(path, p):
        return reference_ndim(cfg, path, p)

    def step():
        apply_updates(params, grads, state, ocfg, ndim=ndim)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.steps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        step()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    casts = _cast_kernel_keys(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    groups, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = casts.get(e.key) or _train_kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        launches += e.count
    up = {k for k, g in casts.items() if g == "cast_bf16_f32"}
    after_cast, clips = _kernels_before(torch, prof, "l2_clip_kernel", up)
    leaves = T.leaves(params)
    print(json.dumps({
        "src": os.path.relpath(args.src, ROOT), "arch": cfg.name,
        "layers": args.layers, "leaves": len(leaves),
        "elements": sum(p.numel() for p in leaves),
        "step_ms": ms, "step_ms_median": statistics.median(ms),
        "device_ms": sum(groups.values()), "device_ms_by_group": groups,
        "device_launches": launches, "l2_clip_launches": clips,
        "l2_clip_after_a_cast": after_cast,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
