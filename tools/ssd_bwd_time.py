#!/usr/bin/env python3
"""Time the port's SSD backward on one NVIDIA GPU, launch by launch.

    python3 tools/ssd_bwd_time.py [--src DIR]

Builds ``ssd_scan.cu`` of the tree at ``--src`` (default: this checkout's
``src``), prints what ptxas reported for the backward's kernels and their
HMMA counts, then times ``ssd_scan_bwd`` at ``chip_smoke.py``'s timed
shapes (``SSD_BWD_TIMED``: mamba2-1.3b's and zamba2-2.7b's train shapes,
f32, chunk 128): ``chip_smoke.Timer`` medians (L2 flushed, a device sleep
before the start event) and the profiler's device time of each launch
(``SSD_BWD_LAUNCHES``). Run it on two trees in one call to compare them
on one card. Prints the card's name and power limit, then one JSON
object per line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (SSD_BWD_TIMED, Timer, _ptxas_by_kernel,
                            _tensor_core_counts)
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import ssd_scan as ss
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib_path = cuda_build.build("ssd_scan.cu")[0]
    with open(f"{lib_path}.log") as f:
        ptxas = _ptxas_by_kernel(f.read())
    _emit({"src": args.src, "torch": torch.__version__,
           "ptxas": {k: v for k, v in ptxas.items() if "ssd_bwd" in k},
           "sass": {k: v for k, v in _tensor_core_counts(lib_path).items()
                    if "ssd_bwd" in k}})
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (b, s, h, p, n), key in SSD_BWD_TIMED.items():
        xs = (torch.randn((b, s, h, p), generator=g, device="cuda"),
              torch.rand((b, s, h), generator=g, device="cuda") * 0.29 + 0.01,
              torch.log(torch.arange(1, h + 1, device="cuda",
                                     dtype=torch.float32)),
              torch.randn((b, s, n), generator=g, device="cuda") * 0.3,
              torch.randn((b, s, n), generator=g, device="cuda") * 0.3,
              torch.randn((h,), generator=g, device="cuda"))
        dy = torch.randn((b, s, h, p), generator=g, device="cuda")
        states = ss.ssd_scan_with_states(*xs, chunk=128)[2]

        def run(xs=xs, dy=dy, states=states):
            return ss.ssd_scan_bwd(*xs, dy, states, chunk=128)

        _emit({"timed": key or "mamba2", "shape": [b, s, h, p, n],
               "ms": timer.ms(run), "device_ms": timer.device_ms(run, "ssd_"),
               "device_ms_by_kernel": {
                   name: timer.device_ms(run, name)
                   for name in ss.SSD_BWD_LAUNCHES}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
