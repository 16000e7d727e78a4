#!/usr/bin/env python3
"""Check and time the port's SSD backward on one NVIDIA GPU, by kind and
launch by launch.

    python3 tools/ssd_bwd_time.py [--src DIR] [--check-only]

Builds ``ssd_scan.cu`` of the tree at ``--src`` (default: this checkout's
``src``) and runs ``chip_smoke.py``'s ``_ssd_bwd_rows``: at every case of
``SSD_BWD_CASES`` the kind the dispatch takes (``ssd_bwd_kind``) and the
kernels a call launches, the six gradients against the plain version
(f32, 2e-4 norm-relative), two calls bitwise equal, each launch's device
ms; unless ``--check-only``, at the timed shapes (``SSD_BWD_TIMED``:
mamba2-1.3b's and zamba2-2.7b's train shapes, f32, chunk 128) also the
f64 check, the ``mma_sync`` kind checked and timed in turns beside the
dispatched one, and the call's time, and ``SSD_BWD_LONG``: the backward
at chunk 256 (128-step sub-chunks from recomputed states) checked against
the plain backward at 256 and timed in turns against chunk 128. Then the build's registers, spills,
HMMA and HGMMA of the backward's kernels and the TF32 unit product
(``_tf32_unit``). Times are ``chip_smoke.Timer`` medians (L2 flushed, a
device sleep before the start event) and the profiler's device time of
each launch. Run it on two trees in one call to compare them on one
card. Prints the card's name and power limit, then one JSON object per
line; exits non-zero if a check fails.
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
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ssd_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import Timer, _ssd_bwd_rows
    from repro_torch.kernels import cuda_build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_build.build("ssd_scan.cu")
    _emit({"src": args.src, "torch": torch.__version__,
           "cuda": torch.version.cuda})
    checks = []
    g = torch.Generator(device="cuda").manual_seed(0)
    row = _ssd_bwd_rows(torch, F, Timer(torch), g, checks,
                        timed=not args.check_only)
    for c in checks:
        _emit({"check": c})
    for case in row.pop("cases"):
        _emit({"case": case})
    _emit({"row": row})
    return 0 if all(c["ok"] for c in checks) else 1


if __name__ == "__main__":
    sys.exit(main())
