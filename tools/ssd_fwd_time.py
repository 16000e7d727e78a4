#!/usr/bin/env python3
"""Check and time the port's SSD forward on one NVIDIA GPU, by kind and
launch by launch.

    python3 tools/ssd_fwd_time.py [--src DIR] [--check-only]

Prints the card's name and power limit first. Builds ``ssd_scan.cu`` of
the tree at ``--src`` (default: this checkout's ``src``; a tree whose
``kernels.ssd_scan`` has ``ssd_fwd_kind``) and runs ``chip_smoke.py``'s
``_ssd_fwd_rows``: at every case of ``SSD_FWD_CASES`` (the serve shapes,
ragged S, S below a chunk, one step, one and five chunks) and
``SSD_FWD_TRAIN`` (mamba2-1.3b's and zamba2-2.7b's train shapes with the
chunk states) the kind the dispatch takes (``ssd_fwd_kind``) and the
kernels a call launches, each kind's y, final state and chunk states
against the plain versions (f32, 2e-4), two calls bitwise equal; unless
``--check-only``, at the timed shapes (``SSD_FWD_TIMED`` and the train
shapes) also the call's card and device ms, the device ms of each launch,
the ``mma_sync`` kind timed in turns beside the dispatched one and its
device ms by launch, the scratch bytes, the bound and the plain version's
time. Then the build's registers, spills, HMMA and HGMMA of the forward's
kernels. Times are ``chip_smoke.Timer`` medians (L2 flushed, a device
sleep before the start event) and the profiler's device time of each
launch. Run it on two trees in one call to compare them on one card.
Prints one JSON object per line after the card's line; exits non-zero if
a check fails.
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
    if not torch.cuda.is_available():
        print("ssd_fwd_time: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from chip_smoke import Timer, _randn_from, _ssd_fwd_rows
    from repro_torch.kernels import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build("ssd_scan.cu")
    _emit({"src": args.src, "torch": torch.__version__,
           "cuda": torch.version.cuda})
    checks = []
    row = _ssd_fwd_rows(torch, Timer(torch), _randn_from(torch, 0), checks,
                        timed=not args.check_only)
    for c in checks:
        _emit({"check": c})
    _emit({"row": row})
    return 0 if all(c["ok"] for c in checks) else 1


if __name__ == "__main__":
    sys.exit(main())
