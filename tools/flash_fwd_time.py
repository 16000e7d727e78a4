#!/usr/bin/env python3
"""Check and time the port's flash-attention forward on one NVIDIA GPU.

    python3 tools/flash_fwd_time.py [--src DIR] [--dtype float32]
                                    [--check-only]

Runs ``chip_smoke.py``'s bf16 forward rows (``_flash_fwd_rows``: every
forward case against the plain version at ``chip_smoke.py``'s limits,
and at the timed shapes the kernel's card and device ms, the mma.sync
kernel held against the plain version and timed in turns, SDPA's time,
the bound, registers, spills and tensor-core counts) with the
``repro_torch`` of the tree at ``--src`` (default: this checkout's
``src``), which builds its own kernels. Then it times a prefill mix of
``VARIED_CALLS`` prompt lengths, each new to the process, through
``flash_attention`` as a server calls it (minitron-4b's heads): host
wall ms of the whole mix, once cold and once again with the same
lengths, so that any per-shape host work shows as cold minus warm.

With ``--dtype float32`` it runs the f32 forward instead
(``_flash_f32_rows``: every ``FLASH_F32_EDGES`` case with the lse
against the plain version, then at ``FLASH_F32_FWD`` and, with the lse,
``FLASH_F32_TRAIN`` the kind the dispatch picks (3xTF32 ``wgmma`` at
head_dim 64, 80 and 128) timed in turns against the CUDA-core kernel,
SDPA's f32 time as the library's, the bound at 3xTF32 and by bytes),
after the ptxas report and tensor-core counts of the f32 forward
kernels. ``--check-only`` stops after the checks. Run it on two trees in
one call to compare them on one card. Prints the card's name and power
limit, then one JSON object per line; exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIED_CALLS = 48
VARIED_HEADS = (1, 24, 8, 128)   # B, H, KH, D: minitron-4b's prefill


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _varied_prefill(torch, fa, seed=0):
    """Host wall ms of ``VARIED_CALLS`` causal forwards at distinct
    lengths in [64, 2048] (seeded), cold then warm, synchronised once at
    the end of each pass."""
    import numpy as np
    B, H, KH, D = VARIED_HEADS
    lengths = np.random.default_rng(seed).choice(
        np.arange(64, 2049), VARIED_CALLS, replace=False).tolist()
    g = torch.Generator(device="cuda").manual_seed(seed)
    ops = [tuple(torch.randn((B, n, S, D), generator=g, device="cuda")
                 .to(torch.bfloat16) for n in (H, KH, KH))
           for S in lengths]
    out = {"shape": [B, H, KH, "S", D], "lengths": lengths}
    for name in ("cold_ms", "warm_ms"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q, k, v in ops:
            fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_time: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (Timer, _flash_build_info, _flash_f32_rows,
                            _flash_fwd_rows, _randn_from)
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    checks = []
    if args.dtype == "float32":
        _emit({"src": args.src, "torch": torch.__version__,
               "cuda": torch.version.cuda,
               "build": {k: v for k, v in _flash_build_info(
                   "flash_fwd_").items() if "f32" in k}})
        rows = _flash_f32_rows(torch, F, Timer(torch), checks,
                               timed=not args.check_only,
                               ways=("forward",))
        failed = [c for c in checks if not c["ok"]]
        _emit({"checks": len(checks), "failed": failed})
        for r in rows.values():
            for key, row in {"row": r, **r.pop("shapes")}.items():
                _emit({"timed": key, **{k: v for k, v in row.items()
                                        if k not in ("source", "replaces",
                                                     "route")}})
        return 1 if failed else 0
    row = _flash_fwd_rows(torch, F, Timer(torch), _randn_from(torch, 0),
                          _randn_from(torch, 23), checks)
    failed = [c for c in checks if not c["ok"]]
    _emit({"src": args.src, "torch": torch.__version__,
           "cuda": torch.version.cuda, "checks": len(checks),
           "failed": failed})
    for key, r in {"prefill": row, **row.pop("shapes")}.items():
        r.pop("route", None)
        _emit({"timed": key, **{k: v for k, v in r.items()
                                if k not in ("source", "replaces")}})
    _emit({"varied_prefill": _varied_prefill(torch, fa)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
