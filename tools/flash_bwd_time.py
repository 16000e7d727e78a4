#!/usr/bin/env python3
"""Check and time the port's flash-attention backward on one NVIDIA GPU.

    python3 tools/flash_bwd_time.py [--src DIR] [--dtype float32]
                                    [--check-only]

Builds ``flash_attention.cu`` of the tree at ``--src`` (default: this
checkout's ``src``), prints what ptxas reported for its backward kernels
and their tensor-core instruction counts (HMMA for ``mma.sync``, HGMMA
for ``wgmma``), then runs ``chip_smoke.py``'s bf16 backward cases
(``FLASH_BWD_CASES``: ``flash_attention_bwd`` against
``flash_attention_bwd_plain``, element-wise and norm-relative at
``chip_smoke.py``'s limits, two calls bitwise equal at the training
shapes). Unless ``--check-only``, it then times the backward at
``chip_smoke.py``'s timed shapes and causal flags (``FLASH_BWD_TIMED``),
beside the library's backward (autograd of ``scaled_dot_product_attention``)
and the ``mma.sync`` backward at the same shape (the library's
``flash_attention_bwd_bf16`` entry). Times are ``chip_smoke.Timer``
medians (L2 flushed, a device sleep before the start event);
``device_ms`` is the profiler's kernel time per call. Run it on two
trees in one call to compare them on one card.

With ``--dtype float32`` it runs the f32 backward instead: the f32 cases
of ``FLASH_BWD_CASES`` and ``FLASH_F32_EDGES`` against the plain version,
then (unless ``--check-only``) at ``FLASH_F32_TRAIN``, the training-parity
shapes, the kind the dispatch picks (3xTF32 ``wgmma`` at head_dim 64, 80
and 128) timed in turns against the CUDA-core kernels, each launch's
device ms, SDPA's f32 backward as the library's, the bound at 3xTF32 and
by bytes (``_flash_f32_rows``). Prints the card's name and power limit,
then one JSON object per line; exits non-zero if a check fails.
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (FLASH_BWD_CASES, FLASH_BWD_TIMED, Timer,
                            _flash_bwd_case, _flash_f32_rows, _mma_sync_bwd,
                            _ptxas_by_kernel, _sdpa, _tensor_core_counts)
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib_path = cuda_build.build("flash_attention.cu")[0]
    with open(f"{lib_path}.log") as f:
        ptxas = _ptxas_by_kernel(f.read())
    _emit({"src": args.src, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "ptxas": {k: v for k, v in ptxas.items() if "flash_bwd" in k},
           "sass": {k: v for k, v in _tensor_core_counts(lib_path).items()
                    if "flash_bwd" in k}})
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    ok = True
    for shape, dtype, causal in FLASH_BWD_CASES:
        if dtype != args.dtype:
            continue
        checks = []
        _, err, rel, same = _flash_bwd_case(torch, F, randn, shape, dtype,
                                            causal, checks)
        good = all(c["ok"] for c in checks)
        ok &= good
        _emit({"check": list(shape), "causal": causal, "ok": good,
               "max_abs_err": err, "norm_rel_err": rel,
               "bitwise_repeat": same})
    if args.dtype == "float32":
        checks = []
        rows = _flash_f32_rows(torch, F, Timer(torch), checks,
                               timed=ok and not args.check_only,
                               ways=("backward",))
        failed = [c for c in checks if not c["ok"]]
        ok &= not failed
        _emit({"f32_checks": len(checks), "failed": failed})
        for r in rows.values():
            for key, row in {"row": r, **r.pop("shapes")}.items():
                _emit({"timed": key, **{k: v for k, v in row.items()
                                        if k not in ("source", "replaces",
                                                     "route")}})
        return 0 if ok else 1
    if not ok or args.check_only:
        return 0 if ok else 1
    timer = Timer(torch)
    for (shape, causal), key in FLASH_BWD_TIMED.items():
        B, H, KH, S, D = shape
        q, k, v, do = (randn(B, n, S, D, dtype=torch.bfloat16)
                       for n in (H, KH, KH, H))
        o, lse = fa._launch_fwd(q, k, v, causal, None, with_lse=True)

        def run():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

        row = {"shape": list(shape), "causal": causal, "ms": timer.ms(run),
               "device_ms": timer.device_ms(run, "flash_bwd_"),
               "device_ms_by_kernel": {
                   name: timer.device_ms(run, name)
                   for name in ("flash_bwd_prep", "flash_bwd_delta",
                                "flash_bwd_dkdv", "flash_bwd_dq")},
               "mma_sync_ms": timer.ms(_mma_sync_bwd(torch, q, k, v, o, lse,
                                                     do, causal))}
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lo = _sdpa(F, lq, lk, lv, causal)()
        row["library_ms"] = timer.ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        _emit({"timed": key or "train", **row})
        del lo, lq, lk, lv
    return 0


if __name__ == "__main__":
    sys.exit(main())
