#!/usr/bin/env python3
"""Time the port's rotary tile kernel on one NVIDIA GPU, as a tree plans it.

    python3 tools/rotary_time.py [--src DIR]

Times rotary, sync and pipelined, as the tree at ``--src`` (default: this
checkout's ``src``) emits and plans it, at minitron-4b's prefill q
(4, 24, 512, 128) and k (4, 8, 512, 128), bf16, with f32 cos/sin
(1, 1, 512, 128), and at the decode tick's q and k (one position, one
cos/sin row). Run it on two trees in one call to compare them on one
card. Beside each shape it times two yardsticks under the same timer:
``copy_ms``, ``Tensor.copy_`` of q into a tensor of its shape (the same
bytes of q moved, without cos/sin), and ``floor_ms``, a one-element copy
(what one launch costs under this timer, whatever its bytes).
``device_ms`` beside a time is the profiler's duration of the kernel
itself (``chip_smoke.Timer.device_ms``). For each form it also reports
the launch plan, and the shared memory, registers and PTX access widths
of the kernel it compiled.

Times are ``chip_smoke.Timer`` medians (L2 flushed, device sleep before
the start event). Prints the card's name and power limit, then one JSON
object per line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(torch):
    g = torch.Generator(device="cuda").manual_seed(0)
    S = 512
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    inv = 1.0 / (10_000.0 ** (torch.arange(0, 128, 2, device="cuda")
                              / 128.0))
    ang = pos[:, None] * inv
    ang = torch.cat([ang, ang], -1)[None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)

    def q(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    return {"q": (q(4, 24, S, 128), cos, sin),
            "k": (q(4, 8, S, 128), cos, sin),
            "decode_q": (q(4, 24, 1, 128), cos[:, :, 7:8].contiguous(),
                         sin[:, :, 7:8].contiguous()),
            "decode_k": (q(4, 8, 1, 128), cos[:, :, 7:8].contiguous(),
                         sin[:, :, 7:8].contiguous())}


def _measure(torch, timer, op, args):
    want = op.torch_ref(*(a.expand(args[0].shape) for a in args))
    err = (op.apply(*args).float() - want.float()).abs().max().item()
    if not err <= 3e-2:
        raise AssertionError(f"{op.name}: max abs error {err}")
    return {"ms": timer.ms(lambda: op.apply(*args)), "max_abs_err": err}


def _plan(op, args):
    """The tree's launch plan of the op on these operands (a tree before
    the plan took dtypes plans from the shapes alone)."""
    from repro_torch.core.tritongen import plan_tile_call
    shapes = [a.shape for a in args]
    if "in_dtypes" in inspect.signature(plan_tile_call).parameters:
        return plan_tile_call(op.tk, shapes, [a.dtype for a in args])
    return plan_tile_call(op.tk, shapes)


def _compiled(op, args):
    """``chip_smoke._kernel_info`` of every kernel the op's Triton
    function compiled for these operands' layout (read from Triton's
    per-device kernel cache, so it works for any tree's emitter)."""
    from chip_smoke import _kernel_info
    plan = _plan(op, args)
    jit = op.tk.compiled(getattr(plan, "layout", plan.kinds))
    try:
        return [_kernel_info(ck) for cache in jit.device_caches.values()
                for ck in cache[0].values()]
    except (AttributeError, IndexError, KeyError, TypeError) as e:
        return f"not available ({type(e).__name__})"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rotary_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        ROOT, "src", "repro_torch", "_build", "triton_cache"))
    from chip_smoke import Timer
    from repro_torch.roofline.kernel_work import tile_bound
    from repro_torch.kernels.tile_programs import get_tile_op

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = Timer(torch)
    ops = {"sync": get_tile_op("rotary"),
           "pipelined": get_tile_op("rotary", emitter="triton_pipelined")}
    one = torch.zeros(1, device="cuda")
    for name, a in _inputs(torch).items():
        row = {"src": os.path.relpath(args.src, ROOT), "shape": name,
               "bound_ms": tile_bound(ops["sync"], a)[0]}
        for form, op in ops.items():
            plan = _plan(op, a)
            row[form] = _measure(torch, timer, op, a)
            row[form]["device_ms"] = timer.device_ms(
                lambda: op.apply(*a), "rotary_kernel")
            row[form]["plan"] = {"block_r": plan.block_r,
                                 "grid": list(plan.grid),
                                 "num_warps": plan.num_warps}
            row[form]["compiled"] = _compiled(op, a)
        dst = torch.empty_like(a[0])
        row["copy_ms"] = timer.ms(lambda: dst.copy_(a[0]))
        row["floor_ms"] = timer.ms(lambda: one.copy_(a[1][0, 0, 0, :1]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
