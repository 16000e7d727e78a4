#!/usr/bin/env python3
"""Time the port's row-reduction tile kernels on one NVIDIA GPU, as a tree
plans them, and try other launch plans of the same emitted kernels.

    python3 tools/tile_time.py [--src DIR] [--variants]

For each case (the router softmax at dbrx's prefill (32, 64, 16), its
decode tick (4, 1, 16) and arctic's width (2048, 128); layernorm at
whisper's (2048, 768), (4, 768) and a ragged (37, 768); rmsnorm at 2048
rows of 3072, 2560, 6144 and 1536 and 4 rows of 3072 and 1536;
rmsnorm_gated at 4 and 2048 rows of 4096 and 2048 of 5120; gelu at
(2048, 3072) and (4, 3072); the softmax program at (2048, 4096)) and each
form (sync, pipelined), it
checks the kernel against its plain version and reports the tree's plan
(block, pieces, grid, warps), the CUDA-event time, the profiler's device
time, the bytes bound and one PyTorch call's time under the same timer.
Run it on two trees in one call to compare them on one card.

``--variants`` also launches each reduction case's sync kernel under
other plans: rows a program, warps, and the layout (column pieces, or one
masked block of ``next_pow2(d)``, as the tree before pieces planned it),
and some cases' pipelined kernel as a persistent walk of such blocks.
Each variant is checked against the plain version and timed the same way,
twice, in two passes over all variants. The last line counts the profiler
sessions and the launches they recorded (``chip_smoke.Timer.profiler``).

Times are ``chip_smoke.Timer`` medians (L2 flushed, device sleep before
the start event). Prints the card's name and power limit, then one JSON
object per line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _cases(torch, F):
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    bf = torch.bfloat16
    cases = {}
    for tag, shape in (("router_prefill", (32, 64, 16)),
                       ("router_decode", (4, 1, 16)),
                       ("router_arctic", (2048, 128))):
        x = randn(*shape)
        cases[tag] = ("moe_router", (x,), {},
                      lambda x=x: torch.softmax(x, -1))
    for tag, rows in (("layernorm", 2048), ("layernorm_decode", 4),
                      ("layernorm_ragged", 37)):
        x, w, b = randn(rows, 768), randn(768), randn(768)
        cases[tag] = ("layernorm", (x, w, b), {"eps": 1e-6},
                      lambda x=x, w=w, b=b: F.layer_norm(x, (768,), w, b,
                                                         1e-6))
    for d in (3072, 2560, 6144, 1536):
        x, w = randn(2048, d), randn(d)
        cases[f"rmsnorm_{d}"] = ("rmsnorm", (x, w), {"eps": 1e-6},
                                 lambda x=x, w=w, d=d: F.rms_norm(
                                     x, (d,), w, 1e-6))
    for d in (3072, 1536):
        x, w = randn(4, d), randn(d)
        cases[f"rmsnorm_{d}_decode"] = ("rmsnorm", (x, w), {"eps": 1e-6},
                                        lambda x=x, w=w, d=d: F.rms_norm(
                                            x, (d,), w, 1e-6))
    cases["rmsnorm_gated_decode"] = (
        "rmsnorm_gated", (randn(4, 4096, dtype=bf), randn(4, 4096, dtype=bf),
                          randn(4096, dtype=bf)), {"eps": 1e-6}, None)
    for d in (4096, 5120):
        cases[f"rmsnorm_gated_{d}"] = (
            "rmsnorm_gated", (randn(2048, d, dtype=bf),
                              randn(2048, d, dtype=bf), randn(d, dtype=bf)),
            {"eps": 1e-6}, None)
    for tag, rows in (("gelu", 2048), ("gelu_decode", 4)):
        a = randn(rows, 3072, dtype=bf)
        cases[tag] = ("gelu", (a,), {},
                      lambda a=a: F.gelu(a, approximate="tanh"))
    x = randn(2048, 4096)
    cases["softmax_4096"] = ("softmax", (x,), {},
                             lambda x=x: torch.softmax(x, -1))
    return cases


# (rows a program, warps) tried under --variants: the sync kernel in both
# layouts, and the pipelined kernel's persistent walk in the tree's
SYNC_VARIANTS = {
    "router_prefill": [(2, 1), (4, 1), (8, 1), (16, 1)],
    "layernorm": [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 2),
                  (4, 4), (4, 8), (8, 8)],
    "layernorm_decode": [(1, 1), (1, 2), (1, 4), (2, 2), (4, 1), (4, 2),
                         (4, 4), (4, 8)],
    "rmsnorm_3072": [(1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (2, 8)],
    "rmsnorm_2560": [(1, 1), (1, 2), (1, 4), (1, 8), (2, 8)],
    "rmsnorm_6144": [(1, 2), (1, 4), (1, 8), (1, 16)],
    "rmsnorm_1536": [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4), (4, 4),
                     (4, 8)],
    "rmsnorm_3072_decode": [(1, 1), (1, 2), (1, 4), (1, 8), (2, 8), (4, 4)],
    "rmsnorm_gated_4096": [(1, 2), (1, 4), (1, 8), (2, 8)],
    "rmsnorm_gated_5120": [(1, 2), (1, 4), (1, 8)],
    "rmsnorm_gated_decode": [(1, 2), (1, 4), (1, 8), (2, 8), (4, 4)],
    "softmax_4096": [(1, 2), (1, 4), (1, 8), (2, 8)],
}
PIPE_VARIANTS = {
    "layernorm": [(1, 2), (2, 2), (2, 4), (4, 4), (8, 8)],
    "rmsnorm_3072": [(1, 2), (1, 4), (2, 4), (2, 8)],
    "rmsnorm_2560": [(1, 2), (1, 4), (2, 8)],
    "rmsnorm_1536": [(1, 2), (2, 2), (4, 4), (4, 8)],
}


def _err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _plan_dict(plan):
    return {"block_r": plan.block_r, "block_d": plan.block_d,
            "pieces": list(getattr(plan, "pieces", ())),
            "grid": list(plan.grid), "num_warps": plan.num_warps,
            "persistent": getattr(plan, "persistent", None)}


def _layout(plan):
    """The compiled kernel's key: ``plan.layout`` in a tree with column
    pieces, the operand kinds before."""
    return getattr(plan, "layout", plan.kinds)


def _variant_plan(plan, br, warps, pieces, persistent):
    """``plan`` with ``br`` rows a program at ``warps`` warps, in column
    pieces or in one masked block of next_pow2(d), as a persistent walk
    or one program per block."""
    from repro_torch.core import tritongen
    d = plan.d
    if pieces:
        pcs = tritongen._pow2_pieces(d)
        if len(pcs) > tritongen.MAX_PIECES:
            return None
        bd = d
    else:
        pcs, bd = (), tritongen._next_pow2(d)
    n_blocks = -(-plan.rows // br)
    grid = (min(n_blocks, tritongen.PROGRAMS_PER_SM
                * tritongen.H100_SXM.sm_count),) if persistent \
        else (n_blocks, 1)
    return dataclasses.replace(plan, block_r=br, block_d=bd, pieces=pcs,
                               grid=grid, n_blocks=n_blocks,
                               num_warps=warps, persistent=persistent)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("tile_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        ROOT, "src", "repro_torch", "_build", "triton_cache"))
    from chip_smoke import Timer, _tile_bound
    from repro_torch.core.tritongen import plan_tile_call
    from repro_torch.kernels.tile_programs import get_tile_op

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = Timer(torch)
    src = os.path.relpath(args.src, ROOT)
    cases = _cases(torch, F)
    for tag, (name, xs, sc, lib) in cases.items():
        dtype = str(xs[0].dtype)[6:]
        row = {"src": src, "case": tag, "program": name, "dtype": dtype,
               "shape": [list(a.shape) for a in xs],
               "bound_ms": _tile_bound(get_tile_op(name), xs)[0],
               "library_ms": timer.ms(lib) if lib is not None else None}
        want = _want(name, xs, sc)
        for form, emitter in (("sync", None),
                              ("pipelined", "triton_pipelined")):
            op = get_tile_op(name, emitter=emitter)
            err = _err(op.apply(*xs, **sc), want)
            if not err <= TOL[dtype] * (1 + want.float().abs().max().item()):
                raise AssertionError(f"{tag}/{form}: max abs error {err}")
            row[form] = {
                "plan": _plan_dict(plan_tile_call(op.tk, [a.shape
                                                          for a in xs])),
                "max_abs_err": err,
                "ms": timer.ms(lambda: op.apply(*xs, **sc)),
                "device_ms": timer.device_ms(lambda: op.apply(*xs, **sc),
                                             op.tk.kernel_name)}
        print(json.dumps(row), flush=True)
    if args.variants:
        for rep in range(2):
            for tag, (name, xs, sc, _) in cases.items():
                for emitter, table in ((None, SYNC_VARIANTS),
                                       ("triton_pipelined", PIPE_VARIANTS)):
                    for br, warps in table.get(tag, ()):
                        for pieces in (True, False):
                            _variant(torch, timer, src, tag, rep, name, xs,
                                     sc, emitter, br, warps, pieces)
    print(json.dumps({"src": src, "profiler": timer.profiler}), flush=True)
    return 0


def _want(name, xs, sc):
    from repro_torch.kernels.tile_programs import get_tile_op
    return get_tile_op(name).torch_ref(
        *(a.expand(xs[0].shape) for a in xs), **sc)


def _variant(torch, timer, src, tag, rep, name, xs, sc, emitter, br, warps,
             pieces):
    """Check and time one variant plan of one case's kernel."""
    from repro_torch.core.tritongen import (launch_tile_kernel,
                                            prepare_tile_call)
    from repro_torch.kernels.tile_programs import get_tile_op
    op = get_tile_op(name, emitter=emitter)
    plan, ins, outs = prepare_tile_call(op.tk, xs, name)
    vp = _variant_plan(plan, br, warps, pieces, emitter is not None)
    if vp is None:
        return
    kern = op.tk.compiled(_layout(vp))
    svals = [float(sc[s]) for s in op.tk.scalars]

    def run():
        launch_tile_kernel(kern, vp, ins, outs, svals)
        return outs[0]

    want = _want(name, xs, sc)
    err = _err(run(), want)
    tol = TOL[str(xs[0].dtype)[6:]]
    print(json.dumps({
        "src": src, "case": tag, "rep": rep,
        "form": "sync" if emitter is None else "pipelined",
        "variant": _plan_dict(vp), "max_abs_err": err,
        "ok": err <= tol * (1 + want.float().abs().max().item()),
        "ms": timer.ms(run),
        "device_ms": timer.device_ms(run, op.tk.kernel_name)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
