#!/usr/bin/env python3
"""Time the port's tile kernels on one NVIDIA GPU, as a tree plans them,
and try other launch plans of the same emitted kernels.

    python3 tools/tile_time.py [--src DIR] [--variants] [--tanh]
                               [--only TAG ...]

For each case (the router softmax at dbrx's prefill (32, 64, 16), its
decode tick (4, 1, 16) and arctic's width (2048, 128); layernorm at
whisper's (2048, 768), (4, 768) and a ragged (37, 768); rmsnorm at 2048
rows of 3072, 2560, 6144 and 1536 and 4 rows of 3072 and 1536;
rmsnorm_gated at 4 and 2048 rows of 4096 and 2048 of 5120; the softmax
program at (2048, 4096); and the elementwise programs at their paths'
shapes: gelu (bf16) at whisper's (2048, 3072) and (4, 3072), swiglu
(bf16) at minitron's serve (2048, 9216) and train (8192, 9216) rows, and
the optimizer's f32 kernels at minitron's embedding (256000, 3072) and an
MLP leaf (3072, 9216): adamw, l2_clip, and l2_clip of a bf16 gradient
into f32) and each form (sync, pipelined), it checks the kernel against
its plain version and reports the tree's plan (block, pieces or the flat
plan's form, grid, warps), the CUDA-event time, the profiler's device
time, the bytes bound, one PyTorch call's time under the same timer and,
for the sync form, the kernel and that call in turns. Run it on two trees
in one call to compare them on one card. A tree whose l2_clip cannot
write f32 from a bf16 gradient times the optimizer's path there: the
cast, then the f32 kernel (``"call"``).

``--variants`` also launches each reduction case's sync kernel under
other plans: rows a program, warps, and the layout (column pieces, or one
masked block of ``next_pow2(d)``, as the tree before pieces planned it),
and some cases' pipelined kernel as a persistent walk of such blocks; and
each elementwise case's sync kernel under other flat plans (a tree with
the flat plan): 16-byte vectors a thread, warps, and one program per
block or a persistent grid of some programs per SM. Each variant is
checked against the plain version and timed the same way, twice, in two
passes over all variants.

``--tanh`` times each gelu case's sync kernel, under the tree's plan,
with its tanh written in two forms: through ``tl.exp`` and ``/``, and as
inline PTX on the MUFU (ex2 and rcp, flushed to zero); each checked
against the plain version, with its PTX's divisions and MUFU ops, and
the two timed in turns.

The last line counts the profiler sessions and the launches they
recorded (``chip_smoke.Timer.profiler``).

Times are ``chip_smoke.Timer`` medians (L2 flushed, device sleep before
the start event). Prints the card's name and power limit, then one JSON
object per line.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import re
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
    for tag, rows in (("swiglu", 2048), ("swiglu_train", 8192)):
        cases[tag] = ("swiglu", (randn(rows, 9216, dtype=bf),
                                 randn(rows, 9216, dtype=bf)), {}, None)
    clip = {"norm": 3.0, "max_norm": 1.0, "eps": 1e-9}
    scale = min(1.0, clip["max_norm"] / (clip["norm"] + clip["eps"]))
    for size, shape in (("embedding", (256000, 3072)),
                        ("mlp", (3072, 9216))):
        grad = randn(*shape)
        cases[f"l2_clip_{size}"] = ("l2_clip", (grad,), clip,
                                    lambda x=grad: torch.mul(x, scale))
        gb = grad.bfloat16()
        cases[f"l2_clip_bf16_{size}"] = (
            "l2_clip", (gb,), clip, lambda gb=gb: gb.float().mul_(scale),
            torch.float32)
        xs = [randn(*shape) for _ in range(4)]
        xs[3] = xs[3].abs() * 0.01
        cases[f"adamw_{size}"] = (
            "adamw", tuple(xs), {"lr": 3e-4, "b1": 0.9, "b2": 0.95,
                                 "eps": 1e-8, "wd": 0.1, "inv_bc1": 10.0,
                                 "inv_bc2": 20.0}, None)
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
# (16-byte vectors a thread, warps, programs per SM or None for one
# program per block) tried on the flat plan's sync kernel
FLAT_VARIANTS = [(v, w, per_sm) for v in (1, 2, 4) for w in (4, 8)
                 for per_sm in (None, 4)] + [
    (2, 4, per_sm) for per_sm in (1, 2, 8)]
FLAT_CASES = ("gelu", "swiglu", "swiglu_train", "l2_clip_embedding",
              "l2_clip_mlp", "l2_clip_bf16_embedding", "adamw_mlp")


def _err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _plan_dict(plan):
    flat = getattr(plan, "flat", None)
    return {"block_r": plan.block_r, "block_d": plan.block_d,
            "pieces": list(getattr(plan, "pieces", ())),
            "grid": list(plan.grid), "num_warps": plan.num_warps,
            "persistent": getattr(plan, "persistent", None),
            "flat": dataclasses.asdict(flat) if flat else None}


def _takes(fn, name):
    return name in inspect.signature(fn).parameters


def _call(op, xs, sc, out_dtype):
    """The op on a case's operands, and what it launches: the kernel, or,
    where the tree's op cannot write ``out_dtype`` from these operands,
    the cast to it and then the kernel."""
    if out_dtype is None:
        return (lambda: op.apply(*xs, **sc)), "kernel"
    if _takes(op.apply, "out_dtype"):
        return (lambda: op.apply(*xs, out_dtype=out_dtype, **sc)), "kernel"
    return (lambda: op.apply(*(x.to(out_dtype) for x in xs), **sc)), \
        "cast_then_kernel"


def _plan(op, xs, out_dtype):
    """The tree's plan of the call (a tree before the plan took dtypes
    plans from the shapes alone)."""
    from repro_torch.core.tritongen import plan_tile_call
    shapes = [a.shape for a in xs]
    if not _takes(plan_tile_call, "in_dtypes"):
        return plan_tile_call(op.tk, shapes)
    return plan_tile_call(op.tk, shapes, [a.dtype for a in xs], out_dtype)


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
    ap.add_argument("--tanh", action="store_true")
    ap.add_argument("--only", nargs="*", default=None,
                    help="time only these cases")
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
    from chip_smoke import Timer, _in_turns
    from repro_torch.roofline.kernel_work import tile_bound
    from repro_torch.kernels.tile_programs import get_tile_op

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = Timer(torch)
    src = os.path.relpath(args.src, ROOT)
    cases = {tag: (*case, None)[:5]
             for tag, case in _cases(torch, F).items()
             if args.only is None or tag in args.only}
    for tag, (name, xs, sc, lib, out_dtype) in cases.items():
        dtype = str(xs[0].dtype)[6:]
        row = {"src": src, "case": tag, "program": name, "dtype": dtype,
               "out_dtype": str(out_dtype or xs[0].dtype)[6:],
               "shape": [list(a.shape) for a in xs],
               "bound_ms": tile_bound(get_tile_op(name), xs, out_dtype)[0],
               "library_ms": timer.ms(lib) if lib is not None else None}
        want = _want(name, xs, sc, out_dtype)
        tol = TOL[str(out_dtype or xs[0].dtype)[6:]]
        for form, emitter in (("sync", None),
                              ("pipelined", "triton_pipelined")):
            op = get_tile_op(name, emitter=emitter)
            run, row["call"] = _call(op, xs, sc, out_dtype)
            err = _err(run(), want)
            if not err <= tol * (1 + _amax(want)):
                raise AssertionError(f"{tag}/{form}: max abs error {err}")
            row[form] = {
                "plan": _plan_dict(_plan(op, xs, out_dtype)),
                "max_abs_err": err, "ms": timer.ms(run),
                "device_ms": timer.device_ms(run, op.tk.kernel_name)}
            if form == "sync" and lib is not None:
                row[form]["in_turns"] = _in_turns(timer, run, lib)
        del want
        print(json.dumps(row), flush=True)
    if args.variants:
        for rep in range(2):
            for tag, (name, xs, sc, _, out_dtype) in cases.items():
                for emitter, table in ((None, SYNC_VARIANTS),
                                       ("triton_pipelined", PIPE_VARIANTS)):
                    for br, warps in table.get(tag, ()):
                        for pieces in (True, False):
                            _variant(torch, timer, src, tag, rep, name, xs,
                                     sc, emitter, br, warps, pieces)
                if tag in FLAT_CASES:
                    for variant in FLAT_VARIANTS:
                        _flat_variant(timer, src, tag, rep, name, xs, sc,
                                      out_dtype, *variant)
    if args.tanh:
        for tag, (name, xs, sc, _, _) in cases.items():
            if name == "gelu":
                _tanh_forms(timer, src, tag, xs)
    print(json.dumps({"src": src, "profiler": timer.profiler}), flush=True)
    return 0


def _amax(t):
    t = t if isinstance(t, tuple) else (t,)
    return max(x.float().abs().max().item() for x in t)


def _want(name, xs, sc, out_dtype=None):
    """The plain version (on operands cast to f32 where the kernel
    writes another dtype than the lead's)."""
    from repro_torch.kernels.tile_programs import get_tile_op
    if out_dtype is not None:
        xs = [a.float() for a in xs]
    return get_tile_op(name).torch_ref(
        *(a.expand(xs[0].shape) for a in xs), **sc)


def _flat_variant(timer, src, tag, rep, name, xs, sc, out_dtype, vectors,
                  warps, per_sm):
    """Check and time one flat plan of one elementwise case's sync
    kernel (a tree with the flat plan only): the tree's plan with
    ``vectors`` 16-byte vectors a thread at ``warps`` warps, and one
    program per block or ``per_sm`` programs an SM."""
    from repro_torch.core import tritongen
    from repro_torch.kernels.tile_programs import get_tile_op
    if not hasattr(tritongen, "flat_plan"):
        return
    op = get_tile_op(name)
    plan, ins, outs = tritongen.prepare_tile_call(op.tk, xs, name,
                                                  out_dtype)
    # elements of a 16-byte vector, as the tree sized its block
    vec = plan.block_d // (plan.num_warps * 32 * tritongen.FLAT_VECTORS)
    block = warps * 32 * vectors * vec
    n = plan.rows * plan.d
    n_blocks = -(-n // block)
    cap = per_sm * tritongen.H100_SXM.sm_count if per_sm else n_blocks
    vp = dataclasses.replace(
        plan, block_d=block, n_blocks=n_blocks, num_warps=warps,
        grid=(min(n_blocks, cap),), persistent=n_blocks > cap,
        flat=tritongen.FlatLayout(tail=n % block != 0,
                                  off64=n_blocks * block > 2 ** 31))
    kern = op.tk.compiled(vp.layout)
    svals = [float(sc[s]) for s in op.tk.scalars]

    def run():
        tritongen.launch_tile_kernel(kern, vp, ins, outs, svals)
        return outs[0] if len(outs) == 1 else tuple(outs)

    want = _want(name, xs, sc, out_dtype)
    err = _err(run(), want)
    tol = TOL[str(outs[0].dtype)[6:]]
    print(json.dumps({
        "src": src, "case": tag, "rep": rep, "form": "sync",
        "variant": {**_plan_dict(vp), "vectors": vectors,
                    "per_sm": per_sm}, "max_abs_err": err,
        "ok": err <= tol * (1 + _amax(want)),
        "ms": timer.ms(run),
        "device_ms": timer.device_ms(run, op.tk.kernel_name)}), flush=True)


# gelu's tanh in the two forms --tanh compares: through tl.exp and "/",
# and as inline PTX on the MUFU, tanh(x) = 1 - 2 / (2^(2 log2(e) x) + 1)
# with ex2 and rcp flushed to zero ("{0}": the argument)
_TANH_PTX = ("{ .reg .f32 t; mul.f32 t, $1, 0f4038AA3B; "
             "ex2.approx.ftz.f32 t, t; add.f32 t, t, 0f3F800000; "
             "rcp.approx.ftz.f32 t, t; fma.rn.f32 $0, t, 0fC0000000, "
             "0f3F800000; }")
TANH_FORMS = {
    "exp_div": "(1.0 - 2.0 / (tl.exp(2.0 * {0}) + 1.0))",
    "mufu_asm": ("tl.inline_asm_elementwise(" + repr(_TANH_PTX)
                 + ", '=r,r', [{0}], dtype=tl.float32, is_pure=True, "
                   "pack=1)"),
}
# either form in an emitted source, its argument in group 1 or 2
_TANH_EXPR = re.compile(
    r"\(1\.0 - 2\.0 / \(tl\.exp\(2\.0 \* (\w+)\) \+ 1\.0\)\)"
    r"|tl\.inline_asm_elementwise\('[^']*', '=r,r', \[(\w+)\], "
    r"dtype=tl\.float32, is_pure=True, pack=1\)")


def _tanh_forms(timer, src, tag, xs):
    """gelu's sync kernel under the tree's plan with each of
    :data:`TANH_FORMS` in place of the tanh the tree emits: checked,
    timed, its PTX's math ops counted, and the two timed in turns
    (``kernel``: the MUFU form, ``library``: the exp and "/" form)."""
    from chip_smoke import _in_turns, _kernel_info
    from repro_torch.core import tritongen
    from repro_torch.kernels.tile_programs import get_tile_op
    op = get_tile_op("gelu")
    plan, ins, outs = tritongen.prepare_tile_call(op.tk, xs, "gelu")
    source = op.tk.render(*plan.layout)
    want = _want("gelu", xs, {})
    row = {"src": src, "case": tag, "tanh": {}}
    runs = {}
    for form, fmt in TANH_FORMS.items():
        text, n = _TANH_EXPR.subn(
            lambda m: fmt.replace("{0}", m.group(1) or m.group(2)), source)
        if n == 0:
            raise AssertionError(f"{tag}: no tanh in the emitted source")
        kern = tritongen._import_kernel(text, op.tk.kernel_name)
        out = [outs[0].clone()]

        def run(kern=kern, out=out):
            return tritongen.launch_tile_kernel(kern, plan, ins, out, [])

        info = _kernel_info(run())
        err = _err(out[0], want)
        if not err <= TOL[str(xs[0].dtype)[6:]] * (1 + _amax(want)):
            raise AssertionError(f"{tag}/{form}: max abs error {err}")
        runs[form] = run
        row["tanh"][form] = {
            "max_abs_err": err, "math": info["math"],
            "registers": info["registers"], "ms": timer.ms(run),
            "device_ms": timer.device_ms(run, op.tk.kernel_name)}
    row["mufu_over_exp_div"] = _in_turns(timer, runs["mufu_asm"],
                                         runs["exp_div"])
    print(json.dumps(row), flush=True)


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
