#!/usr/bin/env python3
"""Calibrate the saturator's latency model on one NVIDIA GPU.

    python3 tools/calibrate.py [--reps N] [--out FILE]

The port's lane of the JAX package's tile measurement
(``benchmarks/measure.py``: ``measure_tile_schedules`` and
``fit_profiles``). For each of the 13 tile programs it builds the sync
Triton op under the three statement orders (``"source"``, ``"bulk"``,
``"cost"``; the cost search priced with the committed H100 profile where
there is one, else with the analytic roofline), runs each on seeded
inputs uniform in [0.1, 1) on the card and holds it against its plain
version (f32, 2e-5), and times the three in turns, in rotating order,
each launch after an L2 flush, with CUDA events (median over ``--reps``).

Every program runs on the same element count: 8192 x 4096 (32 M
elements an array) where the row width is free, and the declared width
(8192 x 4096 / declared rows of it) where the program declares one; a declared broadcast row stays one row. At that
size a launch's few microseconds are under 5 % of the kernel. The time a
tile instance takes is the kernel's time x ``TILE_ELEMS`` / the elements
of an output, the unit of ``kernel_features`` (the features of the
order each Triton kernel was emitted from).

The ``"cost"`` rows are fitted (``fit_profile``, name
``h100_triton_sched``, ``measured_kind`` ``triton_compiled``), with each
program's three medians and its paired cost-vs-bulk percentage (the
median over reps of the per-rep difference) under
``fit["schedule_medians"]``. A fit with Spearman >= 0.8 and a MAPE below
the uncalibrated one's is promoted to
``experiments/device_profiles_torch/h100_triton_sched.json``; any other
goes under ``src/repro_torch/_build/``. ``--out`` writes the profile
there as well, whatever the outcome.

Triton and LLVM may reorder loads, so two orders can compile to one
binary: each row carries a hash of the kernel's SASS (``cuobjdump
-sass`` of its cubin, addresses and encodings dropped) and of its PTX
(debug lines dropped) under each schedule.

Prints the card's name and power limit, one JSON line per program and a
last JSON line with the fit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SCHEDULES = ("source", "bulk", "cost")
PROFILE_NAME = "h100_triton_sched"
MEASURED_KIND = "triton_compiled"
ROWS, WIDTH = 8192, 4096
TOL = 2e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def committed_profile():
    """Path of the committed H100 profile, or None."""
    from repro_torch.analysis.calibrate import profile_dir
    path = profile_dir() / f"{PROFILE_NAME}.json"
    return str(path) if path.exists() else None


def schedule_ops(name, profile=None, schedules=SCHEDULES):
    """The sync Triton op of ``name`` under each schedule; ``profile``
    prices the cost search. The process-wide saturation cache and
    verifier settings apply (``ops.set_saturation_cache``)."""
    from repro_torch.kernels.tile_programs import get_tile_op
    return {s: get_tile_op(name, schedule=s,
                           device_profile=profile if s == "cost" else None)
            for s in schedules}


def tile_inputs(torch, prog, rows=ROWS, width=WIDTH, seed=0):
    """Seeded inputs of ``prog`` on the card, uniform in [0.1, 1) as the
    reference's ``tile_inputs_for`` makes them: ``rows x width`` where
    the width is free, the same element count at a declared width, and
    a declared broadcast row as one row; every scalar 0.5."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    decl = next((a.shape[-1] for a in prog.arrays.values()
                 if a.role != "out" and a.shape and a.shape[0] != 1), None)
    d = decl or width
    n_rows = rows * width // d
    arrays = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        shape = (a.shape[-1],) if a.shape and a.shape[0] == 1 \
            else (n_rows, d)
        arrays.append(torch.rand(shape, generator=g, device="cuda")
                      * 0.9 + 0.1)
    return arrays, {s: 0.5 for s in prog.scalars}


def _hash_lines(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    import triton
    cand = os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def binary_hashes(ck):
    """Hashes of a compiled Triton kernel's SASS (instructions only:
    addresses, encodings and line markers dropped) and PTX (``.loc`` and
    ``.file`` debug lines dropped)."""
    ptx = [ln.strip() for ln in ck.asm["ptx"].splitlines()
           if ln.strip() and not ln.strip().startswith((".loc", ".file",
                                                        "//"))]
    out = {"ptx_sha": _hash_lines(ptx), "sass_sha": None, "sass_lines": None}
    tool = _cuobjdump()
    if tool is None:
        return out
    with tempfile.NamedTemporaryFile(suffix=".cubin") as f:
        f.write(ck.asm["cubin"])
        f.flush()
        sass = subprocess.run([tool, "-sass", f.name], capture_output=True,
                              text=True, check=True).stdout
    ins = []
    for ln in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
        if m:
            ins.append(m.group(1))
    out.update(sass_sha=_hash_lines(ins), sass_lines=len(ins))
    return out


def check_and_compile(torch, ops, arrays, scalars, hashes=True):
    """Each op against its plain version on ``arrays`` (max abs error),
    and (``hashes``) its compiled kernel's hashes, from one launch
    outside its counter."""
    from repro_torch.core.tritongen import (launch_tile_kernel,
                                            prepare_tile_call)
    errs, hashed = {}, {}
    for s, op in ops.items():
        plan, ins, outs = prepare_tile_call(op.tk, arrays, op.name)
        ck = launch_tile_kernel(op.tk.compiled(plan.layout), plan, ins, outs,
                                [float(scalars[k]) for k in op.tk.scalars])
        want = op.torch_ref(*arrays, **scalars)
        want = want if isinstance(want, tuple) else (want,)
        errs[s] = max(float((o - w).abs().max()) for o, w in zip(outs, want))
        if hashes:
            hashed[s] = binary_hashes(ck)
    return errs, hashed


def time_in_turns(torch, ops, arrays, scalars, reps, flush, warmup=2):
    """Milliseconds of each op's call per rep: the schedules in turns,
    their order rotating every rep, each launch after an L2 flush and a
    device sleep (so the events time the device, not the host)."""
    for _ in range(warmup):
        for op in ops.values():
            op.apply(*arrays, **scalars)
    order = list(ops)
    times = {s: [] for s in order}
    for rep in range(reps):
        rot = rep % len(order)
        for s in order[rot:] + order[:rot]:
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ops[s].apply(*arrays, **scalars)
            e1.record()
            e1.synchronize()
            times[s].append(e0.elapsed_time(e1))
    return times


def summarize(name, ops, arrays, times):
    """One program's timings: median ms per schedule, the bytes bound,
    the per-instance ns (``TILE_ELEMS`` / an output's elements of the
    kernel's time), the paired percentages against bulk, and the cost
    order's features."""
    from repro_torch.analysis import TILE_ELEMS, kernel_features
    lead = arrays[0].numel()
    n_out = len(ops["cost"].tk.out_arrays)
    nbytes = sum(a.numel() * a.element_size() for a in arrays) \
        + n_out * lead * arrays[0].element_size()
    med_ms = {s: statistics.median(t) for s, t in times.items()}

    return {
        "kernel": name, "shape": list(arrays[0].shape), "ms": med_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "measured_ns": {s: m * 1e6 * TILE_ELEMS / lead
                        for s, m in med_ms.items()},
        "cost_vs_bulk_paired_pct": statistics.median(
            100.0 * (c - b) / b for c, b in zip(times["cost"],
                                                times["bulk"])),
        "sources_differ": {s: ops[s].tk.source != ops["bulk"].tk.source
                           for s in ("source", "cost")},
        "features": kernel_features(
            ops["cost"].sk, schedule=ops["cost"].tk.schedule).to_dict(),
        "reps": len(times["bulk"])}


def measure_program(torch, name, reps, flush, profile=None):
    """One program's row: the three schedules checked against their
    plain versions, their binaries hashed, timed in turns."""
    ops = schedule_ops(name, profile)
    arrays, scalars = tile_inputs(torch, ops["cost"].sk.ssa.prog)
    errs, hashes = check_and_compile(torch, ops, arrays, scalars)
    if max(errs.values()) > TOL:
        raise AssertionError(f"{name}: kernel vs plain version {errs}")
    times = time_in_turns(torch, ops, arrays, scalars, reps, flush)
    return {**summarize(name, ops, arrays, times), "max_abs_err": errs,
            "binaries": hashes}


def fit_rows(rows, device_name):
    """The profile fitted on the cost rows, with the schedule medians,
    and whether it clears the promotion bar."""
    from repro_torch.analysis import (SPEARMAN_FLOOR, KernelFeatures,
                                      fit_profile)
    feats = [KernelFeatures.from_dict(r["features"]) for r in rows]
    meas = [r["measured_ns"]["cost"] for r in rows]
    prof = fit_profile(feats, meas, name=PROFILE_NAME, chip=device_name,
                       measured_kind=MEASURED_KIND)
    prof.fit["schedule_medians"] = {
        r["kernel"]: {**r["measured_ns"],
                      "cost_vs_bulk_paired_pct": r["cost_vs_bulk_paired_pct"]}
        for r in rows}
    prof.fit["schedule_mode"] = "cost"
    f = prof.fit
    ok = (f["spearman"] >= SPEARMAN_FLOOR
          and f["mape_pct"] < f["uncalibrated_mape_pct"])
    return prof, ok


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the fitted profile to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        SRC, "repro_torch", "_build", "triton_cache"))
    from repro_torch.analysis.calibrate import profile_dir
    from repro_torch.kernels.tile_programs import PROGRAMS
    print(card(), flush=True)
    profile = committed_profile()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for name in sorted(PROGRAMS):
        row = measure_program(torch, name, args.reps, flush, profile)
        rows.append(row)
        print(json.dumps(row), flush=True)
    prof, ok = fit_rows(rows, torch.cuda.get_device_name(0))
    dest = (profile_dir() if ok
            else os.path.join(SRC, "repro_torch", "_build"))
    path = prof.save(os.path.join(dest, f"{PROFILE_NAME}.json"))
    if args.out:
        prof.save(args.out)
    f = prof.fit
    print(json.dumps({
        "fit": PROFILE_NAME, "promoted": ok, "path": str(path),
        "cost_priced_by": profile or "analytic",
        "mape_pct": f["mape_pct"], "spearman": f["spearman"],
        "uncalibrated_mape_pct": f["uncalibrated_mape_pct"],
        "uncalibrated_spearman": f["uncalibrated_spearman"],
        "loss_msle": f["loss_msle"], "rounds": f["rounds"],
        "params": prof.params.to_dict(),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    # the saturator breaks ties between equal-cost terms in hash order:
    # one fixed seed gives every run chip_smoke.py's terms
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
