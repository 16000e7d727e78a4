#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout, checks each against its
plain PyTorch version at the main path's shapes, serves minitron-4b at
full width (32 layers, d_model 3072, vocab 256k, random seeded weights)
through the port's Server, and compares one full-width prefill through
the kernels with the same prefill through the plain versions. Each phase
prints one JSON line; the line before the last lists every kernel of the
path, and the last line is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # f32 outside the tensor cores
TILE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
# Last-position logits of the full-width prefill, kernels vs plain
# versions. Both run the same bf16 model; they differ only where values
# are rounded to bf16 (the kernels compute in f32 and round once; the
# plain swiglu rounds after every op, plain attention normalises before
# rounding). The logits have a std near 1 (unit-variance hidden state
# times an unembedding of std d^-0.5); a wrong head mapping, mask or
# rotation moves them by O(1), bf16 rounding over 32 layers by far less.
PARITY_TOL = 0.5

SERVE = dict(arch="minitron-4b", max_batch=4, requests=6, prompt_len=512,
             max_new=32, seed=0)


def emit(obj):
    print(json.dumps(obj), flush=True)


class Timer:
    """CUDA-event timing of one callable: median of ``iters`` launches,
    each after a write that evicts the 50 MB L2 (the path's operands
    arrive from other kernels, not from a warm cache of this one) and a
    1 ms device sleep, so that the host has enqueued the callable's
    kernels before the device reaches them and the events time the
    device, not the host's launch path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    from repro_torch.kernels.flash_attention import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton_version,
          "nvcc": nvcc.splitlines()[-1],
          "allow_tf32": {"matmul": False, "cudnn": False}})
    return smi


def phase_build():
    from repro_torch.kernels.flash_attention import build
    t0 = time.perf_counter()
    lib = build()
    secs = time.perf_counter() - t0
    with open(f"{lib}.log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "spill" in ln]
    emit({"phase": "build", "nvcc_s": secs, "library": os.path.relpath(
        lib, ROOT), "ptxas": ptxas})


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _check(name, got, want, tol, checks):
    """abs error and whether |got - want| <= tol * (1 + |want|)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, ok = 0.0, True
    for g, w in zip(got, want, strict=True):
        err = max(err, _err(g, w))
        ok &= bool(((g.float() - w.float()).abs()
                    <= tol * (1 + w.float().abs())).all())
        ok &= bool(g.isfinite().all())
    checks.append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok})
    return err


def phase_kernels(torch, timer):
    """Every kernel against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

    checks, rows = [], {}
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # all 13 generated tile kernels at a small, ragged shape (37 x 200)
    scal = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
            "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
            "bias": 0.1, "norm": 3.0, "max_norm": 1.0}
    for name in sorted(PROGRAMS):
        op = get_tile_op(name)
        prog = PROGRAMS[name]()
        for dt in (torch.float32, torch.bfloat16):
            xs = []
            for a in prog.arrays.values():
                if a.role == "out":
                    continue
                x = randn(200, dtype=dt) if a.shape == (1, 128) \
                    else randn(37, 200, dtype=dt)
                xs.append(x.abs() * 0.01 if a.name == "v" else x)
            sc = {s: scal[s] for s in prog.scalars}
            _check(f"{name}/{str(dt)[6:]}/37x200", op.apply(*xs, **sc),
                   op.torch_ref(*xs, **sc), TILE_TOL[str(dt)[6:]], checks)

    # the main path's shapes: B=4 requests x S=512 tokens of minitron-4b
    B, S, D, H, KH, F_ = 4, 512, 3072, 24, 8, 9216
    x, gain = randn(B * S, D), randn(D)
    q, kk = randn(B, H, S, 128, dtype=torch.bfloat16), \
        randn(B, KH, S, 128, dtype=torch.bfloat16)
    pos = torch.arange(S, device="cuda", dtype=torch.float32)
    inv = 1.0 / (10_000.0 ** (torch.arange(0, 128, 2, device="cuda")
                              / 128.0))
    ang = pos[:, None] * inv
    ang = torch.cat([ang, ang], -1)[None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a_, b_ = randn(B * S, F_, dtype=torch.bfloat16), \
        randn(B * S, F_, dtype=torch.bfloat16)

    rms, rot, swi = (get_tile_op(n) for n in ("rmsnorm", "rotary",
                                              "swiglu"))
    cases = {
        "rmsnorm": (rms, (x, gain), {"eps": 1e-6},
                    x.numel() * 8 + D * 4,
                    lambda: F.rms_norm(x, (D,), gain, 1e-6)),
        "rotary": (rot, (q, cos, sin), {},
                   q.numel() * 4 + cos.numel() * 8, None),
        "swiglu": (swi, (a_, b_), {}, a_.numel() * 6, None),
    }
    for name, (op, args, sc, nbytes, lib) in cases.items():
        err = _check(f"{name}/path", op.apply(*args, **sc),
                     op.torch_ref(*(a.expand(args[0].shape) for a in args),
                                  **sc),
                     TILE_TOL[str(args[0].dtype)[6:]], checks)
        rows[name] = {
            "route": "triton", "source": "src/repro_torch/core/tritongen.py",
            "replaces": "src/repro/core/pallasgen.py:554",
            "shape": [list(a.shape) for a in args],
            "dtype": str(args[0].dtype)[6:], "max_abs_err": err,
            "ms": timer.ms(lambda: op.apply(*args, **sc)),
            "plain_ms": timer.ms(lambda: op.torch_ref(
                *(a.expand(args[0].shape) for a in args), **sc)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": timer.ms(lib) if lib is not None else None}
    _check("rotary/path-k", rot.apply(kk, cos, sin),
           rot.torch_ref(kk, cos.expand(kk.shape), sin.expand(kk.shape)),
           TILE_TOL["bfloat16"], checks)

    # flash attention: full width causal (the path) and not, a ragged S,
    # and a small f32 head_dim-16 case
    flash_cases = [((4, 24, 8, 512, 128), torch.bfloat16, True),
                   ((4, 24, 8, 512, 128), torch.bfloat16, False),
                   ((4, 24, 8, 100, 128), torch.bfloat16, True),
                   ((2, 4, 2, 128, 16), torch.float32, True),
                   ((2, 4, 2, 128, 16), torch.float32, False)]
    for (b, h, kh, s, d), dt, causal in flash_cases:
        fq, fk, fv = randn(b, h, s, d, dtype=dt), randn(b, kh, s, d, dtype=dt), \
            randn(b, kh, s, d, dtype=dt)
        tag = f"flash_attention/{str(dt)[6:]}/{b}x{h}x{kh}x{s}x{d}/" \
              f"{'causal' if causal else 'full'}"
        err = _check(tag, flash_attention(fq, fk, fv, causal=causal),
                     flash_attention_plain(fq, fk, fv, causal=causal),
                     FLASH_TOL[str(dt)[6:]], checks)
        if (b, h, kh, s, d) == (4, 24, 8, 512, 128) and causal:
            pairs = s * (s + 1) // 2
            flops = 4 * d * pairs * b * h
            nbytes = (2 * fq.numel() + 2 * fk.numel()) * fq.element_size()
            t_ops = flops / PEAK_FLOPS[str(dt)[6:]] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            rows["flash_attention"] = {
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:147",
                "shape": [b, h, kh, s, d], "dtype": str(dt)[6:],
                "max_abs_err": err,
                "ms": timer.ms(lambda: flash_attention(fq, fk, fv)),
                "plain_ms": timer.ms(
                    lambda: flash_attention_plain(fq, fk, fv)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": timer.ms(_sdpa(F, fq, fk, fv))}
    emit({"phase": "kernels", "checks": checks, "timings": rows})
    bad = [c["name"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return rows


def _sdpa(F, q, k, v):
    """PyTorch's fused attention on the same inputs, causal (the
    yardstick; the port never calls it)."""
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:   # a torch without enable_gqa: repeat kv beforehand
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.tile_programs import get_tile_op
    return {"rmsnorm": get_tile_op("rmsnorm"), "rotary": get_tile_op("rotary"),
            "swiglu": get_tile_op("swiglu"),
            "flash_attention": flash_attention}


def phase_serve(torch):
    import numpy as np
    from repro_torch.core.telemetry import reset_telemetry
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.common import tree_bytes

    t0 = time.perf_counter()
    srv = Server(SERVE["arch"], smoke=False, max_batch=SERVE["max_batch"],
                 seed=SERVE["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill_ms, decode_ms = [], []
    prefill, decode = srv._prefill_batch, srv._decode

    def timed(fn, out):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return r
        return run

    srv._prefill_batch = timed(prefill, prefill_ms)
    srv._decode = timed(decode, decode_ms)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, srv.cfg.vocab, size=SERVE["prompt_len"] - (i % 3)).astype(np.int32),
        max_new=SERVE["max_new"]) for i in range(SERVE["requests"])]
    counters = _counters()
    reset_telemetry()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = srv.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    guard = srv.metrics["saturation"]["guard"]
    levels = {n: c.sk.ladder_level for n, c in counters.items()
              if hasattr(c, "sk")}
    ok_tokens = all(len(out[r.rid]) == SERVE["max_new"]
                    and all(0 <= t < srv.cfg.vocab for t in out[r.rid])
                    for r in reqs)
    emit({"phase": "serve", "config": srv.cfg.name,
          "params": srv.cfg.param_count(),
          "param_bytes": tree_bytes(srv.params), "init_s": init_s, **SERVE,
          "wall_s": wall, "prefill_ms": prefill_ms,
          "decode_ms_per_token": statistics.median(decode_ms),
          "tokens": srv.metrics["tokens"] + len(reqs),
          "tokens_per_s": (srv.metrics["tokens"] + len(reqs)) / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "ladder_levels": levels,
          "runtime_fallbacks": sum(guard["runtime_fallbacks"].values()),
          "degradations": guard["degradations"],
          "first_tokens": {r.rid: out[r.rid][:8] for r in reqs}})
    if not ok_tokens:
        raise AssertionError("served tokens are missing or out of range")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if guard["runtime_fallbacks"] or guard["degradations"] or \
            set(levels.values()) != {"cold"}:
        raise AssertionError(f"fallbacks/degradations on the card: {guard}")
    return srv, reqs, launches


def phase_parity(torch, srv, reqs):
    import numpy as np
    from repro_torch.kernels import ops

    prompts = np.stack([r.prompt[:SERVE["prompt_len"] - 2]
                        for r in reqs[:SERVE["max_batch"]]])
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")

    def prefill():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = srv.model.prefill(srv.params, tokens)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t) * 1e3

    kern, kern_ms = prefill()      # warm: the serve phase built everything
    ops.set_impl("torch")
    try:
        plain, plain_ms = prefill()
    finally:
        ops.set_impl(None)
    err = _err(kern, plain)
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    ok = err <= PARITY_TOL and bool(kern.isfinite().all())
    emit({"phase": "parity", "shape": list(tokens.shape),
          "prefill_ms": kern_ms, "plain_prefill_ms": plain_ms,
          "max_abs_logit_diff": err, "tol": PARITY_TOL,
          "logit_std": kern.float().std().item(), "argmax_agree": agree,
          "ok": ok})
    if not ok:
        raise AssertionError(f"kernel and plain prefill differ by {err}")
    return tokens


def _kernel_group(name: str) -> str:
    from repro_torch.kernels.tile_programs import PROGRAMS
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(name.startswith(f"{p}_kernel") for p in PROGRAMS):
        return "tile"
    if any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma",
                                        "cutlass")):
        return "matmul"
    return "other"


def phase_trace(torch, srv, tokens):
    """Where the time goes: one warm prefill and three decode ticks under
    torch.profiler — device time by kernel group and the device's busy
    share of the host wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        groups, n_launch, top = {}, 0, []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e3
            n_launch += e.count
            top.append((us / 1e3, e.count, g, e.key[:70]))
        busy = sum(groups.values())
        return out, {"wall_ms": wall_ms, "device_ms": busy,
                     "busy_share": busy / wall_ms, "device_launches": n_launch,
                     "device_ms_by_group": groups,
                     "top_kernels": sorted(top, reverse=True)[:8]}

    (logits, cache), pre = profiled(
        lambda: srv.model.prefill(srv.params, tokens))
    tok = torch.argmax(logits[:, -1], -1)[:, None]

    def ticks():
        nonlocal tok
        c = cache
        for _ in range(3):
            out, c = srv.model.decode_step(srv.params, c, tok)
            tok = torch.argmax(out[:, -1], -1)[:, None]
        return c

    _, dec = profiled(ticks)
    emit({"phase": "trace", "prefill": pre, "decode_3_ticks": dec})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository (src/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        SRC, "repro_torch", "_build", "triton_cache"))
    t_start = time.perf_counter()
    try:
        smi = phase_env(torch)
        phase_build()
        timer = Timer(torch)
        rows = phase_kernels(torch, timer)
        del timer
        srv, reqs, launches = phase_serve(torch)
        tokens = phase_parity(torch, srv, reqs)
        phase_trace(torch, srv, tokens)
    except Exception:
        traceback.print_exc()
        return 1
    kernels = []
    for name in ("rmsnorm", "rotary", "swiglu", "flash_attention"):
        r = rows[name]
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
