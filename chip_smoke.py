#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout (the CUDA libraries in
parallel), checks each against its plain PyTorch version at the main
paths' shapes and times it, then drives two paths through the port's
Server at full width with random seeded weights:

* minitron-4b (32 layers, d_model 3072, vocab 256k): serve, parity of a
  kernel prefill with a plain one, the same prefill through the
  pipelined tile kernels, and a profiler trace;
* mamba2-1.3b (48 layers, d_model 2048, 64 SSD heads): serve, parity of
  a kernel prefill and two decode ticks fed from its state with the
  plain versions, the pipelined prefill, and a trace.

Each path's launch counts are zeroed just before it and read just after.
Each phase prints one JSON line; the line before the last lists every
kernel, and the last line is ``{"ok": true, "device": {...}}``. Any
failure exits non-zero. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
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
              "float32": 67e12,           # f32 outside the tensor cores
              "tf32x3": 495e12 / 3}       # f32 as 3 TF32 tensor-core products
TILE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
SSD_TOL = 2e-4                            # f32, as tests/test_kernels.py
CUDA_SOURCES = ("flash_attention.cu", "ssd_scan.cu")
PIPELINED = "triton_pipelined"
# Last-position logits of the full-width prefill, kernels vs plain
# versions. Both run the same bf16 model; they differ only where values
# are rounded to bf16 (the kernels compute in f32 and round once; the
# plain swiglu rounds after every op, plain attention normalises before
# rounding). The logits have a std near 1 (unit-variance hidden state
# times an unembedding of std d^-0.5); a wrong head mapping, mask or
# rotation moves them by O(1), bf16 rounding over 32 layers by far less.
PARITY_TOL = 0.5
# Mamba2-1.3B, kernels vs plain versions: last-position logits of a
# 4 x 510 prefill, then of two decode ticks fed the same tokens, each
# from its own prefill's state, with the served weights in f32. In bf16
# the two paths round at different places (the rmsnorm_gated kernel
# computes in f32 and rounds once, its plain version rounds after every
# bf16 op, ~1 % apart), and 48 layers of random weights amplify that,
# on an H100, past the 0.5 that bounds the minitron comparison: as large
# as a fault. In f32 they differ only in summation order (~1e-6
# relative), which the same amplification leaves far below 0.02; a wrong
# state handed to decode, a wrong chunk carry or a mask error moves the
# logits by O(1).
MAMBA_PARITY_TOL = 0.02

SERVE = dict(arch="minitron-4b", max_batch=4, requests=6, prompt_len=512,
             max_new=32, seed=0)
SERVE_MAMBA = dict(SERVE, arch="mamba2-1.3b")


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
    from repro_torch.kernels.cuda_build import nvcc as nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton_version,
          "nvcc": nvcc.splitlines()[-1],
          "allow_tf32": {"matmul": False, "cudnn": False}})
    return smi


def _hmma_counts(lib):
    """HMMA (tensor-core) instructions in each kernel of a library, from
    ``cuobjdump -sass``, by kernel name (with the head_dim template
    argument where there is one)."""
    import re
    from repro_torch.kernels.cuda_build import nvcc
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        m = re.match(
            r"\S*?\d((?:flash_fwd|ssd)_[a-z0-9]+_kernel)(?:ILi(\d+)E)?", body)
        name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "") \
            if m else body.split()[0]
        counts[name] = body.count("HMMA")
    return counts


def phase_build():
    """Both CUDA libraries, one nvcc each, all started together."""
    from repro_torch.kernels.cuda_build import build
    t0 = time.perf_counter()
    libs = build(*CUDA_SOURCES)
    secs = time.perf_counter() - t0
    ptxas, hmma = {}, {}
    for src, lib in zip(CUDA_SOURCES, libs):
        with open(f"{lib}.log") as f:
            ptxas[src] = [ln.strip() for ln in f if "registers" in ln
                          or "spill" in ln or "smem" in ln]
        hmma[src] = _hmma_counts(lib)
    emit({"phase": "build", "nvcc_s": secs,
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs],
          "ptxas": ptxas, "hmma": hmma})
    return hmma


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


def _tile_bound(op, args):
    """Least time of a tile kernel: each input read once and each output
    (the lead's shape and dtype) written once over the memory rate, or
    the body's operations per element, in f32, over the f32 rate."""
    n_out = len(op.tk.out_arrays)
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + n_out * args[0].numel() * args[0].element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = op.tk.stats.n_ops * args[0].numel() / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def _ssd_work(B, S, H, P, N, chunk):
    """Bytes and operations one SSD scan with its final state needs: x,
    dt, B, C, a_log, d_skip read once, y and the state written once; per
    (b, h, chunk) of L steps the causal scores . dx (L(L+1)/2 x P MACs),
    C . h (L N P, none in the first chunk, whose state is zero) and the
    state update (L N P), and per (b, chunk) the causal half of C . B^T
    (L(L+1)/2 x N), two operations per MAC."""
    nbytes = 4 * (2 * B * S * H * P + B * H * N * P + 2 * B * S * N
                  + B * S * H + 2 * H)
    macs = 0
    for k, t0 in enumerate(range(0, S, chunk)):
        L = min(chunk, S - t0)
        tri = L * (L + 1) // 2
        macs += B * H * (tri * P + (L * N * P if k else 0) + L * N * P)
        macs += B * tri * N
    return nbytes, 2 * macs


def phase_kernels(torch, timer):
    """Every kernel against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

    checks, rows = [], {}
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # all 13 generated tile kernels, sync and pipelined, at a small,
    # ragged shape (37 x 200)
    scal = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
            "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
            "bias": 0.1, "norm": 3.0, "max_norm": 1.0}

    def tile_inputs(name, rows_, d, dt):
        xs = []
        for a in PROGRAMS[name]().arrays.values():
            if a.role == "out":
                continue
            x = randn(d, dtype=dt) if a.shape == (1, 128) \
                else randn(rows_, d, dtype=dt)
            xs.append(x.abs() * 0.01 if a.name == "v" else x)
        return xs, {s: scal[s] for s in PROGRAMS[name]().scalars}

    for name in sorted(PROGRAMS):
        for emitter in (None, PIPELINED):
            op = get_tile_op(name, emitter=emitter)
            tag = name if emitter is None else f"{name}@{emitter}"
            for dt in (torch.float32, torch.bfloat16):
                xs, sc = tile_inputs(name, 37, 200, dt)
                _check(f"{tag}/{str(dt)[6:]}/37x200", op.apply(*xs, **sc),
                       op.torch_ref(*xs, **sc), TILE_TOL[str(dt)[6:]],
                       checks)

    # the main paths' shapes: B=4 requests x S=512 tokens of minitron-4b
    # (rmsnorm, rotary, swiglu) and of mamba2-1.3b (rmsnorm_gated)
    B, S, D, H, KH, F_ = 4, 512, 3072, 24, 8, 9216
    DI = 4096
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
    yg, zg, gg = randn(B * S, DI, dtype=torch.bfloat16), \
        randn(B * S, DI, dtype=torch.bfloat16), randn(DI, dtype=torch.bfloat16)

    def tile_row(tag, op, args, sc, lib, replaces):
        want = op.torch_ref(*(a.expand(args[0].shape) for a in args), **sc)
        err = _check(f"{tag}/path", op.apply(*args, **sc), want,
                     TILE_TOL[str(args[0].dtype)[6:]], checks)
        bound, by = _tile_bound(op, args)
        return {
            "route": "triton", "source": "src/repro_torch/core/tritongen.py",
            "replaces": replaces,
            "shape": [list(a.shape) for a in args],
            "dtype": str(args[0].dtype)[6:], "max_abs_err": err,
            "ms": timer.ms(lambda: op.apply(*args, **sc)),
            "plain_ms": timer.ms(lambda: op.torch_ref(
                *(a.expand(args[0].shape) for a in args), **sc)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.ms(lib) if lib is not None else None}

    cases = {
        "rmsnorm": ((x, gain), {"eps": 1e-6},
                    lambda: F.rms_norm(x, (D,), gain, 1e-6)),
        "rotary": ((q, cos, sin), {}, None),
        "swiglu": ((a_, b_), {}, None),
        "rmsnorm_gated": ((yg, zg, gg), {"eps": 1e-6}, None),
    }
    for emitter, replaces in ((None, "src/repro/core/pallasgen.py:554"),
                              (PIPELINED, "src/repro/core/pallasgen.py:546")):
        for name, (args, sc, lib) in cases.items():
            tag = name if emitter is None else f"{name}@{emitter}"
            rows[tag] = tile_row(tag, get_tile_op(name, emitter=emitter),
                                 args, sc, lib, replaces)
    rot = get_tile_op("rotary")
    _check("rotary/path-k", rot.apply(kk, cos, sin),
           rot.torch_ref(kk, cos.expand(kk.shape), sin.expand(kk.shape)),
           TILE_TOL["bfloat16"], checks)

    # the tile programs on no path yet: kernel, plain and library times
    # beside the bound at one stated shape, f32 (2048, 4096)
    libs = {
        "layernorm": lambda xs, sc: F.layer_norm(
            xs[0], (xs[0].shape[-1],), xs[1], xs[2], sc["eps"]),
        "gelu": lambda xs, sc: F.gelu(xs[0], approximate="tanh"),
        "softmax": lambda xs, sc: torch.softmax(xs[0], -1),
        "moe_router": lambda xs, sc: torch.softmax(xs[0], -1),
        "residual_scale": lambda xs, sc: torch.add(xs[0], xs[1],
                                                   alpha=sc["alpha"]),
        "l2_clip": lambda xs, sc: torch.mul(
            xs[0], min(1.0, sc["max_norm"] / (sc["norm"] + sc["eps"]))),
    }
    others = {}
    for name in sorted(set(PROGRAMS) - set(cases)):
        op = get_tile_op(name)
        xs, sc = tile_inputs(name, 2048, 4096, torch.float32)
        bound, by = _tile_bound(op, xs)
        lib = libs.get(name)
        others[name] = {
            "shape": [list(a.shape) for a in xs], "dtype": "float32",
            "ms": timer.ms(lambda: op.apply(*xs, **sc)),
            "plain_ms": timer.ms(lambda: op.torch_ref(
                *(a.expand(xs[0].shape) for a in xs), **sc)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.ms(lambda: lib(xs, sc))
            if lib is not None else None}

    # flash attention: full width causal (the path) and not, a ragged S,
    # the bf16 kernel's tile edges (one row, one past a 64-row tile, one
    # past two), and a small f32 head_dim-16 case
    flash_cases = [((4, 24, 8, 512, 128), torch.bfloat16, True),
                   ((4, 24, 8, 512, 128), torch.bfloat16, False),
                   ((4, 24, 8, 100, 128), torch.bfloat16, True),
                   ((2, 8, 8, 1, 64), torch.bfloat16, True),
                   ((2, 8, 8, 65, 64), torch.bfloat16, True),
                   ((2, 8, 8, 129, 64), torch.bfloat16, True),
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

    # SSD scan, y and the final state: the serve shape (the path), ragged
    # S and S below a chunk at full width, the tile edges (one step, one
    # chunk, five chunks) at full width, and a small case
    ssd_cases = [((4, 512, 64, 64, 128), 128), ((4, 510, 64, 64, 128), 128),
                 ((4, 100, 64, 64, 128), 128), ((1, 1, 64, 64, 128), 128),
                 ((1, 128, 64, 64, 128), 128), ((1, 640, 64, 64, 128), 128),
                 ((2, 64, 2, 16, 16), 16)]
    for (b, s, h, p, n), chunk in ssd_cases:
        sx, sb, sc_ = randn(b, s, h, p), randn(b, s, n) * 0.3, \
            randn(b, s, n) * 0.3
        sdt = torch.rand((b, s, h), generator=g, device="cuda") * 0.29 + 0.01
        sa = torch.log(torch.arange(1, h + 1, device="cuda",
                                    dtype=torch.float32))
        sd = randn(h)
        args = (sx, sdt, sa, sb, sc_, sd)
        err = _check(f"ssd_scan/{b}x{s}x{h}x{p}x{n}/chunk{chunk}",
                     ssd_scan(*args, chunk=chunk, return_state=True),
                     ssd_scan_plain(*args, chunk=chunk, return_state=True),
                     SSD_TOL, checks)
        if (b, s) == (4, 512):
            nbytes, flops = _ssd_work(b, s, h, p, n, chunk)
            t_ops = flops / PEAK_FLOPS["tf32x3"] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            rows["ssd_scan"] = {
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:127",
                "shape": [b, s, h, p, n], "chunk": chunk, "dtype": "float32",
                "max_abs_err": err, "bytes": nbytes, "flops": flops,
                "ms": timer.ms(lambda: ssd_scan(*args, chunk=chunk,
                                                return_state=True)),
                "plain_ms": timer.ms(lambda: ssd_scan_plain(
                    *args, chunk=chunk, return_state=True)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                # the first kernel's reckoning: f32 on the CUDA cores
                "bound_cuda_core_ms": max(
                    flops / PEAK_FLOPS["float32"] * 1e3, t_bytes),
                "library_ms": None}
    emit({"phase": "kernels", "checks": checks, "timings": rows,
          "other_programs": others})
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


def _counters(arch):
    """The launch counters of one path's kernels."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.tile_programs import get_tile_op
    if arch == "mamba2-1.3b":
        return {"ssd_scan": ssd_scan,
                "rmsnorm_gated": get_tile_op("rmsnorm_gated"),
                "rmsnorm": get_tile_op("rmsnorm")}
    return {"rmsnorm": get_tile_op("rmsnorm"), "rotary": get_tile_op("rotary"),
            "swiglu": get_tile_op("swiglu"),
            "flash_attention": flash_attention}


def phase_serve(torch, serve, phase):
    import numpy as np
    from repro_torch.core.telemetry import reset_telemetry
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.common import tree_bytes

    t0 = time.perf_counter()
    srv = Server(serve["arch"], smoke=False, max_batch=serve["max_batch"],
                 seed=serve["seed"])
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
        1, srv.cfg.vocab, size=serve["prompt_len"] - (i % 3)).astype(np.int32),
        max_new=serve["max_new"]) for i in range(serve["requests"])]
    counters = _counters(serve["arch"])
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
    ok_tokens = all(len(out[r.rid]) == serve["max_new"]
                    and all(0 <= t < srv.cfg.vocab for t in out[r.rid])
                    for r in reqs)
    emit({"phase": phase, "config": srv.cfg.name,
          "params": srv.cfg.param_count(),
          "param_bytes": tree_bytes(srv.params), "init_s": init_s, **serve,
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


def _prefill_tokens(torch, serve, reqs):
    import numpy as np
    prompts = np.stack([r.prompt[:serve["prompt_len"] - 2]
                        for r in reqs[:serve["max_batch"]]])
    return torch.as_tensor(prompts, dtype=torch.int64, device="cuda")


def _timed_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_parity(torch, srv, tokens):
    from repro_torch.kernels import ops

    def prefill():
        return srv.model.prefill(srv.params, tokens)[0]

    kern, kern_ms = _timed_ms(torch, prefill)  # warm: serve built all
    ops.set_impl("torch")
    try:
        plain, plain_ms = _timed_ms(torch, prefill)
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
    return kern


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()


def phase_parity_mamba2(torch, srv, tokens):
    """A 4 x 510 prefill and two decode ticks of the served model with
    its weights in f32, through the kernels, then through the plain
    versions with the same tokens; each decode starts from its own
    prefill's state, so the kernel's final state is checked, not only
    its output."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    model = LM(dataclasses.replace(srv.cfg, dtype=torch.float32),
               device="cuda")
    params = _f32(srv.params)
    feed = []

    def run():
        logits, cache = model.prefill(params, tokens)
        outs = [logits]
        for i in range(2):
            if len(feed) == i:
                feed.append(torch.argmax(outs[-1][:, -1], -1)[:, None])
            logits, cache = model.decode_step(params, cache, feed[i])
            outs.append(logits)
        return outs

    kern, kern_ms = _timed_ms(torch, run)
    ops.set_impl("torch")
    try:
        plain, plain_ms = _timed_ms(torch, run)
    finally:
        ops.set_impl(None)
    errs = [_err(k, p) for k, p in zip(kern, plain, strict=True)]
    ok = max(errs) <= MAMBA_PARITY_TOL and \
        all(bool(k.isfinite().all()) for k in kern)
    emit({"phase": "parity_mamba2", "shape": list(tokens.shape),
          "dtype": "float32", "prefill_and_2_ticks_ms": kern_ms,
          "plain_prefill_and_2_ticks_ms": plain_ms,
          "max_abs_logit_diff": {"prefill": errs[0], "tick1": errs[1],
                                 "tick2": errs[2]},
          "tol": MAMBA_PARITY_TOL,
          "logit_std": kern[0].float().std().item(),
          "argmax_agree": [(k.argmax(-1) == p.argmax(-1)).float().mean()
                           .item() for k, p in zip(kern, plain)],
          "ok": ok})
    if not ok:
        raise AssertionError(f"kernel and plain mamba2 logits differ by "
                             f"{errs}")


def phase_pipelined(torch, srv, tokens, sync_logits, names, phase):
    """The same prefill with the tile ops launching their persistent,
    pipelined kernels: the path of the pipelined emitter. Its logits
    equal the sync kernels' prefill up to the parity tolerance (the two
    run the same arithmetic in the same order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_programs import get_tile_op

    counters = {n: get_tile_op(n, emitter=PIPELINED) for n in names}
    ops.set_tile_emitter(PIPELINED)
    try:
        for c in counters.values():
            c.launches = 0
        logits, ms = _timed_ms(torch, lambda: srv.model.prefill(
            srv.params, tokens)[0])
        launches = {f"{n}@{PIPELINED}": c.launches
                    for n, c in counters.items()}
    finally:
        ops.set_tile_emitter(None)
    err = _err(logits, sync_logits)
    ok = err <= PARITY_TOL and all(launches.values())
    emit({"phase": phase, "shape": list(tokens.shape), "prefill_ms": ms,
          "launches": launches, "max_abs_logit_diff_vs_sync": err,
          "tol": PARITY_TOL, "ok": ok})
    if not ok:
        raise AssertionError(f"pipelined prefill: launches {launches}, "
                             f"logits differ from the sync kernels' by {err}")
    return launches


def _kernel_group(name: str) -> str:
    from repro_torch.kernels.tile_programs import PROGRAMS
    if "flash_fwd_" in name:            # flash_fwd_{bf16,f32}_kernel
        return "flash_attention"
    if "ssd_cb_kernel" in name or "ssd_scan_kernel" in name:
        return "ssd_scan"
    if any(name.startswith(f"{p}_kernel") for p in PROGRAMS):
        return "tile"
    if any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma",
                                        "cutlass")):
        return "matmul"
    return "other"


def phase_trace(torch, srv, tokens, phase):
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
    emit({"phase": phase, "prefill": pre, "decode_3_ticks": dec})


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
    launches = {}
    try:
        smi = phase_env(torch)
        hmma = phase_build()
        timer = Timer(torch)
        rows = phase_kernels(torch, timer)
        del timer
        # minitron-4b: the dense path
        srv, reqs, dense = phase_serve(torch, SERVE, "serve")
        tokens = _prefill_tokens(torch, SERVE, reqs)
        sync_logits = phase_parity(torch, srv, tokens)
        piped = phase_pipelined(torch, srv, tokens, sync_logits,
                                ("rmsnorm", "rotary", "swiglu"),
                                "pipelined_minitron")
        phase_trace(torch, srv, tokens, "trace")
        del srv, sync_logits
        gc.collect()    # the serve phase's timing wrappers hold a cycle
        torch.cuda.empty_cache()
        # mamba2-1.3b: the ssm path
        srv, reqs, ssm = phase_serve(torch, SERVE_MAMBA, "serve_mamba2")
        if ssm["ssd_scan"] != srv.cfg.n_layers * 2:
            raise AssertionError(f"ssd_scan launched {ssm['ssd_scan']} "
                                 f"times, expected one per layer and "
                                 f"prefill batch")
        tokens = _prefill_tokens(torch, SERVE_MAMBA, reqs)
        phase_parity_mamba2(torch, srv, tokens)
        sync_logits = srv.model.prefill(srv.params, tokens)[0]
        for name, n in phase_pipelined(
                torch, srv, tokens, sync_logits, ("rmsnorm", "rmsnorm_gated"),
                "pipelined_mamba2").items():
            piped[name] = piped.get(name, 0) + n
        phase_trace(torch, srv, tokens, "trace_mamba2")
    except Exception:
        traceback.print_exc()
        return 1
    for paths in (dense, ssm, piped):
        for name, n in paths.items():
            launches[name] = launches.get(name, 0) + n
    kernels = []
    for name, r in rows.items():
        src = os.path.basename(r["source"])
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        # tensor-core instructions by kernel (CUDA routes)
                        "sass": {"HMMA": hmma[src]} if src in hmma else None,
                        **({"bound_cuda_core_ms": r["bound_cuda_core_ms"]}
                           if "bound_cuda_core_ms" in r else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
