"""Cross-process check of the port's persistent saturation cache.

    python3 tools/cache_smoke.py

Two worker subprocesses share one fresh cache directory:

  1. the **cold** worker builds a set of tile ops, populating the cache
     (every build must be a cache miss that stores an entry);
  2. the **warm** worker, launched with a *different* PYTHONHASHSEED (so
     e-class ids and set-iteration orders differ), rebuilds the same
     ops. Every build must be an exact cache hit that skips saturation
     and search, the total saturation wall time must drop by at least
     ``SPEEDUP_FLOOR``x, and both the emitted kernel sources (torch and
     Triton) and the plain versions' outputs on the CPU must hash
     identically to the cold run (replay is bit for bit, not merely
     equivalent).

The counterpart of the JAX package's ``benchmarks/cache_smoke.py``, with
its kernels and floor. Runs on the CPU; imports neither jax nor the JAX
package. Exit code 0 on success, 1 on any violation.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# a spread of tile programs: norms (shared-subexpression heavy), the
# multi-store optimizer, and the two-output gating kernel — these
# dominate cold search time, so the speedup is not noise-bound
KERNELS = ("rmsnorm", "rmsnorm_gated", "layernorm", "adamw", "ssd_gate")
SPEEDUP_FLOOR = 10.0
_MARK = "CACHE_SMOKE_JSON:"


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _worker(cache_dir: str) -> None:
    import numpy as np
    import torch

    from repro_torch.analysis import TILE_SHAPE
    from repro_torch.core.telemetry import telemetry
    from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

    report = {}
    for name in KERNELS:
        # cost schedule = the full pipeline (saturation + beam extraction
        # + schedule search); replay must skip all three
        op = get_tile_op(name, schedule="cost", cache_dir=cache_dir)
        sk = op.sk
        events = [e for e in telemetry().events
                  if e["kind"] == "cache" and e["kernel"] == name]
        prog = PROGRAMS[name]()
        rng = np.random.default_rng(0)
        arrays = []
        for spec in prog.arrays.values():
            shape = tuple(TILE_SHAPE[i] if d is None else int(d)
                          for i, d in enumerate(
                              getattr(spec, "shape", None) or TILE_SHAPE))
            arrays.append(rng.uniform(0.1, 1.0,
                                      size=shape).astype(np.float32))
        args = [torch.from_numpy(a) for a in arrays] \
            + [0.5 for _ in sk.kernel.scalars]
        outs = sk.kernel.fn(*args)
        report[name] = {
            "status": sk.cache_status,
            "wall_s": events[-1]["wall_s"],
            "torch_src": _sha(sk.kernel.source.encode()),
            "triton_src": _sha(op.source.encode()),
            "out": _sha(b"".join(np.asarray(o).tobytes() for o in outs)),
        }
    print(_MARK + json.dumps(report))


def _run_worker(cache_dir: str, hashseed: str) -> dict:
    env = dict(os.environ,
               PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED=hashseed)
    env.pop("REPRO_SAT_CACHE", None)   # the explicit dir is the subject
    p = subprocess.run([sys.executable, __file__, "--worker", cache_dir],
                       env=env, capture_output=True, text=True,
                       timeout=600)
    if p.returncode != 0:
        sys.stderr.write(p.stdout + p.stderr)
        raise SystemExit(f"worker (hashseed={hashseed}) failed")
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith(_MARK)]
    return json.loads(lines[-1][len(_MARK):])


def main() -> int:
    cache_dir = tempfile.mkdtemp(prefix="repro_torch_cache_smoke_")
    cold = _run_worker(cache_dir, hashseed="11")
    warm = _run_worker(cache_dir, hashseed="23")

    failures = []
    for name in KERNELS:
        c, w = cold[name], warm[name]
        if c["status"] != "miss":
            failures.append(f"{name}: cold run was {c['status']!r}, "
                            "expected a miss on a fresh cache")
        if w["status"] != "hit":
            failures.append(f"{name}: warm run was {w['status']!r}, "
                            "expected an exact hit")
        for k, label in (("torch_src", "generated torch source"),
                         ("triton_src", "Triton source"),
                         ("out", "numeric output")):
            if c[k] != w[k]:
                failures.append(f"{name}: {label} differs cold vs warm "
                                f"({c[k][:12]} != {w[k][:12]})")
        print(f"  {name:14s} cold {c['wall_s']*1e3:8.1f} ms ({c['status']})"
              f" -> warm {w['wall_s']*1e3:7.2f} ms ({w['status']})")

    cold_s = sum(cold[k]["wall_s"] for k in KERNELS)
    warm_s = sum(warm[k]["wall_s"] for k in KERNELS)
    speedup = cold_s / warm_s if warm_s > 0 else float("inf")
    print(f"saturation+search wall: cold {cold_s:.2f}s, warm "
          f"{warm_s:.3f}s -> {speedup:.0f}x (floor {SPEEDUP_FLOOR:.0f}x)")
    if speedup < SPEEDUP_FLOOR:
        failures.append(f"replay speedup {speedup:.1f}x below the "
                        f"{SPEEDUP_FLOOR:.0f}x floor")

    if failures:
        print(f"\nFAIL: {len(failures)} cache-smoke violation(s):",
              file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"\nOK: {len(KERNELS)} kernels replayed bit-identically from "
          f"{cache_dir} across PYTHONHASHSEED 11 -> 23")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2])
    else:
        sys.exit(main())
