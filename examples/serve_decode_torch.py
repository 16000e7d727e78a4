"""Serving example on the PyTorch/CUDA port: decode throughput with the
persistent saturation cache.

The twin of examples/serve_decode.py, through
``repro_torch.launch.serve.Server``. Batched requests run over the
Mamba2 (SSD) architecture: prefill builds the recurrent state, decode
advances every active sequence one token per tick. It measures

  * decode tokens/s with saturation on (the saturated tile kernels the
    models dispatch through repro_torch.kernels.ops) and off (the plain
    reference functions, ``ops.set_impl("ref")``: the caller's explicit
    choice, never a fallback);
  * the persistent cache: a cold pass fills ``--cache-dir``, a second
    pass replays it from disk; hit rate and cold and replay saturation
    seconds come from repro_torch.core.telemetry.

It runs on the GPU unless given ``--device cpu``, and stops with an
error when there is no CUDA device and no device is named.

Flags:
  --cache-dir DIR   saturation cache directory (default: a fresh temp
                    dir, removed at the end, so the cold and warm phases
                    are well defined)
  --no-cache        no on-disk cache (the report then has no cache part)
  --out PATH        write the measured report as JSON

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
      [--out report.json]
"""
import argparse
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.telemetry import reset_telemetry, telemetry
from repro_torch.kernels import ops
from repro_torch.kernels.tile_programs import get_tile_op
from repro_torch.launch.serve import Request, Server


def _requests(cfg, n, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab,
                                        size=12 + 3 * (i % 3)).astype(
                                            np.int32),
                    max_new=max_new)
            for i in range(n)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_generate(srv, reqs):
    """Run one warmup batch (kernel builds), then time a full generate."""
    srv.generate(_requests(srv.cfg, len(reqs), reqs[0].max_new, seed=1))
    tokens_before = srv.metrics["tokens"]
    _sync(srv.device)
    t0 = time.perf_counter()
    out = srv.generate(reqs)
    _sync(srv.device)
    dt = time.perf_counter() - t0
    return out, srv.metrics["tokens"] - tokens_before, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--requests", type=int, default=7)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--cache-dir", default=None,
                    help="saturation cache dir (default: fresh temp dir)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent saturation cache")
    ap.add_argument("--out", default=None,
                    help="write the benchmark report JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.no_cache or args.cache_dir:
        return run(args, None if args.no_cache else args.cache_dir)
    with tempfile.TemporaryDirectory(prefix="repro_torch_sat_cache_") as d:
        return run(args, d)


def run(args, cache_dir):
    """The three phases, with the saturation cache at ``cache_dir`` (None:
    no on-disk cache); returns the report."""
    def server():
        # False: no on-disk cache, whatever REPRO_SAT_CACHE says
        return Server(args.arch, smoke=True, max_batch=4, device=args.device,
                      cache_dir=False if cache_dir is None else cache_dir)

    # -- phase 1: cold boot, the saturation searches run and fill the cache
    reset_telemetry()
    srv = server()
    backend = torch.cuda.get_device_name(srv.device) \
        if srv.device.type == "cuda" else srv.device.type
    report = {"schema_version": 1, "pr": 6,
              "bench": "serve_decode", "arch": args.arch,
              "backend": backend,
              "requests": args.requests, "max_new": args.max_new,
              "cache_dir": cache_dir}
    out, tokens, dt = _timed_generate(
        srv, _requests(srv.cfg, args.requests, args.max_new))
    for rid in sorted(out):
        print(f"req{rid}: {out[rid]}")
    cold = telemetry().snapshot()
    report["saturated"] = {"tokens": tokens, "wall_s": dt,
                           "tokens_per_s": tokens / dt}
    print(f"saturation ON : {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s) on {backend}")
    del srv

    if cache_dir is not None:
        # -- phase 2: warm boot, the in-process ops dropped so every tile
        # op is rebuilt, now replayed from the entries on disk
        get_tile_op.cache_clear()
        reset_telemetry()
        srv2 = server()
        _, tokens2, dt2 = _timed_generate(
            srv2, _requests(srv2.cfg, args.requests, args.max_new))
        warm = telemetry().snapshot()
        del srv2
        replay_speedup = (cold["cold_wall_s"] / warm["hit_wall_s"]
                          if warm["hit_wall_s"] > 0 else float("inf"))
        report["cache"] = {
            "cold": {"misses": cold["cache_misses"],
                     "stores": cold["cache_stores"],
                     "saturation_wall_s": cold["cold_wall_s"]},
            "warm": {"hits": warm["cache_hits"],
                     "misses": warm["cache_misses"],
                     "hit_rate": warm["cache_hit_rate"],
                     "saturation_wall_s": warm["hit_wall_s"],
                     "tokens_per_s": tokens2 / dt2},
            "replay_speedup": replay_speedup,
        }
        print(f"cache: cold misses={cold['cache_misses']} "
              f"({cold['cold_wall_s']:.2f}s search) -> warm "
              f"hits={warm['cache_hits']} hit_rate="
              f"{warm['cache_hit_rate']:.2f} "
              f"({warm['hit_wall_s']:.3f}s replay, "
              f"{replay_speedup:.0f}x)")
        if not (warm["cache_hits"] > 0 and warm["cache_hit_rate"] == 1.0):
            raise SystemExit("the warm pass missed the cache: "
                             f"{warm['cache_hits']} hits, "
                             f"{warm['cache_misses']} misses")
        print("the warm pass hit every lookup")

    # -- phase 3: saturation off, the plain reference functions ----------
    ops.set_impl("ref")
    try:
        srv3 = server()
        _, tokens3, dt3 = _timed_generate(
            srv3, _requests(srv3.cfg, args.requests, args.max_new))
        del srv3
    finally:
        ops.set_impl(None)
    report["reference"] = {"tokens": tokens3, "wall_s": dt3,
                           "tokens_per_s": tokens3 / dt3}
    report["decode_speedup_vs_ref"] = (
        report["saturated"]["tokens_per_s"]
        / report["reference"]["tokens_per_s"])
    print(f"saturation OFF: {tokens3} tokens in {dt3:.2f}s "
          f"({tokens3 / dt3:.1f} tok/s) -> saturated is "
          f"{report['decode_speedup_vs_ref']:.2f}x")
    if tokens3 != tokens:
        raise SystemExit(f"saturated decoded {tokens} tokens, ref "
                         f"{tokens3}")
    print("saturated and ref decoded the same number of tokens")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
