"""Serving driver: batched prefill + greedy decode.

The port of :mod:`repro.launch.serve`:
  * requests arrive with prompts of different lengths;
  * up to ``max_batch`` requests are packed, left-padded with token 0
    (no attention mask, as the JAX server);
  * prefill runs per batch, then decode advances the whole batch one
    token per tick;
  * finished batches free their slots.

Runs on the GPU unless ``device="cpu"`` is passed:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --full

(``--arch`` takes minitron-4b, mamba2-1.3b, zamba2-2.7b, dbrx-132b,
qwen2-vl-2b and whisper-small; dbrx-132b's full 40 layers do not fit one
80 GB card, so serve it through ``Server(..., cfg=...)`` with a cut
depth. qwen2-vl-2b is served on text positions, whisper-small on zero
audio frames of the prompt's length, as the JAX server does.)
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.telemetry import telemetry
from repro_torch.models import ModelConfig, get_model, resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    def __init__(self, arch: str, *, smoke: bool = True, max_batch: int = 4,
                 max_seq: int = 128, seed: int = 0, device=None,
                 cfg: Optional[ModelConfig] = None):
        """``cfg``, when given, is served in place of ``arch``'s config
        (a full-width config at a cut depth, for one card)."""
        self.device = resolve_device(device)
        arch = ARCH_IDS.get(arch, arch)
        if cfg is not None:
            self.cfg = cfg
        else:
            self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        self.model = get_model(self.cfg, device=self.device)
        self.params = self.model.init(seed)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self._decode = self.model.decode_step
        # metrics are mutated from every serving thread — concurrent
        # generate() calls are supported, so counter updates take this
        # lock (prevents lost increments / torn read-modify-write)
        self._metrics_lock = threading.Lock()
        self.metrics = {"prefills": 0, "decode_ticks": 0, "tokens": 0}

    def _bump(self, key: str, n: int = 1):
        with self._metrics_lock:
            self.metrics[key] += n

    def _prefill_batch(self, prompts: np.ndarray):
        tokens = torch.as_tensor(prompts, dtype=torch.int64,
                                 device=self.device)
        logits, cache = self.model.prefill(self.params, tokens)
        self._bump("prefills")
        return logits, cache

    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve a list of requests batch by batch (greedy)."""
        pending = list(requests)
        results: Dict[int, List[int]] = {}
        while pending:
            batch = pending[:self.max_batch]
            pending = pending[self.max_batch:]
            plen = max(len(r.prompt) for r in batch)
            prompts = np.stack([
                np.pad(r.prompt, (plen - len(r.prompt), 0)) for r in batch])
            logits, cache = self._prefill_batch(prompts)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            steps = max(r.max_new for r in batch)
            for t in range(steps - 1):
                ids = tok[:, 0].tolist()
                for i, r in enumerate(batch):
                    if len(r.out) < r.max_new:
                        r.out.append(ids[i])
                logits, cache = self._decode(self.params, cache, tok)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                self._bump("decode_ticks")
                self._bump("tokens", len(batch))
            ids = tok[:, 0].tolist()
            for i, r in enumerate(batch):
                if len(r.out) < r.max_new:
                    r.out.append(ids[i])
                r.done = True
                results[r.rid] = r.out
        snap = telemetry().snapshot()
        with self._metrics_lock:
            # snap["guard"] carries the robustness counters (ladder
            # levels, degradations, breaker events, runtime fallbacks)
            self.metrics["saturation"] = snap
        return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b",
                    help=f"one of {sorted(ARCH_IDS)}")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config (default: smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)

    srv = Server(args.arch, smoke=not args.full, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, srv.cfg.vocab,
                                        size=args.prompt_len
                                        - (i % 3)).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    out = srv.generate(reqs)
    dt = time.time() - t0
    sat = srv.metrics.get("saturation", {})
    print(f"arch={args.arch} device={srv.device} served {len(out)} requests, "
          f"{srv.metrics['tokens']} tokens in {dt:.1f}s "
          f"({srv.metrics['prefills']} prefills, "
          f"{srv.metrics['decode_ticks']} ticks)")
    guard = sat.get("guard", {})
    print(f"  guard: levels={guard.get('ladder_levels', {})} "
          f"degradations={sum(guard.get('degradations', {}).values())} "
          f"breaker={guard.get('breaker_events', {})} "
          f"runtime_fallbacks="
          f"{sum(guard.get('runtime_fallbacks', {}).values())}")
    for rid in sorted(out):
        print(f"  req{rid}: {out[rid]}")
    return out


if __name__ == "__main__":
    main()
