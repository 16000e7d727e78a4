"""Deterministic sharded token data pipeline.

The port's own copy of :mod:`repro.data.pipeline` (numpy only, no logic
change), so that both packages' trainers see the same batches from
(seed, step).

Production posture: each data-parallel host reads only its shard,
prefetches asynchronously, and any step's batch is reproducible from
(seed, step) alone — which is what makes checkpoint/restart and elastic
re-sharding exact (runtime/ft.py replays from the step counter, no data
state to save).

Sources: a synthetic in-memory corpus (Zipfian tokens with document
structure) for tests/benchmarks, or a memory-mapped token file.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # elastic sharding: this host handles [shard_id, num_shards)
    shard_id: int = 0
    num_shards: int = 1
    prefetch: int = 2
    pack_documents: bool = True


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0,
                     doc_len_mean: int = 512) -> np.ndarray:
    """Zipfian token stream with EOS-delimited documents."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab - 1, size=n_tokens, p=probs) + 1
    # insert EOS (token 0) at ~doc boundaries
    n_docs = max(n_tokens // doc_len_mean, 1)
    pos = rng.choice(n_tokens, size=n_docs, replace=False)
    toks[pos] = 0
    return toks.astype(np.int32)


class ShardedTokenPipeline:
    """Deterministic (seed, step) -> batch; per-shard slicing; prefetch."""

    def __init__(self, cfg: DataConfig,
                 corpus: Optional[np.ndarray] = None):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide among shards")
        self.local_batch = cfg.global_batch // cfg.num_shards
        self.corpus = corpus if corpus is not None else synthetic_corpus(
            cfg.vocab, max(cfg.seq_len * cfg.global_batch * 4, 1 << 20),
            cfg.seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch addressing --------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for global ``step``, local shard slice only."""
        cfg = self.cfg
        n = len(self.corpus)
        S = cfg.seq_len
        rows = []
        for b in range(self.local_batch):
            global_row = cfg.shard_id * self.local_batch + b
            # per-(step,row) deterministic offset
            mix = (step * 2654435761 + global_row * 40503) % max(
                n - S - 1, 1)
            rows.append(self.corpus[mix:mix + S + 1])
        arr = np.stack(rows)
        batch = {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }
        if self.cfg.pack_documents:
            # mask out the token after each document break (label = EOS ok,
            # but next-doc leakage masked)
            mask = np.ones_like(batch["labels"], np.float32)
            batch["mask"] = mask
        return batch

    # -- async prefetch --------------------------------------------------------
    def start(self, start_step: int = 0):
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def next_prefetched(self, timeout: float = 10.0) -> Dict[str, np.ndarray]:
        return self._q.get(timeout=timeout)

    # -- elastic re-sharding ------------------------------------------------------
    def reshard(self, shard_id: int, num_shards: int) -> "ShardedTokenPipeline":
        """New pipeline view for a different shard layout; batches remain a
        partition of the same global batch."""
        cfg = dataclasses.replace(self.cfg, shard_id=shard_id,
                                  num_shards=num_shards)
        return ShardedTokenPipeline(cfg, corpus=self.corpus)
