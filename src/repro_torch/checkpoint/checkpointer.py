"""Sharded, async, resharding-capable checkpointing: the port of
:mod:`repro.checkpoint.checkpointer`, for trees of torch tensors.

Layout (one directory per step):
  step_000123/
    manifest.json      — tree structure, leaf names, shapes, dtypes, step
    shard_<host>.npz   — this host's slices of the flattened leaves
    _COMMITTED_<host>  — atomic commit marker (written last)

As the JAX package's: per-host shard files, an async save (the files are
written by a background thread; ``wait()`` joins it), a commit marker
written last so a killed run never restores a torn checkpoint, restore
onto any host count (the union of the shards, re-sliced: N -> M), and
only the newest ``keep`` committed checkpoints kept.

Tensors are copied to host numpy arrays before ``save`` returns, so the
trainer may update them in place while the thread writes. bf16 has no
numpy type that npz round-trips: it is stored as its uint16 bits with
"bfloat16" in the manifest, as the JAX package stores it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    n_hosts: int
    tree_def: str
    leaf_info: List[Tuple[str, list, str]]  # (name, shape, dtype)
    extra: Dict[str, Any]


def _leaf_names(tree) -> List[str]:
    return ["/".join(str(k) for k in path) for path in T.flatten(tree)[0]]


def _tree_def(tree) -> str:
    """The tree's structure with each leaf as ``*``."""
    return repr(T.unflatten(tree, ["*"] * len(T.leaves(tree))))


def _host_array(x) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf and its dtype name (bf16 as uint16 bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).split(".")[-1]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.array(x)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree, *, host_id: int = 0, n_hosts: int = 1,
             extra: Optional[Dict[str, Any]] = None,
             async_: bool = True) -> None:
        """Save this host's shard of ``tree`` (host slices along the
        leading axis; a real deployment passes each host's local
        shards)."""
        names = _leaf_names(tree)
        host = [_host_array(x) for x in T.leaves(tree)]
        tree_def = _tree_def(tree)

        def work():
            step_dir = self.dir / f"step_{step:09d}"
            step_dir.mkdir(parents=True, exist_ok=True)
            shard: Dict[str, np.ndarray] = {}
            for i, (arr, _) in enumerate(host):
                lo, hi = _host_slice(arr.shape, host_id, n_hosts)
                shard[f"{i}"] = arr[lo:hi] if arr.ndim else arr
            np.savez(step_dir / f"shard_{host_id}.npz", **shard)
            if host_id == 0:
                meta = CheckpointMeta(
                    step=step, n_hosts=n_hosts, tree_def=tree_def,
                    leaf_info=[(n, list(a.shape), dt)
                               for n, (a, dt) in zip(names, host)],
                    extra=extra or {})
                (step_dir / "manifest.json").write_text(
                    json.dumps(dataclasses.asdict(meta)))
            # commit marker written LAST (atomicity)
            (step_dir / f"_COMMITTED_{host_id}").touch()
            self._gc()

        if async_:
            self.wait()
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()
        else:
            work()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -- restore ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if any(p.glob("_COMMITTED_*")) and (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, tree_like, step: Optional[int] = None,
                ) -> Tuple[Any, Dict[str, Any]]:
        """Rebuild full tensors from ALL committed shards (any host count),
        shaped like ``tree_like``, each on its leaf's device and in its
        dtype. Returns (tree, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        step_dir = self.dir / f"step_{step:09d}"
        meta = json.loads((step_dir / "manifest.json").read_text())
        shards = []
        for h in range(meta["n_hosts"]):
            if not (step_dir / f"_COMMITTED_{h}").exists():
                raise IOError(f"shard {h} of step {step} uncommitted")
            shards.append(np.load(step_dir / f"shard_{h}.npz"))
        out = []
        for i, ref in enumerate(T.leaves(tree_like)):
            parts = [sh[f"{i}"] for sh in shards]
            full = parts[0] if np.ndim(parts[0]) == 0 \
                else np.concatenate(parts, axis=0)
            t = _from_host(full, meta["leaf_info"][i][2])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint {tuple(t.shape)} vs "
                                 f"model {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            out.append(t)
        return T.unflatten(tree_like, out), meta["extra"]

    # -- gc ------------------------------------------------------------------------
    def _gc(self):
        steps = sorted(
            (int(p.name.split("_")[1]), p) for p in self.dir.glob("step_*")
            if any(p.glob("_COMMITTED_*")))
        for _, p in steps[:-self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(p, ignore_errors=True)


def _host_slice(shape, host_id: int, n_hosts: int) -> Tuple[int, int]:
    if not shape:
        return 0, 1
    n = shape[0]
    per = (n + n_hosts - 1) // n_hosts
    lo = min(host_id * per, n)
    return lo, min(lo + per, n)
