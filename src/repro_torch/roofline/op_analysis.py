"""Operation counting for the roofline report: the port's counterpart of
:mod:`repro.roofline.hlo_analysis`.

The reference re-walks a compiled step's optimized HLO. Eager torch has
no compiled module to walk, so the port runs the step itself on ``meta``
tensors (shapes and dtypes, no storage: nothing is allocated and nothing
computed) under :class:`OpCounter`, a ``TorchDispatchMode`` that sees
every aten op the step dispatches, forward and backward, and counts:

* FLOPs: every product (the matmul and convolution family of
  ``torch.utils.flop_counter``'s registry) = 2 · |result| · K.
  Elementwise FLOPs are omitted, as the reference omits them;
* HBM bytes (traffic model, per op):
    products, reductions, sort, scatter -> result + full operands
    an in-place write into a slice      -> 2 × the update's bytes
      (the KV cache update: ``cache[:, :, pos] = k``)
    everything else                     -> result + Σ min(operand, result)
  (the min() caps slice-style reads of a window of a big buffer). Unlike
  HLO, eager views (``view``, ``transpose``, ``expand``, ``slice``,
  ``permute``, ...) are not ops that run: they move no bytes, and
  neither does an allocation (``empty``);
* collectives (``_c10d_functional.*``): result bytes × the reference's
  ring wire factor ((g-1)/g per pass; 2× for all-reduce; ×(g-1) for
  reduce-scatter, whose result is the shard). On ``meta`` the counter
  computes their results itself: there is no process group to run them;
* the hand-written kernels: a kernel wrapper given ``meta`` tensors
  launches nothing; it records the kernel's own work
  (:mod:`repro_torch.roofline.kernel_work`) with the active counter and
  returns ``meta`` outputs of the kernel's shapes. Its plain version is
  never run there: flash's builds the S×S scores the causal kernel skips
  half of;
* live bytes: each new storage adds its bytes when an op makes it and
  gives them back when the storage is freed (``weakref.finalize``), so
  ``peak_live_bytes`` is the step's peak of temporaries above what
  existed before it (the arguments), the counterpart of XLA's
  ``memory_analysis().temp_size_in_bytes``.

* on a mesh (DTensor arguments, a ``fake`` process group in the dry
  run): each device's share. A DTensor op is handed back to DTensor
  (``NotImplemented``), which runs it with the counter still on, so the
  counter sees what one rank runs: the op on its local shards and the
  collectives of any redistribution DTensor makes first; DTensor's own
  propagation on fake tensors of the global shapes is not counted.

Eager torch runs a loop in Python, so there is no ``while`` to walk and
``trip_counts`` stays empty: every iteration dispatches its ops and is
counted as it runs. A caller that traces one of several identical
iterations (the dry run's one microbatch) scales it with
:meth:`OpCounter.repeat`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_COLLECTIVE_OPS = {"all_reduce": "all-reduce",
                   "all_gather_into_tensor": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   # DTensor's move of a shard to another dimension
                   "shard_dim_alltoall": "all-to-all",
                   "broadcast": "collective-permute"}
# aten ops that read their whole operands (products come from the flop
# registry): reductions, sort, scatter
_FULL_READ_OPS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
    "any", "all", "argmax", "argmin", "cumsum", "cumprod", "sort", "topk",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "index_put",
    "_index_put_impl", "index_copy", "embedding_dense_backward",
    "bincount"))
# ops that move no bytes: allocations, scalars read to the host, aliases
_FREE_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "detach", "alias",
    "lift_fresh", "lift_fresh_copy", "set_", "resize_", "_unsafe_view"))

_ACTIVE = threading.local()


def active_counter() -> Optional["OpCounter"]:
    """The innermost :class:`OpCounter` open on this thread, or None."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@dataclasses.dataclass
class OpReport:
    """What :class:`OpCounter` counted: the fields of
    :class:`repro.roofline.hlo_analysis.HLOReport` that the report reads,
    and the port's own (kernels, ops by name, live bytes)."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: int = 0
    trip_counts: List[int] = dataclasses.field(default_factory=list)
    # (op, result_shape, group, execs, wire_bytes, metadata_hint)
    collectives: List[tuple] = dataclasses.field(default_factory=list)
    # elementwise operations of the tile kernels (not in dot_flops)
    vector_ops: float = 0.0
    # hand-written kernels: name -> {"calls", "flops", "bytes"}
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # aten ops: name -> {"calls", "flops", "bytes"}
    ops: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0
    # bytes of tensors made on another device than meta while counting
    # (host scalars of the optimizer, say): what the run allocated
    other_device_bytes: int = 0

    def top_collectives(self, n: int = 10) -> List[tuple]:
        return sorted(self.collectives, key=lambda t: -t[4])[:n]

    def top_ops(self, n: int = 10, key: str = "bytes") -> List[tuple]:
        """The ``n`` aten ops and kernels with the most ``key`` (bytes or
        flops): ``(name, calls, flops, bytes)``."""
        rows = [(k, v["calls"], v["flops"], v["bytes"])
                for d in (self.ops, self.kernels) for k, v in d.items()]
        i = 3 if key == "bytes" else 2
        return sorted(rows, key=lambda r: -r[i])[:n]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_str(t: torch.Tensor) -> str:
    return f"{str(t.dtype)[6:]}[{','.join(map(str, t.shape))}]"


class OpCounter(TorchDispatchMode):
    """Count the ops, kernels, collectives and live bytes of what runs on
    ``meta`` tensors inside ``with OpCounter() as c:``; ``c.report``
    holds the counts. ``n_devices`` is the group size of a collective
    whose op does not carry one (an all-reduce names only its group),
    unless ``group_sizes`` maps its group's name; on ``meta`` a host read
    of a value (``float(t)``, ``t.item()``) returns 1.0 for a float (0
    for an integer, False for a bool): no value exists, and only the
    arithmetic around it is counted."""

    def __init__(self, n_devices: int = 1,
                 group_sizes: Optional[Dict[str, int]] = None):
        super().__init__()
        self.n_devices = n_devices
        self.group_sizes = dict(group_sizes or {})
        self.report = OpReport()
        self.live_bytes = 0
        self._scale = 1.0

    def __enter__(self):
        if not hasattr(_ACTIVE, "stack"):
            _ACTIVE.stack = []
        _ACTIVE.stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.stack.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def repeat(self, k: float):
        """Count what runs inside ``k`` times (FLOPs, bytes, wire bytes,
        kernels): one of ``k`` identical iterations traced for all of
        them. Live bytes are not multiplied: the iterations reuse the
        memory."""
        prev, self._scale = self._scale, self._scale * k
        try:
            yield
        finally:
            self._scale = prev

    # -- records ----------------------------------------------------------
    def record_kernel(self, name: str, *, flops: float = 0.0,
                      nbytes: float = 0.0, vector_ops: float = 0.0):
        """One launch of a hand-written kernel: ``flops`` of products
        (into ``dot_flops``), ``vector_ops`` elementwise operations,
        ``nbytes`` of traffic."""
        s = self._scale
        rep = self.report
        rep.dot_flops += flops * s
        rep.vector_ops += vector_ops * s
        rep.hbm_bytes += nbytes * s
        row = rep.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
        row["calls"] += s
        row["flops"] += (flops + vector_ops) * s
        row["bytes"] += nbytes * s

    def _record_op(self, name: str, flops: float, nbytes: float):
        s = self._scale
        self.report.dot_flops += flops * s
        self.report.hbm_bytes += nbytes * s
        row = self.report.ops.setdefault(name, {"calls": 0, "flops": 0.0,
                                                "bytes": 0.0})
        row["calls"] += s
        row["flops"] += flops * s
        row["bytes"] += nbytes * s

    def _record_collective(self, kind: str, result: torch.Tensor, g: int):
        size = _nbytes(result)
        if kind == "all-reduce":
            wire = 2.0 * size * (g - 1) / max(g, 1)
        elif kind in ("all-gather", "all-to-all"):
            wire = size * (g - 1) / max(g, 1)
        elif kind == "reduce-scatter":
            wire = size * (g - 1)
        else:
            wire = size
        s = self._scale
        rep = self.report
        rep.collective_wire_bytes += wire * s
        rep.collective_breakdown[kind] = \
            rep.collective_breakdown.get(kind, 0.0) + wire * s
        rep.collective_count += 1
        rep.collectives.append((kind, _shape_str(result), g, s, wire * s,
                                ""))

    # -- live bytes -------------------------------------------------------
    def _mark_known(self, t: torch.Tensor):
        """A storage made before the counter (an argument): known, not
        counted."""
        st = t.untyped_storage()
        if not getattr(st, "_op_counter_seen", False):
            st._op_counter_seen = True

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if getattr(st, "_op_counter_seen", False):
            return
        st._op_counter_seen = True
        n = st.nbytes()
        self.live_bytes += n
        self.report.peak_live_bytes = max(self.report.peak_live_bytes,
                                          self.live_bytes)
        weakref.finalize(st, self._release, n)

    def _release(self, n: int):
        self.live_bytes -= n

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in flat_in):
            # a DTensor op: let DTensor run it with this mode still on, so
            # what the device does is counted: its redistributions'
            # collectives and the op on the local shards
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shapes to learn its output's: no device work
            return func(*args, **kwargs)
        on_meta = any(t.device.type == "meta" for t in flat_in)
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" or (
                func.namespace == "_dtensor" and name == "shard_dim_alltoall"):
            return self._collective(func, name, args, kwargs, on_meta)
        if on_meta and func is aten._local_scalar_dense.default:
            t = args[0]
            return (1.0 if t.dtype.is_floating_point
                    else False if t.dtype == torch.bool else 0)
        if on_meta and packet is aten.bincount:
            # the length depends on the data: the minlength, which holds
            # every id below it (the MoE dispatch's expert ids are)
            out = torch.empty((kwargs.get("minlength", args[2] if
                                          len(args) > 2 else 0),),
                              dtype=torch.int64, device="meta")
        else:
            out = func(*args, **kwargs)
        flat_out = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
        if not (on_meta or any(t.device.type == "meta" for t in flat_out)):
            self.report.other_device_bytes += sum(
                _nbytes(t) for t in flat_out
                if t.untyped_storage().data_ptr()
                not in {a.untyped_storage().data_ptr() for a in flat_in})
            return out
        for t in flat_in:
            self._mark_known(t)
        for t in flat_out:
            self._track(t)
        if func.is_view or name in _FREE_OPS:
            self._record_op(name, 0.0, 0.0)
            return out
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        self._record_op(name, flops, self._traffic(func, name, packet,
                                                   args, flat_in, flat_out,
                                                   full=flops > 0))
        return out

    def _traffic(self, func, name, packet, args, flat_in, flat_out,
                 full: bool) -> float:
        if not flat_out:
            return 0.0
        mutated = func._schema.is_mutable
        if mutated and args and isinstance(args[0], torch.Tensor):
            dst = args[0]
            if _nbytes(dst) < dst.untyped_storage().nbytes():
                return 2.0 * _nbytes(dst)      # a write into a slice
        rb = sum(_nbytes(t) for t in flat_out)
        reads = [_nbytes(t) for t in flat_in]
        if full or name.rstrip("_") in _FULL_READ_OPS:
            return rb + sum(reads)
        return rb + sum(min(r, rb) for r in reads)

    def _collective(self, func, name, args, kwargs, on_meta):
        kind = _COLLECTIVE_OPS.get(name)
        if name == "wait_tensor":
            return args[0] if on_meta else func(*args, **kwargs)
        if name == "_wrap_tensor_autograd":       # no data moves
            return func(*args, **kwargs)
        if kind is None:
            raise NotImplementedError(
                f"OpCounter: no wire formula for _c10d_functional.{name}")
        x = args[0]
        group = args[-1] if isinstance(args[-1], str) else ""
        if kind in ("all-gather", "reduce-scatter"):
            g = int(args[1] if kind == "all-gather" else args[2])
        else:
            g = self.group_sizes.get(group, self.n_devices)
        if on_meta:
            if name == "shard_dim_alltoall":     # (input, gather, shard, group)
                shape = list(x.shape)
                shape[args[1]] *= g
                shape[args[2]] //= g
                out = torch.empty(shape, dtype=x.dtype, device="meta")
            elif kind == "all-gather":
                out = torch.empty((x.shape[0] * g, *x.shape[1:]),
                                  dtype=x.dtype, device="meta")
            elif kind == "reduce-scatter":
                out = torch.empty((x.shape[0] // g, *x.shape[1:]),
                                  dtype=x.dtype, device="meta")
            else:
                out = torch.empty_like(x)
        else:
            out = func(*args, **kwargs)
        self._mark_known(x)
        self._track(out)
        self._record_collective(kind, out, g)
        self._record_op(name, 0.0, _nbytes(out) + min(_nbytes(x),
                                                      _nbytes(out)))
        return out


def count_ops(fn, *args, n_devices: int = 1,
              group_sizes: Optional[Dict[str, int]] = None,
              **kwargs) -> OpReport:
    """``fn(*args, **kwargs)`` under a fresh :class:`OpCounter`: its
    report (the arguments are ``meta`` tensors, made before the call).
    The counterpart of the reference's ``analyze(hlo_text)``."""
    with OpCounter(n_devices, group_sizes) as c:
        fn(*args, **kwargs)
    return c.report


def tensors_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (nested
    dicts, lists, tuples): what the arguments of a call hold, a DTensor
    by its local shard (one device's bytes)."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total
