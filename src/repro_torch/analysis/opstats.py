"""Operation statistics: the unified per-node accounting engine.

One table classifies every IR operator (shared with the paper-weight
adapters in :mod:`repro.core.cost`), and :func:`node_stats` prices a node
in hardware terms — FLOPs, HBM byte traffic, and VPU tile passes — under
the saturator's tile execution model: every e-graph term is the body of
one tile program, so a `load` moves one tile HBM→VMEM and an elementwise
op is one (or more) full-tile VPU passes.

These statistics are the shared currency between the e-graph extractor
(:class:`repro.analysis.cost_model.RooflineCostModel`) and the HLO
roofline walk (:mod:`repro.analysis.hlo`): both sides reduce to an
:class:`OpStats`, and :mod:`repro.analysis.latency` turns either into a
predicted latency against the chip peaks.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

if TYPE_CHECKING:  # avoid a load-time cycle: repro.core.cost imports us
    from repro_torch.core.ir import ENode

# ---------------------------------------------------------------------------
# Operator classification — the single source of truth. The paper cost
# model (repro.core.cost) derives its 0/1/10/100 weight classes from these
# same sets, so the two layers can never drift apart.
# ---------------------------------------------------------------------------
FREE_OPS = frozenset({"const", "tuple"})
INPUT_OPS = frozenset({"var", "array"})          # paper weight 1
PHI_OPS = frozenset({"phi", "phi_loop"})         # paper weight 1
MEMORY_OPS = frozenset({"load"})                 # paper weight 100
CALL_OPS = frozenset({"call"})                   # paper weight 100
SERIAL_ARITH = frozenset({"div", "mod"})         # paper weight 100
TRANSCENDENTALS = frozenset({"exp", "log", "tanh", "sigmoid", "pow"})
ROOTLIKE = frozenset({"sqrt", "rsqrt", "recip"})
SIGN_OPS = frozenset({"neg"})                    # folds into FMA operands
REDUCTIONS = frozenset({"rsum", "rmean", "rmax"})

# Default tile geometry: one (8, 128) f32 vreg tile per term instance.
TILE_SHAPE = (8, 128)
TILE_ELEMS = TILE_SHAPE[0] * TILE_SHAPE[1]
DTYPE_BYTES = 4

# HBM byte width per element for the dtypes the saturator prices. bf16/f16
# tiles move half the bytes of f32, f8 a quarter — the memory roof scales
# with the stored width, not the compute width.
DTYPE_BYTE_WIDTH = {
    "f64": 8, "i64": 8,
    "f32": 4, "tf32": 4, "i32": 4,
    "bf16": 2, "f16": 2, "i16": 2,
    "f8": 1, "f8_e4m3": 1, "f8_e5m2": 1, "i8": 1, "bool": 1,
}


def dtype_byte_width(dtype: str) -> int:
    """HBM bytes per element of ``dtype`` (raises on unknown names so a
    typo'd declaration fails loudly instead of silently pricing as f32)."""
    try:
        return DTYPE_BYTE_WIDTH[dtype]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype!r}; known: {sorted(DTYPE_BYTE_WIDTH)}")


@dataclasses.dataclass(frozen=True)
class ArrayInfo:
    """Declared (shape, dtype) of one kernel array — the SSA array table
    entry the analysis layer prices loads/stores with.

    ``shape=None`` means unknown extent (price a full tile, the pre-shape
    behavior). A dimension may be ``None`` for a symbolic/runtime extent;
    any symbolic dimension left after indexing also falls back to a full
    tile. Known extents are capped at the tile size: one term instance
    never moves more than one tile per load, but a broadcast scalar or row
    moves only its true operand extent.
    """
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: str = "f32"

    @property
    def byte_width(self) -> int:
        return dtype_byte_width(self.dtype)

    def index(self, n_idx: int) -> "ArrayInfo":
        """Info of the operand left after ``n_idx`` leading indices."""
        if self.shape is None or n_idx <= 0:
            return self
        return ArrayInfo(shape=self.shape[n_idx:], dtype=self.dtype)

    def elems(self, tile_elems: int = TILE_ELEMS) -> int:
        """Per-tile-instance element extent of this operand."""
        if self.shape is None:
            return tile_elems
        n = 1
        for d in self.shape:
            if d is None:       # symbolic dimension: unknown extent
                return tile_elems
            n *= int(d)
        return min(n, tile_elems)

    def bytes(self, tile_elems: int = TILE_ELEMS) -> float:
        return float(self.elems(tile_elems) * self.byte_width)

# Vector multi-pass issue counts, the JAX package's relative weights (same
# rationale as TPUCostModel: transcendentals are multi-pass polynomial
# sequences, true divide the longest, cross-lane reductions a short
# log-tree).
_PASSES = {
    "transcendental": 8.0,
    "rootlike": 4.0,
    "serial": 10.0,
    "call": 20.0,
    "reduction": 4.0,
    "simple": 1.0,
    "sign": 0.0,     # folds into the consumer's FMA operand slot
    "leaf": 0.0,
}

# FLOPs per element (mirrors repro.core.cost.count_flops so roofline and
# histogram accounting agree).
_FLOPS_PER_ELEM = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "min": 1, "max": 1,
    "square": 1, "recip": 1, "mod": 1, "fma": 2,
    "exp": 8, "log": 8, "sqrt": 8, "rsqrt": 8, "tanh": 8, "sigmoid": 8,
    "pow": 8,
    "rsum": 1, "rmean": 1, "rmax": 1,
}


@dataclasses.dataclass(frozen=True)
class OpStats:
    """Additive hardware statistics for a node, term, or whole program."""
    flops: float = 0.0            # elementwise (VPU) floating-point ops
    mxu_flops: float = 0.0        # matrix-unit FLOPs (HLO dots/convs)
    bytes_read: float = 0.0
    bytes_written: float = 0.0
    vpu_passes: float = 0.0       # full-tile vector issue slots
    n_ops: int = 0                # executed instructions (non-leaf nodes)

    @property
    def total_flops(self) -> float:
        return self.flops + self.mxu_flops

    @property
    def total_bytes(self) -> float:
        return self.bytes_read + self.bytes_written

    def __add__(self, other: "OpStats") -> "OpStats":
        return OpStats(
            flops=self.flops + other.flops,
            mxu_flops=self.mxu_flops + other.mxu_flops,
            bytes_read=self.bytes_read + other.bytes_read,
            bytes_written=self.bytes_written + other.bytes_written,
            vpu_passes=self.vpu_passes + other.vpu_passes,
            n_ops=self.n_ops + other.n_ops)

    def scaled(self, k: float) -> "OpStats":
        return OpStats(flops=self.flops * k, mxu_flops=self.mxu_flops * k,
                       bytes_read=self.bytes_read * k,
                       bytes_written=self.bytes_written * k,
                       vpu_passes=self.vpu_passes * k,
                       n_ops=int(self.n_ops * k))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def op_pass_class(op: str) -> str:
    """Pass-count class of an operator (also keys the paper adapters)."""
    if op in FREE_OPS or op in INPUT_OPS or op in PHI_OPS:
        return "leaf"
    if op in SIGN_OPS:
        return "sign"
    if op in TRANSCENDENTALS:
        return "transcendental"
    if op in ROOTLIKE:
        return "rootlike"
    if op in SERIAL_ARITH:
        return "serial"
    if op in CALL_OPS:
        return "call"
    if op in REDUCTIONS:
        return "reduction"
    if op in MEMORY_OPS:
        return "leaf"   # no VPU pass; priced on the memory axis
    return "simple"     # arith, cmp, select, structural tile ops


def node_stats(node: ENode, *, tile_elems: int = TILE_ELEMS,
               dtype_bytes: int = DTYPE_BYTES,
               info: Optional[ArrayInfo] = None) -> OpStats:
    """Hardware statistics of one e-node under tile semantics.

    ``info`` — when the caller resolved the loaded operand's
    :class:`ArrayInfo` (shape after indexing + dtype), a load is priced at
    its true operand extent and byte width: a broadcast scalar costs one
    element, a broadcast row one row, a bf16 tile half an f32 tile.
    Without it, loads keep the full-f32-tile default.
    """
    op = node.op
    counted = op not in FREE_OPS and op not in INPUT_OPS
    if op in MEMORY_OPS:
        if info is not None:
            return OpStats(bytes_read=info.bytes(tile_elems), n_ops=1)
        return OpStats(bytes_read=float(tile_elems * dtype_bytes), n_ops=1)
    passes = _PASSES[op_pass_class(op)]
    flops = _FLOPS_PER_ELEM.get(op, 0) * float(tile_elems)
    return OpStats(flops=flops, vpu_passes=passes, n_ops=1 if counted else 0)


def store_stats(n_stores: int, *, tile_elems: int = TILE_ELEMS,
                dtype_bytes: int = DTYPE_BYTES,
                infos: Optional[Sequence[Optional[ArrayInfo]]] = None
                ) -> OpStats:
    """Write traffic of a term's root stores (constant across extraction
    choices — reported, never part of the minimized objective).

    With ``infos`` (one entry per store, ``None`` = unknown) each store is
    priced at its target operand's true extent and byte width instead of a
    full f32 tile; ``n_stores`` is then ignored in favor of the list.
    """
    if infos is not None:
        total = 0.0
        for inf in infos:
            if inf is None:
                total += float(tile_elems * dtype_bytes)
            else:
                total += inf.bytes(tile_elems)
        return OpStats(bytes_written=total)
    return OpStats(bytes_written=float(n_stores * tile_elems * dtype_bytes))
