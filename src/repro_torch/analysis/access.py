"""Symbolic grid/block access analysis — affine footprints of BlockSpecs.

The one layer of the stack `repro_torch.verify` could not see without it is
the *grid*: every `pl.pallas_call` carries index-map lambdas that decide
which block of which operand each grid instance touches, and until now
those lambdas were trusted by eye. This module gives them a semantics
the verifier can reason about:

* :class:`Sym` — a symbolic integer over named grid axes. Index maps
  are *probed* with one ``Sym`` per grid axis; ordinary arithmetic
  (``+ - *`` and ``// %`` by constants) propagates an exact **affine
  form** ``sum(c_k * g_k) + b``, while anything non-affine (``bh // H``,
  ``(bh % H) // group`` — the flash-attention GQA maps) degrades to an
  opaque-but-evaluable closure. Either way every map can be *evaluated*
  at concrete grid coordinates; affine maps can additionally be bounded
  and proven injective without enumeration.
* :class:`BlockAccess` / :class:`GridModel` — the declarative model of
  one ``pallas_call``: grid extents, per-operand block shapes, buffer
  shapes (post-padding), index maps, element byte widths, and the VMEM
  buffer multiplicity (2 for double-buffered async staging).

Footprints use Pallas *blocked* indexing semantics: an index map returns
block coordinates, so instance ``g`` touches elements
``[idx_k(g) * bs_k, (idx_k(g) + 1) * bs_k)`` along dim ``k`` — always
aligned to the block lattice. That alignment is load-bearing: two block
footprints either coincide exactly or are disjoint, which turns
coverage/race certification into set arithmetic over block-index tuples
(see :mod:`repro_torch.verify.grid_check` for the checks themselves).

A copy of the JAX package's module. In the port a :class:`GridModel`
describes one Triton or CUDA launch: a grid instance is a program (a
thread block), an index map gives the block of each operand it reads or
writes, and ``vmem_bytes`` counts what the blocks hold on chip.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Exhaustive-evaluation ceiling: grids up to this many instances are
# certified by full enumeration when the affine fast path does not
# apply; beyond it the checker samples the grid-box corners and
# downgrades its verdict to a warning (documented in
# the checker's findings as the not-provable fallback).
ENUM_LIMIT = 1 << 16


class Sym:
    """Symbolic integer over grid axes with affine tracking.

    ``affine`` is ``(coeffs, const)`` — one integer coefficient per grid
    axis plus a constant — or ``None`` when an operation left the exact
    affine lattice (the value is still evaluable through ``ev``).
    """

    __slots__ = ("n_axes", "affine", "_ev")

    def __init__(self, n_axes: int,
                 affine: Optional[Tuple[Tuple[int, ...], int]],
                 ev: Callable[[Sequence[int]], int]):
        self.n_axes = n_axes
        self.affine = affine
        self._ev = ev

    # -- constructors -------------------------------------------------------
    @classmethod
    def axis(cls, n_axes: int, k: int) -> "Sym":
        coeffs = tuple(1 if i == k else 0 for i in range(n_axes))
        return cls(n_axes, (coeffs, 0), lambda env, _k=k: env[_k])

    @classmethod
    def const(cls, n_axes: int, v: int) -> "Sym":
        v = int(v)
        return cls(n_axes, ((0,) * n_axes, v), lambda env, _v=v: _v)

    def ev(self, env: Sequence[int]) -> int:
        return int(self._ev(env))

    def _coerce(self, other) -> Optional["Sym"]:
        if isinstance(other, Sym):
            return other
        if isinstance(other, int):
            return Sym.const(self.n_axes, other)
        return None

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        aff = None
        if self.affine is not None and o.affine is not None:
            (ca, ba), (cb, bb) = self.affine, o.affine
            aff = (tuple(x + y for x, y in zip(ca, cb)), ba + bb)
        return Sym(self.n_axes, aff,
                   lambda env, s=self, t=o: s.ev(env) + t.ev(env))

    __radd__ = __add__

    def __neg__(self):
        aff = None
        if self.affine is not None:
            c, b = self.affine
            aff = (tuple(-x for x in c), -b)
        return Sym(self.n_axes, aff, lambda env, s=self: -s.ev(env))

    def __sub__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return self + (-o)

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return o + (-self)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        aff = None
        for a, b in ((self, o), (o, self)):
            if a.affine is not None and not any(a.affine[0]):
                k = a.affine[1]
                if b.affine is not None:
                    c, bb = b.affine
                    aff = (tuple(k * x for x in c), k * bb)
                break
        return Sym(self.n_axes, aff,
                   lambda env, s=self, t=o: s.ev(env) * t.ev(env))

    __rmul__ = __mul__

    def __floordiv__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        aff = None
        if o.affine is not None and not any(o.affine[0]):
            d = o.affine[1]
            if d != 0 and self.affine is not None:
                c, b = self.affine
                # d | every coefficient: a*g ≡ 0 (mod d) for integer g,
                # so floor((a*g + b)/d) = (a/d)*g + floor(b/d) exactly
                if all(x % d == 0 for x in c):
                    aff = (tuple(x // d for x in c), b // d)
        return Sym(self.n_axes, aff,
                   lambda env, s=self, t=o: s.ev(env) // t.ev(env))

    def __rfloordiv__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return o // self

    def __mod__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        aff = None
        if o.affine is not None and not any(o.affine[0]):
            d = o.affine[1]
            if d != 0 and self.affine is not None:
                c, b = self.affine
                if all(x % d == 0 for x in c):
                    aff = ((0,) * self.n_axes, b % d)
        return Sym(self.n_axes, aff,
                   lambda env, s=self, t=o: s.ev(env) % t.ev(env))

    def __rmod__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return o % self

    # an index map that *branches* on a symbolic coordinate is outside
    # the model; raising here makes the probe fail cleanly so the
    # summary degrades to concrete per-instance evaluation
    def __bool__(self):
        raise TypeError("symbolic grid coordinate has no truth value")

    def __repr__(self):
        if self.affine is None:
            return "Sym(<non-affine>)"
        c, b = self.affine
        terms = [f"{x}*g{i}" for i, x in enumerate(c) if x]
        terms.append(str(b))
        return f"Sym({' + '.join(terms)})"


@dataclasses.dataclass
class IndexMapSummary:
    """One index map, probed: per-output-dim symbolic forms (or opaque)."""
    n_axes: int
    dims: Optional[List[Sym]]       # None: probe failed — call fn directly
    fn: Callable

    @property
    def opaque(self) -> bool:
        return self.dims is None

    @property
    def fully_affine(self) -> bool:
        return (self.dims is not None
                and all(d.affine is not None for d in self.dims))


def summarize_index_map(fn: Callable, n_axes: int) -> IndexMapSummary:
    """Probe ``fn`` with one :class:`Sym` per grid axis."""
    try:
        out = fn(*[Sym.axis(n_axes, k) for k in range(n_axes)])
    except Exception:
        return IndexMapSummary(n_axes, None, fn)
    if not isinstance(out, tuple):
        out = (out,)
    dims: List[Sym] = []
    for o in out:
        if isinstance(o, Sym):
            dims.append(o)
        elif isinstance(o, int):
            dims.append(Sym.const(n_axes, o))
        else:
            return IndexMapSummary(n_axes, None, fn)
    return IndexMapSummary(n_axes, dims, fn)


def eval_index(summary: IndexMapSummary,
               env: Sequence[int]) -> Tuple[int, ...]:
    """Block coordinates of one grid instance."""
    if summary.dims is None:
        out = summary.fn(*env)
        if not isinstance(out, tuple):
            out = (out,)
        return tuple(int(x) for x in out)
    return tuple(d.ev(env) for d in summary.dims)


def affine_bounds(sym: Sym, grid: Sequence[int]) -> Tuple[int, int]:
    """Inclusive (min, max) of an affine form over the grid box — the
    extremum of an affine function over a box sits at a corner, picked
    per-axis by coefficient sign."""
    assert sym.affine is not None
    coeffs, const = sym.affine
    lo = hi = const
    for c, g in zip(coeffs, grid):
        if c >= 0:
            hi += c * (g - 1)
        else:
            lo += c * (g - 1)
    return lo, hi


# ---------------------------------------------------------------------------
# The declarative pallas_call model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockAccess:
    """One operand of a ``pallas_call``: which block of which buffer
    each grid instance reads or writes.

    ``array_shape`` is the shape of the buffer actually passed to the
    call — i.e. *after* any host-side padding (``_ceil_to``), so the
    pad region is modeled explicitly as in-bounds. ``buffers`` is the
    VMEM copy count (2 when the pipelined emitter stages the operand
    through a double-buffer scratch in addition to its block window).
    """
    array: str
    mode: str                       # "read" | "write"
    block_shape: Tuple[int, ...]
    array_shape: Tuple[int, ...]
    index_map: Callable
    dtype_bytes: int = 4
    buffers: int = 1

    def __post_init__(self):
        if self.mode not in ("read", "write"):
            raise ValueError(f"mode must be read|write, got {self.mode!r}")
        if len(self.block_shape) != len(self.array_shape):
            raise ValueError(
                f"{self.array}: block rank {len(self.block_shape)} != "
                f"array rank {len(self.array_shape)}")

    @property
    def block_elems(self) -> int:
        return math.prod(self.block_shape)

    @property
    def vmem_bytes(self) -> int:
        return self.block_elems * self.dtype_bytes * self.buffers

    def n_blocks(self) -> Tuple[int, ...]:
        """Block-lattice extents (ceil per dim — a ragged final block is
        masked by Pallas and counts as one block)."""
        return tuple(-(-a // b) for a, b in
                     zip(self.array_shape, self.block_shape))


@dataclasses.dataclass(frozen=True)
class GridModel:
    """Everything :func:`repro_torch.verify.grid_check.check_grid` needs to
    certify one kernel launch configuration."""
    name: str
    grid: Tuple[int, ...]
    reads: Tuple[BlockAccess, ...]
    writes: Tuple[BlockAccess, ...]
    scratch_bytes: int = 0

    def __post_init__(self):
        if not self.grid or any(g <= 0 for g in self.grid):
            raise ValueError(f"{self.name}: grid {self.grid} must be "
                             "non-empty with positive extents")

    @property
    def n_instances(self) -> int:
        return math.prod(self.grid)

    def instances(self):
        """All grid coordinate tuples (row-major)."""
        return itertools.product(*[range(g) for g in self.grid])

    @property
    def vmem_bytes(self) -> int:
        """Exact VMEM working set: every operand's block window times
        its buffer multiplicity, plus declared scratch."""
        return (sum(a.vmem_bytes for a in self.reads + self.writes)
                + self.scratch_bytes)
