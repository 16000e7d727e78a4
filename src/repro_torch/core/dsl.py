"""Kernel DSL — the 'sequential body of a parallel loop' (paper §IV).

A :class:`KernelProgram` is the analogue of the code under an OpenACC
``loop vector`` directive: straight-line assignments, array loads/stores,
``if`` and sequential ``for``, over scalars or whole VMEM tiles.  The
framework's model hot-spots (RMSNorm, SwiGLU, rotary, AdamW, ...) and the
NPB-style benchmark kernels are all written in this DSL, saturated, and
re-emitted as JAX or Pallas code.

Expression building uses operator overloading and returns nested-tuple
terms consumed by :mod:`repro.core.ssa`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


class Expr:
    """Wrapper over nested-tuple terms with operator overloading."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t if isinstance(t, tuple) else ("const", t)

    # arithmetic ------------------------------------------------------------
    def _bin(self, op, other, rev=False):
        o = other.t if isinstance(other, Expr) else ("const", other)
        return Expr((op, o, self.t) if rev else (op, self.t, o))

    def __add__(self, o):      return self._bin("add", o)
    def __radd__(self, o):     return self._bin("add", o, rev=True)
    def __sub__(self, o):      return self._bin("sub", o)
    def __rsub__(self, o):     return self._bin("sub", o, rev=True)
    def __mul__(self, o):      return self._bin("mul", o)
    def __rmul__(self, o):     return self._bin("mul", o, rev=True)
    def __truediv__(self, o):  return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, rev=True)
    def __mod__(self, o):      return self._bin("mod", o)
    def __pow__(self, o):      return self._bin("pow", o)
    def __neg__(self):         return Expr(("neg", self.t))
    # comparisons ------------------------------------------------------------
    def __lt__(self, o):       return self._bin("lt", o)
    def __le__(self, o):       return self._bin("le", o)
    def __gt__(self, o):       return self._bin("gt", o)
    def __ge__(self, o):       return self._bin("ge", o)

    def eq(self, o):           return self._bin("eq", o)
    def ne(self, o):           return self._bin("ne", o)

    def __repr__(self):
        return f"Expr{self.t}"


def _t(x) -> tuple:
    return x.t if isinstance(x, Expr) else ("const", x)


# functional builders ---------------------------------------------------------
def v(name: str) -> Expr:
    return Expr(("var", name))


def c(val) -> Expr:
    return Expr(("const", val))


def exp(x): return Expr(("exp", _t(x)))
def log(x): return Expr(("log", _t(x)))
def sqrt(x): return Expr(("sqrt", _t(x)))
def rsqrt(x): return Expr(("rsqrt", _t(x)))
def tanh(x): return Expr(("tanh", _t(x)))
def sigmoid(x): return Expr(("sigmoid", _t(x)))
def abs_(x): return Expr(("abs", _t(x)))
def floor(x): return Expr(("floor", _t(x)))
def square(x): return Expr(("square", _t(x)))
def recip(x): return Expr(("recip", _t(x)))
def toint(x): return Expr(("toint", _t(x)))
def minimum(a, b): return Expr(("min", _t(a), _t(b)))
def maximum(a, b): return Expr(("max", _t(a), _t(b)))
def select(cond, a, b): return Expr(("select", _t(cond), _t(a), _t(b)))
def fma(a, b, c_): return Expr(("fma", _t(a), _t(b), _t(c_)))
def call(fn: str, *args): return Expr(("call", fn) + tuple(_t(a) for a in args))
# tile reductions (last axis, keepdims) and structural ops — TPU tile DSL
def rsum(x): return Expr(("rsum", _t(x)))
def rmean(x): return Expr(("rmean", _t(x)))
def rmax(x): return Expr(("rmax", _t(x)))
def rothalf(x): return Expr(("rothalf", _t(x)))  # rotate_half for RoPE
# composites used by models (stay as DSL so the saturator sees through them)
def silu(x):
    xe = _t(x)
    return Expr(("mul", xe, ("sigmoid", xe)))
def gelu_tanh(x):
    # 0.5*x*(1+tanh(sqrt(2/pi)*(x+0.044715*x^3)))
    xe = Expr(_t(x))
    inner = c(0.7978845608028654) * (xe + c(0.044715) * xe * xe * xe)
    return c(0.5) * xe * (c(1.0) + tanh(inner))
def softplus(x):
    return log(c(1.0) + exp(x))


# statements -------------------------------------------------------------------
@dataclasses.dataclass
class ArrayRef:
    name: str
    indices: Tuple[tuple, ...]  # index terms; () = whole tile


@dataclasses.dataclass
class Assign:
    target: Union[str, ArrayRef]
    expr: tuple


@dataclasses.dataclass
class If:
    cond: tuple
    then: List[Any]
    orelse: List[Any]


@dataclasses.dataclass
class For:
    var: str
    start: tuple
    stop: tuple
    body: List[Any]


@dataclasses.dataclass
class ArraySpec:
    name: str
    role: str  # 'in' | 'out' | 'inout'
    # Declared operand geometry, consumed by the analysis layer to price
    # HBM traffic at the true extent/byte width (None = unknown: a full
    # f32 tile). A dim may be None for a symbolic/runtime extent.
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: str = "f32"


class KernelProgram:
    """Builder for one saturable kernel (body of one parallel region).

    ``dtype`` is the kernel's default element type; per-array ``shape`` /
    ``dtype`` declarations refine it so the extraction cost model prices
    bf16/f8 tiles and broadcast scalars/rows honestly.
    """

    def __init__(self, name: str, dtype: str = "f32"):
        self.name = name
        self.dtype = dtype
        self.arrays: Dict[str, ArraySpec] = {}
        self.scalars: List[str] = []
        self.body: List[Any] = []
        self._stack: List[List[Any]] = [self.body]

    # ---- declarations -----------------------------------------------------
    def _declare(self, name: str, role: str, shape, dtype) -> "ArrayHandle":
        self.arrays[name] = ArraySpec(
            name, role, shape=tuple(shape) if shape is not None else None,
            dtype=dtype or self.dtype)
        return ArrayHandle(self, name)

    def array_in(self, name: str, shape: Optional[Sequence[Optional[int]]]
                 = None, dtype: Optional[str] = None) -> "ArrayHandle":
        return self._declare(name, "in", shape, dtype)

    def array_out(self, name: str, shape: Optional[Sequence[Optional[int]]]
                  = None, dtype: Optional[str] = None) -> "ArrayHandle":
        return self._declare(name, "out", shape, dtype)

    def array_inout(self, name: str, shape: Optional[Sequence[Optional[int]]]
                    = None, dtype: Optional[str] = None) -> "ArrayHandle":
        return self._declare(name, "inout", shape, dtype)

    def scalar(self, name: str) -> Expr:
        if name not in self.scalars:
            self.scalars.append(name)
        return v(name)

    # ---- statement emission --------------------------------------------------
    def let(self, name: str, expr) -> Expr:
        self._stack[-1].append(Assign(name, _t(expr)))
        return v(name)

    def store(self, array: Union[str, "ArrayHandle"], expr,
              *indices) -> None:
        name = array.name if isinstance(array, ArrayHandle) else array
        if name not in self.arrays:
            self.arrays[name] = ArraySpec(name, "out", dtype=self.dtype)
        idx = tuple(_t(i) for i in indices)
        self._stack[-1].append(Assign(ArrayRef(name, idx), _t(expr)))

    # ---- control flow (context managers) ---------------------------------------
    def if_(self, cond) -> "_BlockCtx":
        stmt = If(_t(cond), [], [])
        self._stack[-1].append(stmt)
        return _BlockCtx(self, stmt.then)

    def else_(self) -> "_BlockCtx":
        last = self._stack[-1][-1]
        assert isinstance(last, If), "else_ must follow if_"
        return _BlockCtx(self, last.orelse)

    def for_(self, var: str, start, stop) -> "_BlockCtx":
        stmt = For(var, _t(start), _t(stop), [])
        self._stack[-1].append(stmt)
        return _BlockCtx(self, stmt.body)

    def __repr__(self):
        return (f"KernelProgram({self.name}, arrays={list(self.arrays)}, "
                f"scalars={self.scalars}, stmts={len(self.body)})")


class _BlockCtx:
    def __init__(self, prog: KernelProgram, block: List[Any]):
        self.prog, self.block = prog, block

    def __enter__(self):
        self.prog._stack.append(self.block)
        return self

    def __exit__(self, *exc):
        self.prog._stack.pop()
        return False


class ArrayHandle:
    """Array symbol supporting h[i, j] loads and whole-tile h.load()."""

    def __init__(self, prog: KernelProgram, name: str):
        self.prog, self.name = prog, name

    def load(self, *indices) -> Expr:
        idx = tuple(_t(i) for i in indices)
        return Expr(("aload", self.name) + idx)

    def __getitem__(self, idx) -> Expr:
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self.load(*idx)
