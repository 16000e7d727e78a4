"""Term IR for the saturator (paper §IV).

An :class:`ENode` is one operator application whose children are *e-class
ids* (ints). Leaf nodes carry a payload instead of children:

  op='const'  payload=float/int/bool  — literal (cost 0, paper §V-B)
  op='var'    payload=str             — SSA input variable (cost 1)
  op='load'   children=(array_class, *index_classes)  — memory read (cost 100)
  op='phi'    children=(cond, then, else)             — conditional phi (§IV-A)
  op='phi_loop' payload=loop_id children=(init, next) — loop-carried phi
  op='call'   payload=fn_name children=args           — function call (cost 100)
  op='array'  payload=str             — array symbol (for load/store roots)

Interior arithmetic ops use the canonical names below.  ``fma(a, b, c)``
denotes ``a + b * c`` exactly as the paper's FMA1 rule (Table I).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

# Canonical operator vocabulary ------------------------------------------------
# Binary arithmetic
BINOPS = ("add", "sub", "mul", "div", "mod", "min", "max", "pow")
# Unary
UNOPS = ("neg", "exp", "log", "sqrt", "rsqrt", "tanh", "abs", "sigmoid",
         "recip", "floor", "square", "toint")
# Tile reductions (last axis, keepdims=True) + structural tile ops.
# Scalars are fixed points of the reductions, so constant folding is sound.
REDOPS = ("rsum", "rmean", "rmax")
STRUCTOPS = ("rothalf",)
# Ternary
TERNOPS = ("fma", "select")
# Comparisons (produce booleans consumed by select/phi)
CMPOPS = ("lt", "le", "gt", "ge", "eq", "ne")
# Structural
LEAF_OPS = ("const", "var", "array")
MEM_OPS = ("load",)
CTRL_OPS = ("phi", "phi_loop", "call", "tuple")

ALL_OPS = (BINOPS + UNOPS + TERNOPS + CMPOPS + LEAF_OPS + MEM_OPS
           + CTRL_OPS + REDOPS + STRUCTOPS)

COMMUTATIVE = frozenset({"add", "mul", "min", "max", "eq", "ne"})


@dataclasses.dataclass(frozen=True, eq=False)
class ENode:
    """Immutable, hash-consable operator application.

    Equality/hash are *type-aware* on the payload: ``0``, ``0.0`` and
    ``False`` compare equal in Python but are distinct constants (an int
    loop bound must not alias a float accumulator init), so the payload
    type participates in the hash-cons key.
    """
    op: str
    children: Tuple[int, ...] = ()
    payload: Any = None

    def _key(self):
        return (self.op, self.children, type(self.payload).__name__,
                self.payload)

    def __eq__(self, other):
        if not isinstance(other, ENode):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        # hash(None) is id-based in CPython <= 3.11, i.e. different per
        # process under ASLR — which would reorder e-node sets (and with
        # them rule-match/union order, e-class numbering, and extraction
        # tie-breaks) from run to run even under a fixed PYTHONHASHSEED.
        # Substitute a stable sentinel so e-graph construction is
        # reproducible; equality semantics are unchanged.
        payload = self.payload
        if payload is None:
            payload = "\0none"
        return hash((self.op, self.children,
                     type(self.payload).__name__, payload))

    def map_children(self, f: Callable[[int], int]) -> "ENode":
        if not self.children:
            return self
        return ENode(self.op, tuple(f(c) for c in self.children), self.payload)

    def is_leaf(self) -> bool:
        return not self.children

    def __repr__(self) -> str:  # compact, used in debug dumps
        if self.op == "const":
            return f"#{self.payload}"
        if self.op in ("var", "array"):
            return f"{self.payload}"
        inner = ",".join(map(str, self.children))
        tag = f"[{self.payload}]" if self.payload is not None else ""
        return f"{self.op}{tag}({inner})"


def const(v) -> ENode:
    return ENode("const", (), v)


def var(name: str) -> ENode:
    return ENode("var", (), name)


# Numeric evaluation of operators (used by constant folding and by the
# reference interpreter in tests). Works on python scalars and numpy/jnp
# arrays alike.
def _sigmoid(x):
    import numpy as np
    return 1.0 / (1.0 + np.exp(-x))


EVAL_FNS: Dict[str, Callable] = {}


def _register_eval():
    import numpy as np
    EVAL_FNS.update({
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b,
        "div": lambda a, b: a / b,
        "mod": lambda a, b: a % b,
        "min": lambda a, b: np.minimum(a, b),
        "max": lambda a, b: np.maximum(a, b),
        "pow": lambda a, b: a ** b,
        "neg": lambda a: -a,
        "exp": np.exp,
        "log": np.log,
        "sqrt": np.sqrt,
        "rsqrt": lambda a: 1.0 / np.sqrt(a),
        "tanh": np.tanh,
        "abs": np.abs,
        "sigmoid": _sigmoid,
        "recip": lambda a: 1.0 / a,
        "floor": np.floor,
        "square": lambda a: a * a,
        "fma": lambda a, b, c: a + b * c,
        "select": lambda c, t, f: np.where(c, t, f),
        "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b,
        "eq": lambda a, b: a == b,
        "ne": lambda a, b: a != b,
        # reductions: identity on scalars, last-axis keepdims on arrays
        "rsum": lambda a: (np.sum(a, axis=-1, keepdims=True)
                           if getattr(a, "ndim", 0) else a),
        "rmean": lambda a: (np.mean(a, axis=-1, keepdims=True)
                            if getattr(a, "ndim", 0) else a),
        "rmax": lambda a: (np.max(a, axis=-1, keepdims=True)
                           if getattr(a, "ndim", 0) else a),
        "toint": lambda a: (a.astype(np.int64) if getattr(a, "ndim", 0)
                            else int(a)),
        "rothalf": lambda a: (np.concatenate(
            [-a[..., a.shape[-1] // 2:], a[..., :a.shape[-1] // 2]], axis=-1)
            if getattr(a, "ndim", 0) else a),
    })


_register_eval()


def try_const_eval(op: str, child_values: Tuple[Optional[Any], ...],
                   payload: Any = None) -> Optional[Any]:
    """Fold ``op`` over known-constant children; None if not foldable.

    Mirrors the paper's 'constant folding of arithmetic operations with
    integer and floating-point numbers' (§V-A).
    """
    if op == "const":
        return payload
    # rsum / rothalf of a constant-filled tile depend on the tile width, so
    # folding them to the scalar would be unsound under tile semantics.
    if op in ("rsum", "rothalf"):
        return None
    if any(v is None for v in child_values):
        return None
    fn = EVAL_FNS.get(op)
    if fn is None:
        return None
    try:
        import numpy as np
        with np.errstate(all="ignore"):
            out = fn(*child_values)
        # Only fold clean finite scalars — keep e-graph payloads hashable.
        if isinstance(out, (bool,)):
            return out
        out_f = float(out)
        if out_f != out_f or out_f in (float("inf"), float("-inf")):
            return None
        # preserve int-ness when exact
        if (isinstance(out, (int,)) or
                (out_f.is_integer() and all(isinstance(v, (int, bool))
                                            for v in child_values)
                 and op not in ("div", "rsqrt", "recip", "exp", "log",
                                "sqrt", "tanh", "sigmoid"))):
            return int(out_f)
        return out_f
    except Exception:
        return None
