"""Generated-code pass: AST-level analysis of emitted kernel sources.

The port of the JAX package's codegen pass. The port emits two kinds of
source for one saturated program, and this pass parses each with
:mod:`ast`:

**The torch source** (:mod:`repro_torch.core.torchgen`, the plain
version), checked as the JAX package checks its JAX source
(:func:`check_generated`):

* **out-of-bounds indexing** (``error``) — constant indices vs the
  declared :class:`~repro_torch.core.dsl.ArraySpec` shape, through the
  alias chain (``_v3 = x``, ``o_v_2 = _set(o_v_1, (i,), v)`` carry x's
  and o's shape), including ``_set`` stores and rank overflow;
* **use-before-def** (``error``) — a name read before any binding, with
  closure semantics for nested loop bodies (``def _loopN`` may read
  anything its enclosing function ever binds);
* **overwritten stores** (``warning``) — two ``_set`` stores to one
  array at the same static index with no read of that array between;
* **dead loads** (``warning``) — a ``_vN`` load temp never consumed;
* **memory-access order** (``info``) — the overlap-distance lint: loads
  whose first consumer is the immediately following statement leave the
  scheduler no latency to hide (one aggregated note per function).

**Each rendered Triton source** (:mod:`repro_torch.core.tritongen`, one
per launch layout), checked by :func:`check_triton_source`:

* **masking** (``error``, ``unmasked-access``) — every ``tl.load`` and
  ``tl.store`` of a layout that can end in a ragged tail carries a
  ``mask=``: every row and cycle layout (rows or positions past the end
  of the last block), and a flat layout with a tail outside its whole
  blocks (the branch under ``_blk < n_elems // BLOCK`` and the
  persistent walk over ``n_elems // BLOCK`` blocks);
* **neutral fill** (``error``, ``reduction-fill`` /
  ``unmasked-reduction``) — in a layout with masked column lanes, every
  row reduction sees the neutral value there (0 for a sum, −inf for a
  max): through ``tl.where(mask, x, neutral)``, or a masked load of that
  ``other=``;
* **offset width** (``error``, ``int32-offset``) — offsets are int64
  where the plan asks for it (``FlatLayout.off64``), and the row index
  of a row or cycle layout is int64 (``_rows * D`` passes 2^31 on large
  operands);
* **use-before-def** (``error``) — per branch and loop body, in order.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import PASS_CODEGEN, Finding

Shape = Optional[Tuple[Optional[int], ...]]

_TEMP_RE = re.compile(r"_v\d+$")
# the torch source's prelude helpers (torchgen's _PRELUDE): not generated
# code, and readable from every function
_PRELUDE = {"_T", "_rothalf", "_toint", "_set", "_fori_loop"}
_GLOBALS = {
    "torch", "_calls", "True", "False", "None", "range", "len", "float",
    "int", "tuple",
} | _PRELUDE


def shapes_of(prog) -> Dict[str, Shape]:
    """Declared shapes of a :class:`~repro_torch.core.dsl.KernelProgram`."""
    return {name: spec.shape for name, spec in prog.arrays.items()}


def _const_int(node: ast.expr) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_int(node.operand)
        return None if inner is None else -inner
    return None


def _index_elts(sl: ast.expr) -> List[ast.expr]:
    return list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]


def _is_set(node: ast.AST) -> bool:
    """``_set(array, (i, ...), value)``: the torch source's indexed store."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "_set" and len(node.args) == 3)


def check_generated(source: str, shapes: Dict[str, Shape], *,
                    subject: str = "") -> List[Finding]:
    """Analyze one emitted torch source against declared ``shapes``."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(PASS_CODEGEN, "error", "syntax-error",
                        f"emitted source does not parse: {e}",
                        subject=subject)]
    out: List[Finding] = []
    module_fns = {n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef)}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name not in _PRELUDE:
            out.extend(_check_fn(fn, shapes, module_fns, subject or fn.name))
    return out


# -- per-function analysis ----------------------------------------------------
def _assigned_names(stmts: List[ast.stmt]) -> Set[str]:
    """Every name a statement list binds, at any nesting depth."""
    out: Set[str] = set()
    for st in stmts:
        for node in ast.walk(st):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Store):
                out.add(node.id)
            elif isinstance(node, ast.FunctionDef):
                out.add(node.name)
                out.update(a.arg for a in node.args.args)
    return out


def _loads_outside_nested(st: ast.stmt) -> List[ast.Name]:
    """Name loads of one statement, excluding nested-function bodies
    (those are checked with closure semantics separately)."""
    found: List[ast.Name] = []

    def walk(node: ast.AST):
        if isinstance(node, ast.FunctionDef) and node is not st:
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            found.append(node)
        for ch in ast.iter_child_nodes(node):
            walk(ch)
    walk(st)
    return found


def _aliases(fn: ast.FunctionDef, shapes: Dict[str, Shape]
             ) -> Dict[str, str]:
    """The declared array each identifier stands for: the arrays
    themselves and whole-value aliases (``_v3 = x``, ``o_v_1 = _v8`` for
    a store, ``o_v_2 = _set(o_v_1, idx, v)``), and the post-loop values
    of loop-carried arrays (``post_a1 = _res1[k]`` is left alone: a
    tuple element)."""
    base: Dict[str, str] = {n: n for n in shapes}
    changed = True
    while changed:                       # aliases of aliases
        changed = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            tgt = node.targets[0].id
            if tgt in base:
                continue
            val = node.value
            src = val.id if isinstance(val, ast.Name) else \
                (val.args[0].id if _is_set(val)
                 and isinstance(val.args[0], ast.Name) else None)
            if src is not None and src in base:
                base[tgt] = base[src]
                changed = True
    return base


def _check_fn(fn: ast.FunctionDef, shapes: Dict[str, Shape],
              module_fns: Set[str], tag: str) -> List[Finding]:
    out: List[Finding] = []
    alias = _aliases(fn, shapes)

    def bounds(arr: Optional[str], elts: List[ast.expr]):
        shp = shapes.get(alias.get(arr or "", ""))
        if shp is None:
            return
        base = alias[arr]
        if len(elts) == 1 and isinstance(elts[0], ast.Constant) \
                and elts[0].value is Ellipsis:
            return
        if len(elts) > len(shp):
            out.append(Finding(
                PASS_CODEGEN, "error", "rank-mismatch",
                f"{base} has rank {len(shp)} but is indexed with "
                f"{len(elts)} subscripts", subject=f"{tag}:{base}"))
            return
        for dim, (elt, extent) in enumerate(zip(elts, shp)):
            idx = _const_int(elt)
            if idx is None or extent is None:
                continue                  # dynamic index / symbolic dim
            if not (-extent <= idx < extent):
                out.append(Finding(
                    PASS_CODEGEN, "error", "oob-index",
                    f"constant index {idx} out of bounds for {base} "
                    f"dim {dim} (extent {extent})",
                    subject=f"{tag}:{base}"))

    # ---- out-of-bounds / rank check over every subscript and store -------
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name):
            bounds(node.value.id, _index_elts(node.slice))
        elif _is_set(node) and isinstance(node.args[0], ast.Name):
            bounds(node.args[0].id, _index_elts(node.args[1]))

    # ---- use-before-def (closure-aware) -----------------------------------
    def scan(stmts: List[ast.stmt], defined: Set[str], closure: Set[str]):
        for st in stmts:
            if isinstance(st, ast.FunctionDef):
                # body runs later: it may read anything the enclosing
                # scope ever binds (loop carries, later temps)
                inner = set(a.arg for a in st.args.args)
                scan(st.body, inner,
                     closure | defined | _assigned_names(stmts))
                defined.add(st.name)
                continue
            for nm in _loads_outside_nested(st):
                name = nm.id
                if name in defined or name in closure or \
                        name in _GLOBALS or name in module_fns:
                    continue
                out.append(Finding(
                    PASS_CODEGEN, "error", "use-before-def",
                    f"{name!r} is read at line {nm.lineno} before any "
                    f"definition", subject=f"{tag}:{name}"))
                defined.add(name)        # report each name once
            for node in ast.walk(st):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Store):
                    defined.add(node.id)

    scan(fn.body, {a.arg for a in fn.args.args}, set())

    # ---- linear top-level walk: stores, dead loads, overlap ---------------
    all_loads: Dict[str, List[int]] = {}     # name -> stmt positions read
    load_defs: Dict[str, int] = {}           # _vN load temp -> position
    writes: Dict[str, List[Tuple[int, str]]] = {}  # array -> (pos, idx)
    reads_of_array: Dict[str, List[int]] = {}
    for pos, st in enumerate(fn.body):
        updated = {id(node.args[0]) for node in ast.walk(st)
                   if _is_set(node)}
        for nm in _loads_outside_nested(st) + [
                n for f_ in ast.walk(st) if isinstance(f_, ast.FunctionDef)
                for n in ast.walk(f_)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]:
            all_loads.setdefault(nm.id, []).append(pos)
            # the array a _set updates is not read by the store itself
            if nm.id in alias and id(nm) not in updated:
                reads_of_array.setdefault(alias[nm.id], []).append(pos)
        if not isinstance(st, ast.Assign) or len(st.targets) != 1 \
                or not isinstance(st.targets[0], ast.Name):
            continue
        tgt, val = st.targets[0].id, st.value
        if _is_set(val) and isinstance(val.args[0], ast.Name) \
                and val.args[0].id in alias:
            writes.setdefault(alias[val.args[0].id], []).append(
                (pos, ast.dump(val.args[1])))
        elif _TEMP_RE.match(tgt):
            src = val.id if isinstance(val, ast.Name) else \
                (val.value.id if isinstance(val, ast.Subscript)
                 and isinstance(val.value, ast.Name) else None)
            if src is not None and src in shapes:
                load_defs[tgt] = pos

    # overwritten stores: same static index, no intervening read
    for base, ws in writes.items():
        for (p1, i1), (p2, i2) in zip(ws, ws[1:]):
            if i1 != i2:
                continue
            if not [p for p in reads_of_array.get(base, [])
                    if p1 < p < p2]:
                out.append(Finding(
                    PASS_CODEGEN, "warning", "overwritten-store",
                    f"store to {base} at statement {p1} is overwritten "
                    f"at {p2} with no intervening read",
                    subject=f"{tag}:{base}"))

    # dead loads + overlap-distance lint
    zero_overlap = 0
    for name, pos in load_defs.items():
        later = [p for p in all_loads.get(name, []) if p > pos]
        if not later:
            out.append(Finding(
                PASS_CODEGEN, "warning", "dead-load",
                f"load temp {name} (statement {pos}) is never read",
                subject=f"{tag}:{name}"))
        elif later[0] == pos + 1:
            zero_overlap += 1
    if zero_overlap:
        out.append(Finding(
            PASS_CODEGEN, "info", "zero-overlap-load",
            f"{zero_overlap} of {len(load_defs)} loads are consumed by "
            f"the immediately following statement (no latency-hiding "
            f"distance)", subject=tag))
    return out


# -- Triton sources -------------------------------------------------------------
_TRITON_GLOBALS = {"tl", "triton", "float", "int", "range", "True", "False",
                   "None"}
_NEUTRAL = {"sum": (0.0,), "max": (float("-inf"),)}


def _tl_call(node: ast.AST, *names: str) -> Optional[str]:
    """``name`` where ``node`` is a call ``tl.<name>(...)``."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id == "tl" and node.func.attr in names:
        return node.func.attr
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _float_value(node: Optional[ast.expr]) -> Optional[float]:
    """A constant fill value: a number, ``-x``, or ``float("-inf")``."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, float)):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _float_value(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "float" and len(node.args) == 1 \
            and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return float(node.args[0].value)
    return None


def _whole_block_guard(st: ast.stmt) -> bool:
    """Whether a statement opens the flat plan's region of whole blocks:
    ``if _blk < n_elems // BLOCK:`` (its body) or a walk ``for _blk in
    tl.range(start, n_elems // BLOCK, ...)``."""
    whole = "n_elems // BLOCK"
    if isinstance(st, ast.If):
        t = st.test
        return (isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Lt)
                and isinstance(t.left, ast.Name) and t.left.id == "_blk"
                and ast.unparse(t.comparators[0]) == whole)
    if isinstance(st, ast.For) and _tl_call(st.iter, "range"):
        args = st.iter.args
        return len(args) >= 2 and ast.unparse(args[1]) == whole
    return False


def check_triton_source(source: str, layout: Sequence, *,
                        subject: str = "") -> List[Finding]:
    """Analyze one rendered Triton tile-kernel source for its ``layout``
    (``TileCallPlan.layout``: operand kinds, column pieces, persistent,
    flat form); see the module docstring for the checks."""
    _, pieces, _, flat = layout
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(PASS_CODEGEN, "error", "syntax-error",
                        f"rendered Triton source does not parse: {e}",
                        subject=subject)]
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(fns) != 1:
        return [Finding(PASS_CODEGEN, "error", "kernel-count",
                        f"{len(fns)} functions in a Triton tile source",
                        subject=subject)]
    fn = fns[0]
    tag = subject or fn.name
    out: List[Finding] = []
    defs: Dict[str, ast.expr] = {}           # name -> last assigned value
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            defs[node.targets[0].id] = node.value

    # ---- masking of every access ------------------------------------------
    ragged = flat is None or flat.tail

    def accesses(stmts: List[ast.stmt], whole: bool):
        for st in stmts:
            inner = whole or (flat is not None and _whole_block_guard(st))
            if isinstance(st, (ast.If, ast.For)):
                for node in ast.walk(st.test if isinstance(st, ast.If)
                                     else st.iter):
                    yield node, whole
                yield from accesses(st.body, inner)
                yield from accesses(st.orelse, whole)
                continue
            for node in ast.walk(st):
                yield node, whole

    for node, whole in accesses(fn.body, False):
        kind = _tl_call(node, "load", "store")
        if kind and ragged and not whole and _kw(node, "mask") is None:
            out.append(Finding(
                PASS_CODEGEN, "error", "unmasked-access",
                f"tl.{kind} at line {node.lineno} has no mask= in a "
                f"layout whose last block can be ragged",
                subject=f"{tag}:line{node.lineno}"))

    # ---- neutral fill of every reduction over masked column lanes --------
    if flat is None and not pieces and "_cmask" in defs:
        for node in ast.walk(fn):
            red = _tl_call(node, "sum", "max")
            if red is None or not node.args:
                continue
            arg = node.args[0]
            where = _tl_call(arg, "where")
            if where and len(arg.args) == 3:
                fill = _float_value(arg.args[2])
                if fill not in _NEUTRAL[red]:
                    out.append(Finding(
                        PASS_CODEGEN, "error", "reduction-fill",
                        f"tl.{red} at line {node.lineno} fills masked "
                        f"lanes with {ast.unparse(arg.args[2])}, not "
                        f"{_NEUTRAL[red][0]}",
                        subject=f"{tag}:line{node.lineno}"))
                continue
            load = _load_of(arg, defs)
            if load is None:
                out.append(Finding(
                    PASS_CODEGEN, "error", "unmasked-reduction",
                    f"tl.{red} at line {node.lineno} reduces "
                    f"{ast.unparse(arg)} over masked column lanes with "
                    f"no neutral fill", subject=f"{tag}:line{node.lineno}"))
            elif _float_value(_kw(load, "other")) not in _NEUTRAL[red]:
                out.append(Finding(
                    PASS_CODEGEN, "error", "reduction-fill",
                    f"tl.{red} at line {node.lineno} reduces a load whose "
                    f"other= is not {_NEUTRAL[red][0]}",
                    subject=f"{tag}:line{node.lineno}"))

    # ---- offset width -------------------------------------------------------
    def int64(name: str) -> bool:
        return any(ast.unparse(v).count("tl.int64")
                   for n, v in _all_assigns(fn) if n == name)
    if flat is not None:
        if flat.off64 and not all(
                "tl.int64" in ast.unparse(v)
                for n, v in _all_assigns(fn) if n == "_offs"):
            out.append(Finding(
                PASS_CODEGEN, "error", "int32-offset",
                "the plan asks for int64 offsets, and an _offs is int32",
                subject=f"{tag}:_offs"))
    else:
        index = "_pos" if "_pos" in defs else "_rows"
        if not int64(index):
            out.append(Finding(
                PASS_CODEGEN, "error", "int32-offset",
                f"{index} is not int64: row offsets pass 2^31 on large "
                f"operands", subject=f"{tag}:{index}"))

    # ---- use-before-def, per branch and loop body ----------------------------
    def scan(stmts: List[ast.stmt], defined: Set[str]) -> Set[str]:
        for st in stmts:
            heads = [st.test] if isinstance(st, ast.If) else \
                [st.iter] if isinstance(st, ast.For) else [st]
            for h in heads:
                for nm in ast.walk(h):
                    if isinstance(nm, ast.Name) and \
                            isinstance(nm.ctx, ast.Load) and \
                            nm.id not in defined and \
                            nm.id not in _TRITON_GLOBALS:
                        out.append(Finding(
                            PASS_CODEGEN, "error", "use-before-def",
                            f"{nm.id!r} is read at line {nm.lineno} before "
                            f"any definition", subject=f"{tag}:{nm.id}"))
                        defined.add(nm.id)
            if isinstance(st, ast.If):
                a = scan(st.body, set(defined))
                b = scan(st.orelse, set(defined))
                defined |= a & b
            elif isinstance(st, ast.For):
                body = set(defined)
                body.update(n.id for n in ast.walk(st.target)
                            if isinstance(n, ast.Name))
                scan(st.body, body)
            else:
                defined.update(n.id for n in ast.walk(st)
                               if isinstance(n, ast.Name)
                               and isinstance(n.ctx, ast.Store))
        return defined

    scan(fn.body, {a.arg for a in fn.args.args})
    return out


def _all_assigns(fn: ast.FunctionDef):
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            yield node.targets[0].id, node.value


def _load_of(arg: ast.expr, defs: Dict[str, ast.expr]) -> Optional[ast.Call]:
    """The ``tl.load`` a reduction's operand is (``x`` assigned
    ``tl.load(...)``, or ``tl.load(...).to(...)``), or None."""
    val = defs.get(arg.id) if isinstance(arg, ast.Name) else arg
    while isinstance(val, ast.Call) and isinstance(val.func, ast.Attribute) \
            and val.func.attr == "to":
        val = val.func.value
    return val if _tl_call(val, "load") else None
