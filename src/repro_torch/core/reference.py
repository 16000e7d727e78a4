"""Reference interpreter for the kernel DSL — the correctness oracle.

Executes a :class:`KernelProgram` imperatively with numpy, completely
independent of the e-graph/SSA/codegen path, so tests can check that
saturated kernels preserve semantics (paper's reproducibility requirement,
§IV).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .dsl import ArrayRef, Assign, For, If, KernelProgram
from .ir import EVAL_FNS


def _eval(t: tuple, env: Dict[str, Any], arrays: Dict[str, np.ndarray],
          calls: Dict[str, Any]):
    op = t[0]
    if op == "const":
        return t[1]
    if op == "var":
        return env[t[1]]
    if op == "aload":
        arr = arrays[t[1]]
        idx = tuple(int(_eval(i, env, arrays, calls)) for i in t[2:])
        return arr[idx] if idx else arr
    if op == "call":
        args = [_eval(a, env, arrays, calls) for a in t[2:]]
        return calls[t[1]](*args)
    args = [_eval(a, env, arrays, calls) for a in t[1:]]
    if op == "select":
        c, a, b = args
        return np.where(c, a, b)
    return EVAL_FNS[op](*args)


def _run_block(stmts, env, arrays, calls):
    for st in stmts:
        if isinstance(st, Assign):
            val = _eval(st.expr, env, arrays, calls)
            if isinstance(st.target, str):
                env[st.target] = val
            else:
                ref: ArrayRef = st.target
                idx = tuple(int(_eval(i, env, arrays, calls))
                            for i in ref.indices)
                if idx:
                    arrays[ref.name] = arrays[ref.name].copy()
                    arrays[ref.name][idx] = val
                else:
                    arrays[ref.name] = np.broadcast_to(
                        np.asarray(val, dtype=arrays[ref.name].dtype),
                        arrays[ref.name].shape).copy()
        elif isinstance(st, If):
            cond = _eval(st.cond, env, arrays, calls)
            if np.ndim(cond) == 0:
                _run_block(st.then if cond else st.orelse, env, arrays, calls)
            else:
                raise ValueError("reference interpreter requires scalar "
                                 "if-conditions; use select() for tiles")
        elif isinstance(st, For):
            start = int(_eval(st.start, env, arrays, calls))
            stop = int(_eval(st.stop, env, arrays, calls))
            for i in range(start, stop):
                env[st.var] = i
                _run_block(st.body, env, arrays, calls)
        else:
            raise TypeError(st)


def run_reference(prog: KernelProgram, inputs: Dict[str, Any],
                  calls: Dict[str, Any] | None = None) -> Dict[str, np.ndarray]:
    """Run ``prog`` on numpy inputs; returns the out/inout arrays."""
    env: Dict[str, Any] = {}
    arrays: Dict[str, np.ndarray] = {}
    for name, spec in prog.arrays.items():
        if name not in inputs:
            raise KeyError(f"missing array input {name!r} (out arrays need "
                           f"a zero-initialized buffer, like a C kernel)")
        arrays[name] = np.array(inputs[name], dtype=np.float64, copy=True)
    for s in prog.scalars:
        env[s] = inputs[s]
    _run_block(prog.body, env, arrays, calls or {})
    return {a.name: arrays[a.name] for a in prog.arrays.values()
            if a.role in ("out", "inout")}
