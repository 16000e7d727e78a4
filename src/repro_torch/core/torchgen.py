"""Torch code generation from extracted e-graphs (paper §VI).

The port of :class:`repro.core.codegen.JaxCodeGenerator` (the ``"jax"``
emitter of the JAX package): the same temporary-variable insertion and
bulk-load scheduling, emitting Python/torch source instead of jnp/lax.

* **Temporary-variable insertion** (§VI-A): every selected e-node becomes a
  ``_v{n}`` SSA temp placed immediately before its first use (innermost
  scope covering all uses), so shared subexpressions are computed once.
* **Bulk load** (§VI-B): with ``bulk=True`` every memory load is relocated
  to the *first point where its dependencies are resolved* — the top of the
  innermost legal region, re-flushed after each store/loop that defines a
  new array version — and loads of the same array are sorted by their
  static index representation.

Statement order is owned by :mod:`repro_torch.core.schedule`: the
``schedule`` parameter picks ``"source"`` (loads at use sites),
``"bulk"`` (the paper's rule) or ``"cost"`` (a cost-driven legal
topological order; emission then follows the explicit per-region order).

The emitted source is exec'd into a callable over torch tensors. It is
the plain version of every generated tile kernel (the CPU path, and the
yardstick :mod:`repro_torch.core.tritongen` is checked against on the
card). Indexed stores never write an argument in place: they build a new
tensor, as the functional JAX code does.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.runtime import chaos

from .egraph import EGraph
from .extract import ExtractionResult
from .ir import CMPOPS, ENode
from .schedule import (SCHEDULE_MODES, ScheduleResult, compute_schedule,
                       legacy_bulk_key)
from .ssa import ArrayCarry, Carry, LoopRegion, Region, SSAResult, StoreEffect

sys.setrecursionlimit(100_000)


def _sanitize(sym: str) -> str:
    return (sym.replace("@", "_v_").replace(":", "_").replace("%", "p_")
            .replace(".", "_"))


@dataclasses.dataclass
class GenStats:
    n_temps: int = 0
    n_loads: int = 0
    n_stores: int = 0
    n_fma: int = 0
    n_ops: int = 0
    instruction_mix: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-region: how many loads were emitted before the first compute op
    loads_before_compute: int = 0
    dag_cost: float = 0.0


@dataclasses.dataclass
class GeneratedKernel:
    name: str
    source: str
    fn: Callable
    in_arrays: List[str]
    scalars: List[str]
    out_arrays: List[str]
    stats: GenStats
    bulk: bool
    schedule_mode: str = "bulk"            # source | bulk | cost
    schedule: Optional[ScheduleResult] = None  # set for explicit orders

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)


_PRELUDE = """\
import torch

def _T(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(x)

def _rothalf(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)

def _toint(x):
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else int(x)

def _set(a, idx, val):
    out = a.clone()
    out[idx] = val
    return out

def _fori_loop(start, stop, body, carry):
    for i in range(int(start), int(stop)):
        carry = body(i, carry)
    return carry
"""

# ``_T`` lifts a Python scalar (a folded constant or a scalar argument)
# to a 0-d tensor where torch only takes tensors; a 0-d tensor does not
# promote a tile's dtype, as a weakly typed JAX scalar does not.
_UNARY_FMT = {
    "neg": "(-{0})",
    "exp": "torch.exp(_T({0}))",
    "log": "torch.log(_T({0}))",
    "sqrt": "torch.sqrt(_T({0}))",
    "rsqrt": "torch.rsqrt(_T({0}))",
    "tanh": "torch.tanh(_T({0}))",
    "abs": "torch.abs(_T({0}))",
    "sigmoid": "torch.sigmoid(_T({0}))",
    "recip": "(1.0 / {0})",
    "floor": "torch.floor(_T({0}))",
    "square": "({0} * {0})",
    "toint": "_toint({0})",
    "rsum": "torch.sum({0}, dim=-1, keepdim=True)",
    "rmean": "torch.mean({0}, dim=-1, keepdim=True)",
    "rmax": "torch.amax({0}, dim=-1, keepdim=True)",
    "rothalf": "_rothalf({0})",
}
_BIN_FMT = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "mod": "({0} % {1})", "pow": "({0} ** {1})",
    "min": "torch.minimum(_T({0}), _T({1}))",
    "max": "torch.maximum(_T({0}), _T({1}))",
    "lt": "({0} < {1})", "le": "({0} <= {1})", "gt": "({0} > {1})",
    "ge": "({0} >= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})",
}
_TERN_FMT = {
    "fma": "({0} + {1} * {2})",
    "select": "torch.where(_T({0}), {1}, {2})",
    "phi": "torch.where(_T({0}), {1}, {2})",
}


class _Scope:
    """Stack of name bindings; inner scopes see outer bindings.

    ``forced`` bindings (loop vars, carries, post-loop values) are always
    visible; ``memo`` bindings implement temp reuse and are consulted only
    when the generator runs with ``reuse_temps=True`` (CSE on). Disabling
    them reproduces the 'original' code with fully re-expanded expressions.
    """

    def __init__(self):
        self.stack: List[Dict[int, str]] = [{}]
        self.forced: List[Dict[int, str]] = [{}]
        self.syms: List[Dict[str, str]] = [{}]  # array-version symbol -> name

    def push(self):
        self.stack.append({})
        self.forced.append({})
        self.syms.append({})

    def pop(self):
        self.stack.pop()
        self.forced.pop()
        self.syms.pop()

    def get(self, cid: int, memo: bool = True) -> Optional[str]:
        for frame in reversed(self.forced):
            if cid in frame:
                return frame[cid]
        if memo:
            for frame in reversed(self.stack):
                if cid in frame:
                    return frame[cid]
        return None

    def bind(self, cid: int, name: str):
        self.stack[-1][cid] = name

    def bind_forced(self, cid: int, name: str):
        self.forced[-1][cid] = name

    def get_sym(self, sym: str) -> Optional[str]:
        for frame in reversed(self.syms):
            if sym in frame:
                return frame[sym]
        return None

    def bind_sym(self, sym: str, name: str):
        self.syms[-1][sym] = name


class TorchCodeGenerator:
    """The ``"torch"`` emitter: saturated Python/torch source, exec'd
    into a callable."""

    def __init__(self, ssa: SSAResult, extraction: ExtractionResult, *,
                 bulk: bool = True, fn_name: Optional[str] = None,
                 extra_fns: Optional[Dict[str, Callable]] = None,
                 reuse_temps: bool = True,
                 schedule: Optional[Union[str, ScheduleResult]] = None,
                 sched_cost_model=None):
        self.ssa = ssa
        self.eg: EGraph = ssa.egraph
        self.choice: Dict[int, ENode] = dict(extraction.choice)
        # ``schedule`` overrides the legacy bulk flag: a mode name picks a
        # named order ("bulk" stays bit-identical to bulk=True, "source"
        # to bulk=False, "cost" searches); a ScheduleResult is emitted
        # verbatim (the legality-fuzz tests inject arbitrary legal orders
        # this way). ``sched_cost_model`` prices the cost search — pass
        # the extraction's (possibly calibrated) roofline model so both
        # optimize the same objective.
        if isinstance(schedule, ScheduleResult):
            self.schedule_mode = schedule.mode
            self._explicit: Optional[ScheduleResult] = schedule
        else:
            if schedule is not None and schedule not in SCHEDULE_MODES:
                raise ValueError(f"schedule must be one of "
                                 f"{SCHEDULE_MODES}, got {schedule!r}")
            self.schedule_mode = schedule if schedule is not None else \
                ("bulk" if bulk else "source")
            self._explicit = None
        self.bulk = self.schedule_mode == "bulk"
        self._sched_cm = sched_cost_model
        # reuse_temps: True = CSE on (memoize every e-class); False/"lets"
        # = only programmer-named `let` values are reused, reproducing the
        # original source's temporaries (the paper's un-optimized input)
        self.reuse_temps = reuse_temps
        self._let_set = {ssa.egraph.find(c) for c in ssa.let_cids}
        self.fn_name = fn_name or _sanitize(ssa.prog.name)
        self.extra_fns = extra_fns or {}
        self.scope = _Scope()
        self.tmp = 0
        self.stats = GenStats(dag_cost=extraction.dag_cost)
        self._load_regions: Dict[int, Tuple[int, ...]] = {}
        self._region_first_compute: Dict[Tuple[int, ...], bool] = {}

    def _resolve_schedule(self) -> Optional[ScheduleResult]:
        """The explicit per-region order to emit, or None for the legacy
        source/bulk paths (which stay bit-identical to the original emitter)."""
        if self._explicit is None and self.schedule_mode == "cost":
            cm = self._sched_cm if hasattr(self._sched_cm, "latency") \
                else None   # flat models can't price a schedule
            if cm is not None and hasattr(cm, "bind_egraph"):
                cm.bind_egraph(self.eg)
            self._explicit = compute_schedule(
                self.ssa, self.choice, mode="cost", cost_model=cm)
        return self._explicit

    # -- choice helpers -----------------------------------------------------
    def _numeric(self, cid: int, name: str) -> str:
        """``name`` as a number where it holds a comparison's bool tensor
        (0/1, as the reference's jnp arithmetic promotes it)."""
        return f"{name}.float()" if self.node(cid).op in CMPOPS else name

    def node(self, cid: int) -> ENode:
        cid = self.eg.find(cid)
        n = self.choice.get(cid)
        if n is None:
            # node outside extraction (e.g. demanded pred/index added late):
            # fall back to a fresh greedy extraction for it
            from .extract import extract_dag
            res = extract_dag(self.eg, (cid,), local_search=False)
            for k, v in res.choice.items():
                self.choice.setdefault(k, v)
            n = self.choice[cid]
        return n

    def _fresh(self) -> str:
        self.tmp += 1
        return f"_v{self.tmp}"

    # -- load-region analysis (bulk mode) ---------------------------------------
    def _collect_load_regions(self):
        """min legal region (loop-id path) for every load in the chosen dag."""
        memo: Dict[int, Tuple[int, ...]] = {}
        var_region: Dict[str, Tuple[int, ...]] = {}
        sym_region: Dict[str, Tuple[int, ...]] = {}

        def index_regions(region: Region, path: Tuple[int, ...]):
            for item in region.items:
                if isinstance(item, LoopRegion):
                    inner = path + (item.loop_id,)
                    var_region[f"%L{item.loop_id}:{item.var}"] = inner
                    for carry in item.carries:
                        var_region[f"%L{item.loop_id}:{carry.name}"] = inner
                    for ac in item.array_carries:
                        sym_region[ac.version_body] = inner
                        sym_region[ac.version_post] = path
                    index_regions(item.body, inner)
                else:
                    sym_region[item.version_out] = path
        index_regions(self.ssa.region, ())

        def join(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
            return a if len(a) >= len(b) else b

        def walk(cid: int) -> Tuple[int, ...]:
            cid = self.eg.find(cid)
            if cid in memo:
                return memo[cid]
            memo[cid] = ()  # provisional (acyclic by extraction)
            n = self.node(cid)
            r: Tuple[int, ...] = ()
            if n.op == "var" and isinstance(n.payload, str):
                r = var_region.get(n.payload, ())
            elif n.op == "array":
                r = sym_region.get(n.payload, ())
            for ch in n.children:
                r = join(r, walk(ch))
            memo[cid] = r
            if n.op == "load":
                self._load_regions[cid] = r
            return r

        for root in self.ssa.roots():
            walk(root)

    # -- expression emission ---------------------------------------------------------
    def _const_repr(self, val) -> str:
        if isinstance(val, bool):
            return "True" if val else "False"
        return repr(val)

    def emit_value(self, cid: int, lines: List[str], indent: str) -> str:
        cid = self.eg.find(cid)
        memo_ok = (self.reuse_temps is True
                   or (self.reuse_temps in (False, "lets")
                       and cid in self._let_set))
        bound = self.scope.get(cid, memo=memo_ok)
        if bound is not None:
            return bound
        n = self.node(cid)
        op = n.op
        if op == "const":
            return self._const_repr(n.payload)
        if op == "var":
            if isinstance(n.payload, str) and n.payload.startswith("%"):
                raise RuntimeError(f"unbound placeholder {n.payload}")
            return n.payload  # function parameter
        if op == "array":
            name = self.scope.get_sym(n.payload)
            if name is None:
                raise RuntimeError(f"unbound array version {n.payload}")
            return name
        kid_names = [self.emit_value(ch, lines, indent) for ch in n.children]
        name = self._fresh()
        self.stats.n_temps += 1
        self.stats.instruction_mix[op] = \
            self.stats.instruction_mix.get(op, 0) + 1
        if op == "load":
            self.stats.n_loads += 1
            arr = kid_names[0]
            if len(kid_names) == 1:
                expr = arr  # whole-tile load
            else:
                expr = f"{arr}[{', '.join(kid_names[1:])}]"
        elif op == "call":
            self.stats.n_ops += 1
            expr = f"_calls[{n.payload!r}]({', '.join(kid_names)})"
        elif op in _UNARY_FMT:
            self.stats.n_ops += 1
            if op == "neg":     # nor negate one
                kid_names = [self._numeric(n.children[0], kid_names[0])]
            expr = _UNARY_FMT[op].format(*kid_names)
        elif op in _BIN_FMT:
            self.stats.n_ops += 1
            if op == "sub":     # torch refuses to subtract a bool tensor
                kid_names = [self._numeric(c, k)
                             for c, k in zip(n.children, kid_names)]
            expr = _BIN_FMT[op].format(*kid_names)
        elif op in _TERN_FMT:
            self.stats.n_ops += 1
            if op == "fma":
                self.stats.n_fma += 1
            expr = _TERN_FMT[op].format(*kid_names)
        else:
            raise NotImplementedError(f"codegen for op {op!r}")
        lines.append(f"{indent}{name} = {expr}")
        self.scope.bind(cid, name)
        return name

    # -- bulk-load flushing ---------------------------------------------------------
    def _deps_ready(self, cid: int, visiting: Optional[Set[int]] = None) -> bool:
        cid = self.eg.find(cid)
        if self.scope.get(cid) is not None:
            return True
        visiting = visiting or set()
        if cid in visiting:
            return False
        visiting.add(cid)
        n = self.node(cid)
        if n.op == "var" and isinstance(n.payload, str) and \
                n.payload.startswith("%"):
            return False
        if n.op == "array":
            return self.scope.get_sym(n.payload) is not None
        return all(self._deps_ready(c, visiting) for c in n.children)

    def _load_sort_key(self, cid: int):
        # the flush order is owned by the schedule subsystem (its "bulk"
        # order reproduces this exact key), never an ad-hoc sort here
        return legacy_bulk_key(self.node, cid)

    def _flush_loads(self, path: Tuple[int, ...], pending: List[int],
                     lines: List[str], indent: str):
        """Emit every pending load whose dependencies are resolved, in
        the schedule subsystem's bulk order — the paper's bulk-load
        rule."""
        ready = [c for c in pending if self._deps_ready(c)]
        for cid in sorted(ready, key=self._load_sort_key):
            self.emit_value(cid, lines, indent)
            if not self._region_first_compute.get(path, False):
                # index math emitted alongside counts as address
                # calculation (paper Listing 3: "Addr calculation + 123
                # loads"), not as the region's first compute
                self.stats.loads_before_compute += 1
            pending.remove(cid)

    # -- region emission ---------------------------------------------------------------
    def emit_region(self, region: Region, path: Tuple[int, ...],
                    lines: List[str], indent: str):
        sched = self._explicit.regions.get(path) \
            if self._explicit is not None else None
        if sched is not None:
            self._emit_scheduled(sched, path, lines, indent)
            return
        pending = [cid for cid, r in self._load_regions.items()
                   if r == path and self.scope.get(cid) is None] \
            if self.bulk else []
        if self.bulk:
            self._flush_loads(path, pending, lines, indent)
        for item in region.items:
            if isinstance(item, StoreEffect):
                self._emit_store(item, lines, indent)
            else:
                self._emit_loop(item, path, lines, indent)
            self._region_first_compute[path] = True
            if self.bulk:
                self._flush_loads(path, pending, lines, indent)

    def _emit_scheduled(self, sched, path: Tuple[int, ...],
                        lines: List[str], indent: str):
        """Emit one region following an explicit schedule order. Each
        unit is emitted at its scheduled slot; ``emit_value`` pulls any
        non-unit leaves (consts, bound vars) inline, and a unit already
        bound by an earlier recursion is a no-op."""
        for u in sched.ordered_units():
            if u.kind in ("load", "compute"):
                self.emit_value(u.cid, lines, indent)
                if u.kind == "load" and \
                        not self._region_first_compute.get(path, False):
                    self.stats.loads_before_compute += 1
                else:
                    self._region_first_compute[path] = True
            elif u.kind == "store":
                self._emit_store(u.item, lines, indent)
                self._region_first_compute[path] = True
            else:
                self._emit_loop(u.item, path, lines, indent)
                self._region_first_compute[path] = True

    def _emit_store(self, eff: StoreEffect, lines: List[str], indent: str):
        val = self.emit_value(eff.value_cid, lines, indent)
        idx = [self.emit_value(i, lines, indent) for i in eff.index_cids]
        src = self.scope.get_sym(eff.version_in)
        if src is None:
            raise RuntimeError(f"array version {eff.version_in} unbound")
        dst = _sanitize(eff.version_out)
        if eff.pred_cid is not None:
            pred = self.emit_value(eff.pred_cid, lines, indent)
            if idx:
                old = f"{src}[{', '.join(idx)}]"
            else:
                old = src
            val_expr = f"torch.where(_T({pred}), {val}, {old})"
        else:
            val_expr = val
        if idx:
            lines.append(f"{indent}{dst} = _set({src}, ({', '.join(idx)},), "
                         f"{val_expr})")
        else:
            if eff.pred_cid is None:
                lines.append(f"{indent}{dst} = {val_expr}")
            else:
                lines.append(f"{indent}{dst} = {val_expr}")
        self.scope.bind_sym(eff.version_out, dst)
        self.stats.n_stores += 1

    def _emit_loop(self, loop: LoopRegion, path: Tuple[int, ...],
                   lines: List[str], indent: str):
        start = self.emit_value(loop.start_cid, lines, indent)
        stop = self.emit_value(loop.stop_cid, lines, indent)
        inits = [self.emit_value(c.init_cid, lines, indent)
                 for c in loop.carries]
        arr_inits = []
        for ac in loop.array_carries:
            name = self.scope.get_sym(ac.version_init)
            if name is None:
                raise RuntimeError(f"loop-carried array {ac.version_init} "
                                   f"unbound")
            arr_inits.append(name)
        fn = f"_loop{loop.loop_id}"
        carry_names = [f"c_{_sanitize(c.name)}{loop.loop_id}"
                       for c in loop.carries]
        arr_names = [f"a_{_sanitize(ac.name)}{loop.loop_id}"
                     for ac in loop.array_carries]
        all_names = carry_names + arr_names
        ivar = f"i{loop.loop_id}"
        lines.append(f"{indent}def {fn}({ivar}, _carry):")
        inner = indent + "    "
        if all_names:
            lines.append(f"{inner}{', '.join(all_names)}"
                         f"{',' if len(all_names) == 1 else ''} = _carry")
        self.scope.push()
        self.scope.bind_forced(self.eg.find(loop.var_cid), ivar)
        for c, nm in zip(loop.carries, carry_names):
            self.scope.bind_forced(self.eg.find(c.placeholder_cid), nm)
        for ac, nm in zip(loop.array_carries, arr_names):
            self.scope.bind_sym(ac.version_body, nm)
        body_lines: List[str] = []
        self.emit_region(loop.body, path + (loop.loop_id,), body_lines, inner)
        nexts = [self.emit_value(c.next_cid, body_lines, inner)
                 for c in loop.carries]
        arr_nexts = []
        for ac in loop.array_carries:
            nm = self.scope.get_sym(ac.version_next)
            arr_nexts.append(nm if nm is not None else
                             self.scope.get_sym(ac.version_body))
        self.scope.pop()
        lines.extend(body_lines if body_lines else [f"{inner}pass"])
        rets = nexts + arr_nexts
        lines.append(f"{inner}return ({', '.join(rets)}"
                     f"{',' if len(rets) == 1 else ''})")
        init_tuple = ", ".join(inits + arr_inits)
        trailing = "," if len(inits) + len(arr_inits) == 1 else ""
        res = f"_res{loop.loop_id}"
        lines.append(f"{indent}{res} = _fori_loop({start}, {stop}, {fn}, "
                     f"({init_tuple}{trailing}))")
        # bind post-loop values
        for k, c in enumerate(loop.carries):
            nm = f"post_{_sanitize(c.name)}{loop.loop_id}"
            lines.append(f"{indent}{nm} = {res}[{k}]")
            self.scope.bind_forced(self.eg.find(c.post_cid), nm)
        for k, ac in enumerate(loop.array_carries):
            nm = f"post_{_sanitize(ac.name)}{loop.loop_id}"
            lines.append(f"{indent}{nm} = {res}[{len(loop.carries) + k}]")
            self.scope.bind_sym(ac.version_post, nm)

    # -- top level ------------------------------------------------------------------------
    def generate(self) -> GeneratedKernel:
        prog = self.ssa.prog
        in_arrays = [a.name for a in prog.arrays.values()]
        out_arrays = [a.name for a in prog.arrays.values()
                      if a.role in ("out", "inout")]
        scalars = list(prog.scalars)
        params = in_arrays + scalars
        lines: List[str] = []
        indent = "    "
        # bind array inputs (version @0 and @undef both map to the argument)
        for a in prog.arrays.values():
            self.scope.bind_sym(f"{a.name}@0", a.name)
            self.scope.bind_sym(f"{a.name}@undef", a.name)
        sched = self._resolve_schedule()
        if sched is None and self.bulk:
            self._collect_load_regions()
        self.emit_region(self.ssa.region, (), lines, indent)
        rets = []
        for name in out_arrays:
            ver = self.ssa.final_versions.get(name, f"{name}@0")
            nm = self.scope.get_sym(ver)
            rets.append(nm if nm is not None else name)
        body = "\n".join(lines) if lines else "    pass"
        src = (f"{_PRELUDE}\n"
               f"def {self.fn_name}({', '.join(params)}):\n"
               f"{body}\n"
               f"    return ({', '.join(rets)}{',' if len(rets) == 1 else ''})\n")
        glb: Dict[str, Any] = {"_calls": self.extra_fns}
        chaos.maybe_raise("exec_fail", self.ssa.prog.name,
                          "generated torch source")
        exec(compile(src, f"<saturated:{self.fn_name}>", "exec"), glb)
        return GeneratedKernel(
            name=self.fn_name, source=src, fn=glb[self.fn_name],
            in_arrays=in_arrays, scalars=scalars, out_arrays=out_arrays,
            stats=self.stats, bulk=self.bulk,
            schedule_mode=self.schedule_mode, schedule=sched)
