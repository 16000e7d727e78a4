"""SSA + φ construction from the kernel DSL into an e-graph (paper §IV-A).

Phases, mirroring the paper:
  1. conditional φ nodes represent ``if`` (value-merge / predication) and
     ``for`` (loop-carried φ with an abstract condition);
  2. every variable/array assignment gets an ID (an e-class);
  3. every load refers to the latest ID along its data flow
     (store→load forwarding when the index e-classes match exactly —
     sound even under aliasing, conservative otherwise via array
     versioning);
  4. assignments/φ and their expressions share an e-class.

The result keeps the *structure* (store order, loop nests) out of the
e-graph — exactly how the paper preserves directives and loop structure —
while the pure expressions become fully rewritable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.analysis.opstats import ArrayInfo

from .dsl import ArrayRef, Assign, For, If, KernelProgram
from .egraph import EGraph
from .ir import ENode


@dataclasses.dataclass
class StoreEffect:
    array: str
    version_in: str            # array-version symbol read-modified
    version_out: str           # version defined by this store
    index_cids: Tuple[int, ...]  # () = whole tile
    value_cid: int
    order: int
    pred_cid: Optional[int] = None  # predication condition (store under if)


@dataclasses.dataclass
class Carry:
    name: str
    placeholder_cid: int  # value at top of each iteration
    init_cid: int
    next_cid: int = -1
    post_cid: int = -1    # value after the loop (phi_loop node)


@dataclasses.dataclass
class ArrayCarry:
    name: str
    version_init: str     # version entering the loop
    version_body: str     # symbolic version at top of each iteration
    version_next: str = ""  # version at end of body
    version_post: str = ""  # version after the loop


@dataclasses.dataclass
class LoopRegion:
    loop_id: int
    var: str
    var_cid: int
    start_cid: int
    stop_cid: int
    carries: List[Carry]
    array_carries: List[ArrayCarry]
    body: "Region"
    order: int


@dataclasses.dataclass
class Region:
    items: List[Union[StoreEffect, LoopRegion]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class SSAResult:
    prog: KernelProgram
    egraph: EGraph
    region: Region
    # final array version symbol per array (what the kernel outputs)
    final_versions: Dict[str, str]
    # array version symbol -> how codegen binds it
    #   ('input', name) | ('store', StoreEffect) | ('loop', loop_id, name)
    version_origin: Dict[str, tuple]
    n_loads: int = 0
    n_stores: int = 0
    # e-classes the programmer named with `let` — the 'original code'
    # temporaries (baseline codegen reuses exactly these, §VIII)
    let_cids: Set[int] = dataclasses.field(default_factory=set)
    # SSA array table: array name -> declared (shape, dtype). Mirrors
    # egraph.array_info; the analysis layer prices loads/stores with it.
    array_info: Dict[str, ArrayInfo] = dataclasses.field(default_factory=dict)

    def store_infos(self) -> List[Optional[ArrayInfo]]:
        """Per-store operand info (array info after indexing), in program
        order — what each root store actually writes to HBM. Indexing
        semantics mirror loads: uniform (constant) indices slice the
        operand, varying indices keep a full per-lane tile."""
        out: List[Optional[ArrayInfo]] = []

        def walk(region: Region):
            for item in region.items:
                if isinstance(item, StoreEffect):
                    info = self.array_info.get(item.array)
                    out.append(self.egraph.operand_info(info,
                                                        item.index_cids))
                else:
                    walk(item.body)
        walk(self.region)
        return out

    def roots(self) -> List[int]:
        """Every e-class the codegen will need (extraction roots)."""
        out: List[int] = []

        def walk(region: Region):
            for item in region.items:
                if isinstance(item, StoreEffect):
                    out.append(item.value_cid)
                    out.extend(item.index_cids)
                    if item.pred_cid is not None:
                        out.append(item.pred_cid)
                else:
                    out.extend([item.start_cid, item.stop_cid])
                    for cparr in item.carries:
                        out.extend([cparr.init_cid, cparr.next_cid])
                    walk(item.body)
        walk(self.region)
        return out


class _ScopeError(ValueError):
    pass


class SSABuilder:
    def __init__(self, prog: KernelProgram, egraph: Optional[EGraph] = None):
        self.prog = prog
        self.eg = egraph or EGraph()
        self.env: Dict[str, int] = {}
        # array name -> current version symbol
        self.versions: Dict[str, str] = {}
        self.version_origin: Dict[str, tuple] = {}
        # array name -> (index_cids_key, value_cid): store->load forwarding
        self.forward: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        self._ver_counter: Dict[str, int] = {}
        self._loop_counter = 0
        self._order = 0
        self.n_loads = 0
        self.n_stores = 0
        self.let_cids: Set[int] = set()

    # -- helpers ------------------------------------------------------------
    def _new_version(self, array: str, tag: str = "") -> str:
        k = self._ver_counter.get(array, 0) + 1
        self._ver_counter[array] = k
        return f"{array}@{tag or k}"

    def _array_sym(self, version: str) -> int:
        return self.eg.add(ENode("array", (), version))

    def build(self) -> SSAResult:
        array_info: Dict[str, ArrayInfo] = {}
        for name, spec in self.prog.arrays.items():
            # record the declared (shape, dtype) in the array table and
            # register it with the e-graph's operand analysis up front,
            # before any load/store of the array is added
            info = ArrayInfo(shape=getattr(spec, "shape", None),
                             dtype=getattr(spec, "dtype", "f32"))
            array_info[name] = info
            self.eg.set_array_info(name, info)
            if spec.role in ("in", "inout"):
                ver = f"{name}@0"
                self.versions[name] = ver
                self.version_origin[ver] = ("input", name)
        for s in self.prog.scalars:
            self.env[s] = self.eg.add(ENode("var", (), s))
        region = Region()
        self._eval_block(self.prog.body, region, pred=None)
        return SSAResult(
            prog=self.prog, egraph=self.eg, region=region,
            final_versions=dict(self.versions),
            version_origin=dict(self.version_origin),
            n_loads=self.n_loads, n_stores=self.n_stores,
            let_cids=set(self.let_cids), array_info=array_info)

    # -- expression -> e-class ------------------------------------------------
    def eval_expr(self, t: tuple) -> int:
        op = t[0]
        if op == "const":
            return self.eg.add(ENode("const", (), t[1]))
        if op == "var":
            cid = self.env.get(t[1])
            if cid is None:
                raise _ScopeError(f"undefined variable {t[1]!r}")
            return cid
        if op == "aload":
            name = t[1]
            idx = tuple(self.eval_expr(i) for i in t[2:])
            return self._load(name, idx)
        if op == "call":
            fn = t[1]
            kids = tuple(self.eval_expr(a) for a in t[2:])
            return self.eg.add(ENode("call", kids, fn))
        kids = tuple(self.eval_expr(a) for a in t[1:])
        return self.eg.add(ENode(op, kids, None))

    def _load(self, name: str, idx: Tuple[int, ...]) -> int:
        if name not in self.versions:
            if name in self.prog.arrays:  # 'out' array read before write
                raise _ScopeError(f"array {name!r} read before any store")
            raise _ScopeError(f"unknown array {name!r}")
        fwd = self.forward.get(name)
        idx = tuple(self.eg.find(i) for i in idx)
        if fwd is not None and tuple(self.eg.find(i) for i in fwd[0]) == idx:
            return fwd[1]  # store->load forwarding (latest ID, §IV-A)
        self.n_loads += 1
        arr = self._array_sym(self.versions[name])
        return self.eg.add(ENode("load", (arr,) + idx, None))

    # -- statements --------------------------------------------------------------
    def _eval_block(self, stmts: List[Any], region: Region,
                    pred: Optional[int]) -> None:
        for st in stmts:
            self._order += 1
            if isinstance(st, Assign):
                self._eval_assign(st, region, pred)
            elif isinstance(st, If):
                self._eval_if(st, region, pred)
            elif isinstance(st, For):
                if pred is not None:
                    raise _ScopeError("for-loop under if is not supported; "
                                      "hoist the loop or predicate its body")
                self._eval_for(st, region)
            else:
                raise TypeError(f"unknown statement {st!r}")

    def _eval_assign(self, st: Assign, region: Region,
                     pred: Optional[int]) -> None:
        val = self.eval_expr(st.expr)
        if isinstance(st.target, str):
            if pred is not None and st.target in self.env:
                val = self.eg.add(ENode("phi",
                                        (pred, val, self.env[st.target])))
            self.env[st.target] = val
            self.let_cids.add(val)
            return
        # array store
        ref = st.target
        idx = tuple(self.eval_expr(i) for i in ref.indices)
        ver_in = self.versions.get(ref.name)
        if ver_in is None:  # first write to an 'out' array
            ver_in = f"{ref.name}@undef"
            self.version_origin[ver_in] = ("undef", ref.name)
        ver_out = self._new_version(ref.name)
        eff = StoreEffect(array=ref.name, version_in=ver_in,
                          version_out=ver_out, index_cids=idx,
                          value_cid=val, order=self._order, pred_cid=pred)
        self.versions[ref.name] = ver_out
        self.version_origin[ver_out] = ("store", eff)
        self.forward[ref.name] = (idx, val) if pred is None else None
        if self.forward[ref.name] is None:
            del self.forward[ref.name]
        region.items.append(eff)
        self.n_stores += 1

    def _eval_if(self, st: If, region: Region, pred: Optional[int]) -> None:
        cond = self.eval_expr(st.cond)
        if pred is not None:
            cond = self.eg.add(ENode("mul", (pred, cond)))  # logical and
        saved_env = dict(self.env)
        self._eval_block(st.then, region, pred=cond)
        then_env = self.env
        if st.orelse:
            self.env = dict(saved_env)
            notc = self.eg.add(ENode("sub", (
                self.eg.add(ENode("const", (), 1)), cond)))
            self._eval_block(st.orelse, region, pred=notc)
            # merge: names changed in either branch get phi(cond, then, else)
            merged = dict(saved_env)
            for name in set(then_env) | set(self.env):
                tval = then_env.get(name, saved_env.get(name))
                eval_ = self.env.get(name, saved_env.get(name))
                if tval is None or eval_ is None:
                    continue  # defined in only one branch and not before
                if tval == eval_:
                    merged[name] = tval
                else:
                    merged[name] = self.eg.add(ENode("phi", (cond, tval, eval_)))
            self.env = merged
        # (no else): _eval_assign already φ-merged against prior values

    def _collect_writes(self, stmts: List[Any],
                        scalars: Set[str], arrays: Set[str]) -> None:
        for st in stmts:
            if isinstance(st, Assign):
                if isinstance(st.target, str):
                    scalars.add(st.target)
                else:
                    arrays.add(st.target.name)
            elif isinstance(st, If):
                self._collect_writes(st.then, scalars, arrays)
                self._collect_writes(st.orelse, scalars, arrays)
            elif isinstance(st, For):
                scalars.add(st.var)
                self._collect_writes(st.body, scalars, arrays)

    def _eval_for(self, st: For, region: Region) -> None:
        loop_id = self._loop_counter
        self._loop_counter += 1
        start = self.eval_expr(st.start)
        stop = self.eval_expr(st.stop)
        wr_scalars: Set[str] = set()
        wr_arrays: Set[str] = set()
        self._collect_writes(st.body, wr_scalars, wr_arrays)
        wr_scalars.discard(st.var)

        # loop variable placeholder
        var_cid = self.eg.add(ENode("var", (), f"%L{loop_id}:{st.var}"))
        saved_env = dict(self.env)
        self.env[st.var] = var_cid

        # scalar carries: only names live before the loop are carried out
        carries: List[Carry] = []
        for name in sorted(wr_scalars):
            if name in saved_env:
                ph = self.eg.add(ENode("var", (), f"%L{loop_id}:{name}"))
                carries.append(Carry(name=name, placeholder_cid=ph,
                                     init_cid=saved_env[name]))
                self.env[name] = ph

        # array carries: any array stored inside the loop
        arr_carries: List[ArrayCarry] = []
        saved_versions = dict(self.versions)
        for name in sorted(wr_arrays):
            ver_init = self.versions.get(name, f"{name}@undef")
            if ver_init.endswith("@undef"):
                self.version_origin[ver_init] = ("undef", name)
            ver_body = f"{name}@L{loop_id}"
            arr_carries.append(ArrayCarry(name=name, version_init=ver_init,
                                          version_body=ver_body))
            self.versions[name] = ver_body
            self.version_origin[ver_body] = ("loop", loop_id, name)
            self.forward.pop(name, None)  # no forwarding across iterations

        body_region = Region()
        self._eval_block(st.body, body_region, pred=None)

        for carry in carries:
            carry.next_cid = self.env[carry.name]
            post = self.eg.add(ENode("phi_loop",
                                     (carry.init_cid, carry.next_cid),
                                     (loop_id, carry.name)))
            carry.post_cid = post
        for ac in arr_carries:
            ac.version_next = self.versions[ac.name]
            ac.version_post = f"{ac.name}@postL{loop_id}"
            self.version_origin[ac.version_post] = ("loop_post", loop_id,
                                                    ac.name)

        # restore env: loop var and body-locals go out of scope;
        # carried names bind to their phi_loop value
        self.env = saved_env
        for carry in carries:
            self.env[carry.name] = carry.post_cid
        for name in wr_arrays:
            self.versions[name] = next(a.version_post for a in arr_carries
                                       if a.name == name)
            self.forward.pop(name, None)

        region.items.append(LoopRegion(
            loop_id=loop_id, var=st.var, var_cid=var_cid,
            start_cid=start, stop_cid=stop, carries=carries,
            array_carries=arr_carries, body=body_region, order=self._order))


def build_ssa(prog: KernelProgram, egraph: Optional[EGraph] = None) -> SSAResult:
    return SSABuilder(prog, egraph).build()
