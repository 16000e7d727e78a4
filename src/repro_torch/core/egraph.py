"""E-graph with union-find, hash-consing, congruence closure and e-matching.

Follows the egg design [Willsey et al., POPL'21] the paper builds on
(§II-D): deferred rebuilding, a constant-folding e-class analysis, and
batched rule application with node/iteration/time limits (§VII uses
10 000 e-nodes, 10 iterations, 10 s saturation).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.opstats import ArrayInfo
from repro_torch.runtime.guard import guard_tick

from .ir import ENode, try_const_eval


class UnionFind:
    __slots__ = ("parent", "rank")

    def __init__(self):
        self.parent: List[int] = []
        self.rank: List[int] = []

    def make(self) -> int:
        self.parent.append(len(self.parent))
        self.rank.append(0)
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        # path compression
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra


class EClass:
    __slots__ = ("id", "nodes", "parents", "data", "ainfo")

    def __init__(self, cid: int):
        self.id = cid
        self.nodes: Set[ENode] = set()
        # (parent_enode_as_added, parent_class_id)
        self.parents: List[Tuple[ENode, int]] = []
        self.data: Any = None  # analysis value: folded constant or None
        # array-operand analysis: the (shape, dtype) this class denotes
        # when realized as an array symbol or load (None = not a memory
        # operand / unknown). Priced by the roofline cost model.
        self.ainfo: Optional[ArrayInfo] = None


class EGraph:
    """E-graph over :class:`repro.core.ir.ENode` terms."""

    def __init__(self, enable_const_fold: bool = True):
        self.uf = UnionFind()
        self.classes: Dict[int, EClass] = {}
        self.hashcons: Dict[ENode, int] = {}
        self.pending: List[int] = []  # classes whose parents need re-canon
        self.enable_const_fold = enable_const_fold
        self.n_unions = 0
        # SSA array table: base array name -> declared (shape, dtype).
        # Version symbols ("f@2", "f@L0") all resolve through their base
        # name, so every load of any version prices the same operand.
        self.array_info: Dict[str, ArrayInfo] = {}
        # bumped on every (re)declaration so bound cost models can tell
        # their cached load prices are stale (RooflineCostModel checks
        # this on bind_egraph; extract_dag rebinds per extraction)
        self.ainfo_version = 0

    def set_array_info(self, name: str, info: ArrayInfo) -> None:
        """Register an array declaration; re-derives (and overwrites) the
        analysis for any already-added symbol/load classes of that
        array, so late or corrected declarations take effect. Cost
        models bound to this graph pick the change up on their next
        ``bind_egraph`` (which every ``extract_dag`` call performs)."""
        self.array_info[name] = info
        self.ainfo_version += 1
        for node, cid in list(self.hashcons.items()):
            if node.op == "array" and self._array_base(node.payload) == name:
                self._analyze_ainfo(cid, node, overwrite=True)
                for pnode, pcid in self.classes[self.find(cid)].parents:
                    self._analyze_ainfo(pcid, self.canonicalize(pnode),
                                        overwrite=True)

    @staticmethod
    def _array_base(version_sym: Any) -> str:
        return str(version_sym).split("@", 1)[0]

    # -- basics ---------------------------------------------------------------
    def find(self, cid: int) -> int:
        return self.uf.find(cid)

    def canonicalize(self, node: ENode) -> ENode:
        return node.map_children(self.uf.find)

    def num_classes(self) -> int:
        return len({self.find(c) for c in self.classes})

    def num_nodes(self) -> int:
        return len(self.hashcons)

    # -- insertion ------------------------------------------------------------
    def add(self, node: ENode) -> int:
        node = self.canonicalize(node)
        existing = self.hashcons.get(node)
        if existing is not None:
            return self.find(existing)
        cid = self.uf.make()
        ec = EClass(cid)
        ec.nodes.add(node)
        self.classes[cid] = ec
        self.hashcons[node] = cid
        for ch in set(node.children):
            self.classes[self.find(ch)].parents.append((node, cid))
        self._analyze_node(cid, node)
        self._analyze_ainfo(cid, node)
        return cid

    def add_term(self, op: str, children: Iterable[int] = (),
                 payload: Any = None) -> int:
        return self.add(ENode(op, tuple(self.find(c) for c in children),
                              payload))

    # -- analysis (constant folding, paper §V-A) -------------------------------
    def _analyze_node(self, cid: int, node: ENode) -> None:
        if not self.enable_const_fold:
            return
        child_vals = tuple(self.classes[self.find(c)].data
                           for c in node.children)
        val = try_const_eval(node.op, child_vals, node.payload)
        if val is None:
            return
        ec = self.classes[self.find(cid)]
        if ec.data is None:
            ec.data = val
            # materialize the constant so extraction can pick it (cost 0)
            const_id = self.add(ENode("const", (), val))
            self.union(cid, const_id)

    def operand_info(self, info: Optional[ArrayInfo],
                     index_cids) -> Optional[ArrayInfo]:
        """Operand actually moved by an access of ``info`` at
        ``index_cids``.

        A *uniform* index (constant-folded e-class) selects one
        coordinate, shrinking the operand; a varying index (anything
        else, e.g. the thread/grid scalar) addresses a distinct element
        per lane, so the access still moves a full tile — only the
        declared dtype survives. This is what makes broadcast scalars/
        rows cheap without under-pricing per-lane gathers.
        """
        if info is None:
            return None
        index_cids = tuple(index_cids)
        if not index_cids:
            return info
        for c in index_cids:
            ec = self.classes.get(self.find(c))
            if ec is None or ec.data is None:
                return ArrayInfo(shape=None, dtype=info.dtype)
        return info.index(len(index_cids))

    def load_operand_info(self, node: ENode) -> Optional[ArrayInfo]:
        """Operand a ``load`` e-node moves (resolved at query time, so
        constants folded after the load was added are honored)."""
        if node.op != "load" or not node.children:
            return None
        ec = self.classes.get(self.find(node.children[0]))
        info = ec.ainfo if ec is not None else None
        return self.operand_info(info, node.children[1:])

    def _infer_ainfo(self, node: ENode) -> Optional[ArrayInfo]:
        """Array-operand analysis of one e-node (None = not an operand)."""
        if node.op == "array":
            return self.array_info.get(self._array_base(node.payload))
        if node.op == "load":
            return self.load_operand_info(node)
        return None

    def _analyze_ainfo(self, cid: int, node: ENode,
                       overwrite: bool = False) -> None:
        info = self._infer_ainfo(node)
        if info is None:
            return
        ec = self.classes[self.find(cid)]
        if ec.ainfo is None or overwrite:
            ec.ainfo = info

    # -- union + rebuild --------------------------------------------------------
    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        self.n_unions += 1
        root = self.uf.union(ra, rb)
        other = rb if root == ra else ra
        ec_root, ec_other = self.classes[root], self.classes[other]
        ec_root.nodes |= ec_other.nodes
        ec_root.parents.extend(ec_other.parents)
        # analysis merge: constants must agree; propagate if one-sided
        if ec_root.data is None and ec_other.data is not None:
            ec_root.data = ec_other.data
        # array-operand analysis: one-sided propagation; on disagreement
        # keep the root's (classes only merge when semantically equal, so
        # either description of the operand is a valid pricing basis)
        if ec_root.ainfo is None and ec_other.ainfo is not None:
            ec_root.ainfo = ec_other.ainfo
        del self.classes[other]
        self.pending.append(root)
        return root

    def rebuild(self) -> None:
        """Restore congruence: re-canonicalize parents of merged classes."""
        # guard hook (repro.runtime.guard): the node/class ceilings are
        # enforced here too — rebuild is where congruence closure can
        # blow a graph up past what run_rules' per-iteration check saw
        guard_tick("egraph", nodes=self.num_nodes(),
                   classes=self.num_classes())
        while self.pending:
            todo, self.pending = self.pending, []
            seen_roots = set()
            for cid in todo:
                root = self.find(cid)
                if root in seen_roots or root not in self.classes:
                    continue
                seen_roots.add(root)
                self._repair(root)

    def _repair(self, cid: int) -> None:
        ec = self.classes[cid]
        new_parents: Dict[ENode, int] = {}
        for pnode, pcid in ec.parents:
            # stale hashcons entry: remove then re-canonicalize
            self.hashcons.pop(pnode, None)
            canon = self.canonicalize(pnode)
            pcid = self.find(pcid)
            if canon in new_parents:
                # congruence: two parents became identical → union them
                self.union(pcid, new_parents[canon])
                pcid = self.find(pcid)
            prev = self.hashcons.get(canon)
            if prev is not None and self.find(prev) != pcid:
                self.union(prev, pcid)
                pcid = self.find(pcid)
            self.hashcons[canon] = pcid
            new_parents[canon] = pcid
        ec = self.classes[self.find(cid)]
        ec.parents = [(n, self.find(c)) for n, c in new_parents.items()]
        # re-run analysis over nodes of this class (children may have folded)
        if self.enable_const_fold and self.classes[self.find(cid)].data is None:
            for node in list(self.classes[self.find(cid)].nodes):
                self._analyze_node(self.find(cid), self.canonicalize(node))

    # -- invariant checking ------------------------------------------------------
    def check_invariants(self, *, strict: bool = False) -> list:
        """Static invariant audit (repro_torch.verify pass 2): union-find
        structure, hashcons/congruence closure, const-fold and ainfo
        analysis consistency. Returns the findings; with ``strict=True``
        raises AssertionError on any error-severity finding — the form
        tests call after run_rules and after a cache graft."""
        from repro_torch.verify.egraph_check import check_egraph
        findings = check_egraph(self)
        if strict:
            errors = [f for f in findings if f.severity == "error"]
            if errors:
                raise AssertionError(
                    "e-graph invariants violated:\n  " +
                    "\n  ".join(str(f) for f in errors))
        return findings

    # -- iteration ---------------------------------------------------------------
    def eclasses(self) -> Dict[int, EClass]:
        """Canonical (root) classes only."""
        return {cid: ec for cid, ec in self.classes.items()
                if self.find(cid) == cid}

    def nodes_of(self, cid: int) -> List[ENode]:
        return [self.canonicalize(n) for n in self.classes[self.find(cid)].nodes]

    # -- e-matching ----------------------------------------------------------------
    def ematch(self, pattern: "Pattern") -> List[Tuple[int, Dict[str, int]]]:
        """Return (root_class, substitution) pairs for every match."""
        out: List[Tuple[int, Dict[str, int]]] = []
        for cid, ec in list(self.eclasses().items()):
            for node in list(ec.nodes):
                node = self.canonicalize(node)
                for sub in self._match_node(pattern, node):
                    out.append((cid, sub))
        return out

    def _match_node(self, pat: "Pattern", node: ENode) -> List[Dict[str, int]]:
        if pat.op != node.op or len(pat.children) != len(node.children):
            return []
        if pat.payload is not _ANY and pat.payload != node.payload:
            return []
        subs = [dict()]
        for pchild, ccid in zip(pat.children, node.children):
            ccid = self.find(ccid)
            new_subs: List[Dict[str, int]] = []
            for sub in subs:
                new_subs.extend(self._match_class(pchild, ccid, sub))
            subs = new_subs
            if not subs:
                return []
        return subs

    def _match_class(self, pat: "PatTerm", cid: int,
                     sub: Dict[str, int]) -> List[Dict[str, int]]:
        if isinstance(pat, PatVar):
            bound = sub.get(pat.name)
            if bound is not None:
                return [sub] if self.find(bound) == cid else []
            s2 = dict(sub)
            s2[pat.name] = cid
            return [s2]
        out: List[Dict[str, int]] = []
        for node in self.nodes_of(cid):
            for s in self._match_node(pat, node):
                merged = dict(sub)
                ok = True
                for k, v in s.items():
                    if k in merged and self.find(merged[k]) != self.find(v):
                        ok = False
                        break
                    merged[k] = v
                if ok:
                    out.append(merged)
        return out

    # -- pattern instantiation ----------------------------------------------------
    def instantiate(self, pat: "PatTerm", sub: Dict[str, int]) -> int:
        if isinstance(pat, PatVar):
            return self.find(sub[pat.name])
        kids = tuple(self.instantiate(c, sub) for c in pat.children)
        payload = None if pat.payload is _ANY else pat.payload
        return self.add(ENode(pat.op, kids, payload))

    # -- extraction entry (delegates) ----------------------------------------------
    def extract(self, roots, cost_model=None, **kw):
        """Extract minimum-cost terms (roofline-predicted latency unless a
        flat cost model is passed explicitly)."""
        from .extract import extract_dag
        return extract_dag(self, roots, cost_model=cost_model, **kw)

    def choice_stats(self, choice, roots, n_stores: int = 0,
                     store_infos=None, cost_model=None):
        """Roofline statistics (flops/bytes/latency) of an extraction
        choice map — the unified analysis view of a selected term.

        ``n_stores`` adds the root stores' HBM write traffic (constant
        across choices, so reported but never minimized); ``store_infos``
        (one :class:`ArrayInfo` or None per store) prices each store at
        its target's true extent/byte width instead of a full f32 tile.
        ``cost_model`` overrides the default shape/dtype-aware roofline
        model bound to this e-graph.
        """
        from repro_torch.analysis import RooflineCostModel, store_stats
        from .extract import choice_nodes
        if isinstance(roots, int):
            roots = (roots,)
        nodes = choice_nodes(self, choice, roots)
        if nodes is None:
            return None
        cm = cost_model if cost_model is not None \
            else RooflineCostModel(egraph=self)
        stats = cm.choice_stats(nodes) + store_stats(
            n_stores, dtype_bytes=getattr(cm, "dtype_bytes", 4),
            infos=store_infos)
        return cm.latency.report(stats)


# -- patterns -------------------------------------------------------------------
class _Any:
    def __repr__(self):
        return "<any>"


_ANY = _Any()


class PatVar:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"?{self.name}"


class Pattern:
    __slots__ = ("op", "children", "payload")

    def __init__(self, op: str, children=(), payload=_ANY):
        self.op = op
        self.children = tuple(children)
        self.payload = payload

    def __repr__(self):
        return f"{self.op}({','.join(map(repr, self.children))})"


PatTerm = Any  # Pattern | PatVar


def P(op: str, *children, payload=_ANY) -> Pattern:
    return Pattern(op, children, payload)


def V(name: str) -> PatVar:
    return PatVar(name)


# -- term <-> egraph helpers ------------------------------------------------------
def add_expr(eg: EGraph, expr) -> int:
    """Add a nested-tuple term: ('add', ('var','x'), ('const', 1.0))."""
    if isinstance(expr, (int, float, bool)):
        return eg.add(ENode("const", (), expr))
    op = expr[0]
    if op in ("var", "array"):
        return eg.add(ENode(op, (), expr[1]))
    if op == "const":
        return eg.add(ENode("const", (), expr[1]))
    payload = None
    rest = expr[1:]
    if op == "call":
        payload, rest = expr[1], expr[2:]
    kids = tuple(add_expr(eg, e) for e in rest)
    return eg.add(ENode(op, kids, payload))


def extract_to_term(node_choice: Dict[int, ENode], eg: EGraph, cid: int):
    """Rebuild nested-tuple term from an extraction choice map."""
    cid = eg.find(cid)
    node = node_choice[cid]
    if node.op in ("var", "array"):
        return (node.op, node.payload)
    if node.op == "const":
        return ("const", node.payload)
    kids = tuple(extract_to_term(node_choice, eg, c) for c in node.children)
    if node.op == "call":
        return ("call", node.payload) + kids
    return (node.op,) + kids
