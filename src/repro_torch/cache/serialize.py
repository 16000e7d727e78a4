"""Structural (de)serialization of cached saturation results.

E-class ids are *process-local*: they depend on insertion and
set-iteration order, so a cache entry must never store a cid. Instead
the committed extraction choice is serialized as a flat, topologically
ordered node list — ``[op, [child_indices...], payload]`` — where every
child reference is an index into the same list. Schedule orders are
serialized per region as unit keys that survive the same translation:
``["load"|"compute", node_index]``, ``["store", store_order]``,
``["loop", loop_id]`` (store orders and loop ids are assigned by the
deterministic SSA build, so they are stable across processes).

Deserialization *grafts* the cached term DAG back into a fresh SSA
e-graph: each node is re-added bottom-up (``EGraph.add`` hash-conses,
so nodes that already exist resolve to their canonical class), and each
reconstructed root is unioned with the corresponding SSA root. The
union is sound because the cache key pins the exact program and rule
set — the cached term was proven equal to the root by a previous
saturation of the *same* e-graph (the eqsat-dialect "non-destructive
reuse of e-graph state" idea). This is what lets an exact hit skip
``run_rules`` entirely, not just the extraction search.

Anything unexpected raises :class:`CacheInvalid`; callers treat it as a
miss and fall back to the cold path — a corrupt entry can cost time,
never correctness.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.extract import choice_nodes
from repro_torch.core.ir import ENode


class CacheInvalid(ValueError):
    """Entry cannot be used (corrupt, stale, or structurally wrong)."""


# -- payload encoding --------------------------------------------------------
# Payloads are typed: 0, 0.0 and False are distinct constants (the
# type-aware ENode hash), so the JSON encoding carries an explicit tag.
def _enc_payload(p: Any) -> Any:
    if p is None:
        return ["none"]
    if isinstance(p, bool):
        return ["bool", p]
    if isinstance(p, int):
        return ["int", p]
    if isinstance(p, float):
        return ["float", p.hex()]   # exact round trip, incl. inf/-0.0
    if isinstance(p, str):
        return ["str", p]
    if isinstance(p, tuple):
        return ["tuple", [_enc_payload(x) for x in p]]
    raise CacheInvalid(f"unsupported payload type {type(p).__name__}")


def _dec_payload(doc: Any) -> Any:
    try:
        tag = doc[0]
        if tag == "none":
            return None
        if tag == "bool":
            return bool(doc[1])
        if tag == "int":
            return int(doc[1])
        if tag == "float":
            return float.fromhex(doc[1])
        if tag == "str":
            return str(doc[1])
        if tag == "tuple":
            return tuple(_dec_payload(x) for x in doc[1])
    except (TypeError, ValueError, IndexError, KeyError) as e:
        raise CacheInvalid(f"bad payload {doc!r}: {e}") from e
    raise CacheInvalid(f"unknown payload tag {doc!r}")


# -- choice <-> flat node list ----------------------------------------------
def choice_to_doc(eg, choice: Dict[int, ENode], roots: Sequence[int]
                  ) -> Tuple[Dict[str, Any], Dict[int, int]]:
    """Serialize the chosen DAG reachable from ``roots``.

    Returns ``(doc, index_of)`` where ``index_of`` maps canonical cid →
    node index (the schedule serializer reuses it).
    """
    nodes: List[Any] = []
    index_of: Dict[int, int] = {}

    def visit(cid: int) -> int:
        cid = eg.find(cid)
        if cid in index_of:
            return index_of[cid]
        n = choice.get(cid)
        if n is None:
            raise CacheInvalid(f"choice has no node for class {cid}")
        ch = [visit(c) for c in n.children]   # acyclic by extraction
        idx = len(nodes)
        nodes.append([n.op, ch, _enc_payload(n.payload)])
        index_of[cid] = idx
        return idx

    root_idx = [visit(r) for r in roots]
    return {"nodes": nodes, "roots": root_idx}, index_of


def graft_choice(eg, doc: Dict[str, Any], ssa_roots: Sequence[int]
                 ) -> Tuple[Dict[int, ENode], Tuple[int, ...]]:
    """Rebuild a serialized choice inside ``eg`` (see module docstring).

    ``eg`` may be the fresh SSA e-graph (exact-hit replay: no
    saturation ran) or the saturated one (warm-start seeding) — either
    way missing nodes are added and the reconstructed roots are unioned
    with ``ssa_roots``. Returns the canonical ``(choice, roots)``.

    Validation is ordered so an invalid entry mutates ``eg`` as little
    as possible: node structure and payloads are checked before any
    ``add`` (a ``var`` payload is emitted *verbatim* into exec'd kernel
    source by codegen, so it must name a variable the e-graph already
    knows — a cache entry can never introduce new program text), and
    the choice must cover its own reconstructed roots acyclically
    *before* the root unions merge any classes. Added-but-unused nodes
    land in fresh unreachable classes; no equivalence is created until
    the entry has fully validated.
    """
    try:
        nodes_doc = list(doc["nodes"])
        root_idx = list(doc["roots"])
    except (TypeError, KeyError) as e:
        raise CacheInvalid(f"malformed choice doc: {e}") from e

    # pass 1: decode + validate structurally, no e-graph mutation
    allowed_vars = {n.payload for n in eg.hashcons if n.op == "var"}
    decoded: List[Tuple[str, List[int], Any]] = []
    for i, entry in enumerate(nodes_doc):
        try:
            op, ch_idx, payload = entry
            ch_idx = list(ch_idx)
        except (TypeError, ValueError) as e:
            raise CacheInvalid(f"malformed node {entry!r}") from e
        if not isinstance(op, str):
            raise CacheInvalid(f"bad op {op!r}")
        for j in ch_idx:
            if not isinstance(j, int) or isinstance(j, bool) \
                    or not 0 <= j < i:
                raise CacheInvalid(f"bad child index in {entry!r}")
        p = _dec_payload(payload)
        if op == "var" and p not in allowed_vars:
            raise CacheInvalid(f"var payload {p!r} is not a variable of "
                               "this kernel (refusing to emit it)")
        decoded.append((op, ch_idx, p))

    # pass 2: graft (EGraph.add hash-conses; no unions yet)
    cids: List[int] = []
    for op, ch_idx, p in decoded:
        children = tuple(eg.find(cids[j]) for j in ch_idx)
        cids.append(eg.add(ENode(op, children, p)))

    # pass 3: the choice must stand on its own roots before we union
    # anything — a failure here leaves roots/equivalences untouched
    ssa_roots = [eg.find(r) for r in ssa_roots]
    try:
        rec_roots = [eg.find(cids[i]) for i in root_idx]
    except (IndexError, TypeError) as e:
        raise CacheInvalid(f"bad root index: {e}") from e
    if len(rec_roots) != len(ssa_roots):
        raise CacheInvalid(f"entry has {len(rec_roots)} roots, "
                           f"kernel has {len(ssa_roots)}")

    def _canonical_choice() -> Dict[int, ENode]:
        out: Dict[int, ENode] = {}
        for i, (op, ch_idx, p) in enumerate(decoded):
            children = tuple(eg.find(cids[j]) for j in ch_idx)
            out.setdefault(eg.find(cids[i]),
                           eg.canonicalize(ENode(op, children, p)))
        return out

    if choice_nodes(eg, _canonical_choice(), rec_roots) is None:
        raise CacheInvalid("reconstructed choice does not cover its own "
                           "roots acyclically")

    changed = False
    for a, b in zip(rec_roots, ssa_roots):
        if eg.find(a) != eg.find(b):
            eg.union(a, b)
            changed = True
    if changed:
        eg.rebuild()

    choice = _canonical_choice()
    roots = tuple(eg.find(r) for r in ssa_roots)
    if choice_nodes(eg, choice, roots) is None:
        raise CacheInvalid("reconstructed choice does not cover the "
                           "kernel roots acyclically")
    return choice, roots


def index_to_cid(eg, doc: Dict[str, Any], cids_hint: Optional[List[int]]
                 = None) -> List[int]:
    """Canonical cid of every serialized node, post-graft. Re-walks the
    doc (cheap) so callers don't have to thread the graft's internals."""
    cids: List[int] = []
    for op, ch_idx, payload in doc["nodes"]:
        children = tuple(eg.find(cids[j]) for j in ch_idx)
        node = eg.canonicalize(ENode(op, children, _dec_payload(payload)))
        cid = eg.hashcons.get(node)
        if cid is None:
            raise CacheInvalid(f"grafted node vanished: {node!r}")
        cids.append(eg.find(cid))
    return cids


# -- schedule orders <-> unit keys ------------------------------------------
def schedule_to_doc(sr, eg, index_of: Dict[int, int]
                    ) -> Optional[Dict[str, Any]]:
    """Serialize a ScheduleResult's per-region orders, or None when a
    unit's class is outside the serialized choice (late-demanded
    classes resolved by the greedy fallback — rare; the entry then
    caches the choice but not the order)."""
    orders: Dict[str, Any] = {}
    for path, rs in sr.regions.items():
        keys: List[Any] = []
        for u in rs.ordered_units():
            if u.kind in ("load", "compute"):
                idx = index_of.get(eg.find(u.cid))
                if idx is None:
                    return None
                keys.append([u.kind, idx])
            elif u.kind == "store":
                keys.append(["store", int(u.item.order)])
            else:
                keys.append(["loop", int(u.item.loop_id)])
        orders[",".join(map(str, path))] = keys
    return {"mode": sr.mode, "orders": orders,
            "predicted_ns": sr.predicted_ns,
            "predicted_by_mode": dict(sr.predicted_by_mode)}


def orders_from_doc(doc: Dict[str, Any], node_cids: List[int]
                    ) -> Dict[Tuple[int, ...], List[Tuple[str, Any]]]:
    """Translate serialized orders back to the unit-key form
    ``compute_schedule(fixed_orders=...)`` consumes: node indices become
    canonical cids, store/loop keys pass through."""
    out: Dict[Tuple[int, ...], List[Tuple[str, Any]]] = {}
    try:
        for path_s, keys in doc["orders"].items():
            path = tuple(int(x) for x in path_s.split(",")) if path_s \
                else ()
            units = []
            for kind, ref in keys:
                if kind in ("load", "compute"):
                    units.append((kind, node_cids[int(ref)]))
                elif kind in ("store", "loop"):
                    units.append((kind, int(ref)))
                else:
                    raise CacheInvalid(f"unknown unit kind {kind!r}")
            out[path] = units
    except (TypeError, ValueError, KeyError, IndexError) as e:
        raise CacheInvalid(f"malformed schedule doc: {e}") from e
    return out
