"""Schedule-legality pass: independent certification of emitted orders.

:mod:`repro_torch.core.schedule` builds a dependence DAG and asserts its own
orders are topological — but a bug in its edge construction would
certify its own output. This pass is the N-version check: it re-derives
the dependence requirements of every scheduled unit **from the SSA
structure and the extracted choice alone** (never reading
``SchedUnit.deps``) and replays the emitted order as a forward
simulation:

* **RAW (data)** — a unit may only issue once every unit in the chosen
  cone of its operands has issued, and a load of an array version only
  after the store/loop defining that version;
* **WAR (anti)** — a store/loop overwriting a version must wait for
  every reader (load, or loop carrying the version in) of the
  overwritten version — an emitter may rebind refs in place, so
  this is a real hazard;
* **store-store** — stores to one array issue in version-chain order;
* **coverage** — the order is a permutation of the region's units and
  every store/loop of the SSA region appears exactly once.

Any emitted order — ``source``/``bulk``/``cost`` or a cached replay
(``fixed_orders``) — can be certified; a clean pass means the order is
a legal topological order of the independently derived dependences.

The port adds :func:`verify_persistent_walk`, the counterpart of the
JAX package's check of its pipelined emitter's async copies: the
pipelined Triton kernel has no explicit copies (Triton's software
pipeliner stages its loads), so what is certified is the persistent
grid's walk over the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

from repro_torch.core.ssa import LoopRegion, Region, SSAResult, StoreEffect

from .findings import PASS_SCHEDULE, Finding


@dataclasses.dataclass
class ScheduleCheckResult:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    regions_checked: int = 0
    regions_certified: int = 0   # regions with zero error findings

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)


def _loop_roots(loop: LoopRegion) -> List[int]:
    """Every e-class a loop's emission demands (independent walk of the
    SSA structure — bounds, carry init/next, body store operands)."""
    out = [loop.start_cid, loop.stop_cid]
    for c in loop.carries:
        out.extend([c.init_cid, c.next_cid])

    def body(region: Region):
        for it in region.items:
            if isinstance(it, StoreEffect):
                out.append(it.value_cid)
                out.extend(it.index_cids)
                if it.pred_cid is not None:
                    out.append(it.pred_cid)
            else:
                out.extend(_loop_roots(it))
    body(loop.body)
    return out


def _unit_desc(u) -> str:
    if u.kind in ("load", "compute"):
        return f"{u.kind}(cid={u.cid})"
    if u.kind == "store":
        return f"store({u.item.array}→{u.item.version_out})"
    return f"loop(id={u.item.loop_id})"


def verify_schedule(ssa: SSAResult, choice, sched) -> ScheduleCheckResult:
    """Certify every region order of ``sched`` against independently
    re-derived RAW/WAR/store-store dependences."""
    eg = ssa.egraph
    choice = dict(choice)

    def node(cid: int):
        cid = eg.find(cid)
        nd = choice.get(cid)
        if nd is None:
            # classes demanded after extraction (late preds/indices) get
            # the same greedy local completion codegen uses
            from repro_torch.core.extract import extract_dag
            res = extract_dag(eg, (cid,), local_search=False)
            for k, v in res.choice.items():
                choice.setdefault(k, v)
            nd = choice[cid]
        return nd

    items_by_path: Dict[Tuple[int, ...], list] = {}

    def index(region: Region, path: Tuple[int, ...]):
        items_by_path[path] = list(region.items)
        for it in region.items:
            if isinstance(it, LoopRegion):
                index(it.body, path + (it.loop_id,))
    index(ssa.region, ())

    res = ScheduleCheckResult()
    for path in items_by_path:
        if path not in sched.regions:
            res.findings.append(Finding(
                PASS_SCHEDULE, "error", "missing-region",
                f"SSA region {path!r} has no schedule",
                subject=f"region{path}"))

    for path, rs in sorted(sched.regions.items()):
        res.regions_checked += 1
        before = len([f for f in res.findings if f.severity == "error"])
        _check_region(eg, node, path, items_by_path.get(path, []),
                      rs, res.findings)
        after = len([f for f in res.findings if f.severity == "error"])
        if after == before:
            res.regions_certified += 1
    return res


def _check_region(eg, node, path, items, rs, findings: List[Finding]):
    units = rs.units
    order = rs.order
    region_tag = f"region{path}"

    uids = sorted(u.uid for u in units)
    if sorted(order) != uids:
        findings.append(Finding(
            PASS_SCHEDULE, "error", "not-a-permutation",
            f"order {order} is not a permutation of unit ids {uids}",
            subject=region_tag))
        return

    # -- coverage: every SSA store/loop of this region, exactly once ------
    # keyed structurally (store version chain / loop id are unique), so
    # replayed or deserialized schedules with equal-but-distinct item
    # objects still certify
    def item_key(it):
        if isinstance(it, StoreEffect):
            return ("store", it.array, it.version_out)
        return ("loop", it.loop_id)

    unit_keys = [item_key(u.item) for u in units
                 if u.kind in ("store", "loop")]
    expected = [item_key(it) for it in items]
    for key in expected:
        hits = unit_keys.count(key)
        if hits != 1:
            findings.append(Finding(
                PASS_SCHEDULE, "error", "region-incomplete",
                f"SSA {key[0]} {key[1:]} appears {hits}× in the "
                f"schedule (expected once)", subject=region_tag))
    for key in unit_keys:
        if key not in expected:
            findings.append(Finding(
                PASS_SCHEDULE, "error", "foreign-item",
                f"schedule contains {key[0]} {key[1:]} not in this SSA "
                f"region", subject=region_tag))

    # -- independent requirement derivation -------------------------------
    cid_unit: Dict[int, int] = {eg.find(u.cid): u.uid for u in units
                                if u.cid is not None}
    loop_uid: Dict[int, int] = {u.item.loop_id: u.uid for u in units
                                if u.kind == "loop"}
    sym_def: Dict[str, int] = {}
    for u in units:
        if u.kind == "store":
            sym_def[u.item.version_out] = u.uid
        elif u.kind == "loop":
            for ac in u.item.array_carries:
                sym_def[ac.version_body] = u.uid
                sym_def[ac.version_post] = u.uid

    def cone(self_uid: int, roots) -> Tuple[Set[int], Set[str]]:
        req: Set[int] = set()
        syms: Set[str] = set()
        seen: Set[int] = set()

        def walk(cid: int):
            cid = eg.find(cid)
            if cid in seen:
                return
            seen.add(cid)
            owner = cid_unit.get(cid)
            if owner is not None and owner != self_uid:
                req.add(owner)
                return
            nd = node(cid)
            if nd.op == "array":
                syms.add(nd.payload)
                return
            if nd.op == "phi_loop":
                lu = loop_uid.get(nd.payload[0])
                if lu is not None and lu != self_uid:
                    req.add(lu)
                walk(nd.children[0])  # init value
                return
            for ch in nd.children:
                walk(ch)

        for r in roots:
            walk(r)
        return req, syms

    requires: Dict[int, Set[int]] = {}
    readers: Dict[str, List[int]] = {}
    overwrites: Dict[int, List[str]] = {}
    for u in units:
        if u.kind in ("load", "compute"):
            req, syms = cone(u.uid, node(u.cid).children)
        elif u.kind == "store":
            it = u.item
            roots = [it.value_cid] + list(it.index_cids)
            if it.pred_cid is not None:
                roots.append(it.pred_cid)
            req, syms = cone(u.uid, roots)
            syms.add(it.version_in)          # store chain (RAW)
            overwrites[u.uid] = [it.version_in]
        else:                                 # loop
            req, syms = cone(u.uid, _loop_roots(u.item))
            for ac in u.item.array_carries:
                syms.add(ac.version_init)    # carried array enters here
            overwrites[u.uid] = [ac.version_init
                                 for ac in u.item.array_carries]
        for sym in syms:
            d = sym_def.get(sym)
            if d is not None and d != u.uid:
                req.add(d)
            readers.setdefault(sym, []).append(u.uid)
        requires[u.uid] = req

    # WAR: whoever overwrites a version waits for all its readers
    for uid, syms in overwrites.items():
        for sym in syms:
            for rd in readers.get(sym, []):
                if rd != uid:
                    requires[uid].add(rd)

    # -- replay the emitted order -----------------------------------------
    pos = {uid: i for i, uid in enumerate(order)}
    by_uid = {u.uid: u for u in units}
    for u in units:
        late = sorted(d for d in requires[u.uid] if pos[d] >= pos[u.uid])
        if late:
            deps_txt = ", ".join(
                f"{_unit_desc(by_uid[d])}@{pos[d]}" for d in late)
            findings.append(Finding(
                PASS_SCHEDULE, "error", "illegal-order",
                f"{_unit_desc(u)} at slot {pos[u.uid]} issues before "
                f"its dependences: {deps_txt}",
                subject=f"{region_tag}:{_unit_desc(u)}"))


# -- persistent walks (the pipelined Triton emitter) ------------------------
def walk_blocks(n_programs: int, n_blocks: int, tail: bool = False
                ) -> List[List[int]]:
    """The blocks each program of a persistent launch visits, as the
    emitted kernel walks them (:mod:`repro_torch.core.tritongen`):
    program ``p`` takes ``p, p + n_programs, ...`` below ``n_blocks``
    (``tl.range(tl.program_id(0), n_blocks, tl.num_programs(0))``), and
    with ``tail`` the last program then takes block ``n_blocks`` too (the
    flat plan's masked tail after its walk over the whole blocks)."""
    walks = [list(range(p, n_blocks, n_programs)) for p in range(n_programs)]
    if tail and n_programs:
        walks[-1].append(n_blocks)
    return walks


def verify_persistent_walk(name: str, walks: List[List[int]],
                           n_blocks: int) -> List[Finding]:
    """Certify a persistent launch's walks: every block in
    ``[0, n_blocks)`` is visited exactly once over all programs, and no
    program visits a block outside that range. ``walks`` is what
    :func:`walk_blocks` gives for the plan (or a tampered copy)."""
    out: List[Finding] = []
    seen: Dict[int, int] = {}
    for p, blocks in enumerate(walks):
        for b in blocks:
            if not 0 <= b < n_blocks:
                out.append(Finding(
                    PASS_SCHEDULE, "error", "walk-out-of-range",
                    f"program {p} visits block {b} of {n_blocks}",
                    subject=f"{name}:walk"))
                return out
            if b in seen:
                out.append(Finding(
                    PASS_SCHEDULE, "error", "walk-revisit",
                    f"block {b} is visited by program {seen[b]} and "
                    f"again by program {p}", subject=f"{name}:walk"))
                return out
            seen[b] = p
    if len(seen) != n_blocks:
        missing = next(b for b in range(n_blocks) if b not in seen)
        out.append(Finding(
            PASS_SCHEDULE, "error", "walk-gap",
            f"{n_blocks - len(seen)} of {n_blocks} blocks are visited by "
            f"no program (e.g. block {missing})", subject=f"{name}:walk"))
    return out
