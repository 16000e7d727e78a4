"""Schedule-aware statement ordering for generated kernels.

The paper's closing claim is that *computational reordering* — the order
in which loads, compute, and stores are issued — matters as much as what
is computed. Until this module, the only ordering decision the
reproduction made was the all-or-nothing bulk load in
:mod:`repro.core.codegen`, which front-loads every tile read sorted by
array name — a fixed convention, not an optimization.

This module makes statement order a first-class, cost-driven choice:

* :func:`compute_schedule` builds the **dependence DAG** of the
  extracted choice per codegen region — one :class:`SchedUnit` per load,
  compute temp, store effect, and (atomic) loop — with data edges,
  array-version (store→load) edges, and WAR anti-dependences (a load of
  a version must issue before the store/loop that overwrites it: the
  Pallas path reuses refs in place, so this is a real hazard, and it is
  merely conservative for the functional JAX path);
* three named orders span the schedule space:

  - ``"source"`` — loads at their use sites (the paper's un-optimized
    input; today's ``bulk=False``),
  - ``"bulk"``   — every load front-loaded in the legacy
    ``(array, static index)`` order, reproducing today's emitted
    sources bit-for-bit,
  - ``"cost"``   — a deterministic first-improvement insertion search
    over legal topological orders, seeded with both named orders and
    scored by :meth:`repro.analysis.latency.LatencyModel.schedule_ns`
    (position-dependent load→compute overlap + VMEM live-range
    pressure). The search only ever accepts strict improvements from
    the ``bulk`` seed, so ``predicted(cost) <= predicted(bulk)``
    structurally;

* :class:`ScheduleResult` carries the per-region orders (consumed by
  ``JaxCodeGenerator``/the Pallas generators), the schedule-feature vector
  for calibration (per-load overlap windows, peak live bytes), and the
  predicted latency of each named order;
* :func:`random_topological_order` / :func:`is_legal_order` support the
  property-based legality fuzz in ``tests/test_schedule.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.runtime import chaos
from repro_torch.runtime.guard import BudgetExceeded, guard_tick

from repro_torch.analysis.latency import LatencyModel, ScheduleEvent
from repro_torch.analysis.opstats import _PASSES, op_pass_class

from .ir import ENode
from .ssa import LoopRegion, Region, SSAResult, StoreEffect

SCHEDULE_MODES = ("source", "bulk", "cost")

# Evaluation budget of the cost search (scored candidate orders across
# all regions of one kernel) — deterministic, machine-independent.
DEFAULT_MOVE_BUDGET = 4000


def legacy_bulk_key(node_of: Callable[[int], ENode], cid: int):
    """The bulk-load flush order of one load: ``(array name, static
    index representation)``. This is the single owner of the convention
    — ``CodeGenerator._flush_loads`` sorts by it, and the ``"bulk"``
    order here reproduces it — so emitted load order always comes from
    the schedule subsystem, never from an ad-hoc ``sorted()`` call."""
    n = node_of(cid)
    arr = node_of(n.children[0])
    idx_repr = tuple(repr(node_of(c)) for c in n.children[1:])
    return (str(arr.payload), idx_repr)


@dataclasses.dataclass
class SchedUnit:
    """One schedulable statement of a region."""
    uid: int
    kind: str                      # "load" | "compute" | "store" | "loop"
    cid: Optional[int] = None      # load/compute: canonical e-class id
    item: Any = None               # store: StoreEffect; loop: LoopRegion
    deps: Set[int] = dataclasses.field(default_factory=set)
    # deps in first-encounter (expression) order — what the legacy
    # use-site emission follows; the "source" order replays it
    dep_seq: List[int] = dataclasses.field(default_factory=list)

    def add_dep(self, uid: int):
        if uid not in self.deps:
            self.deps.add(uid)
            self.dep_seq.append(uid)
    # -- pricing (calibrated units when a profile drives the model) -------
    issue_ns: float = 0.0          # issue-pipeline occupancy
    mem_ns: float = 0.0            # async HBM transfer started at issue
    bytes_live: float = 0.0        # VMEM residency (loads)
    # -- raw features for calibration (unweighted, hardware-neutral) ------
    raw_passes: float = 0.0        # unweighted VPU passes (compute)
    key: Any = None                # deterministic tiebreak / bulk rank


@dataclasses.dataclass
class RegionSchedule:
    path: Tuple[int, ...]
    units: List[SchedUnit]
    order: List[int]               # uids in emission order
    report: Dict[str, float] = dataclasses.field(default_factory=dict)

    def ordered_units(self) -> List[SchedUnit]:
        by_uid = {u.uid: u for u in self.units}
        return [by_uid[uid] for uid in self.order]


@dataclasses.dataclass
class ScheduleResult:
    mode: str
    regions: Dict[Tuple[int, ...], RegionSchedule]
    predicted_ns: float            # whole-kernel schedule objective
    # predicted objective of every named order (same units) — the
    # benchmarks' cost<=bulk<=source leg reads these
    predicted_by_mode: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    moves_scored: int = 0          # cost-search telemetry

    @property
    def peak_live_bytes(self) -> float:
        return max((rs.report.get("peak_live_bytes", 0.0)
                    for rs in self.regions.values()), default=0.0)

    def load_windows(self) -> List[Tuple[float, float, float]]:
        """Per-load ``(bytes, gap_passes, gap_loads)`` calibration
        features: the load's HBM bytes and the unweighted compute
        passes / load slots issued between it and its first consumer
        under this schedule (deterministic region order)."""
        out: List[Tuple[float, float, float]] = []
        for path in sorted(self.regions):
            rs = self.regions[path]
            ordered = rs.ordered_units()
            pos = {u.uid: i for i, u in enumerate(ordered)}
            for i, u in enumerate(ordered):
                if u.kind != "load":
                    continue
                first = min((pos[v.uid] for v in ordered
                             if u.uid in v.deps), default=len(ordered))
                gap_passes = gap_loads = 0.0
                for v in ordered[i + 1:first]:
                    if v.kind == "load":
                        gap_loads += 1.0
                    else:
                        gap_passes += v.raw_passes
                out.append((u.bytes_live, gap_passes, gap_loads))
        return out


def is_legal_order(units: Sequence[SchedUnit], order: Sequence[int]) -> bool:
    """True iff ``order`` is a permutation of the units' uids that never
    places a unit before one of its dependences."""
    if sorted(order) != sorted(u.uid for u in units):
        return False
    pos = {uid: i for i, uid in enumerate(order)}
    for u in units:
        for d in u.deps:
            if pos[d] >= pos[u.uid]:
                return False
    return True


def random_topological_order(units: Sequence[SchedUnit], rng
                             ) -> List[int]:
    """A uniformly-seeded random legal topological order (Kahn's
    algorithm with an rng-chosen ready pick) — the fuzz driver for the
    schedule-legality property tests."""
    pending = {u.uid: set(u.deps) for u in units}
    out: List[int] = []
    while pending:
        ready = sorted(uid for uid, deps in pending.items() if not deps)
        if not ready:
            raise ValueError("dependence cycle in schedule units")
        pick = ready[int(rng.integers(len(ready)))]
        out.append(pick)
        del pending[pick]
        for deps in pending.values():
            deps.discard(pick)
    return out


# ---------------------------------------------------------------------------
# DAG construction
# ---------------------------------------------------------------------------
class _Builder:
    def __init__(self, ssa: SSAResult, choice: Dict[int, ENode],
                 cost_model):
        self.ssa = ssa
        self.eg = ssa.egraph
        self.choice = choice
        self.cm = cost_model
        self.lat: LatencyModel = cost_model.latency
        # region (loop-id path) of every cid in the chosen dag
        self.cid_region: Dict[int, Tuple[int, ...]] = {}
        self.var_region: Dict[str, Tuple[int, ...]] = {}
        self.sym_region: Dict[str, Tuple[int, ...]] = {}
        self._store_infos = dict(zip(
            [id(it) for it in self._stores(ssa.region)],
            ssa.store_infos()))
        self._uid = 0

    def _stores(self, region: Region) -> List[StoreEffect]:
        out: List[StoreEffect] = []
        for item in region.items:
            if isinstance(item, StoreEffect):
                out.append(item)
            else:
                out.extend(self._stores(item.body))
        return out

    def node(self, cid: int) -> ENode:
        cid = self.eg.find(cid)
        n = self.choice.get(cid)
        if n is None:
            # same fallback as CodeGenerator.node: classes demanded late
            # (pred/index added after extraction) get a greedy local pick
            from .extract import extract_dag
            res = extract_dag(self.eg, (cid,), local_search=False)
            for k, v in res.choice.items():
                self.choice.setdefault(k, v)
            n = self.choice[cid]
        return n

    # -- region assignment (mirrors codegen._collect_load_regions, over
    #    every cid of the chosen dag, not just loads) ----------------------
    def assign_regions(self):
        def index_regions(region: Region, path: Tuple[int, ...]):
            for item in region.items:
                if isinstance(item, LoopRegion):
                    inner = path + (item.loop_id,)
                    self.var_region[f"%L{item.loop_id}:{item.var}"] = inner
                    for carry in item.carries:
                        self.var_region[f"%L{item.loop_id}:{carry.name}"] \
                            = inner
                    for ac in item.array_carries:
                        self.sym_region[ac.version_body] = inner
                        self.sym_region[ac.version_post] = path
                    index_regions(item.body, inner)
                else:
                    self.sym_region[item.version_out] = path
        index_regions(self.ssa.region, ())

        def join(a, b):
            return a if len(a) >= len(b) else b

        memo = self.cid_region

        def walk(cid: int) -> Tuple[int, ...]:
            cid = self.eg.find(cid)
            if cid in memo:
                return memo[cid]
            memo[cid] = ()   # provisional (acyclic by extraction)
            n = self.node(cid)
            r: Tuple[int, ...] = ()
            if n.op == "var" and isinstance(n.payload, str):
                r = self.var_region.get(n.payload, ())
            elif n.op == "array":
                r = self.sym_region.get(n.payload, ())
            for ch in n.children:
                r = join(r, walk(ch))
            memo[cid] = r
            return r

        for root in self.ssa.roots():
            walk(root)

    # -- cone walks --------------------------------------------------------
    def cone(self, roots: Sequence[int]) -> Tuple[List[int], List[str]]:
        """All cids reachable through the chosen dag from ``roots`` plus
        every array-version symbol they read, in deterministic
        depth-first (expression) visit order."""
        cids: List[int] = []
        seen: Set[int] = set()
        syms: List[str] = []
        seen_syms: Set[str] = set()

        def walk(cid: int):
            cid = self.eg.find(cid)
            if cid in seen:
                return
            seen.add(cid)
            n = self.node(cid)
            if n.op == "array" and n.payload not in seen_syms:
                seen_syms.add(n.payload)
                syms.append(n.payload)
            for ch in n.children:
                walk(ch)
            cids.append(cid)

        for r in roots:
            walk(r)
        return cids, syms

    def loop_roots(self, loop: LoopRegion) -> List[int]:
        out = [loop.start_cid, loop.stop_cid]
        for carry in loop.carries:
            out.extend([carry.init_cid, carry.next_cid])

        def body(region: Region):
            for item in region.items:
                if isinstance(item, StoreEffect):
                    out.append(item.value_cid)
                    out.extend(item.index_cids)
                    if item.pred_cid is not None:
                        out.append(item.pred_cid)
                else:
                    out.extend(self.loop_roots(item))
        body(loop.body)
        return out

    # -- pricing -----------------------------------------------------------
    def _per_pass_ns(self) -> float:
        return self.lat.tile_elems / self.lat.chip.vpu_elems_per_s * 1e9

    def _dispatch_ns(self) -> float:
        coeffs = self.lat.pass_coeffs or {}
        return float(coeffs.get("memory_dispatch", 0.0)) \
            * self._per_pass_ns()

    def make_unit(self, kind: str, *, cid=None, item=None) -> SchedUnit:
        u = SchedUnit(uid=self._uid, kind=kind, cid=cid, item=item)
        self._uid += 1
        if kind == "load":
            st = self.cm.node_stats(self.node(cid))
            u.issue_ns = self.lat.compute_ns(st)  # calibrated dispatch
            u.mem_ns = self.lat.memory_ns(st)
            u.bytes_live = st.bytes_read
            u.key = legacy_bulk_key(self.node, cid)
        elif kind == "compute":
            n = self.node(cid)
            st = self.cm.node_stats(n)
            u.issue_ns = self.lat.compute_ns(st)
            u.raw_passes = _PASSES.get(op_pass_class(n.op), 0.0)
            u.key = repr(n)
        elif kind == "store":
            info = self._store_infos.get(id(item))
            nbytes = (info.bytes(self.lat.tile_elems) if info is not None
                      else float(self.lat.tile_elems * 4))
            u.issue_ns = self._dispatch_ns()
            u.mem_ns = nbytes / (self.lat.chip.hbm_bw
                                 * self.lat.hbm_efficiency) * 1e9
            u.key = ("store", item.order)
        return u


# units that never emit a line of their own: leaves are named inline,
# phi_loop/loop placeholders are bound by the loop emission machinery
_NON_UNIT_OPS = frozenset({"const", "var", "array", "phi_loop"})


def _build_regions(b: _Builder) -> Dict[Tuple[int, ...], List[SchedUnit]]:
    b.assign_regions()
    regions: Dict[Tuple[int, ...], List[SchedUnit]] = {}
    cid_unit: Dict[int, SchedUnit] = {}
    # version symbol -> defining unit (store or loop)
    sym_def: Dict[str, SchedUnit] = {}
    # version symbol -> load units reading it (WAR anti-dependences)
    sym_readers: Dict[str, List[SchedUnit]] = {}

    loop_units: Dict[int, SchedUnit] = {}

    def units_for(region: Region, path: Tuple[int, ...]):
        units: List[SchedUnit] = []
        # 1 unit per load/compute cid homed here (deterministic walk
        # order: discovery from the region's roots in program order)
        seen: Set[int] = set()

        def discover(cid: int):
            cid = b.eg.find(cid)
            if cid in seen:
                return
            seen.add(cid)
            n = b.node(cid)
            for ch in n.children:
                discover(ch)
            if b.cid_region.get(cid) != path or n.op in _NON_UNIT_OPS:
                return
            if cid in cid_unit:
                return  # already homed (shared with an earlier region)
            kind = "load" if n.op == "load" else "compute"
            u = b.make_unit(kind, cid=cid)
            cid_unit[cid] = u
            units.append(u)
            if kind == "load":
                arr = b.node(n.children[0])
                if arr.op == "array":
                    sym_readers.setdefault(arr.payload, []).append(u)

        item_units: List[Tuple[Any, SchedUnit]] = []
        for item in region.items:
            if isinstance(item, StoreEffect):
                discover(item.value_cid)
                for i in item.index_cids:
                    discover(i)
                if item.pred_cid is not None:
                    discover(item.pred_cid)
                u = b.make_unit("store", item=item)
                sym_def[item.version_out] = u
            else:
                for r in b.loop_roots(item):
                    # only the cids homed at THIS path become units here;
                    # deeper ones are discovered by the body's own pass
                    discover(r)
                u = b.make_unit("loop", item=item)
                loop_units[item.loop_id] = u
                for ac in item.array_carries:
                    sym_def[ac.version_post] = u
                    sym_def[ac.version_body] = u
            units.append(u)
            item_units.append((item, u))

        # -- edges ---------------------------------------------------------
        def dep_of_cid(cid: int) -> Optional[SchedUnit]:
            return cid_unit.get(b.eg.find(cid))

        def expr_deps(u: SchedUnit, cid: int, visiting: Set[int]):
            """deps of a unit on the cone of ``cid`` (stop at units),
            registered in expression (first-encounter) order."""
            cid = b.eg.find(cid)
            if cid in visiting:
                return
            visiting.add(cid)
            d = dep_of_cid(cid)
            if d is not None and d.uid != u.uid:
                u.add_dep(d.uid)
                return
            n = b.node(cid)
            if n.op == "array":
                s = sym_def.get(n.payload)
                if s is not None and s.uid != u.uid:
                    u.add_dep(s.uid)
                return
            if n.op == "phi_loop":
                # post-loop value: defined by the loop's emission, not
                # by its (init, next) children — next lives in the body
                lu = loop_units.get(n.payload[0])
                if lu is not None and lu.uid != u.uid:
                    u.add_dep(lu.uid)
                expr_deps(u, n.children[0], visiting)  # init value
                return
            for ch in n.children:
                expr_deps(u, ch, visiting)

        for u in units:
            if u.cid is not None:
                for ch in b.node(u.cid).children:
                    expr_deps(u, ch, set())
        for item, u in item_units:
            if isinstance(item, StoreEffect):
                expr_deps(u, item.value_cid, set())
                for i in item.index_cids:
                    expr_deps(u, i, set())
                if item.pred_cid is not None:
                    expr_deps(u, item.pred_cid, set())
                s = sym_def.get(item.version_in)
                if s is not None and s.uid != u.uid:
                    u.add_dep(s.uid)   # store chain (RAW + store-store)
                # WAR: loads of the overwritten version issue first
                # (the Pallas path rebinds the same ref in place)
                for rd in sym_readers.get(item.version_in, []):
                    if rd.uid != u.uid:
                        u.add_dep(rd.uid)
            else:
                cids, syms = b.cone(b.loop_roots(item))
                for cid in cids:
                    d = dep_of_cid(cid)
                    if d is not None and d.uid != u.uid:
                        u.add_dep(d.uid)
                for sym in syms:
                    s = sym_def.get(sym)
                    if s is not None and s.uid != u.uid:
                        u.add_dep(s.uid)
                    # the loop reads this version: later stores that
                    # overwrite it must wait for the whole loop (WAR)
                    sym_readers.setdefault(sym, []).append(u)
                for ac in item.array_carries:
                    s = sym_def.get(ac.version_init)
                    if s is not None and s.uid != u.uid:
                        u.add_dep(s.uid)
                    for rd in sym_readers.get(ac.version_init, []):
                        if rd.uid != u.uid:
                            u.add_dep(rd.uid)

        # edges may only point inside this region's unit set
        uids = {u.uid for u in units}
        for u in units:
            u.deps &= uids
            u.dep_seq = [d for d in u.dep_seq if d in uids]
        regions[path] = units
        for item in region.items:
            if isinstance(item, LoopRegion):
                units_for(item.body, path + (item.loop_id,))

    units_for(b.ssa.region, ())
    return regions


# ---------------------------------------------------------------------------
# Named orders
# ---------------------------------------------------------------------------
def _source_order(units: List[SchedUnit]) -> List[int]:
    """Loads/compute at their use sites: emit each store/loop after a
    depth-first emission of its not-yet-emitted dependences in
    expression order — the legacy ``bulk=False`` emission shape."""
    by_uid = {u.uid: u for u in units}
    emitted: Set[int] = set()
    out: List[int] = []

    def emit(uid: int):
        if uid in emitted:
            return
        emitted.add(uid)
        for d in by_uid[uid].dep_seq:
            emit(d)
        out.append(uid)

    for u in units:
        if u.kind in ("store", "loop"):
            emit(u.uid)
    for u in units:              # consumer-less stragglers, if any
        emit(u.uid)
    return out


def _bulk_order(units: List[SchedUnit]) -> List[int]:
    """The legacy bulk-load emission order: at the top of the region —
    and again after every store/loop — flush every load whose
    dependences are all emitted, in ``legacy_bulk_key`` order; compute
    still sits at its use sites."""
    by_uid = {u.uid: u for u in units}
    emitted: Set[int] = set()
    out: List[int] = []

    def emit(uid: int):
        if uid in emitted:
            return
        emitted.add(uid)
        for d in by_uid[uid].dep_seq:
            emit(d)
        out.append(uid)

    def ready(u: SchedUnit) -> bool:
        """A load is flushable when nothing blocking (store/loop) sits
        under it — pure compute/load deps are emitted with it, exactly
        like the legacy ``_deps_ready`` recursion."""
        seen: Set[int] = set()

        def ok(uid: int) -> bool:
            if uid in emitted or uid in seen:
                return True
            seen.add(uid)
            d = by_uid[uid]
            if d.kind in ("store", "loop"):
                return False
            return all(ok(x) for x in d.deps)
        return ok(u.uid)

    def flush():
        pend = [u for u in units if u.kind == "load"
                and u.uid not in emitted and ready(u)]
        for u in sorted(pend, key=lambda u: u.key):
            emit(u.uid)

    flush()
    for u in units:
        if u.kind in ("store", "loop"):
            emit(u.uid)
            flush()
    for u in units:
        emit(u.uid)
    return out


# ---------------------------------------------------------------------------
# Objective + cost-driven search
# ---------------------------------------------------------------------------
def _events_of(units: List[SchedUnit], order: List[int]
               ) -> List[ScheduleEvent]:
    by_uid = {u.uid: u for u in units}
    pos = {uid: i for i, uid in enumerate(order)}
    consumers: Dict[int, List[int]] = {uid: [] for uid in order}
    for u in units:
        for d in u.deps:
            consumers[d].append(pos[u.uid])
    events: List[ScheduleEvent] = []
    for uid in order:
        u = by_uid[uid]
        cons = consumers[uid]
        events.append(ScheduleEvent(
            kind=u.kind if u.kind in ("load", "store") else "compute",
            issue_ns=u.issue_ns, mem_ns=u.mem_ns,
            bytes_live=u.bytes_live,
            first_use=min(cons) if cons else -1,
            last_use=max(cons) if cons else -1))
    return events


def _region_ns(lat: LatencyModel, units: List[SchedUnit],
               order: List[int], vmem_budget: Optional[int]
               ) -> Dict[str, float]:
    return lat.schedule_ns(_events_of(units, order),
                           vmem_budget_bytes=vmem_budget)


class _Budget:
    __slots__ = ("remaining",)

    def __init__(self, n: int):
        self.remaining = n

    def take(self) -> bool:
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        return True


def _cost_order(lat: LatencyModel, units: List[SchedUnit],
                seeds: List[List[int]], vmem_budget: Optional[int],
                budget: _Budget) -> Tuple[List[int], int]:
    """Deterministic first-improvement insertion search: repeatedly try
    moving one unit to every other legal position, accepting strict
    improvements, from each seed; return the best order found. Because
    the seeds themselves are candidates, the result is never worse than
    any seed."""
    by_uid = {u.uid: u for u in units}
    scored = 0
    # chaos site: a stalled cost search surfaces as the deadline trip
    # the guard's wall-clock safety net would report, deterministically
    if chaos.chaos_point("slow_stage"):
        raise BudgetExceeded("deadline", "injected slow-stage stall in "
                             "the cost schedule search")

    def objective(order: List[int]) -> float:
        nonlocal scored
        scored += 1
        # guard hook: one deterministic tick per scored order
        guard_tick("schedule")
        return _region_ns(lat, units, order, vmem_budget)["latency_ns"]

    dependents = {u.uid: {v.uid for v in units if u.uid in v.deps}
                  for u in units}
    best_order, best = None, float("inf")
    for seed in seeds:
        cur = list(seed)
        cur_ns = objective(cur)
        improved = True
        while improved and budget.remaining > 0:
            improved = False
            for i in range(len(cur)):
                uid = cur[i]
                u = by_uid[uid]
                # legal final positions for u in the list with u removed:
                # strictly after every dep, strictly before every
                # dependent (indices adjusted for the removal)
                lo, hi = 0, len(cur) - 1
                for j, w in enumerate(cur):
                    if w == uid:
                        continue
                    adj = j if j < i else j - 1
                    if w in u.deps:
                        lo = max(lo, adj + 1)
                    if w in dependents[uid]:
                        hi = min(hi, adj)
                for f in range(lo, hi + 1):
                    if f == i:        # re-inserting at i is the identity
                        continue
                    if not budget.take():
                        break
                    cand = list(cur)
                    cand.pop(i)
                    cand.insert(f, uid)
                    ns = objective(cand)
                    if ns < cur_ns - 1e-9:
                        cur, cur_ns = cand, ns
                        improved = True
                        break
                if improved or budget.remaining <= 0:
                    break
        if cur_ns < best - 1e-12:
            best_order, best = cur, cur_ns
    return (best_order if best_order is not None else list(seeds[0]),
            scored)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def unit_key(eg, u: SchedUnit) -> Tuple[str, Any]:
    """Process-portable identity of one unit: loads/compute by canonical
    e-class, stores by their SSA store order, loops by loop id. The
    persistent saturation cache serializes region orders as these keys
    (with cids further translated to structural node indices)."""
    if u.kind in ("load", "compute"):
        return (u.kind, eg.find(u.cid))
    if u.kind == "store":
        return ("store", u.item.order)
    return ("loop", u.item.loop_id)


def _order_from_keys(eg, units: List[SchedUnit],
                     keys: Optional[Sequence[Tuple[str, Any]]]
                     ) -> List[int]:
    """Translate a unit-key order back to uids; raises ValueError when a
    key is missing/unknown or the order is illegal."""
    if keys is None:
        raise ValueError("no cached order for this region")
    key_uid = {}
    for u in units:
        key_uid[unit_key(eg, u)] = u.uid
    order: List[int] = []
    for kind, ref in keys:
        k = (kind, eg.find(ref)) if kind in ("load", "compute") \
            else (kind, ref)
        uid = key_uid.get(k)
        if uid is None:
            raise ValueError(f"cached order names unknown unit {k!r}")
        order.append(uid)
    if not is_legal_order(units, order):
        raise ValueError("cached order is not a legal topological order")
    return order


def compute_schedule(ssa: SSAResult, choice: Dict[int, ENode], *,
                     mode: str = "cost", cost_model=None,
                     vmem_budget_bytes: Optional[int] = None,
                     move_budget: int = DEFAULT_MOVE_BUDGET,
                     fixed_orders: Optional[Dict[Tuple[int, ...],
                                                 Sequence]] = None,
                     seed_orders: Optional[Dict[Tuple[int, ...],
                                                Sequence]] = None
                     ) -> ScheduleResult:
    """Build the dependence DAG of the extracted ``choice`` and order it
    under ``mode`` (``"source" | "bulk" | "cost"``).

    ``cost_model`` prices the units (defaults to the analytic
    :class:`repro.analysis.RooflineCostModel` bound to the SSA e-graph;
    pass the pipeline's calibrated model so scheduling optimizes the
    same objective as extraction). Loops are scheduled recursively and
    priced as atomic units of their body's one-trip latency.

    ``fixed_orders`` replays a persisted schedule: a ``{region path:
    [unit keys]}`` map (see :func:`unit_key`) that becomes the emitted
    order verbatim — **no cost search runs** (the exact-cache-hit
    path). Every region must be present and legal or ValueError is
    raised (callers fall back to a cold search). ``seed_orders`` has
    the same shape but only *seeds* the cost search (warm start);
    unmappable/illegal seeds are ignored.
    """
    if mode not in SCHEDULE_MODES:
        raise ValueError(
            f"schedule mode must be one of {SCHEDULE_MODES}, got {mode!r}")
    if cost_model is None:
        from repro_torch.analysis import RooflineCostModel
        cost_model = RooflineCostModel(
            dtype=getattr(ssa.prog, "dtype", None) or "f32",
            egraph=ssa.egraph)
    b = _Builder(ssa, choice, cost_model)
    lat = b.lat
    region_units = _build_regions(b)
    budget = _Budget(move_budget)
    regions: Dict[Tuple[int, ...], RegionSchedule] = {}
    moves = 0
    # deepest regions first: loop units in parent regions are priced by
    # their (already scheduled) body latency
    body_ns: Dict[Tuple[int, ...], float] = {}
    mode_ns: Dict[str, Dict[Tuple[int, ...], float]] = {
        m: {} for m in SCHEDULE_MODES}
    for path in sorted(region_units, key=len, reverse=True):
        units = region_units[path]
        for u in units:
            if u.kind == "loop":
                inner = path + (u.item.loop_id,)
                # marginal one-trip time of the body (base_ns is a
                # per-kernel constant, not per-loop)
                u.issue_ns = max(0.0, body_ns.get(inner, 0.0)
                                 - lat.base_ns)
        orders = {"source": _source_order(units),
                  "bulk": _bulk_order(units)}
        reports = {m: _region_ns(lat, units, o, vmem_budget_bytes)
                   for m, o in orders.items()}
        if fixed_orders is not None:
            # replay a persisted order verbatim — no search
            fixed = _order_from_keys(b.eg, units, fixed_orders.get(path))
            orders[mode] = fixed
            if mode != "cost":
                orders["cost"] = orders["bulk"]   # placeholder pricing
            reports[mode] = _region_ns(lat, units, fixed,
                                       vmem_budget_bytes)
            if "cost" not in reports:
                reports["cost"] = _region_ns(lat, units, orders["cost"],
                                             vmem_budget_bytes)
        else:
            seeds = [orders["bulk"], orders["source"]]
            if seed_orders is not None and path in seed_orders:
                try:
                    seeds.insert(0, _order_from_keys(
                        b.eg, units, seed_orders[path]))
                except ValueError:
                    pass   # a stale seed is just not a seed
            cost_o, scored = _cost_order(lat, units, seeds,
                                         vmem_budget_bytes, budget)
            moves += scored
            orders["cost"] = cost_o
            reports["cost"] = _region_ns(lat, units, cost_o,
                                         vmem_budget_bytes)
        for m in SCHEDULE_MODES:
            mode_ns[m][path] = reports[m]["latency_ns"]
        chosen = orders[mode]
        regions[path] = RegionSchedule(path=path, units=units,
                                       order=chosen,
                                       report=reports[mode])
        body_ns[path] = reports[mode]["latency_ns"]
    top = regions.get((), None)
    predicted = top.report["latency_ns"] if top is not None else 0.0
    # whole-kernel per-mode totals: the top region's objective, with
    # loop bodies folded in through their unit pricing under ``mode``
    by_mode = {m: mode_ns[m].get((), 0.0) for m in SCHEDULE_MODES}
    return ScheduleResult(mode=mode, regions=regions,
                          predicted_ns=predicted,
                          predicted_by_mode=by_mode,
                          moves_scored=moves)


def loop_profile(ssa: SSAResult, scalars: Optional[Dict[str, float]] = None
                 ) -> Tuple[Tuple[float, float], ...]:
    """Static per-loop ``(trip_count, body_units)`` calibration features.

    Walks the SSA region tree and, for every loop, resolves the trip
    count from the e-graph's constant-folding analysis — falling back to
    ``scalars`` for runtime-scalar bounds (``cg_like``'s ``nnz`` is a
    scalar the measurement harness *does* know at measure time).
    ``body_units`` is the loop body's per-iteration statement count
    (store effects + scalar/array carry updates — a deterministic
    dispatch-equivalent regressor; the fitted coefficient absorbs the
    per-statement cost scale); nested loops
    multiply the enclosing trip counts in. Unresolvable bounds record a
    trip count of 0.0, which prices as the old once-through formula
    (the extra term contributes nothing)."""
    eg = ssa.egraph
    scalars = scalars or {}

    def resolve(cid: int) -> Optional[float]:
        ec = eg.classes.get(eg.find(cid))
        if ec is None:
            return None
        if ec.data is not None:
            return float(ec.data)
        for n in ec.nodes:
            if n.op == "var" and n.payload in scalars:
                return float(scalars[n.payload])
        return None

    def body_units(loop: LoopRegion) -> float:
        stores = sum(1 for item in loop.body.items
                     if not isinstance(item, LoopRegion))
        return float(stores + len(loop.carries)
                     + len(loop.array_carries))

    out: List[Tuple[float, float]] = []

    def walk(region, outer_trips: float) -> None:
        for item in region.items:
            if not isinstance(item, LoopRegion):
                continue
            start = resolve(item.start_cid)
            stop = resolve(item.stop_cid)
            trips = (max(stop - start, 0.0)
                     if start is not None and stop is not None else 0.0)
            out.append((trips * outer_trips, body_units(item)))
            walk(item.body, outer_trips * max(trips, 1.0))

    walk(ssa.region, 1.0)
    return tuple(out)
