"""Beam-search extraction over per-class node choices (ILP stand-in, v2).

The paper solves CSE-aware extraction as a global optimization (ILP/CBC);
The first extractor approximated it with first-improvement hill climbing, which stalls
on plateaus of the non-additive roofline objective — exactly where "one
more load but one fewer pass" trades sit. This module keeps a *beam* of
the ``width`` best complete selections per generation instead of a single
incumbent:

* every state is a full, acyclic choice map, scored with the true DAG
  objective (shared e-classes counted once; non-additive models are
  exact, never surrogated);
* a generation proposes every single-class node swap of every state over
  that state's live (root-reachable) classes;
* survivors are the ``width`` best *distinct* states — equal-cost
  siblings are retained, which is what lets the beam walk plateaus that
  first-improvement hill climbing cannot cross.

Scoring runs through :class:`Evaluator`, which precomputes each e-node's
canonical children and hardware-statistics tuple once and then walks a
candidate selection with plain dict/int operations — no per-trial
allocation beyond the DFS bookkeeping. Trials mutate the state in place
and revert, so a swap costs one DFS, not a dict copy. ``max_expansions``
bounds the number of scored swaps, which makes a run deterministic and
machine-independent whenever the wall-clock deadline does not bind (the
benchmark-regression CI gate relies on this).

The search is monotone — the best state only ever improves — so seeding
the beam with the tree fixed point and the flat-model restart guarantees
the result is never worse than its seeds.
:func:`repro.core.extract.extract_dag` runs this as the main search and
demotes the old hill climb to a polish pass on the winner.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.guard import guard_tick

from .egraph import EGraph
from .ir import ENode

INF = float("inf")


class Evaluator:
    """Fast DAG-cost evaluation of choice maps against one cost model.

    Supports both model families of :mod:`repro.core.extract`:

    * roofline-style models (``node_stats`` + ``latency``): the cost of a
      selection is the predicted latency of the *summed* statistics of
      the chosen nodes;
    * flat models (``node_cost`` only): the cost is the per-node weight
      sum.

    Results match :func:`repro.core.extract.dag_cost_of` (asserted by
    ``tests/test_beam_extraction.py``); this class exists because the
    generic path allocates an OpStats per node per trial, which dominates
    beam-search wall time on saturated kernels.
    """

    def __init__(self, eg: EGraph, cm):
        self.eg = eg
        self.cm = cm
        self._children: Dict[ENode, Tuple[int, ...]] = {}
        self._cands: Dict[int, List[ENode]] = {}
        self.roofline = (hasattr(cm, "node_stats")
                         and hasattr(cm, "latency"))
        # duck-typed aggregate models without the roofline internals:
        # collect the node multiset and defer to their aggregate_cost
        self.generic = (not self.roofline
                        and getattr(cm, "aggregate_cost", None) is not None)
        if self.roofline:
            lat = cm.latency
            self._tile = float(lat.tile_elems)
            self._vpu = float(lat.chip.vpu_elems_per_s)
            self._mxu_peak = float(lat.mxu_peak_flops())
            # calibrated models (LatencyModel.from_profile) carry an HBM
            # efficiency factor, per-bound overlap slack, and a constant
            # launch overhead; the defaults reduce to the analytic model
            self._hbm = (float(lat.chip.hbm_bw)
                         * float(getattr(lat, "hbm_efficiency", 1.0)))
            self._slack_c = float(getattr(lat, "slack_compute",
                                          lat.overlap_slack))
            self._slack_m = float(getattr(lat, "slack_memory",
                                          lat.overlap_slack))
            self._base = float(getattr(lat, "base_ns", 0.0))
            # schedule-aware profiles: the downstream scheduler hides up
            # to eff × compute of the memory axis (best-schedule bound);
            # None keeps the aggregate formula — mirrors LatencyModel.latency_ns
            self._overlap_eff = getattr(lat, "overlap_efficiency", None)
            self._stats: Dict[ENode, Tuple[float, float, float]] = {}
        else:
            self._weights: Dict[ENode, float] = {}

    # -- per-node caches ------------------------------------------------------
    def children_of(self, node: ENode) -> Tuple[int, ...]:
        ch = self._children.get(node)
        if ch is None:
            find = self.eg.find
            ch = tuple(find(c) for c in node.children)
            self._children[node] = ch
        return ch

    def candidates(self, cid: int) -> List[ENode]:
        """Canonical nodes of a class in a stable, deterministic order."""
        lst = self._cands.get(cid)
        if lst is None:
            ec = self.eg.classes.get(self.eg.find(cid))
            lst = sorted((self.eg.canonicalize(n) for n in ec.nodes),
                         key=repr) if ec is not None else []
            self._cands[cid] = lst
        return lst

    def _stats_of(self, node: ENode) -> Tuple[float, float, float]:
        t = self._stats.get(node)
        if t is None:
            st = self.cm.node_stats(node)
            t = (st.vpu_passes, st.mxu_flops,
                 st.bytes_read + st.bytes_written)
            self._stats[node] = t
        return t

    def _weight_of(self, node: ENode) -> float:
        w = self._weights.get(node)
        if w is None:
            w = float(self.cm.node_cost(node))
            self._weights[node] = w
        return w

    # -- DAG cost of a selection ----------------------------------------------
    def cost(self, get: Callable[[int], Optional[ENode]],
             roots: Sequence[int]) -> float:
        """Objective of the selection ``get`` over ``roots`` (inf on a
        cyclic or incomplete selection). ``get`` maps a canonical class
        id to its chosen node (e.g. ``choice.get``)."""
        passes = mxu = nbytes = weight = 0.0
        roofline = self.roofline
        nodes: Optional[List[ENode]] = [] if self.generic else None
        state: Dict[int, int] = {}  # 0 = on stack, 1 = done
        stack: List[Tuple[int, bool]] = [(r, False) for r in roots]
        while stack:
            cid, processed = stack.pop()
            if processed:
                state[cid] = 1
                continue
            st = state.get(cid)
            if st == 1:
                continue
            if st == 0:
                return INF  # cycle
            node = get(cid)
            if node is None:
                return INF  # incomplete
            state[cid] = 0
            stack.append((cid, True))
            if roofline:
                p, m, b = self._stats_of(node)
                passes += p
                mxu += m
                nbytes += b
            elif nodes is not None:
                nodes.append(node)
            else:
                weight += self._weight_of(node)
            for ch in self.children_of(node):
                st_ch = state.get(ch)
                if st_ch is None:
                    stack.append((ch, False))
                elif st_ch == 0:
                    return INF
        if nodes is not None:
            return self.cm.aggregate_cost(nodes)
        if not roofline:
            return weight
        compute = (passes * self._tile / self._vpu
                   + mxu / self._mxu_peak) * 1e9
        memory = nbytes / self._hbm * 1e9
        if self._overlap_eff is not None:
            memory -= min(memory, self._overlap_eff * compute)
        if compute >= memory:
            return self._base + compute + self._slack_c * memory
        return self._base + memory + self._slack_m * compute


class EvalBudget:
    """Deterministic evaluation budget shared across search passes.

    Wall-clock deadlines make search results depend on machine speed and
    load; every search pass therefore counts objective evaluations
    against one of these and stops when it is spent, so a run is
    reproducible anywhere as long as the (generous) time limit does not
    bind first."""
    __slots__ = ("remaining",)

    def __init__(self, evals: int):
        self.remaining = int(evals)

    def take(self) -> bool:
        """Consume one evaluation; False once the budget is spent."""
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        return True

    @property
    def exhausted(self) -> bool:
        return self.remaining <= 0


@dataclasses.dataclass
class BeamStats:
    """Telemetry of one beam run (reported by the benchmark layer)."""
    width: int = 0
    generations: int = 0
    expanded: int = 0            # candidate swaps scored (all kinds)
    coordinated_expanded: int = 0  # of which: coordinated 2-class moves
    seed_cost: float = INF       # best seed before any search
    best_cost: float = INF       # best complete selection found
    hit_deadline: bool = False
    hit_expansion_cap: bool = False


class _Chain:
    """Two-level choice lookup (state overrides a shared baseline)
    without copying either dict."""
    __slots__ = ("a", "b")

    def __init__(self, a: Dict[int, ENode], b: Dict[int, ENode]):
        self.a, self.b = a, b

    def get(self, cid, default=None):
        n = self.a.get(cid)
        return n if n is not None else self.b.get(cid, default)


def _live_state(eg: EGraph, choice, roots: Sequence[int]
                ) -> Optional[Dict[int, ENode]]:
    """Project ``choice`` onto its root-reachable classes (None if a live
    class has no binding)."""
    from .extract import reachable
    state: Dict[int, ENode] = {}
    get = choice.get
    for cid in reachable(eg, choice, roots):
        node = get(cid)
        if node is None:
            return None
        state[cid] = node
    return state


def beam_search(eg: EGraph, cm, seeds: Sequence[Dict[int, ENode]],
                roots: Sequence[int], *, width: int = 8,
                deadline: Optional[float] = None,
                patience: int = 2,
                max_generations: int = 64,
                max_expansions: int = 200_000,
                coordinated: bool = True,
                evaluator: Optional[Evaluator] = None,
                stats: Optional[BeamStats] = None
                ) -> Tuple[Dict[int, ENode], float]:
    """Beam search over per-class node choices against ``cm``'s objective.

    ``seeds`` are complete selections (cyclic/incomplete ones are scored
    inf and dropped); the first seed doubles as the fallback binding for
    classes a swap newly reaches. Returns the best ``(choice, cost)``
    found — possibly a seed itself. Stops at ``max_expansions`` scored
    swaps (the deterministic budget), at the wall-clock ``deadline``
    (the safety net), after ``patience`` generations without strict
    improvement, or when a generation yields no unseen states.

    ``coordinated`` additionally proposes **2-class moves**: for every
    edge (class, chosen child) of a state's DAG, every pair of
    alternative nodes for the two classes is scored as one move. A
    non-additive objective (the roofline ``max``) has plateaus where a
    load and its consumer must change *together* — either single swap
    is strictly worse, so no 1-swap beam state survives to bridge them;
    the coordinated neighborhood crosses in one step.
    """
    if width < 1:
        raise ValueError(f"beam width must be >= 1, got {width}")
    ev = evaluator if evaluator is not None else Evaluator(eg, cm)
    roots = tuple(eg.find(r) for r in roots)
    st = stats if stats is not None else BeamStats()
    st.width = width

    base: Dict[int, ENode] = dict(seeds[0]) if seeds else {}
    base_get = base.get
    beam: List[Tuple[float, Dict[int, ENode]]] = []
    seen: set = set()
    for seed in seeds:
        state = _live_state(eg, seed, roots)
        if state is None:
            continue
        cost = ev.cost(seed.get, roots)
        if cost == INF:
            continue
        sig = frozenset(state.items())
        if sig in seen:
            continue
        seen.add(sig)
        beam.append((cost, state))
    if not beam:
        return {}, INF
    beam.sort(key=lambda s: s[0])
    beam = beam[:width]
    best_cost, best_choice = beam[0][0], dict(beam[0][1])
    st.seed_cost = st.best_cost = best_cost

    def out_of_budget() -> bool:
        # guard hook: one deterministic tick per budget check, so a
        # runaway extraction trips the ambient SaturationGuard's
        # eval_budget even if max_expansions is misconfigured
        guard_tick("beam")
        if st.expanded >= max_expansions:
            st.hit_expansion_cap = True
            return True
        if deadline is not None and time.perf_counter() >= deadline:
            st.hit_deadline = True
            return True
        return False

    stale = 0
    for _ in range(max_generations):
        if out_of_budget():
            break
        frontier: List[Tuple[float, Dict[int, ENode]]] = []
        # prune bar: no point keeping states worse than the width-th best
        bar = beam[-1][0] if len(beam) >= width else INF
        stop = False
        for _, state in beam:
            # trials mutate `state` in place and revert; classes newly
            # reached by a swap fall back to the seed baseline
            def get(cid, _s=state, _b=base_get):
                n = _s.get(cid)
                return n if n is not None else _b(cid)

            def trial(_s=state, _g=get):
                """Score the mutated state; keep it if it clears the
                frontier bar and is unseen. Caller reverts."""
                nonlocal frontier, bar
                cost = ev.cost(_g, roots)
                st.expanded += 1
                # once the frontier holds a full beam of plateau
                # states, only strictly better candidates may enter —
                # keeps plateau churn (and the seen-set) bounded
                full = len(frontier) >= 2 * width
                if cost == INF or cost > bar + 1e-9 \
                        or (full and cost >= bar - 1e-9):
                    return
                tstate = _live_state(eg, _Chain(_s, base), roots)
                if tstate is None:
                    return
                sig = frozenset(tstate.items())
                if sig in seen:
                    return
                seen.add(sig)
                frontier.append((cost, tstate))
                if len(frontier) >= 4 * width:
                    frontier.sort(key=lambda s: s[0])
                    frontier = frontier[:2 * width]
                    bar = min(bar, frontier[-1][0])

            for cid in sorted(state):
                cands = ev.candidates(cid)
                if len(cands) <= 1:
                    continue
                current = state[cid]
                for cand in cands:
                    if cand == current:
                        continue
                    state[cid] = cand
                    trial()
                    state[cid] = current
                if out_of_budget():
                    stop = True
                    break
            if not stop and coordinated:
                # 2-class neighborhood: a chosen-DAG edge's two classes
                # move together (only both-change pairs — single swaps
                # were already scored above)
                for cid in sorted(state):
                    cur_p = state[cid]
                    for ch in ev.children_of(cur_p):
                        if ch == cid or ch not in state:
                            continue
                        p_cands = ev.candidates(cid)
                        c_cands = ev.candidates(ch)
                        if len(p_cands) <= 1 or len(c_cands) <= 1:
                            continue
                        cur_c = state[ch]
                        for np_ in p_cands:
                            if np_ == cur_p:
                                continue
                            for nc in c_cands:
                                if nc == cur_c:
                                    continue
                                state[cid], state[ch] = np_, nc
                                trial()
                                st.coordinated_expanded += 1
                                state[cid], state[ch] = cur_p, cur_c
                        if out_of_budget():
                            stop = True
                            break
                    if stop:
                        break
            if stop:
                break
        if not frontier:
            break
        st.generations += 1
        # survivors: width best distinct states across old beam + frontier
        merged = beam + frontier
        merged.sort(key=lambda s: s[0])
        beam = merged[:width]
        if beam[0][0] < best_cost - 1e-9:
            best_cost, best_choice = beam[0][0], dict(beam[0][1])
            stale = 0
        else:
            stale += 1
            if stale >= patience:
                break
        if stop:
            break
    st.best_cost = best_cost
    # re-complete the winner against the fallback so downstream consumers
    # (codegen walks children through the choice map) see every class
    out = dict(base)
    out.update(best_choice)
    return out, best_cost
