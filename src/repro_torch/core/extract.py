"""CSE-aware extraction of optimal terms from an e-graph (paper §IV-B).

The paper extracts the minimum total cost selection where common e-classes
are counted ONCE (CSE folded into extraction) using an ILP solver (CBC).
No ILP solver ships in this environment, so we reproduce the objective
with a staged global search:

  1. a bottom-up fixed point over *tree* cost (classic egg extractor) —
     gives a valid acyclic selection fast;
  2. true *DAG* cost evaluation (shared classes counted once);
  3. width-configurable **beam search** over per-class node choices
     against the true DAG objective (:mod:`repro.core.beam`) — the main
     ILP stand-in; the beam retains equal-cost siblings, so it crosses
     objective plateaus that first-improvement hill climbing cannot;
  4. the first-improvement hill climb, demoted to a **polish pass** over the beam's
     winner and the original seeds (so the result is provably never
     worse than the old extractor given the same budget).

The default objective is *roofline-predicted latency*
(:class:`repro.analysis.RooflineCostModel`): a cost model may expose
``aggregate_cost(nodes)`` and the DAG evaluator then scores a selection
by that non-additive objective (here ``max(compute, memory)`` over the
summed statistics of the chosen nodes) instead of a per-node weight sum —
extraction picks terms that realize less computation AND less memory
traffic simultaneously, not just fewer abstract ops. Cost models exposing
``bind_egraph`` are bound to the graph before searching, which is how the
roofline model resolves per-array (shape, dtype) declarations and prices
broadcast scalars/rows and bf16/f8 tiles at their true HBM traffic.
Flat-weight models (:class:`repro.core.cost.CostModel`) work unchanged.

`extract_exact` brute-forces tiny graphs: tests use it to verify the
search reaches the optimum where enumeration is feasible, and
:func:`optimality_gap` reports the beam-vs-exact gap on such graphs.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import (Any, Dict, List, Optional, Sequence, Set, Tuple)

from repro_torch.analysis import RooflineCostModel

from .beam import BeamStats, EvalBudget, Evaluator, beam_search
from .cost import CostModel
from .egraph import EGraph
from .ir import ENode

INF = float("inf")

SEARCH_STRATEGIES = ("beam", "hillclimb", "none")


@dataclasses.dataclass
class ExtractionResult:
    choice: Dict[int, ENode]           # canonical cid -> chosen e-node
    roots: Tuple[int, ...]             # canonical root cids
    dag_cost: float
    tree_cost: float
    wall_s: float = 0.0
    improved_by_search: float = 0.0    # dag-cost reduction from local search
    predicted: Optional[Dict[str, Any]] = None  # roofline stats of choice
    search: str = "none"               # strategy that produced the choice
    beam_cost: float = INF             # beam stage best (pre-polish)
    beam_stats: Optional[BeamStats] = None

    def term(self, eg: EGraph, root: Optional[int] = None):
        from .egraph import extract_to_term
        root = self.roots[0] if root is None else eg.find(root)
        return extract_to_term(self.choice, eg, root)


# -- step 1: bottom-up tree-cost fixed point ------------------------------------
def _tree_costs(eg: EGraph, cm: CostModel):
    best_cost: Dict[int, float] = {}
    best_node: Dict[int, ENode] = {}
    classes = eg.eclasses()
    changed = True
    while changed:
        changed = False
        for cid, ec in classes.items():
            for node in ec.nodes:
                node = eg.canonicalize(node)
                cost = cm.node_cost(node)
                ok = True
                for ch in node.children:
                    ch_cost = best_cost.get(eg.find(ch))
                    if ch_cost is None:
                        ok = False
                        break
                    cost += ch_cost
                if ok and cost < best_cost.get(cid, INF):
                    best_cost[cid] = cost
                    best_node[cid] = node
                    changed = True
    return best_cost, best_node


# -- DAG cost of a choice map ------------------------------------------------------
def choice_nodes(eg: EGraph, choice: Dict[int, ENode],
                 roots: Sequence[int]) -> Optional[List[ENode]]:
    """Chosen nodes over classes reachable from roots, each class once.

    Returns None on a cyclic or incomplete selection.
    """
    nodes: List[ENode] = []
    state: Dict[int, int] = {}  # 0=on stack, 1=done
    stack: List[Tuple[int, bool]] = [(eg.find(r), False) for r in roots]
    while stack:
        cid, processed = stack.pop()
        cid = eg.find(cid)
        if processed:
            state[cid] = 1
            continue
        st = state.get(cid)
        if st == 1:
            continue
        if st == 0:
            return None  # cycle
        node = choice.get(cid)
        if node is None:
            return None
        state[cid] = 0
        stack.append((cid, True))
        nodes.append(node)
        for ch in node.children:
            ch = eg.find(ch)
            if state.get(ch) is None:
                stack.append((ch, False))
            elif state.get(ch) == 0:
                return None
    return nodes


def dag_cost_of(eg: EGraph, cm: CostModel, choice: Dict[int, ENode],
                roots: Sequence[int]) -> float:
    """Cost of a selection with shared classes counted once.

    Models exposing ``aggregate_cost`` (the roofline objective) score the
    whole node multiset at once; flat models sum per-node weights.
    Returns inf on a cyclic selection.
    """
    nodes = choice_nodes(eg, choice, roots)
    if nodes is None:
        return INF
    aggregate = getattr(cm, "aggregate_cost", None)
    if aggregate is not None:
        return aggregate(nodes)
    return sum(cm.node_cost(n) for n in nodes)


def reachable(eg: EGraph, choice: Dict[int, ENode],
              roots: Sequence[int]) -> Set[int]:
    seen: Set[int] = set()
    stack = [eg.find(r) for r in roots]
    while stack:
        cid = stack.pop()
        if cid in seen:
            continue
        seen.add(cid)
        node = choice.get(cid)
        if node is None:
            continue
        for ch in node.children:
            ch = eg.find(ch)
            if ch not in seen:
                stack.append(ch)
    return seen


# -- unextractable-root diagnostics -------------------------------------------------
def _unextractable_message(eg: EGraph, root: int,
                           extractable: Set[int]) -> str:
    """Explain *why* a root has no extractable term: list its e-nodes and
    walk the blocking dependency cycle through unextractable classes."""
    ec = eg.classes.get(eg.find(root))
    nodes = sorted((eg.canonicalize(n) for n in ec.nodes), key=repr) \
        if ec is not None else []
    lines = [f"no extractable term for e-class {eg.find(root)}"]
    if not nodes:
        lines.append("  the class contains no e-nodes")
        return "\n".join(lines)
    lines.append("  available e-nodes (every one depends on an "
                 "unextractable child):")
    for n in nodes:
        blocked = [eg.find(c) for c in n.children
                   if eg.find(c) not in extractable]
        lines.append(f"    {n!r}  blocked by e-class(es) "
                     f"{sorted(set(blocked))}")
    # Every unextractable class has, in each of its nodes, at least one
    # unextractable child — so following first-blocked-child links from
    # the root must revisit a class: that revisit is the blocking cycle.
    path: List[int] = []
    seen_at: Dict[int, int] = {}
    cur = eg.find(root)
    while cur not in seen_at:
        seen_at[cur] = len(path)
        path.append(cur)
        ecur = eg.classes.get(cur)
        nxt = None
        for n in sorted((eg.canonicalize(m) for m in ecur.nodes), key=repr):
            for c in n.children:
                if eg.find(c) not in extractable:
                    nxt = eg.find(c)
                    break
            if nxt is not None:
                break
        if nxt is None:       # defensive: shouldn't happen by construction
            break
        cur = nxt
    if cur in seen_at:
        cycle = path[seen_at[cur]:] + [cur]
        lines.append("  blocking cycle: "
                     + " -> ".join(str(c) for c in cycle))
    return "\n".join(lines)


# -- local search on the DAG objective (polish pass) --------------------------------
def _local_search(eg: EGraph, cm: CostModel, choice: Dict[int, ENode],
                  roots: Sequence[int], deadline: float,
                  evaluator: Optional[Evaluator] = None,
                  budget: Optional[EvalBudget] = None
                  ) -> Tuple[Dict[int, ENode], float]:
    """First-improvement hill climb (the original extractor). Demoted to the
    polish pass after beam search; trials mutate in place and revert, so
    a swap costs one DAG walk, not a full choice-map copy. ``budget``
    caps the number of scored swaps — the deterministic stop; the
    wall-clock deadline is only a safety net."""
    ev = evaluator if evaluator is not None else Evaluator(eg, cm)
    best = dict(choice)
    get = best.get
    best_cost = ev.cost(get, roots)
    improved = True
    while improved and time.perf_counter() < deadline:
        improved = False
        for cid in list(reachable(eg, best, roots)):
            cid = eg.find(cid)
            cands = ev.candidates(cid)
            if len(cands) <= 1:
                continue
            current = best.get(cid)
            if current is None:
                continue
            for cand in cands:
                if cand == current:
                    continue
                if budget is not None and not budget.take():
                    return best, best_cost
                best[cid] = cand
                c = ev.cost(get, roots)
                if c < best_cost - 1e-9:
                    best_cost = c
                    current = cand
                    improved = True
                    break
                best[cid] = current
            if time.perf_counter() > deadline:
                break
    return best, best_cost


def _collect_seeds(eg: EGraph, cm, tree_choice: Dict[int, ENode],
                   roots: Sequence[int], deadline: float,
                   budget: EvalBudget) -> List[Dict[int, ENode]]:
    """Restart seeds: the objective's own tree fixed point plus, for
    non-additive models, the flat-weight extractor's refined solution —
    so the search can never end worse than what the paper's flat model
    would have chosen (refinement only improves the true objective).
    The refinement draws on its own deterministic ``budget``; the flat
    objective is only a restart heuristic."""
    seeds = [tree_choice]
    if getattr(cm, "aggregate_cost", None) is not None \
            and not isinstance(cm, CostModel):
        flat_cm = CostModel()
        _, flat_choice = _tree_costs(eg, flat_cm)
        if all(eg.find(r) in flat_choice for r in roots):
            refined, _ = _local_search(eg, flat_cm, flat_choice,
                                       roots, deadline, budget=budget)
            seeds.append(refined)
    return seeds


def extract_dag(eg: EGraph, roots, cost_model: Optional[CostModel] = None,
                *, time_limit_s: float = 5.0, local_search: bool = True,
                search: str = "beam", beam_width: int = 8,
                beam_expansions: int = 10_000,
                hillclimb_evals: int = 100_000,
                coordinated: bool = True,
                seed_choices: Optional[Sequence[Dict[int, ENode]]] = None
                ) -> ExtractionResult:
    """Extract a minimum-DAG-cost selection covering ``roots``.

    Defaults to the roofline-calibrated cost model: the objective is the
    predicted latency of the extracted term against the chip's compute
    and memory roofs, not a flat op-weight sum. Models exposing
    ``bind_egraph`` are bound to ``eg`` first so per-array (shape, dtype)
    declarations price loads at their true operand extent.

    ``search`` picks the global strategy. ``"hillclimb"`` is the original
    multi-start hill climb. ``"beam"`` (default) does strictly more
    work in a fixed order: the same seed refinement and seed polish as
    ``"hillclimb"`` first, then :func:`repro.core.beam.beam_search`, then
    a polish of the beam winner — so a beam extraction is never worse
    than a hill-climb extraction of the same graph. ``"none"`` (or
    ``local_search=False``) returns the tree fixed point unrefined.

    ``coordinated`` (default on) extends the beam's neighborhood with
    2-class moves along chosen-DAG edges — a load and its consumer can
    change together, escaping plateaus where either single swap is
    strictly worse (ROADMAP's multi-class-move item).

    ``seed_choices`` prepends extra restart seeds (partial choices are
    completed over the tree fixed point) — the persistent saturation
    cache warm-starts the beam this way, so a near-miss entry can only
    speed the search up, never worsen the committed result.

    Every pass stops on a deterministic evaluation budget
    (``beam_expansions`` for the beam, ``hillclimb_evals`` for the
    hill-climb passes), never on the wall clock unless the generous
    ``time_limit_s`` safety net binds — results are machine-independent
    for a fixed e-graph and ``PYTHONHASHSEED``.
    """
    t0 = time.perf_counter()
    cm = cost_model if cost_model is not None else RooflineCostModel()
    binder = getattr(cm, "bind_egraph", None)
    if binder is not None:
        binder(eg)
    if search not in SEARCH_STRATEGIES:
        raise ValueError(f"search must be one of {SEARCH_STRATEGIES}, "
                         f"got {search!r}")
    if not local_search:
        search = "none"
    if isinstance(roots, int):
        roots = (roots,)
    roots = tuple(eg.find(r) for r in roots)
    tree_cost, tree_choice = _tree_costs(eg, cm)
    for r in roots:
        if r not in tree_choice:
            raise ValueError(
                _unextractable_message(eg, r, set(tree_choice)))
    base_cost = dag_cost_of(eg, cm, tree_choice, roots)
    choice, cost = tree_choice, base_cost
    beam_cost = INF
    beam_stats = None
    if search != "none":
        deadline = t0 + time_limit_s
        evaluator = Evaluator(eg, cm)
        seeds = _collect_seeds(eg, cm, tree_choice, roots, deadline,
                               EvalBudget(max(hillclimb_evals // 4, 1000)))
        if seed_choices:
            # cache warm starts go first; completed over the tree fixed
            # point so every class keeps a pick
            seeds = [{**tree_choice,
                      **{eg.find(c): eg.canonicalize(n)
                         for c, n in sc.items()}}
                     for sc in seed_choices] + seeds
        # stage 1 — identical in both modes: polish every restart seed
        # (this IS the original extractor; in beam mode it doubles as the
        # floor the beam must beat)
        seed_budget = EvalBudget(hillclimb_evals)
        for seed in seeds:
            ch, c = _local_search(eg, cm, seed, roots, deadline,
                                  evaluator=evaluator, budget=seed_budget)
            if c < cost:
                choice, cost = ch, c
        if search == "beam":
            # stage 2 — strictly additional work: beam over the seeds,
            # then polish the beam winner with its own budget, so the
            # final pick can only improve on the hill-climb result
            beam_stats = BeamStats()
            beam_choice, beam_cost = beam_search(
                eg, cm, seeds, roots, width=beam_width,
                deadline=deadline, max_expansions=beam_expansions,
                coordinated=coordinated,
                evaluator=evaluator, stats=beam_stats)
            if beam_cost < INF:
                ch, c = _local_search(
                    eg, cm, beam_choice, roots, deadline,
                    evaluator=evaluator,
                    budget=EvalBudget(max(hillclimb_evals // 2, 1000)))
                if c < cost:
                    choice, cost = ch, c
    live = reachable(eg, choice, roots)
    choice = {cid: n for cid, n in choice.items() if cid in live}
    predicted = None
    reporter = getattr(cm, "report", None)
    if reporter is not None:
        nodes = choice_nodes(eg, choice, roots)
        if nodes is not None:
            predicted = reporter(nodes)
    return ExtractionResult(
        choice=choice, roots=roots, dag_cost=cost,
        tree_cost=sum(tree_cost[r] for r in roots),
        wall_s=time.perf_counter() - t0,
        improved_by_search=base_cost - cost,
        predicted=predicted, search=search,
        beam_cost=beam_cost, beam_stats=beam_stats)


# -- brute force for tests -----------------------------------------------------------
def extract_exact(eg: EGraph, roots, cost_model: Optional[CostModel] = None,
                  max_combos: int = 200_000) -> ExtractionResult:
    """Enumerate all acyclic selections (tiny graphs only)."""
    cm = cost_model if cost_model is not None else RooflineCostModel()
    binder = getattr(cm, "bind_egraph", None)
    if binder is not None:
        binder(eg)
    if isinstance(roots, int):
        roots = (roots,)
    roots = tuple(eg.find(r) for r in roots)
    classes = eg.eclasses()
    cids = sorted(classes.keys())
    node_lists = [[eg.canonicalize(n) for n in classes[c].nodes] for c in cids]
    n_combos = 1
    for nl in node_lists:
        n_combos *= len(nl)
        if n_combos > max_combos:
            raise ValueError(f"too many combos (> {max_combos})")
    best_choice, best_cost = None, INF
    for combo in itertools.product(*node_lists):
        choice = dict(zip(cids, combo))
        c = dag_cost_of(eg, cm, choice, roots)
        if c < best_cost:
            best_choice, best_cost = choice, c
    assert best_choice is not None
    live = reachable(eg, best_choice, roots)
    best_choice = {c: n for c, n in best_choice.items() if c in live}
    return ExtractionResult(choice=best_choice, roots=roots,
                            dag_cost=best_cost, tree_cost=best_cost,
                            search="exact")


def optimality_gap(eg: EGraph, result: ExtractionResult,
                   cost_model: Optional[CostModel] = None, *,
                   max_classes: int = 12,
                   max_combos: int = 200_000) -> Optional[float]:
    """Relative gap of ``result`` vs the brute-force oracle, or None when
    the graph is too large to enumerate.

    ``0.0`` means the search matched the global optimum. Used by the
    benchmark layer to measure how far the beam is from ILP-quality
    extraction wherever the oracle is feasible.
    """
    if eg.num_classes() > max_classes:
        return None
    try:
        exact = extract_exact(eg, result.roots, cost_model,
                              max_combos=max_combos)
    except ValueError:
        return None
    if exact.dag_cost <= 0:
        return 0.0 if result.dag_cost <= exact.dag_cost + 1e-9 else INF
    return max(0.0, (result.dag_cost - exact.dag_cost) / exact.dag_cost)
