"""Rewriting rules — exactly the paper's Table I plus constant folding.

  FMA1       A + B*C      -> FMA(A, B, C)
  FMA2       A - B*C      -> FMA(A, -B, C)
  FMA3       B*C - A      -> FMA(-A, B, C)
  COMM-ADD   A + B        -> B + A
  COMM-MUL   A * B        -> B * A
  ASSOC-ADD1 A + (B + C)  -> (A + B) + C
  ASSOC-ADD2 (A + B) + C  -> A + (B + C)
  ASSOC-MUL1 A * (B * C)  -> (A * B) * C
  ASSOC-MUL2 (A * B) * C  -> A * (B * C)

Constant folding is an e-class analysis in :mod:`repro.core.egraph`.

``EXTENDED_RULES`` adds the rewrites the paper names but disables for
e-graph-size reasons (§V-A: subtraction, division, ...); they are off by
default here too and exercised in tests/ablations.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.runtime import chaos
from repro_torch.runtime.guard import BudgetExceeded, guard_tick

from .egraph import EGraph, P, V, Pattern, PatVar


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    lhs: object  # PatTerm
    rhs: object  # PatTerm
    # True = the equality holds only when no operand/intermediate is
    # non-finite or denormal (IEEE-754 edge cases break it: reassociation
    # changes which partial sum overflows; a/b -> a*(1/b) overflows the
    # reciprocal of a denormal divisor). repro.verify.rules_check gates
    # its adversarial tier on this flag — finite-math rules report a
    # documented info note instead of an unsound-rule error.
    finite_math: bool = False


A, B, C = V("a"), V("b"), V("c")

# The paper's minimum rule set (Table I).
FMA_RULES: List[Rule] = [
    Rule("FMA1", P("add", A, P("mul", B, C)), P("fma", A, B, C)),
    Rule("FMA2", P("sub", A, P("mul", B, C)), P("fma", A, P("neg", B), C)),
    Rule("FMA3", P("sub", P("mul", B, C), A), P("fma", P("neg", A), B, C)),
]

# Reassociation is finite-math only: (1e308 + 1e308) - 1e308 overflows
# to inf in one association and stays 1e308 in the other. Commutativity
# is exact (IEEE add/mul are commutative even for NaN payload-free math).
REORDER_RULES: List[Rule] = [
    Rule("COMM-ADD", P("add", A, B), P("add", B, A)),
    Rule("COMM-MUL", P("mul", A, B), P("mul", B, A)),
    Rule("ASSOC-ADD1", P("add", A, P("add", B, C)),
         P("add", P("add", A, B), C), finite_math=True),
    Rule("ASSOC-ADD2", P("add", P("add", A, B), C),
         P("add", A, P("add", B, C)), finite_math=True),
    Rule("ASSOC-MUL1", P("mul", A, P("mul", B, C)),
         P("mul", P("mul", A, B), C), finite_math=True),
    Rule("ASSOC-MUL2", P("mul", P("mul", A, B), C),
         P("mul", A, P("mul", B, C)), finite_math=True),
]

PAPER_RULES: List[Rule] = FMA_RULES + REORDER_RULES

# Rewrites the paper mentions but restricts (§V-A last paragraph). Sound,
# used only when SaturatorConfig.extended_rules=True.
EXTENDED_RULES: List[Rule] = [
    Rule("SUB-AS-ADDNEG", P("sub", A, B), P("add", A, P("neg", B))),
    Rule("ADDNEG-AS-SUB", P("add", A, P("neg", B)), P("sub", A, B)),
    Rule("NEG-NEG", P("neg", P("neg", A)), A),
    # a/b <-> a*(1/b) is finite-math only: recip of a denormal divisor
    # (1e-310) overflows to inf, so 1e-310/1e-310 = 1 but
    # 1e-310 * recip(1e-310) = inf (likewise 0*recip(inf) = nan vs 0).
    Rule("DIV-AS-RECIP", P("div", A, B), P("mul", A, P("recip", B)),
         finite_math=True),
    Rule("RECIP-AS-DIV", P("mul", A, P("recip", B)), P("div", A, B),
         finite_math=True),
    Rule("SQUARE", P("mul", A, A), P("square", A)),
    Rule("UNSQUARE", P("square", A), P("mul", A, A)),
    Rule("FMA-UNFOLD", P("fma", A, B, C), P("add", A, P("mul", B, C))),
]

# TPU-targeted additions (beyond-paper; see DESIGN.md §2): strength
# reductions that matter on the VPU where transcendentals/divides are
# multi-pass ops. All are exact-value rewrites (no fastmath approximations).
TPU_RULES: List[Rule] = [
    Rule("RSQRT", P("recip", P("sqrt", A)), P("rsqrt", A)),
    Rule("RSQRT-DIV", P("div", A, P("sqrt", B)), P("mul", A, P("rsqrt", B))),
    Rule("DIV-CONST-NOP", P("div", A, A), P("div", A, A)),  # placeholder keeps table aligned
]


@dataclasses.dataclass
class SaturationReport:
    iterations: int = 0
    n_nodes: int = 0
    n_classes: int = 0
    n_unions: int = 0
    saturated: bool = False
    stop_reason: str = ""
    wall_s: float = 0.0
    per_rule_matches: dict = dataclasses.field(default_factory=dict)


def run_rules(eg: EGraph, rules: List[Rule], *,
              iter_limit: int = 10,
              node_limit: int = 10_000,
              time_limit_s: float = 10.0) -> SaturationReport:
    """egg-style batched saturation under the paper's §VII limits."""
    rep = SaturationReport()
    t0 = time.perf_counter()
    for it in range(iter_limit):
        rep.iterations = it + 1
        # guard hook: one tick per saturation iteration, carrying the
        # graph size so the node/class ceilings (safety nets above the
        # paper's node_limit) are enforced even if a rule loops
        guard_tick("saturation", nodes=eg.num_nodes(),
                   classes=eg.num_classes())
        chaos.maybe_raise("rule_raise", detail="rule application")
        if chaos.chaos_point("egraph_budget"):
            raise BudgetExceeded("egraph_budget",
                                 "injected e-graph exhaustion")
        matches: List[Tuple[Rule, int, dict]] = []
        for rule in rules:
            found = eg.ematch(rule.lhs)
            if found:
                rep.per_rule_matches[rule.name] = (
                    rep.per_rule_matches.get(rule.name, 0) + len(found))
            for cid, sub in found:
                matches.append((rule, cid, sub))
            if time.perf_counter() - t0 > time_limit_s:
                rep.stop_reason = "time_limit"
                break
        if rep.stop_reason:
            break
        before_unions = eg.n_unions
        before_nodes = eg.num_nodes()
        for rule, cid, sub in matches:
            new_id = eg.instantiate(rule.rhs, sub)
            eg.union(cid, new_id)
            if eg.num_nodes() > node_limit:
                rep.stop_reason = "node_limit"
                break
        eg.rebuild()
        if rep.stop_reason:
            break
        if eg.n_unions == before_unions and eg.num_nodes() == before_nodes:
            rep.saturated = True
            rep.stop_reason = "saturated"
            break
        if time.perf_counter() - t0 > time_limit_s:
            rep.stop_reason = "time_limit"
            break
    else:
        rep.stop_reason = rep.stop_reason or "iter_limit"
    rep.n_nodes = eg.num_nodes()
    rep.n_classes = eg.num_classes()
    rep.n_unions = eg.n_unions
    rep.wall_s = time.perf_counter() - t0
    return rep
