"""Rule-soundness pass: structural lint + differential validation.

Every :class:`repro_torch.core.rules.Rule` is a (lhs, rhs) pattern pair the
saturator treats as a semantics-preserving equality. This pass checks
that claim from two sides:

* **structural lint** — every RHS pattern variable is bound on the LHS
  (an unbound variable would instantiate from a missing substitution),
  every operator exists in the IR vocabulary with the right arity, and
  each rule is classified by size growth (expanding rules are what blow
  e-graphs up; the classification is reported, not judged);
* **differential validation** — LHS and RHS are evaluated under the
  shared :data:`repro_torch.core.ir.EVAL_FNS` semantics over (a) a random
  tier of well-conditioned float64 environments, (b) a bf16 tier of
  values quantized to the bfloat16 grid, and (c) an adversarial tier
  sweeping ±0.0, ±inf, NaN, double denormals and near-overflow
  magnitudes. A random/bf16-tier disagreement is always an
  ``error`` (the rule is wrong on ordinary finite math); an
  adversarial-tier disagreement is an ``error`` unless the rule is
  explicitly gated with ``finite_math=True`` (then it is a documented
  ``info`` note — the rule assumes no overflow/non-finite operands,
  e.g. reassociation or div→reciprocal strength reduction).

Comparison tolerates rounding re-association (|x−y| ≤ 1e-9 + 1e-9·max)
and treats NaN==NaN; genuinely unsound rules (e.g. add→sub) differ at
O(1) and are always caught. All environments are deterministic (seeded)
so findings are reproducible across runs and machines.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core.egraph import PatVar, Pattern
from repro_torch.core.ir import (ALL_OPS, BINOPS, CMPOPS, EVAL_FNS, REDOPS,
                           STRUCTOPS, TERNOPS, UNOPS)

from .findings import PASS_RULES, Finding

# Fixed-arity operator table for the structural lint. Structural /
# memory ops (load, call, phi_loop, ...) are variadic or carry payload
# semantics rules should not rewrite — their use in a pattern is
# flagged as a warning below.
_ARITY: Dict[str, int] = {}
for _op in BINOPS + CMPOPS:
    _ARITY[_op] = 2
for _op in UNOPS + REDOPS + STRUCTOPS:
    _ARITY[_op] = 1
for _op in TERNOPS:
    _ARITY[_op] = 3
_ARITY["phi"] = 3

_RTOL = 1e-9
_ATOL = 1e-9

# Adversarial operand values: signed zeros, non-finite, double
# denormals (recip overflows), near-overflow magnitudes (reassociation
# overflows) and a couple of ordinary anchors.
_SPECIALS: Tuple[float, ...] = (
    0.0, -0.0, 1.0, -1.0, 0.5, 2.0,
    float("inf"), float("-inf"), float("nan"),
    1e-310, -1e-310, 1e308, -1e308,
)
_MAX_ADVERSARIAL_ENVS = 4096


@dataclasses.dataclass
class RuleRecord:
    """Per-rule structural classification (metadata, not findings)."""
    name: str
    growth: str            # "expanding" | "contracting" | "neutral"
    lhs_size: int
    rhs_size: int
    finite_math: bool
    envs_checked: int = 0


@dataclasses.dataclass
class RulesCheckResult:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    records: List[RuleRecord] = dataclasses.field(default_factory=list)

    @property
    def rules_checked(self) -> int:
        return len(self.records)


# -- pattern helpers ----------------------------------------------------------
def pattern_vars(pat: Any) -> Set[str]:
    if isinstance(pat, PatVar):
        return {pat.name}
    out: Set[str] = set()
    for ch in pat.children:
        out |= pattern_vars(ch)
    return out


def pattern_size(pat: Any) -> int:
    """Operator-node count (variables are free)."""
    if isinstance(pat, PatVar):
        return 0
    return 1 + sum(pattern_size(ch) for ch in pat.children)


def pattern_ops(pat: Any) -> List[Tuple[str, int]]:
    """(op, arity) of every operator node in the pattern."""
    if isinstance(pat, PatVar):
        return []
    out = [(pat.op, len(pat.children))]
    for ch in pat.children:
        out.extend(pattern_ops(ch))
    return out


def eval_pattern(pat: Any, env: Dict[str, float]):
    """Evaluate a pattern under EVAL_FNS with variables bound by env.

    Variables are bound as ``np.float64`` so every operator follows
    IEEE-754 semantics (0/0 → nan, x/0 → ±inf) instead of raising like
    plain Python floats."""
    import numpy as np
    if isinstance(pat, PatVar):
        return np.float64(env[pat.name])
    args = [eval_pattern(ch, env) for ch in pat.children]
    fn = EVAL_FNS[pat.op]
    with np.errstate(all="ignore"):
        return fn(*args)


# -- environments -------------------------------------------------------------
def _bf16(x: float) -> float:
    """Quantize to the bfloat16 grid (truncate the f32 mantissa to 7
    bits) — every result is an exactly-representable bf16 value, no
    ml_dtypes dependency needed."""
    import numpy as np
    a = np.array([x], dtype=np.float32)
    bits = a.view(np.uint32)
    bits &= np.uint32(0xFFFF0000)
    return float(a[0])


def _random_envs(names: List[str], n: int, seed: int,
                 quantize_bf16: bool = False) -> List[Dict[str, float]]:
    rng = random.Random(seed)
    envs = []
    for _ in range(n):
        env = {}
        for v in names:
            mag = math.exp(rng.uniform(math.log(0.25), math.log(4.0)))
            val = mag if rng.random() < 0.5 else -mag
            env[v] = _bf16(val) if quantize_bf16 else val
        envs.append(env)
    return envs


def _adversarial_envs(names: List[str]) -> Iterable[Dict[str, float]]:
    combos = itertools.product(_SPECIALS, repeat=len(names))
    for combo in itertools.islice(combos, _MAX_ADVERSARIAL_ENVS):
        yield dict(zip(names, combo))


def _fmt(x) -> str:
    import numpy as np
    if isinstance(x, (bool, np.bool_)):
        return str(bool(x))
    try:
        return repr(float(x))
    except (TypeError, ValueError):
        return repr(x)


# -- comparison ---------------------------------------------------------------
def _agree(x, y) -> bool:
    import numpy as np
    if isinstance(x, (bool, np.bool_)) or isinstance(y, (bool, np.bool_)):
        return bool(x) == bool(y)
    try:
        xf, yf = float(x), float(y)
    except (TypeError, ValueError):
        return repr(x) == repr(y)
    if math.isnan(xf) or math.isnan(yf):
        return math.isnan(xf) and math.isnan(yf)
    if math.isinf(xf) or math.isinf(yf):
        return xf == yf
    return abs(xf - yf) <= _ATOL + _RTOL * max(abs(xf), abs(yf))


# -- the pass -----------------------------------------------------------------
def _lint_rule(rule) -> List[Finding]:
    out: List[Finding] = []
    lhs_vars = pattern_vars(rule.lhs)
    rhs_vars = pattern_vars(rule.rhs)
    unbound = sorted(rhs_vars - lhs_vars)
    if unbound:
        out.append(Finding(
            PASS_RULES, "error", "unbound-rhs-var",
            f"RHS variables {unbound} are not bound on the LHS",
            subject=rule.name))
    if isinstance(rule.lhs, PatVar):
        out.append(Finding(
            PASS_RULES, "error", "catchall-lhs",
            "LHS is a bare variable — the rule matches every e-class",
            subject=rule.name))
    for side, pat in (("lhs", rule.lhs), ("rhs", rule.rhs)):
        for op, arity in pattern_ops(pat):
            if op not in ALL_OPS:
                out.append(Finding(
                    PASS_RULES, "error", "unknown-op",
                    f"{side} uses operator {op!r} not in the IR "
                    f"vocabulary", subject=rule.name))
            elif op in _ARITY and _ARITY[op] != arity:
                out.append(Finding(
                    PASS_RULES, "error", "bad-arity",
                    f"{side} applies {op!r} to {arity} operands "
                    f"(expected {_ARITY[op]})", subject=rule.name))
            elif op not in _ARITY:
                out.append(Finding(
                    PASS_RULES, "warning", "structural-op",
                    f"{side} rewrites structural/memory op {op!r} — "
                    f"load/φ/call semantics are not value-only",
                    subject=rule.name))
    return out


def _evaluable(rule) -> bool:
    return all(op in EVAL_FNS
               for op, _ in pattern_ops(rule.lhs) + pattern_ops(rule.rhs))


def _differential(rule, n_random: int, seed: int
                  ) -> Tuple[Optional[Finding], int]:
    """At most one finding per rule: the first tier that disagrees.

    Returns (finding_or_None, environments_checked)."""
    names = sorted(pattern_vars(rule.lhs) | pattern_vars(rule.rhs))
    finite = bool(getattr(rule, "finite_math", False))
    checked = 0
    tiers = [
        ("random", "error", _random_envs(names, n_random, seed)),
        ("bf16", "error",
         _random_envs(names, max(4, n_random // 4), seed + 1,
                      quantize_bf16=True)),
        ("adversarial", "info" if finite else "error",
         _adversarial_envs(names)),
    ]
    for tier, severity, envs in tiers:
        for env in envs:
            checked += 1
            lv = eval_pattern(rule.lhs, env)
            rv = eval_pattern(rule.rhs, env)
            if not _agree(lv, rv):
                code = ("finite-math-gated"
                        if tier == "adversarial" and finite
                        else "unsound-rule")
                msg = (f"LHS≢RHS on {tier} tier: env={env} "
                       f"lhs={_fmt(lv)} rhs={_fmt(rv)}")
                if tier == "adversarial" and finite:
                    msg += " (documented finite_math=True gate)"
                return Finding(PASS_RULES, severity, code, msg,
                               subject=rule.name), checked
    return None, checked


def verify_rules(rules, *, n_random: int = 32,
                 seed: int = 0) -> RulesCheckResult:
    """Run structural lint + differential validation over ``rules``.

    Deterministic; one differential finding max per rule (the clean
    built-in rule sets produce zero error findings — the ``finite_math``
    rules contribute documented ``info`` notes only)."""
    res = RulesCheckResult()
    for rule in rules:
        lint = _lint_rule(rule)
        res.findings.extend(lint)
        delta = pattern_size(rule.rhs) - pattern_size(rule.lhs)
        rec = RuleRecord(
            name=rule.name,
            growth=("expanding" if delta > 0 else
                    "contracting" if delta < 0 else "neutral"),
            lhs_size=pattern_size(rule.lhs),
            rhs_size=pattern_size(rule.rhs),
            finite_math=bool(getattr(rule, "finite_math", False)))
        res.records.append(rec)
        if any(f.severity == "error" for f in lint):
            continue  # structurally broken: differential would misfire
        if not _evaluable(rule):
            res.findings.append(Finding(
                PASS_RULES, "info", "not-evaluable",
                "rule uses operators without a numeric evaluation — "
                "differential validation skipped", subject=rule.name))
            continue
        finding, checked = _differential(rule, n_random, seed)
        rec.envs_checked = checked
        if finding is not None:
            res.findings.append(finding)
    return res
