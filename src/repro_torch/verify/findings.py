"""Severity-tagged findings shared by every verification pass.

A :class:`Finding` is one observed violation (or note) from a static
pass; a :class:`VerifyReport` aggregates the findings of a whole
verification run plus the coverage counters the telemetry layer and
``chip_smoke.py`` surface (``rules_checked``,
``schedules_certified``, ...).

Severities:

* ``"error"``   — a soundness/legality violation: an unsound rule, a
  broken e-graph invariant, a non-topological statement order, an
  out-of-bounds index. CI gates on zero of these.
* ``"warning"`` — suspicious but not provably wrong (dead loads,
  write-write ref races, dtype disagreement across a merge).
* ``"info"``    — advisory: documented ``finite_math`` rule gating,
  memory-access-order (overlap-distance) lint notes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List

SEVERITIES = ("error", "warning", "info")

# Pass names — the keys of ``findings_by_pass`` everywhere.
PASS_RULES = "rules"
PASS_EGRAPH = "egraph"
PASS_SCHEDULE = "schedule"
PASS_CODEGEN = "codegen"
PASS_GRID = "grid"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verification finding.

    ``code`` is a stable kebab-case identifier tests and CI match on
    (e.g. ``"unsound-rule"``, ``"illegal-order"``, ``"oob-index"``);
    ``subject`` names the checked object (rule name, e-class, unit,
    array)."""
    pass_name: str
    severity: str
    code: str
    message: str
    subject: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def __str__(self) -> str:
        subj = f" [{self.subject}]" if self.subject else ""
        return f"{self.severity}:{self.pass_name}:{self.code}{subj} " \
               f"{self.message}"


@dataclasses.dataclass
class VerifyReport:
    """Findings + coverage counters of one verification run."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    rules_checked: int = 0
    schedules_certified: int = 0
    egraphs_checked: int = 0
    sources_checked: int = 0
    grids_checked: int = 0

    def add(self, f: Finding) -> None:
        self.findings.append(f)

    def extend(self, fs: Iterable[Finding]) -> None:
        self.findings.extend(fs)

    def merge(self, other: "VerifyReport") -> None:
        self.findings.extend(other.findings)
        self.rules_checked += other.rules_checked
        self.schedules_certified += other.schedules_certified
        self.egraphs_checked += other.egraphs_checked
        self.sources_checked += other.sources_checked
        self.grids_checked += other.grids_checked

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def by_severity(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def by_pass(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.pass_name] = out.get(f.pass_name, 0) + 1
        return out

    @property
    def ok(self) -> bool:
        """True when no error-severity finding was recorded."""
        return not self.errors()

    def summary(self) -> Dict[str, Any]:
        """JSON-able digest (what benchmarks/telemetry persist)."""
        return {
            "ok": self.ok,
            "findings": len(self.findings),
            "by_severity": self.by_severity(),
            "by_pass": self.by_pass(),
            "rules_checked": self.rules_checked,
            "schedules_certified": self.schedules_certified,
            "egraphs_checked": self.egraphs_checked,
            "sources_checked": self.sources_checked,
            "grids_checked": self.grids_checked,
        }
