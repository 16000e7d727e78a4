"""Deterministic, seeded fault injection for the saturator stack.

A :class:`FaultPlan` names *injection sites* — fixed points in the
pipeline (cache I/O, rule application, e-graph budgets, codegen
``exec``, verification, the schedule search) where a fault is raised
when the plan says so. Sites call :func:`chaos_point` /
:func:`maybe_raise`; with no plan installed those are near-free no-ops,
so production paths pay nothing.

Determinism contract: whether occurrence *n* of a site fires depends
only on ``(plan.seed, site, n)`` via sha256 — never on wall clock,
``random``, or hash order — so a chaos run replays bit-identically
under any ``PYTHONHASHSEED`` (``benchmarks/chaos_sweep.py`` gates on
this).

Activation: ``install_plan()`` / the ``plan_scope()`` context manager
(what ``SaturatorConfig.guard_cfg.chaos`` uses), or the ``REPRO_CHAOS``
environment variable (see :func:`plan_from_env`).

The module also hosts :class:`ScheduledFaults` — the seeded one-shot
keyed registry behind :class:`repro.runtime.ft.FailureInjector`, so the
training-loop fault schedule and the saturator chaos sites share one
injection mechanism and one telemetry stream.

No top-level repro imports: deep core modules (egraph/beam/schedule/
rules/codegen) import this module at module scope without cycles.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

ENV_VAR = "REPRO_CHAOS"

# Every site the stack exposes. Raising styles differ on purpose:
# cache sites raise *real* OSErrors inside the store's own try blocks
# (exercising the production handlers), the rest raise InjectedFault
# (caught by the degradation ladder in repro.core.pipeline).
FAULT_SITES = (
    "cache_read_io",    # OSError while reading a cache entry
    "cache_write_io",   # OSError (ENOSPC) in the atomic-write path
    "cache_corrupt",    # entry bytes tampered -> digest mismatch
    "rule_raise",       # a rewrite rule raises mid-saturation
    "egraph_budget",    # e-graph budget exhaustion during saturation
    "exec_fail",        # codegen exec() of the generated source fails
    "verify_error",     # the static verifier raises
    "slow_stage",       # the cost schedule search stalls past deadline
    "train_host_loss",  # ft.py: simulated host loss in the train loop
)


class InjectedFault(RuntimeError):
    """A fault raised by the chaos harness (never by production code)."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which sites fire, how often, and for which kernels.

    ``max_fires`` bounds fires *per site* (None = unlimited);
    ``probability`` < 1 makes occurrence *n* of a site fire iff the
    deterministic hash of ``(seed, site, n)`` lands under it; a
    ``kernels`` filter restricts firing to those kernel names (sites
    reached outside any kernel context always pass the filter when it
    is unset, never when it is set)."""
    sites: Tuple[str, ...]
    seed: int = 0
    max_fires: Optional[int] = 1
    kernels: Optional[Tuple[str, ...]] = None
    probability: float = 1.0

    def __post_init__(self):
        unknown = sorted(set(self.sites) - set(FAULT_SITES))
        if unknown:
            raise ValueError(f"unknown fault site(s) {unknown}; "
                             f"valid: {FAULT_SITES}")


_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None
_OCCURRENCES: Dict[str, int] = {}
_FIRES: Dict[str, int] = {}
# env-plan cache: (raw REPRO_CHAOS value, parsed plan)
_ENV_CACHE: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)

# thread-local kernel context, pushed by SaturationGuard.activate()
_TLS = threading.local()


def _tel():
    from repro_torch.core.telemetry import telemetry
    return telemetry()


def _u01(seed: int, site: str, occurrence: int) -> float:
    h = hashlib.sha256(f"{seed}:{site}:{occurrence}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def install_plan(plan: Optional[FaultPlan]):
    """Install ``plan`` process-wide (None = clear). Resets fire/
    occurrence counters so expectations are per-installation."""
    global _PLAN
    with _LOCK:
        _PLAN = plan
        _OCCURRENCES.clear()
        _FIRES.clear()


def clear_plan():
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else the ``REPRO_CHAOS`` environment plan."""
    if _PLAN is not None:
        return _PLAN
    return _env_plan()


def _env_plan() -> Optional[FaultPlan]:
    global _ENV_CACHE
    raw = os.environ.get(ENV_VAR) or None
    cached_raw, cached_plan = _ENV_CACHE
    if raw == cached_raw:
        return cached_plan
    plan = plan_from_env(raw) if raw else None
    with _LOCK:
        _ENV_CACHE = (raw, plan)
    return plan


def plan_from_env(spec: str) -> FaultPlan:
    """Parse a ``REPRO_CHAOS`` value into a plan.

    Format: ``site[,site...][:key=value]...`` with keys ``seed`` (int),
    ``max_fires`` (int or ``inf``), ``p`` (float probability) and
    ``kernels`` (``|``-separated names). Example::

        REPRO_CHAOS="rule_raise,exec_fail:seed=3:max_fires=1:kernels=rmsnorm|adamw"
    """
    parts = [p for p in spec.split(":") if p]
    if not parts:
        raise ValueError(f"empty {ENV_VAR} spec")
    sites = tuple(s.strip() for s in parts[0].split(",") if s.strip())
    kw: Dict[str, Any] = {}
    for opt in parts[1:]:
        if "=" not in opt:
            raise ValueError(f"bad {ENV_VAR} option {opt!r} "
                             f"(expected key=value)")
        k, v = opt.split("=", 1)
        if k == "seed":
            kw["seed"] = int(v)
        elif k == "max_fires":
            kw["max_fires"] = None if v in ("inf", "none") else int(v)
        elif k == "p":
            kw["probability"] = float(v)
        elif k == "kernels":
            kw["kernels"] = tuple(n for n in v.split("|") if n)
        else:
            raise ValueError(f"unknown {ENV_VAR} option {k!r}")
    return FaultPlan(sites=sites, **kw)


@contextmanager
def plan_scope(plan):
    """Temporarily install ``plan`` (a FaultPlan, a spec string, or
    None for a no-op scope); restores the previous plan on exit."""
    if plan is None:
        yield
        return
    if isinstance(plan, str):
        plan = plan_from_env(plan)
    global _PLAN
    with _LOCK:
        prev = _PLAN
    install_plan(plan)
    try:
        yield
    finally:
        install_plan(prev)


@contextmanager
def kernel_scope(name: Optional[str]):
    """Thread-local kernel context for the plan's ``kernels`` filter."""
    prev = getattr(_TLS, "kernel", None)
    _TLS.kernel = name
    try:
        yield
    finally:
        _TLS.kernel = prev


def current_kernel() -> Optional[str]:
    return getattr(_TLS, "kernel", None)


def chaos_point(site: str, kernel: Optional[str] = None) -> bool:
    """True iff this occurrence of ``site`` should fault. Near-free
    when no plan is active (one global read + None check)."""
    plan = _PLAN
    if plan is None:
        plan = _env_plan()
        if plan is None:
            return False
    if site not in plan.sites:
        return False
    if plan.kernels is not None:
        k = kernel if kernel is not None else current_kernel()
        if k not in plan.kernels:
            return False
    with _LOCK:
        if plan.max_fires is not None and \
                _FIRES.get(site, 0) >= plan.max_fires:
            return False
        occ = _OCCURRENCES.get(site, 0)
        _OCCURRENCES[site] = occ + 1
        if plan.probability < 1.0 and \
                _u01(plan.seed, site, occ) >= plan.probability:
            return False
        _FIRES[site] = _FIRES.get(site, 0) + 1
        k = kernel if kernel is not None else current_kernel()
    _tel().record_chaos(site, k)
    return True


def maybe_raise(site: str, kernel: Optional[str] = None,
                detail: str = ""):
    """Raise :class:`InjectedFault` when the plan fires ``site``."""
    if chaos_point(site, kernel):
        raise InjectedFault(site, detail)


def maybe_raise_os(site: str, errno_code: int, detail: str):
    """Raise a *real* ``OSError`` (tagged with ``.chaos_site``) when the
    plan fires — cache sites use this so the store's production OSError
    handlers are what gets exercised, not a special-cased chaos type."""
    if chaos_point(site):
        err = OSError(errno_code, f"injected: {detail}")
        err.chaos_site = site  # type: ignore[attr-defined]
        raise err


def fire_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_FIRES)


class ScheduledFaults:
    """Seeded one-shot keyed fault schedule (the registry behind
    ``ft.FailureInjector``): each armed key fires exactly once, and
    every fire is recorded in the shared chaos telemetry stream."""

    def __init__(self, site: str, schedule: Optional[Dict[Any, Any]] = None):
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        self.site = site
        self._armed: Dict[Any, Any] = dict(schedule or {})
        self.fired: List[Any] = []
        self._lock = threading.Lock()

    def arm(self, key: Any, payload: Any = True):
        with self._lock:
            self._armed[key] = payload

    def check(self, key: Any) -> Optional[Any]:
        """The payload armed for ``key`` (once; None afterwards)."""
        with self._lock:
            if key not in self._armed or key in self.fired:
                return None
            self.fired.append(key)
            payload = self._armed[key]
        _tel().record_chaos(self.site, str(key))
        return payload
