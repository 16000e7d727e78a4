"""Guarded saturation runtime: budgets, degradation ladder, breakers.

Equality saturation is non-destructive — stopping early or falling
back is always sound (Tate et al.) — so the robustness contract here
is a *guaranteed degradation ladder*, not retry-until-success:

    hit -> warm -> cold -> cheap -> ref

``hit``/``warm``/``cold`` are the persistent-cache outcomes of the full
configuration; ``cheap`` is a minimal deterministic search (beam width
1, legacy bulk emission with no schedule search, verify off, cache
off); ``ref`` is the reference interpreter from ``core/reference.py``
(and, at the kernels layer, the named oracles in ``kernels/ref.py``).
``repro.core.pipeline.saturate_program`` walks the ladder; nothing
inside it may raise to ``launch/serve.py`` / ``launch/train.py``.

Three guard mechanisms, all reported through ``core/telemetry.py``:

* :class:`SaturationGuard` — per-attempt hard ceilings. The primary
  limit is a *deterministic* eval-budget counter (``guard_tick`` calls
  from the saturation loop, beam expansion, hill climb, and schedule
  search); the wall-clock deadline and the e-graph node/class ceilings
  are safety nets only, so fault-free runs never depend on timing.
* :func:`run_ladder` — runs attempts top to bottom, converting any
  exception into a recorded degradation; only the floor failing
  re-raises (there is nothing left to fall to).
* :class:`CircuitBreaker` — per (kernel, config) key: after K
  consecutive failures of the primary attempt, skip straight to the
  last level that worked for a cool-down of N calls, then allow one
  half-open trial.

No top-level repro imports (telemetry is resolved lazily), so core
modules can import ``guard_tick`` at module scope without cycles.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import chaos

LADDER_LEVELS = ("hit", "warm", "cold", "cheap", "ref")


def _tel():
    from repro_torch.core.telemetry import telemetry
    return telemetry()


class BudgetExceeded(RuntimeError):
    """A guard ceiling tripped. ``trigger`` names which one:
    ``eval_budget`` | ``deadline`` | ``node_ceiling`` | ``class_ceiling``
    | ``egraph_budget`` (chaos-injected exhaustion)."""

    def __init__(self, trigger: str, detail: str = ""):
        super().__init__(f"guard budget exceeded: {trigger}"
                         + (f" ({detail})" if detail else ""))
        self.trigger = trigger


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Ceilings + ladder/breaker policy for one saturate call.

    ``eval_budget`` counts deterministic guard ticks (saturation
    iterations, beam expansions, hill-climb evals, schedule moves) and
    is the primary limit — generously above any sane build (a default
    full build spends well under 200k ticks). ``deadline_s`` and the
    e-graph ceilings are safety nets for runaway stages the tick
    counters cannot see. None of these fields enter the cache
    fingerprint (``repro.cache.keys`` lists its components explicitly),
    so tightening a budget never churns cache keys.

    ``chaos`` optionally carries a :class:`repro.runtime.chaos`
    plan-spec string scoped to the call (the config-level twin of the
    ``REPRO_CHAOS`` environment variable)."""
    eval_budget: int = 2_000_000
    deadline_s: float = 120.0
    node_ceiling: int = 200_000
    class_ceiling: int = 200_000
    ladder: bool = True
    breaker_threshold: int = 3
    breaker_cooldown: int = 8
    chaos: Optional[str] = None


_TLS = threading.local()


class SaturationGuard:
    """Hard ceilings for one ladder attempt; activated thread-locally
    so deep stages (egraph/beam/schedule) report via :func:`guard_tick`
    without threading a handle through every signature."""

    __slots__ = ("kernel", "cfg", "ticks", "stage", "_deadline")

    def __init__(self, kernel: str, cfg: Optional[GuardConfig] = None):
        self.kernel = kernel
        self.cfg = cfg or GuardConfig()
        self.ticks = 0
        self.stage = "init"
        self._deadline: Optional[float] = None

    def tick(self, stage: str, n: int = 1,
             nodes: Optional[int] = None,
             classes: Optional[int] = None):
        self.stage = stage
        cfg = self.cfg
        self.ticks += n
        if self.ticks > cfg.eval_budget:
            raise BudgetExceeded(
                "eval_budget", f"{self.ticks} ticks at {stage}")
        if nodes is not None and nodes > cfg.node_ceiling:
            raise BudgetExceeded(
                "node_ceiling", f"{nodes} e-nodes at {stage}")
        if classes is not None and classes > cfg.class_ceiling:
            raise BudgetExceeded(
                "class_ceiling", f"{classes} e-classes at {stage}")
        # wall clock is a safety net only — sampled every 1024 ticks so
        # the hot loops stay free of syscalls
        if self._deadline is not None and (self.ticks & 0x3FF) == 0 \
                and time.monotonic() > self._deadline:
            raise BudgetExceeded("deadline", f"at {stage}")

    @contextmanager
    def activate(self):
        prev = getattr(_TLS, "guard", None)
        _TLS.guard = self
        self._deadline = time.monotonic() + self.cfg.deadline_s
        try:
            with chaos.kernel_scope(self.kernel):
                yield self
        finally:
            _TLS.guard = prev


def current_guard() -> Optional[SaturationGuard]:
    return getattr(_TLS, "guard", None)


def guard_tick(stage: str, n: int = 1, nodes: Optional[int] = None,
               classes: Optional[int] = None):
    """Report progress to the ambient guard (no-op when none active —
    the fast path is one thread-local read)."""
    g = getattr(_TLS, "guard", None)
    if g is not None:
        g.tick(stage, n, nodes=nodes, classes=classes)


def classify_failure(exc: BaseException, stage: str) -> str:
    """Stable trigger label for telemetry: budget trips and injected
    faults keep their own names; anything else is ``stage:ExcType``."""
    if isinstance(exc, BudgetExceeded):
        return f"budget:{exc.trigger}"
    if isinstance(exc, chaos.InjectedFault):
        return f"chaos:{exc.site}"
    site = getattr(exc, "chaos_site", None)
    if site is not None:
        return f"chaos:{site}"
    return f"{stage}:{type(exc).__name__}"


class CircuitBreaker:
    """closed -> (K consecutive primary failures) -> open -> (cool-down
    of N admitted calls, skipping straight to the recorded fallback
    level) -> half-open (one trial) -> closed on success / re-open on
    failure. Cool-down is counted in calls, not seconds — deterministic
    under test and load-proportional in production."""

    def __init__(self, key: Any, threshold: int = 3, cooldown: int = 8):
        self.key = key
        self.threshold = max(1, threshold)
        self.cooldown = max(1, cooldown)
        self.state = "closed"
        self.failures = 0          # consecutive primary failures
        self._cooldown_left = 0
        self.fallback_level = "cheap"
        self._lock = threading.Lock()

    def admit(self) -> Optional[str]:
        """None = try the full ladder; a level name = skip straight to
        that rung (the breaker is open / another half-open trial is in
        flight)."""
        with self._lock:
            if self.state == "closed":
                return None
            if self.state == "open":
                self._cooldown_left -= 1
                if self._cooldown_left <= 0:
                    self.state = "half_open"
                    _tel().record_breaker(self.key, "half_open")
                    return None    # the one trial passes through
            return self.fallback_level

    def record_success(self):
        with self._lock:
            self.failures = 0
            if self.state != "closed":
                self.state = "closed"
                _tel().record_breaker(self.key, "close")

    def record_failure(self, fallback_level: Optional[str] = None):
        with self._lock:
            self.failures += 1
            if fallback_level is not None:
                self.fallback_level = fallback_level
            if self.state == "half_open" or self.failures >= self.threshold:
                if self.state != "open":
                    _tel().record_breaker(self.key, "open")
                self.state = "open"
                self._cooldown_left = self.cooldown


_BREAKERS: Dict[Any, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def breaker_for(key: Any, threshold: int = 3,
                cooldown: int = 8) -> CircuitBreaker:
    """The process-wide breaker for ``key`` (created on first use; the
    policy of the first caller wins for the key's lifetime)."""
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(key)
        if br is None:
            br = _BREAKERS[key] = CircuitBreaker(
                key, threshold=threshold, cooldown=cooldown)
        return br


def reset_breakers():
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


def breakers_snapshot() -> Dict[str, Any]:
    with _BREAKERS_LOCK:
        states: Dict[str, int] = {}
        for br in _BREAKERS.values():
            states[br.state] = states.get(br.state, 0) + 1
        return {"total": len(_BREAKERS), "states": states}


def run_ladder(kernel: str,
               attempts: List[Tuple[str, Callable[[], Any]]],
               *, cfg: Optional[GuardConfig] = None,
               breaker: Optional[CircuitBreaker] = None
               ) -> Tuple[str, Any]:
    """Run ``attempts`` (ordered ``(level, thunk)`` rungs) under a fresh
    :class:`SaturationGuard` each, degrading on any exception. Returns
    ``(level, result)`` of the first rung that succeeds; only the floor
    failing re-raises. The breaker counts *primary* attempts: a skip
    drops straight to its recorded fallback rung."""
    cfg = cfg or GuardConfig()
    start = 0
    if breaker is not None:
        skip_to = breaker.admit()
        if skip_to is not None:
            _tel().record_breaker(kernel, "skip")
            start = next((i for i, (lv, _) in enumerate(attempts)
                          if lv == skip_to), len(attempts) - 1)
    first_trigger: Optional[str] = None
    last_err: Optional[BaseException] = None
    for i in range(start, len(attempts)):
        level, thunk = attempts[i]
        g = SaturationGuard(kernel, cfg)
        try:
            with g.activate():
                result = thunk()
        except BaseException as e:  # ladder contract: degrade on anything
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            trigger = classify_failure(e, g.stage)
            if first_trigger is None:
                first_trigger = trigger
            _tel().record_guard_failure(kernel, level, trigger)
            last_err = e
            continue
        if breaker is not None and start == 0:
            if i == 0:
                breaker.record_success()
            else:
                breaker.record_failure(fallback_level=level)
        if i > 0 or start > 0:
            _tel().record_degradation(
                kernel, level, first_trigger or "breaker_skip")
        return level, result
    if breaker is not None and start == 0:
        breaker.record_failure(fallback_level=attempts[-1][0])
    assert last_err is not None
    raise last_err
