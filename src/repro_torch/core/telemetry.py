"""Process-wide saturation telemetry.

One tiny registry counts what the saturation subsystem actually did at
runtime — persistent-cache hits / misses / warm starts with their wall
times, and jaxpr-bridge fallbacks per unsupported primitive (the
coverage gaps ``maybe_saturate`` used to swallow silently). It has no
dependencies so every layer (core pipeline, cache store, jaxpr bridge,
launch drivers, benchmarks) can report into the same counters without
import cycles.

Consumers: ``launch/serve.py`` / ``launch/train.py`` surface
``snapshot()`` in their metrics, ``benchmarks/saturation_stats.py``
records it per run, and ``examples/serve_decode.py`` commits it to
``BENCH_6.json``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict

# Retained event dicts are a debugging aid, not the record of truth (the
# counters are); cap them so a long-lived serve/train process with
# recurring bridge fallbacks or cache lookups doesn't leak memory.
EVENT_LIMIT = 512


@dataclasses.dataclass
class SaturationTelemetry:
    """Counters for one process. All methods are thread-safe."""
    cache_hits: int = 0
    cache_misses: int = 0
    cache_warm_starts: int = 0
    cache_stores: int = 0
    cache_invalid: int = 0         # entries rejected (corrupt/stale/version)
    cold_wall_s: float = 0.0       # saturate+extract+schedule, no cache help
    warm_wall_s: float = 0.0       # same, seeded from a near-miss entry
    hit_wall_s: float = 0.0        # replay-only wall time on exact hits
    bridge_fallbacks: Dict[str, int] = dataclasses.field(
        default_factory=dict)  # primitive name -> count
    # static-verification counters (repro.verify)
    verify_runs: int = 0
    verify_errors: int = 0
    verify_findings_by_pass: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # pass name -> finding count
    rules_checked: int = 0
    schedules_certified: int = 0
    grids_checked: int = 0
    # guarded-runtime counters (runtime.guard / .chaos)
    ladder_levels: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # final ladder level -> build count
    degradations: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # degraded level (cheap/ref/...) -> count
    degradation_triggers: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # trigger label -> count
    guard_failures: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # "level:trigger" -> failed-attempt count
    breaker_events: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # open/close/half_open/skip -> count
    chaos_fires: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # injection site -> fire count
    runtime_fallbacks: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # kernel -> ops-layer ref-fallback count
    elastic_recoveries: int = 0
    events: Deque[Dict[str, Any]] = dataclasses.field(
        default_factory=lambda: deque(maxlen=EVENT_LIMIT))

    def __post_init__(self):
        self._lock = threading.Lock()

    # -- cache events -------------------------------------------------------
    def record_cache(self, status: str, kernel: str, wall_s: float):
        """status in {"hit", "warm", "miss"} — one saturate_program call."""
        with self._lock:
            if status == "hit":
                self.cache_hits += 1
                self.hit_wall_s += wall_s
            elif status == "warm":
                self.cache_warm_starts += 1
                self.warm_wall_s += wall_s
            else:
                self.cache_misses += 1
                self.cold_wall_s += wall_s
            self.events.append({"kind": "cache", "status": status,
                                "kernel": kernel, "wall_s": wall_s})

    def record_store(self, kernel: str):
        with self._lock:
            self.cache_stores += 1

    def record_invalid(self, kernel: str, reason: str):
        with self._lock:
            self.cache_invalid += 1
            self.events.append({"kind": "cache_invalid", "kernel": kernel,
                                "reason": reason})

    # -- bridge events ------------------------------------------------------
    def record_bridge_fallback(self, primitive: str, fn_name: str = ""):
        with self._lock:
            self.bridge_fallbacks[primitive] = \
                self.bridge_fallbacks.get(primitive, 0) + 1
            self.events.append({"kind": "bridge_fallback",
                                "primitive": primitive, "fn": fn_name})

    # -- verification events ------------------------------------------------
    def record_verify(self, report):
        """Fold one :class:`repro.verify.VerifyReport` into the counters."""
        with self._lock:
            self.verify_runs += 1
            for f in report.findings:
                self.verify_findings_by_pass[f.pass_name] = \
                    self.verify_findings_by_pass.get(f.pass_name, 0) + 1
                if f.severity == "error":
                    self.verify_errors += 1
            self.rules_checked += report.rules_checked
            self.schedules_certified += report.schedules_certified
            self.grids_checked += getattr(report, "grids_checked", 0)
            if not report.ok:
                self.events.append({"kind": "verify_errors",
                                    "errors": [str(f) for f
                                               in report.errors()][:8]})

    # -- guarded-runtime events ------------------------------------------------
    def record_ladder(self, kernel: str, level: str):
        """Final degradation-ladder level of one saturate call."""
        with self._lock:
            self.ladder_levels[level] = self.ladder_levels.get(level, 0) + 1

    def record_degradation(self, kernel: str, level: str, trigger: str):
        """One build landed below the full path: at ``level``, pushed
        there by ``trigger`` (the first failure's classified label)."""
        with self._lock:
            self.degradations[level] = self.degradations.get(level, 0) + 1
            self.degradation_triggers[trigger] = \
                self.degradation_triggers.get(trigger, 0) + 1
            self.events.append({"kind": "degradation", "kernel": kernel,
                                "level": level, "trigger": trigger})

    def record_guard_failure(self, kernel: str, level: str, trigger: str):
        with self._lock:
            k = f"{level}:{trigger}"
            self.guard_failures[k] = self.guard_failures.get(k, 0) + 1
            self.events.append({"kind": "guard_failure", "kernel": kernel,
                                "level": level, "trigger": trigger})

    def record_breaker(self, key: Any, event: str):
        """event in {"open", "close", "half_open", "skip"}."""
        with self._lock:
            self.breaker_events[event] = \
                self.breaker_events.get(event, 0) + 1
            self.events.append({"kind": "breaker", "key": str(key),
                                "event": event})

    def record_chaos(self, site: str, kernel: Any = None):
        with self._lock:
            self.chaos_fires[site] = self.chaos_fires.get(site, 0) + 1
            self.events.append({"kind": "chaos", "site": site,
                                "kernel": kernel})

    def record_runtime_fallback(self, kernel: str, reason: str):
        """ops-layer safety net: an op call fell back to its named
        reference oracle at apply time."""
        with self._lock:
            self.runtime_fallbacks[kernel] = \
                self.runtime_fallbacks.get(kernel, 0) + 1
            self.events.append({"kind": "runtime_fallback",
                                "kernel": kernel, "reason": reason})

    def record_recovery(self, step: int, kind: str, shards: Any = None):
        """ft.ElasticTrainer completed a recovery (state preserved)."""
        with self._lock:
            self.elastic_recoveries += 1
            self.events.append({"kind": "elastic_recovery", "step": step,
                                "event": kind, "shards": shards})

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lookups = self.cache_hits + self.cache_misses \
                + self.cache_warm_starts
            return {
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_warm_starts": self.cache_warm_starts,
                "cache_stores": self.cache_stores,
                "cache_invalid": self.cache_invalid,
                "cache_hit_rate": (self.cache_hits / lookups
                                   if lookups else 0.0),
                "cold_wall_s": self.cold_wall_s,
                "warm_wall_s": self.warm_wall_s,
                "hit_wall_s": self.hit_wall_s,
                "bridge_fallbacks": dict(sorted(
                    self.bridge_fallbacks.items())),
                "verify": {
                    "runs": self.verify_runs,
                    "errors": self.verify_errors,
                    "findings_by_pass": dict(sorted(
                        self.verify_findings_by_pass.items())),
                    "rules_checked": self.rules_checked,
                    "schedules_certified": self.schedules_certified,
                    "grids_checked": self.grids_checked,
                },
                "guard": {
                    "ladder_levels": dict(sorted(
                        self.ladder_levels.items())),
                    "degradations": dict(sorted(
                        self.degradations.items())),
                    "degradation_triggers": dict(sorted(
                        self.degradation_triggers.items())),
                    "guard_failures": dict(sorted(
                        self.guard_failures.items())),
                    "breaker_events": dict(sorted(
                        self.breaker_events.items())),
                    "chaos_fires": dict(sorted(self.chaos_fires.items())),
                    "runtime_fallbacks": dict(sorted(
                        self.runtime_fallbacks.items())),
                    "elastic_recoveries": self.elastic_recoveries,
                },
            }

    def reset(self):
        with self._lock:
            self.cache_hits = self.cache_misses = 0
            self.cache_warm_starts = self.cache_stores = 0
            self.cache_invalid = 0
            self.cold_wall_s = self.warm_wall_s = self.hit_wall_s = 0.0
            self.bridge_fallbacks.clear()
            self.verify_runs = self.verify_errors = 0
            self.verify_findings_by_pass.clear()
            self.rules_checked = self.schedules_certified = 0
            self.grids_checked = 0
            self.ladder_levels.clear()
            self.degradations.clear()
            self.degradation_triggers.clear()
            self.guard_failures.clear()
            self.breaker_events.clear()
            self.chaos_fires.clear()
            self.runtime_fallbacks.clear()
            self.elastic_recoveries = 0
            self.events.clear()


_TELEMETRY = SaturationTelemetry()


def telemetry() -> SaturationTelemetry:
    """The process-wide registry."""
    return _TELEMETRY


def reset_telemetry():
    _TELEMETRY.reset()
