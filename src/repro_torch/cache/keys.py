"""Deterministic cache keys for the persistent saturation cache.

Every component of a key is derived from *content*, never from Python
object identity or set/dict iteration order (the ``ENode.__hash__``
lesson: ``id()``-dependent hashing made e-class ids differ across
processes, which is exactly what a cross-process cache must not depend
on). Keys are sha256 digests over canonical JSON:

* :func:`program_fingerprint` — the kernel's structure: statements
  (nested-tuple term reprs are deterministic), array names/roles and
  scalar names **in declaration order** (the emitted signature depends
  on it). Shapes and dtypes are deliberately *excluded* — they go into
  the exact key only, so a shape change is a near-miss (warm start),
  not a different kernel.
* :func:`rules_fingerprint` — names + lhs/rhs pattern reprs of the
  exact rule list the config would run. Editing any rule changes the
  digest and invalidates stale entries instead of silently reusing
  them.
* :func:`config_fingerprint` / :func:`shapes_fingerprint` — the search
  configuration (budgets, strategy, schedule mode, device-profile id)
  and the per-array geometry. Wall-clock safety limits are excluded:
  results are determined by the deterministic evaluation budgets.

The composite :class:`CacheKey` carries a ``warm_key`` (kernel + rules
+ extractor + search config — same kernel, any shapes) and an
``exact_key`` (warm + shapes/dtypes): an exact hit replays the
committed choice, a warm hit seeds the searches.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

# Bump when extraction/scheduling *semantics* change in a way the rules
# fingerprint cannot see (e.g. a new beam neighborhood, a changed
# objective): stale entries are then ignored, never reused.
EXTRACTOR_VERSION = 1

# On-disk entry format; bump on incompatible serialization changes.
# v2: entries carry a mandatory content digest over the sealed fields.
FORMAT_VERSION = 2


def _digest(obj: Any) -> str:
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                         default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()


def _stmt_doc(stmt) -> Any:
    from repro_torch.core.dsl import Assign, ArrayRef, For, If
    if isinstance(stmt, Assign):
        tgt = stmt.target
        if isinstance(tgt, ArrayRef):
            target = ["store", tgt.name, [repr(i) for i in tgt.indices]]
        else:
            target = ["let", str(tgt)]
        return ["assign", target, repr(stmt.expr)]
    if isinstance(stmt, If):
        return ["if", repr(stmt.cond),
                [_stmt_doc(s) for s in stmt.then],
                [_stmt_doc(s) for s in stmt.orelse]]
    if isinstance(stmt, For):
        return ["for", stmt.var, repr(stmt.start), repr(stmt.stop),
                [_stmt_doc(s) for s in stmt.body]]
    raise TypeError(f"unknown statement {type(stmt).__name__}")


def program_fingerprint(prog) -> str:
    """Structure-only digest of a :class:`KernelProgram` (no shapes)."""
    doc = {
        "name": prog.name,
        "arrays": [[spec.name, spec.role] for spec in prog.arrays.values()],
        "scalars": list(prog.scalars),
        "body": [_stmt_doc(s) for s in prog.body],
    }
    return _digest(doc)


def shapes_fingerprint(prog) -> str:
    """Digest of the declared operand geometry + dtypes (exact key only)."""
    doc = {
        "dtype": prog.dtype,
        "arrays": [[spec.name,
                    list(spec.shape) if spec.shape is not None else None,
                    spec.dtype]
                   for spec in prog.arrays.values()],
    }
    return _digest(doc)


def rules_fingerprint(config) -> str:
    """Digest of the exact rule list the config runs (names + patterns)."""
    if not config.use_sat:
        return _digest({"rules": []})
    doc = {"rules": [[r.name, repr(r.lhs), repr(r.rhs)]
                     for r in config.rules()]}
    return _digest(doc)


# Bump an emitter's version whenever its emitted source for a fixed
# (choice, schedule) changes: non-default emitters carry name@version in
# the cache config fingerprint, so cached replays never mix emitters.
_EMITTER_VERSIONS: Dict[str, int] = {"torch": 1, "triton": 1,
                                     "triton_pipelined": 1}
# Emitters that add no key component, so their keys equal the JAX
# package's keys of its default emitters.
_DEFAULT_EMITTERS = (None, "torch", "triton")


def emitter_cache_id(name: Optional[str]) -> Optional[str]:
    """The ``name@v{version}`` token a config fingerprint carries for a
    non-default emitter, or None for the defaults (None, ``"torch"``,
    ``"triton"``)."""
    if name in _DEFAULT_EMITTERS:
        return None
    if name not in _EMITTER_VERSIONS:
        raise ValueError(f"unknown emitter {name!r}; expected one of "
                         f"{tuple(_EMITTER_VERSIONS)}")
    return f"{name}@v{_EMITTER_VERSIONS[name]}"


def device_profile_id(config) -> Optional[str]:
    """Stable identifier of the configured device profile, or None for
    the analytic models. When the profile resolves, the id is
    ``<name>@<digest of its fitted parameters>`` — re-fitting a profile
    under the same file name then changes the key, so entries tuned for
    stale calibration are not silently replayed. An unresolvable spec
    (e.g. the profile file is gone) falls back to the name string."""
    prof = config.device_profile
    if prof is None:
        return None
    name = getattr(prof, "name", None)
    name = str(name if name is not None else prof)
    try:
        from repro_torch.analysis.calibrate import (CalibrationError,
                                                    load_profile)
        params = load_profile(prof).params.to_dict()
    except (CalibrationError, OSError, ValueError, TypeError):
        return name
    return f"{name}@{_digest(params)[:16]}"


def config_fingerprint(config) -> str:
    """Digest of everything besides the program/rules that shapes the
    committed result: mode, search strategy + deterministic budgets,
    schedule mode, cost model, device profile — and, for non-default
    emission backends, the versioned emitter id (``name@v{n}``, see
    :func:`emitter_cache_id`) so cached replays never mix emitters.
    Default emitters (None/"torch"/"triton") contribute no key at all,
    so the default emitter's keys equal the JAX package's. Wall-clock time limits are
    excluded (safety nets, machine-dependent)."""
    doc = {
        "mode": config.mode,
        "cost_model": config.cost_model,
        "search": config.search,
        "beam_width": config.beam_width,
        "beam_expansions": config.beam_expansions,
        "beam_coordinated": config.beam_coordinated,
        "hillclimb_evals": config.hillclimb_evals,
        "local_search": config.local_search,
        "iter_limit": config.iter_limit,
        "node_limit": config.node_limit,
        "schedule": config.schedule_mode,
        "device_profile": device_profile_id(config),
    }
    em = emitter_cache_id(getattr(config, "emitter", None))
    if em is not None:
        doc["emitter"] = em
    return _digest(doc)


@dataclasses.dataclass(frozen=True)
class CacheKey:
    kernel: str          # sanitized program name (directory component)
    warm_key: str        # same kernel+rules+config, any shapes
    exact_key: str       # warm + shapes/dtypes
    components: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                                   compare=False)


def _sanitize(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "-_" else "_"
                   for ch in name) or "kernel"


def cache_key_for(prog, config) -> CacheKey:
    """The composite key of one ``saturate_program(prog, config)`` call."""
    prog_fp = program_fingerprint(prog)
    rules_fp = rules_fingerprint(config)
    cfg_fp = config_fingerprint(config)
    shapes_fp = shapes_fingerprint(prog)
    warm = _digest({"program": prog_fp, "rules": rules_fp,
                    "config": cfg_fp,
                    "extractor_version": EXTRACTOR_VERSION})
    exact = _digest({"warm": warm, "shapes": shapes_fp})
    return CacheKey(
        kernel=_sanitize(prog.name), warm_key=warm, exact_key=exact,
        components={
            "program": prog_fp, "rules": rules_fp, "config": cfg_fp,
            "shapes": shapes_fp, "extractor_version": EXTRACTOR_VERSION,
            "device_profile": device_profile_id(config),
            "schedule": config.schedule_mode, "mode": config.mode,
        })
