"""End-to-end saturator pipeline (paper Fig. 1) with the four evaluated
configurations:

  =========  ====  ============  =========
  mode       CSE   saturation    bulk load
  =========  ====  ============  =========
  baseline    no        no           no      (original code, §VIII)
  cse         yes       no           no
  cse_sat     yes    Table I        no
  cse_bulk    yes       no          yes
  accsat      yes    Table I       yes      (default, = ACCSAT)
  =========  ====  ============  =========

`saturate_program` runs: DSL → SSA+φ → e-graph → equality saturation →
CSE-aware extraction → codegen (temp vars + bulk load) → callable torch
kernel. Limits default to the paper's §VII values.

A copy of :mod:`repro.core.pipeline` for the torch port. Two layers of
the JAX package are not in the port yet (ROADMAP queue A): the
persistent saturation cache and the static verifier. A config that asks
for either is rejected with a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, Optional

from repro_torch.analysis import RooflineCostModel
from repro_torch.runtime import chaos
from repro_torch.runtime.guard import GuardConfig, breaker_for, run_ladder

from .cost import CostModel, TPUCostModel
from .dsl import KernelProgram
from .egraph import EGraph
from .extract import SEARCH_STRATEGIES, ExtractionResult, extract_dag
from .rules import (EXTENDED_RULES, PAPER_RULES, TPU_RULES, Rule,
                    SaturationReport, run_rules)
from .ssa import SSAResult, build_ssa
from .telemetry import telemetry
from .torchgen import TorchCodeGenerator, GeneratedKernel, GenStats

# The port's emitters: "torch" (the plain version, core/torchgen.py),
# "triton" (the Hopper tile kernel, core/tritongen.py) and
# "triton_pipelined" (its persistent, software-pipelined form, the
# counterpart of the TPU's "pallas_pipelined").
EMITTER_NAMES = ("torch", "triton", "triton_pipelined")
# Not in this slice of the port (ROADMAP queue A, "saturation cache and
# static verifier"): configs asking for them are rejected.
_NOT_PORTED = "is not ported to repro_torch yet (see ROADMAP.md, queue A)"

MODES = ("baseline", "cse", "cse_sat", "cse_bulk", "accsat")
COST_MODELS = ("paper", "tpu_v5e", "roofline")
SEARCHES = SEARCH_STRATEGIES  # single source of truth: repro.core.extract

_UNSET = object()   # "caller did not pass this" sentinel (from_env)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Saturation + extraction search budgets (paper §VII limits).

    ``iter_limit``/``node_limit``/``time_limit_s`` bound equality
    saturation (10 iters, 10k e-nodes, 10 s); ``extract_time_limit_s``
    bounds extraction (30 s). ``search`` picks the global extraction
    strategy — beam search (default, hill climb kept as the polish pass)
    or ``"hillclimb"`` (the original extractor, for ablations);
    ``beam_expansions``/``hillclimb_evals`` are the deterministic search
    budgets (scored swaps) — wall clocks are only safety nets.
    ``beam_coordinated`` enables multi-class beam moves (load +
    consumers swapped together), escaping plateaus the 1-swap
    neighborhood cannot leave. ``local_search`` is the DAG-cost
    refinement pass (ILP stand-in)."""
    iter_limit: int = 10
    node_limit: int = 10_000
    time_limit_s: float = 10.0
    extract_time_limit_s: float = 30.0
    local_search: bool = True
    search: str = "beam"
    beam_width: int = 8
    beam_expansions: int = 10_000
    hillclimb_evals: int = 100_000
    beam_coordinated: bool = True


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Statement order + emission backend of the generated kernel.

    ``schedule`` (repro.core.schedule): "source" = loads at use sites,
    "bulk" = the paper's bulk load (bit-identical to the original
    emitter), "cost" = cost-driven legal topological order minimizing
    the schedule-aware latency objective. None keeps the mode's
    historical default (bulk for accsat/cse_bulk, source otherwise), so
    baselines never drift.

    ``device_profile``: a calibrated device profile. Calibration is not
    ported yet (ROADMAP queue A, "measurement and tuning"), so only
    None, the analytic roofline constants, builds.

    ``emitter``: one of :data:`EMITTER_NAMES`. None keeps the context's
    default ("torch" in the pipeline, "triton" in make_tile_op)."""
    schedule: Optional[str] = None
    device_profile: Optional[Any] = None
    emitter: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Persistent saturation cache (``repro.cache`` in the JAX package).

    Not ported yet: ``cache_dir`` must stay None or False (off), or
    :class:`SaturatorConfig` raises."""
    cache_dir: Optional[Any] = None
    cache_warm_start: bool = True


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Static verification (``repro.verify`` in the JAX package).

    Not ported yet: ``verify`` must stay "off", or
    :class:`SaturatorConfig` raises."""
    verify: str = "off"


_GROUP_FIELDS = {
    "search_cfg": SearchConfig,
    "schedule_cfg": ScheduleConfig,
    "cache_cfg": CacheConfig,
    "verify_cfg": VerifyConfig,
}
# legacy flat kwarg -> owning sub-config field ("emitter" is post-split,
# so it is a first-class keyword, not a deprecated one)
_LEGACY_TO_GROUP = {
    f.name: g for g, cls in _GROUP_FIELDS.items()
    for f in dataclasses.fields(cls) if f.name != "emitter"
}


@dataclasses.dataclass(init=False)
class SaturatorConfig:
    """Pipeline configuration, grouped.

    Four evergreen fields stay flat (``mode``, ``cost_model``,
    ``extended_rules``, ``tpu_rules``); everything else lives in the
    :class:`SearchConfig` / :class:`ScheduleConfig` / :class:`CacheConfig`
    / :class:`VerifyConfig` sub-configs (``search_cfg`` etc.). The old
    flat keyword arguments still construct (forwarded into their group
    with a ``DeprecationWarning``) and every flat *read* keeps working
    through read-only properties, so older flat call sites keep
    working.

    ``cost_model``: 'roofline' minimizes predicted latency
    (repro.analysis); 'paper' and 'tpu_v5e' are the flat-weight models
    kept for ablation comparisons. ``extended_rules`` is the §V-A
    restricted set (off, as in the paper); ``tpu_rules`` adds the
    beyond-paper strength-reduction set."""
    mode: str = "accsat"
    cost_model: str = "roofline"
    extended_rules: bool = False
    tpu_rules: bool = False
    search_cfg: SearchConfig = dataclasses.field(
        default_factory=SearchConfig)
    schedule_cfg: ScheduleConfig = dataclasses.field(
        default_factory=ScheduleConfig)
    cache_cfg: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    verify_cfg: VerifyConfig = dataclasses.field(default_factory=VerifyConfig)
    # guarded-runtime policy (runtime.guard): hard ceilings,
    # degradation-ladder/breaker knobs, optional chaos plan. Deliberately
    # outside the cache fingerprint (keys.py lists components explicitly)
    # and outside the legacy flat-kwarg shim (like "emitter", it is
    # post-split — pass the group).
    guard_cfg: GuardConfig = dataclasses.field(default_factory=GuardConfig)

    def __init__(self, mode: str = "accsat", cost_model: str = "roofline",
                 extended_rules: bool = False, tpu_rules: bool = False,
                 search_cfg: Optional[SearchConfig] = None,
                 schedule_cfg: Optional[ScheduleConfig] = None,
                 cache_cfg: Optional[CacheConfig] = None,
                 verify_cfg: Optional[VerifyConfig] = None,
                 guard_cfg: Optional[GuardConfig] = None,
                 emitter: Any = _UNSET, **legacy: Any):
        self.mode = mode
        self.cost_model = cost_model
        self.extended_rules = extended_rules
        self.tpu_rules = tpu_rules
        groups: Dict[str, Any] = {
            "search_cfg": search_cfg or SearchConfig(),
            "schedule_cfg": schedule_cfg or ScheduleConfig(),
            "cache_cfg": cache_cfg or CacheConfig(),
            "verify_cfg": verify_cfg or VerifyConfig(),
        }
        unknown = sorted(k for k in legacy if k not in _LEGACY_TO_GROUP)
        if unknown:
            raise TypeError(f"SaturatorConfig got unexpected keyword "
                            f"argument(s) {unknown}")
        if legacy:
            owners = sorted({_LEGACY_TO_GROUP[k] for k in legacy})
            warnings.warn(
                f"flat SaturatorConfig kwarg(s) {sorted(legacy)} are "
                f"deprecated; pass the grouped {'/'.join(owners)} "
                f"sub-config(s) instead", DeprecationWarning, stacklevel=2)
            for k, v in legacy.items():
                g = _LEGACY_TO_GROUP[k]
                groups[g] = dataclasses.replace(groups[g], **{k: v})
        if emitter is not _UNSET:
            groups["schedule_cfg"] = dataclasses.replace(
                groups["schedule_cfg"], emitter=emitter)
        self.search_cfg = groups["search_cfg"]
        self.schedule_cfg = groups["schedule_cfg"]
        self.cache_cfg = groups["cache_cfg"]
        self.verify_cfg = groups["verify_cfg"]
        self.guard_cfg = guard_cfg or GuardConfig()
        self.__post_init__()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode}")
        if self.cost_model not in COST_MODELS:
            raise ValueError(f"cost_model must be one of {COST_MODELS}, "
                             f"got {self.cost_model}")
        if self.search not in SEARCHES:
            raise ValueError(f"search must be one of {SEARCHES}, "
                             f"got {self.search}")
        from .schedule import SCHEDULE_MODES
        if self.schedule is not None and \
                self.schedule not in SCHEDULE_MODES:
            raise ValueError(f"schedule must be one of {SCHEDULE_MODES}, "
                             f"got {self.schedule}")
        if self.emitter is not None and self.emitter not in EMITTER_NAMES:
            raise ValueError(f"emitter must be one of {EMITTER_NAMES}, "
                             f"got {self.emitter}")
        if self.verify != "off":
            raise ValueError(f"verify={self.verify!r}: the static verifier "
                             f"{_NOT_PORTED}")
        if self.cache_dir not in (None, False):
            raise ValueError(f"cache_dir={self.cache_dir!r}: the saturation "
                             f"cache {_NOT_PORTED}")

    # -- flat read-only views (older flat call sites) ------------------------
    @property
    def iter_limit(self) -> int:
        return self.search_cfg.iter_limit

    @property
    def node_limit(self) -> int:
        return self.search_cfg.node_limit

    @property
    def time_limit_s(self) -> float:
        return self.search_cfg.time_limit_s

    @property
    def extract_time_limit_s(self) -> float:
        return self.search_cfg.extract_time_limit_s

    @property
    def local_search(self) -> bool:
        return self.search_cfg.local_search

    @property
    def search(self) -> str:
        return self.search_cfg.search

    @property
    def beam_width(self) -> int:
        return self.search_cfg.beam_width

    @property
    def beam_expansions(self) -> int:
        return self.search_cfg.beam_expansions

    @property
    def hillclimb_evals(self) -> int:
        return self.search_cfg.hillclimb_evals

    @property
    def beam_coordinated(self) -> bool:
        return self.search_cfg.beam_coordinated

    @property
    def schedule(self) -> Optional[str]:
        return self.schedule_cfg.schedule

    @property
    def device_profile(self) -> Optional[Any]:
        return self.schedule_cfg.device_profile

    @property
    def emitter(self) -> Optional[str]:
        return self.schedule_cfg.emitter

    @property
    def cache_dir(self) -> Optional[Any]:
        return self.cache_cfg.cache_dir

    @property
    def cache_warm_start(self) -> bool:
        return self.cache_cfg.cache_warm_start

    @property
    def verify(self) -> str:
        return self.verify_cfg.verify

    @property
    def schedule_mode(self) -> str:
        """The effective statement order (explicit ``schedule`` wins,
        else the mode's historical bulk/source behavior)."""
        if self.schedule is not None:
            return self.schedule
        return "bulk" if self.use_bulk else "source"

    @property
    def use_sat(self) -> bool:
        return self.mode in ("cse_sat", "accsat")

    @property
    def use_bulk(self) -> bool:
        return self.mode in ("cse_bulk", "accsat")

    @property
    def use_cse(self) -> bool:
        return self.mode != "baseline"

    def rules(self) -> list:
        rules = list(PAPER_RULES)
        if self.extended_rules:
            rules += EXTENDED_RULES
        if self.tpu_rules:
            rules += [r for r in TPU_RULES if "NOP" not in r.name]
        return rules

    def make_cost_model(self, prog: Optional[KernelProgram] = None
                        ) -> CostModel:
        if self.cost_model == "roofline":
            # thread the kernel's declared dtype through the roofline
            # objective (per-array shapes/dtypes resolve later, when
            # extract_dag binds the model to the e-graph); a device
            # profile makes the beam minimize the calibrated objective
            dtype = getattr(prog, "dtype", None) or "f32"
            return RooflineCostModel(dtype=dtype,
                                     profile=self.device_profile)
        return TPUCostModel() if self.cost_model == "tpu_v5e" else CostModel()

    def make_schedule_cost_model(self, prog: Optional[KernelProgram] = None):
        """Model pricing the cost-driven schedule search. The roofline
        objective (calibrated or not) is shared with extraction; flat
        extraction models can't price a schedule, so a configured
        ``device_profile`` still drives scheduling through a calibrated
        roofline model (extraction stays flat — the committed choice is
        unchanged, only the statement order is optimized), and None
        falls back to the analytic roofline."""
        if self.cost_model == "roofline":
            return self.make_cost_model(prog)
        if self.device_profile is not None:
            dtype = getattr(prog, "dtype", None) or "f32"
            return RooflineCostModel(dtype=dtype,
                                     profile=self.device_profile)
        return None


@dataclasses.dataclass
class SaturatedKernel:
    """Everything the pipeline produced for one kernel."""
    kernel: GeneratedKernel
    ssa: SSAResult
    extraction: ExtractionResult
    saturation: Optional[SaturationReport]
    config: SaturatorConfig
    ssa_wall_s: float = 0.0
    codegen_wall_s: float = 0.0
    # persistent-cache outcome for this build: "off" (no cache), "miss"
    # (cold search, result stored), "warm" (searches seeded from a
    # near-miss entry), "hit" (replayed with no search at all)
    cache_status: str = "off"
    # static-verification report (repro.verify) when config.verify != "off"
    verify_report: Optional[Any] = None
    # degradation-ladder rung this build landed on (repro.runtime.guard):
    # "hit" | "warm" | "cold" | "cheap" | "ref"
    ladder_level: str = "cold"

    @property
    def fn(self) -> Callable:
        return self.kernel.fn

    @property
    def source(self) -> str:
        return self.kernel.source

    def __call__(self, *a, **k):
        return self.kernel.fn(*a, **k)

    def report(self) -> Dict[str, Any]:
        s = self.kernel.stats
        pred = self.extraction.predicted or {}
        bs = self.extraction.beam_stats
        return {
            "mode": self.config.mode,
            "cost_model": self.config.cost_model,
            "search": self.extraction.search,
            "beam_width": self.config.beam_width,
            "beam_cost": self.extraction.beam_cost,
            "beam_generations": bs.generations if bs else 0,
            "beam_expanded": bs.expanded if bs else 0,
            "dag_cost": self.extraction.dag_cost,
            "tree_cost": self.extraction.tree_cost,
            "predicted_flops": pred.get("flops", 0.0),
            "predicted_bytes": (pred.get("bytes_read", 0.0)
                                + pred.get("bytes_written", 0.0)),
            "predicted_latency_ns": pred.get("latency_ns", 0.0),
            "predicted_bound": pred.get("bound", "n/a"),
            "device_profile": pred.get("profile"),
            "n_temps": s.n_temps,
            "n_loads": s.n_loads,
            "n_stores": s.n_stores,
            "n_fma": s.n_fma,
            "n_ops": s.n_ops,
            "loads_before_compute": s.loads_before_compute,
            "schedule": self.kernel.schedule_mode,
            "schedule_predicted_ns": (
                self.kernel.schedule.predicted_ns
                if self.kernel.schedule is not None else None),
            "cache": self.cache_status,
            "ladder": self.ladder_level,
            "sat_iterations": self.saturation.iterations
            if self.saturation else 0,
            "sat_nodes": self.saturation.n_nodes if self.saturation else 0,
            "sat_stop": self.saturation.stop_reason if self.saturation
            else ("cached" if self.cache_status == "hit" else "disabled"),
            "ssa_ms": self.ssa_wall_s * 1e3,
            "sat_s": self.saturation.wall_s if self.saturation else 0.0,
            "extract_s": self.extraction.wall_s,
            "codegen_ms": self.codegen_wall_s * 1e3,
            "verify": (self.verify_report.summary()
                       if self.verify_report is not None else None),
        }


def predict_choice(ssa: SSAResult, choice, roots, n_stores: int,
                   profile=None):
    """Roofline prediction of an extraction choice in the pipeline's
    reporting units: shape/dtype-aware load pricing bound to the SSA
    e-graph, plus the root stores' write traffic (per-store operand info
    when the SSA store count matches codegen's). Shared with
    ``benchmarks/saturation_stats.py`` so beam-vs-hillclimb deltas are
    always computed in these exact units. ``profile`` reports in a
    calibrated device profile's units instead of the analytic ones."""
    store_infos = ssa.store_infos()
    return ssa.egraph.choice_stats(
        choice, roots, n_stores=n_stores,
        store_infos=store_infos if len(store_infos) == n_stores else None,
        cost_model=RooflineCostModel(
            dtype=getattr(ssa.prog, "dtype", "f32"), egraph=ssa.egraph,
            profile=profile))


def _saturate_attempt(prog: KernelProgram, cfg: SaturatorConfig,
                      extra_fns: Optional[Dict[str, Callable]] = None
                      ) -> SaturatedKernel:
    """One un-guarded build of the configured pipeline (what
    ``saturate_program`` runs under the guard). May raise; the ladder wrapper catches."""
    t_begin = time.perf_counter()
    ssa = build_ssa(prog)
    ssa_wall = time.perf_counter() - t_begin

    sat_report = None
    if cfg.use_sat:
        sat_report = run_rules(ssa.egraph, cfg.rules(),
                               iter_limit=cfg.iter_limit,
                               node_limit=cfg.node_limit,
                               time_limit_s=cfg.time_limit_s)
    roots = ssa.roots()
    cm = cfg.make_cost_model(prog)
    extraction = extract_dag(
        ssa.egraph, tuple(roots) if roots else (),
        cost_model=cm,
        time_limit_s=cfg.extract_time_limit_s,
        local_search=cfg.local_search and cfg.use_cse,
        search=cfg.search, beam_width=cfg.beam_width,
        beam_expansions=cfg.beam_expansions,
        hillclimb_evals=cfg.hillclimb_evals,
        coordinated=cfg.beam_coordinated)
    t1 = time.perf_counter()
    gen = TorchCodeGenerator(ssa, extraction, bulk=cfg.use_bulk,
                             extra_fns=extra_fns,
                             reuse_temps=cfg.use_cse,
                             schedule=cfg.schedule,
                             sched_cost_model=cfg.make_schedule_cost_model(
                                 prog)).generate()
    codegen_wall = time.perf_counter() - t1
    # Roofline prediction of the chosen term including root-store write
    # traffic (known only post-codegen), regardless of which cost model
    # drove extraction — ablations compare in the same units. Stores are
    # priced per target operand (shape after indexing, declared dtype).
    # A configured device profile reports in its calibrated units.
    predicted = predict_choice(ssa, extraction.choice, extraction.roots,
                               gen.stats.n_stores,
                               profile=cfg.device_profile
                               if cfg.cost_model == "roofline" else None)
    if predicted is not None:
        extraction.predicted = predicted
    return SaturatedKernel(kernel=gen, ssa=ssa, extraction=extraction,
                           saturation=sat_report, config=cfg,
                           ssa_wall_s=ssa_wall, codegen_wall_s=codegen_wall)


def _cheap_config(cfg: SaturatorConfig) -> SaturatorConfig:
    """The ladder's "cheap" rung: beam width 1 with tiny deterministic
    budgets, the mode's legacy emission with *no* schedule search
    (``schedule=None`` — the effective bulk order for accsat), verify
    off, cache off, default emitter. Same mode/rules, so semantics are
    unchanged; only search effort and optional machinery drop away."""
    return SaturatorConfig(
        mode=cfg.mode, cost_model=cfg.cost_model,
        extended_rules=cfg.extended_rules, tpu_rules=cfg.tpu_rules,
        search_cfg=dataclasses.replace(
            cfg.search_cfg, search="beam", beam_width=1,
            beam_coordinated=False, local_search=False,
            beam_expansions=min(cfg.beam_expansions, 2_000),
            hillclimb_evals=min(cfg.hillclimb_evals, 2_000)),
        schedule_cfg=ScheduleConfig(),
        cache_cfg=CacheConfig(cache_dir=False),
        verify_cfg=VerifyConfig(verify="off"),
        guard_cfg=dataclasses.replace(cfg.guard_cfg, ladder=False))


def _reference_kernel(prog: KernelProgram, cfg: SaturatorConfig,
                      extra_fns: Optional[Dict[str, Callable]] = None
                      ) -> SaturatedKernel:
    """The ladder's floor: a SaturatedKernel whose callable is the
    reference interpreter (``core/reference.py``) wrapped in the
    generated-kernel calling convention (all declared arrays in order,
    then scalars; returns the out/inout tuple, cast to each out
    buffer's dtype). Eager numpy — not jit-traceable; inside traced
    code the kernels layer falls back to the jnp oracles in
    ``kernels/ref.py`` instead (see ``repro.kernels.ops``)."""
    import numpy as np

    from .reference import run_reference
    t0 = time.perf_counter()
    names = list(prog.arrays)
    scalar_names = list(prog.scalars)
    out_names = [a.name for a in prog.arrays.values()
                 if a.role in ("out", "inout")]
    calls = dict(extra_fns or {})

    def ref_fn(*args):
        arrays = {n: np.asarray(a) for n, a in zip(names, args)}
        inputs: Dict[str, Any] = dict(arrays)
        inputs.update(zip(scalar_names, args[len(names):]))
        out = run_reference(prog, inputs, calls=calls)
        return tuple(np.asarray(out[n], dtype=arrays[n].dtype)
                     for n in out_names)

    gen = GeneratedKernel(
        name=prog.name, source=f"# reference-interpreter fallback for "
        f"{prog.name!r} (degradation-ladder floor)\n",
        fn=ref_fn, in_arrays=names, scalars=scalar_names,
        out_arrays=out_names, stats=GenStats(), bulk=False,
        schedule_mode="source", schedule=None)
    try:
        ssa = build_ssa(prog)
    except Exception:   # even SSA may be the failing stage
        ssa = None
    extraction = ExtractionResult(choice={}, roots=(), dag_cost=0.0,
                                  tree_cost=0.0, search="reference")
    return SaturatedKernel(
        kernel=gen, ssa=ssa, extraction=extraction, saturation=None,
        config=cfg, codegen_wall_s=time.perf_counter() - t0,
        cache_status="off", ladder_level="ref")


def _breaker_key(prog: KernelProgram, cfg: SaturatorConfig):
    """Cheap stable key: same kernel under a meaningfully different
    configuration fails (and cools down) independently."""
    return (prog.name, cfg.mode, cfg.cost_model, cfg.schedule_mode,
            cfg.emitter, cfg.tpu_rules, cfg.extended_rules)


def saturate_program(prog: KernelProgram,
                     config: Optional[SaturatorConfig] = None,
                     extra_fns: Optional[Dict[str, Callable]] = None
                     ) -> SaturatedKernel:
    """Guarded front door: the full configured build under a
    :class:`repro.runtime.guard.SaturationGuard`, degrading down the
    ladder (hit/warm/cold -> cheap -> ref) instead of raising, with a
    per-(kernel, config) circuit breaker skipping the full path after
    repeated failures. ``guard_cfg.ladder=False`` restores the raw
    single-attempt behavior (the ladder uses it internally)."""
    cfg = config or SaturatorConfig()
    gcfg = cfg.guard_cfg
    with chaos.plan_scope(gcfg.chaos):
        if not gcfg.ladder:
            return _saturate_attempt(prog, cfg, extra_fns)
        breaker = breaker_for(_breaker_key(prog, cfg),
                              threshold=gcfg.breaker_threshold,
                              cooldown=gcfg.breaker_cooldown)
        level, sk = run_ladder(
            prog.name,
            [("full", lambda: _saturate_attempt(prog, cfg, extra_fns)),
             ("cheap", lambda: _saturate_attempt(
                 prog, _cheap_config(cfg), extra_fns)),
             ("ref", lambda: _reference_kernel(prog, cfg, extra_fns))],
            cfg=gcfg, breaker=breaker)
        if level == "full":
            level = sk.cache_status if sk.cache_status in ("hit", "warm") \
                else "cold"
        sk.ladder_level = level
        telemetry().record_ladder(prog.name, level)
        return sk
