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

A copy of :mod:`repro.core.pipeline` for the torch port, with the
persistent saturation cache (:mod:`repro_torch.cache`) and the static
verifier (:mod:`repro_torch.verify`).
"""
from __future__ import annotations

import dataclasses
import os
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
from .schedule import compute_schedule
from .ssa import SSAResult, build_ssa
from .telemetry import telemetry
from .torchgen import TorchCodeGenerator, GeneratedKernel, GenStats

# The port's emitters: "torch" (the plain version, core/torchgen.py),
# "triton" (the Hopper tile kernel, core/tritongen.py) and
# "triton_pipelined" (its persistent, software-pipelined form, the
# counterpart of the TPU's "pallas_pipelined").
EMITTER_NAMES = ("torch", "triton", "triton_pipelined")
# Environment switch for the persistent saturation cache: a directory
# path enables it for every SaturatorConfig that doesn't set its own
# cache_dir (the launch entry points use this to make serving/training warm
# across processes).
CACHE_ENV_VAR = "REPRO_SAT_CACHE"
# Environment switch for static verification: a repro_torch.verify level
# name ("off" | "cheap" | "full") picked up by SaturatorConfig.from_env().
VERIFY_ENV_VAR = "REPRO_VERIFY"

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

    ``device_profile``: a calibrated DeviceProfile instance, a path, or
    a bare profile name under experiments/device_profiles_torch/ (see
    repro_torch.analysis.calibrate). None keeps the analytic roofline
    constants. Only meaningful with cost_model="roofline" for
    extraction; always prices the cost schedule search.

    ``emitter``: one of :data:`EMITTER_NAMES`. None keeps the context's
    default ("torch" in the pipeline, "triton" in make_tile_op).
    Non-default emitters enter the cache fingerprint as
    ``name@v{version}`` so cached replays never mix emitters."""
    schedule: Optional[str] = None
    device_profile: Optional[Any] = None
    emitter: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Persistent saturation cache (repro_torch.cache).

    ``cache_dir``: a directory path (or SaturationCache instance)
    enabling on-disk reuse of committed extraction choices + schedule
    orders across processes. None falls back to the REPRO_SAT_CACHE
    environment variable (unset = off); False disables the cache even
    when that variable is set (the resolved form of ``--no-cache``).
    An exact hit skips saturation, beam search, and schedule search
    and re-emits a bit-identical kernel; a near-miss (same kernel,
    other shapes) seeds the searches when ``cache_warm_start`` is on."""
    cache_dir: Optional[Any] = None
    cache_warm_start: bool = True


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Static verification (repro_torch.verify): "off" adds zero
    overhead, "cheap" audits the e-graph + certifies the attached
    schedule + lints the emitted source on every build (cold and cached
    replay), "full" additionally certifies reconstructed legacy orders
    and differentially re-validates the active rule set."""
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
        from repro_torch.verify import VERIFY_LEVELS
        if self.verify not in VERIFY_LEVELS:
            raise ValueError(f"verify must be one of {VERIFY_LEVELS}, "
                             f"got {self.verify}")

    # -- resolved side-channels (one documented front door) --------------
    @classmethod
    def from_env(cls, *, cache_dir: Any = _UNSET, verify: Any = _UNSET,
                 flags: Any = None, env: Optional[Dict[str, str]] = None,
                 **kwargs: Any) -> "SaturatorConfig":
        """Build a config with the cache/verify side-channels resolved.

        Precedence, per setting: **explicit keyword argument > CLI flag
        > environment variable > default**. ``flags`` is an
        ``argparse.Namespace`` (or mapping) that may carry ``cache_dir``,
        ``no_cache`` and ``verify`` — the launch entry points
        (``repro_torch.launch.serve`` / ``repro_torch.launch.train``)
        pass their parsed args here verbatim. Environment variables
        consulted: ``REPRO_SAT_CACHE`` (cache directory) and
        ``REPRO_VERIFY`` (verification level); ``env`` overrides
        ``os.environ`` for tests. The resolved values land in
        ``cache_cfg``/``verify_cfg`` (``--no-cache`` resolves to
        ``cache_dir=False``, which disables the cache even when
        ``REPRO_SAT_CACHE`` is set); remaining ``kwargs`` pass through
        to the constructor."""
        env_map = os.environ if env is None else env
        if flags is None:
            fl: Dict[str, Any] = {}
        elif isinstance(flags, dict):
            fl = dict(flags)
        else:
            fl = vars(flags)
        if cache_dir is _UNSET:
            if fl.get("no_cache"):
                cache_dir = False
            elif fl.get("cache_dir") is not None:
                cache_dir = fl["cache_dir"]
            else:
                cache_dir = env_map.get(CACHE_ENV_VAR) or None
        if verify is _UNSET:
            if fl.get("verify") is not None:
                verify = fl["verify"]
            else:
                verify = env_map.get(VERIFY_ENV_VAR) or "off"
        cache_cfg = dataclasses.replace(
            kwargs.pop("cache_cfg", None) or CacheConfig(),
            cache_dir=cache_dir)
        verify_cfg = dataclasses.replace(
            kwargs.pop("verify_cfg", None) or VerifyConfig(),
            verify=verify)
        return cls(cache_cfg=cache_cfg, verify_cfg=verify_cfg, **kwargs)

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
    # static-verification report (repro_torch.verify) when config.verify
    # != "off"
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


def _resolve_cache(cfg: SaturatorConfig):
    """The configured SaturationCache, or None (off). ``cache_dir=None``
    consults the REPRO_SAT_CACHE environment variable; ``False`` is the
    resolved "explicitly off" form (``SaturatorConfig.from_env`` with
    ``--no-cache``) and never falls back to the environment."""
    cdir = cfg.cache_dir
    if cdir is False:
        return None
    if cdir is None:
        cdir = os.environ.get(CACHE_ENV_VAR) or None
        if cdir is None:
            return None
    from repro_torch.cache import SaturationCache
    if isinstance(cdir, SaturationCache):
        return cdir
    return SaturationCache(cdir)


def _schedule_cm(cfg: SaturatorConfig, prog, eg):
    """The schedule-pricing model the generator would use (None for flat
    models — compute_schedule then defaults to the analytic roofline)."""
    cm = cfg.make_schedule_cost_model(prog)
    if not hasattr(cm, "latency"):
        return None
    if hasattr(cm, "bind_egraph"):
        cm.bind_egraph(eg)
    return cm


def _maybe_verify(sk: SaturatedKernel) -> SaturatedKernel:
    """Run the static verifier when configured ("off" = no work at all,
    keeping the cache warm-hit path overhead-free)."""
    if sk.config.verify != "off":
        chaos.maybe_raise("verify_error", sk.ssa.prog.name
                          if sk.ssa is not None else None)
        from repro_torch.verify import verify_saturated
        sk.verify_report = verify_saturated(sk)
    return sk


def _replay_cached(prog, cfg: SaturatorConfig, ssa: SSAResult,
                   ssa_wall: float, entry: Dict[str, Any], extra_fns
                   ) -> Optional[SaturatedKernel]:
    """Exact-hit path: graft the cached choice into the *unsaturated*
    SSA e-graph, replay the cached statement order, and re-emit. Skips
    run_rules, the beam, and the schedule search entirely. Returns None
    (caller goes cold) when the entry doesn't validate."""
    from repro_torch.cache import CacheInvalid, graft_choice, orders_from_doc
    from repro_torch.cache.serialize import index_to_cid
    try:
        t0 = time.perf_counter()
        choice, roots = graft_choice(ssa.egraph, entry["choice"],
                                     ssa.roots())
        sched = None
        sched_doc = entry.get("schedule")
        if sched_doc is not None:
            node_cids = index_to_cid(ssa.egraph, entry["choice"])
            fixed = orders_from_doc(sched_doc, node_cids)
            try:
                sched = compute_schedule(
                    ssa, dict(choice), mode=cfg.schedule_mode,
                    cost_model=_schedule_cm(cfg, prog, ssa.egraph),
                    fixed_orders=fixed)
            except ValueError as e:
                raise CacheInvalid(f"cached order rejected: {e}") from e
            by = sched_doc.get("predicted_by_mode") or {}
            sched.predicted_by_mode.update(
                {k: float(v) for k, v in by.items()})
        elif cfg.schedule_mode == "cost":
            # without a persisted order the cost search would have to
            # re-run — that's a miss, not a hit
            raise CacheInvalid("entry lacks schedule orders")
        extract_wall = time.perf_counter() - t0
        extraction = ExtractionResult(
            choice=choice, roots=roots,
            dag_cost=float(entry.get("dag_cost") or 0.0),
            tree_cost=float(entry.get("tree_cost") or 0.0),
            wall_s=extract_wall, search="cache")
        t1 = time.perf_counter()
        gen = TorchCodeGenerator(
            ssa, extraction, bulk=cfg.use_bulk, extra_fns=extra_fns,
            reuse_temps=cfg.use_cse,
            schedule=sched if sched is not None else cfg.schedule,
            sched_cost_model=cfg.make_schedule_cost_model(prog)
            ).generate()
        codegen_wall = time.perf_counter() - t1
    except CacheInvalid as e:
        telemetry().record_invalid(prog.name, str(e))
        return None
    predicted = predict_choice(ssa, extraction.choice, extraction.roots,
                               gen.stats.n_stores,
                               profile=cfg.device_profile
                               if cfg.cost_model == "roofline" else None)
    if predicted is not None:
        extraction.predicted = predicted
    return _maybe_verify(SaturatedKernel(
        kernel=gen, ssa=ssa, extraction=extraction,
        saturation=None, config=cfg,
        ssa_wall_s=ssa_wall, codegen_wall_s=codegen_wall,
        cache_status="hit"))


def _store_entry(cache, key, cfg: SaturatorConfig, prog,
                 sk: SaturatedKernel):
    """Persist a cold/warm result (best-effort: never raises)."""
    from repro_torch.cache import (CacheInvalid, choice_to_doc, make_entry,
                                   schedule_to_doc)
    try:
        eg = sk.ssa.egraph
        choice_doc, index_of = choice_to_doc(
            eg, sk.extraction.choice, sk.extraction.roots)
        sr = sk.kernel.schedule
        if sr is None:
            # non-cost modes keep the legacy emitters; the named order
            # is reconstructed searchlessly (move_budget=0) so the hit
            # path can replay it explicitly, bit-identically
            sr = compute_schedule(
                sk.ssa, dict(sk.extraction.choice),
                mode=cfg.schedule_mode,
                cost_model=_schedule_cm(cfg, prog, eg), move_budget=0)
        sched_doc = schedule_to_doc(sr, eg, index_of)
        entry = make_entry(
            key, choice_doc=choice_doc, schedule_doc=sched_doc,
            predicted=sk.extraction.predicted,
            dag_cost=sk.extraction.dag_cost, report=sk.report())
        entry["tree_cost"] = sk.extraction.tree_cost
        cache.put(key, entry)
    except (CacheInvalid, ValueError, OSError) as e:
        telemetry().record_invalid(prog.name, f"store failed: {e}")


def _saturate_attempt(prog: KernelProgram, cfg: SaturatorConfig,
                      extra_fns: Optional[Dict[str, Callable]] = None
                      ) -> SaturatedKernel:
    """One un-guarded build of the configured pipeline (what
    ``saturate_program`` runs under the guard). May raise; the ladder wrapper catches."""
    cache = _resolve_cache(cfg)
    t_begin = time.perf_counter()
    ssa = build_ssa(prog)
    ssa_wall = time.perf_counter() - t_begin

    key = entry = None
    status = "off"
    if cache is not None:
        from repro_torch.cache import cache_key_for
        key = cache_key_for(prog, cfg)
        entry, status = cache.lookup(key)
        if status == "warm" and not cfg.cache_warm_start:
            entry, status = None, "miss"
        if status == "hit":
            sk = _replay_cached(prog, cfg, ssa, ssa_wall, entry, extra_fns)
            if sk is not None:
                telemetry().record_cache(
                    "hit", prog.name, time.perf_counter() - t_begin)
                return sk
            # invalid exact entry (already counted): rebuild cold on a
            # fresh e-graph — the failed graft may have dirtied this one
            entry, status = None, "miss"
            ssa = build_ssa(prog)

    sat_report = None
    if cfg.use_sat:
        sat_report = run_rules(ssa.egraph, cfg.rules(),
                               iter_limit=cfg.iter_limit,
                               node_limit=cfg.node_limit,
                               time_limit_s=cfg.time_limit_s)
    roots = ssa.roots()
    seed_choices = None
    seed_order_keys = None
    if entry is not None and status == "warm":
        # near miss (same kernel/rules/config, other shapes): graft the
        # cached choice into the saturated graph as a beam seed and keep
        # its statement order as a schedule-search seed
        from repro_torch.cache import (CacheInvalid, graft_choice,
                                       orders_from_doc)
        from repro_torch.cache.serialize import index_to_cid
        try:
            wchoice, _ = graft_choice(ssa.egraph, entry["choice"], roots)
            seed_choices = [wchoice]
            if entry.get("schedule") is not None:
                node_cids = index_to_cid(ssa.egraph, entry["choice"])
                seed_order_keys = orders_from_doc(entry["schedule"],
                                                  node_cids)
        except CacheInvalid as e:
            telemetry().record_invalid(prog.name, str(e))
            status = "miss"
            seed_choices = seed_order_keys = None
            # the failed graft may have mutated the saturated e-graph
            # (grafted nodes, possibly root unions) before validation
            # tripped — rebuild and re-saturate so the cold search never
            # runs on a graph a bad entry touched (mirrors the exact-hit
            # fallback's fresh build_ssa)
            ssa = build_ssa(prog)
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
        coordinated=cfg.beam_coordinated,
        seed_choices=seed_choices)
    t1 = time.perf_counter()
    # the cost scheduler prices statement orders with the same model
    # extraction minimized — one objective end to end
    sched_arg: Any = cfg.schedule
    if cfg.schedule_mode == "cost" and seed_order_keys is not None:
        try:
            sched_arg = compute_schedule(
                ssa, dict(extraction.choice), mode="cost",
                cost_model=_schedule_cm(cfg, prog, ssa.egraph),
                seed_orders=seed_order_keys)
        except ValueError:
            sched_arg = cfg.schedule
    gen = TorchCodeGenerator(ssa, extraction, bulk=cfg.use_bulk,
                             extra_fns=extra_fns,
                             reuse_temps=cfg.use_cse,
                             schedule=sched_arg,
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
    sk = SaturatedKernel(kernel=gen, ssa=ssa, extraction=extraction,
                         saturation=sat_report, config=cfg,
                         ssa_wall_s=ssa_wall, codegen_wall_s=codegen_wall,
                         cache_status=status)
    if cache is not None and key is not None:
        telemetry().record_cache("warm" if status == "warm" else "miss",
                                 prog.name,
                                 time.perf_counter() - t_begin)
        _store_entry(cache, key, cfg, prog, sk)
    return _maybe_verify(sk)


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
