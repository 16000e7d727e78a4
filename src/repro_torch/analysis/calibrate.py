"""Calibration: fit the roofline latency model to measured kernel times.

The port's copy of :mod:`repro.analysis.calibrate`. The analytic
:class:`repro_torch.analysis.latency.LatencyModel` guesses its constants
(``overlap_slack=0.05``, the per-class vector pass counts, the H100's
published peaks), so nothing guarantees the extraction and schedule
objectives rank terms the way the card runs them. This module closes the
predicted-vs-measured loop:

* :func:`kernel_features` reduces a saturated kernel to the calibration
  feature vector — per-op-class vector pass counts, matrix-unit FLOPs,
  and shape/dtype-aware device-memory bytes (loads + root stores), the
  same :class:`~repro_torch.analysis.opstats.OpStats` accounting
  extraction uses.
* :func:`fit_params` fits the free parameters of the latency formula —
  per-class pass coefficients, memory efficiency, per-bound overlap
  slack, and a constant per-instance overhead — to measured times
  (``tools/calibrate.py`` on the card) by deterministic coordinate
  descent on mean squared *log* error (scale-free).
* :class:`DeviceProfile` persists a fit (parameters + the measurements
  and per-kernel predictions it was fitted on) as versioned JSON under
  ``experiments/device_profiles_torch/<name>.json``;
  ``LatencyModel.from_profile(...)`` loads it back, and
  ``RooflineCostModel(profile=...)`` / ``SaturatorConfig(
  device_profile=...)`` thread it through the search so it minimizes the
  calibrated objective instead of the guessed one.
* :func:`evaluate_params` / :func:`check_profile` score a parameter set
  against measurements (MAPE + Spearman rank correlation of the
  predicted ordering) and fail when a committed profile's rank
  correlation drops below the floor or its stored baseline, or when it
  stops beating the uncalibrated defaults on MAPE.

The fitted model stays the same formula the extractor optimizes::

    compute = Σ_class passes·coeff_class × tile/vector_rate + mma/peak
    memory  = bytes / (hbm_bw × hbm_efficiency)
    latency = base + max(compute, memory) + slack_bound × min(...)

with ``slack_bound`` chosen by the binding roof. The working-set budget
of the pressure term is a quarter of the shared memory one block can use
(``ChipSpec.smem_bytes``), as :meth:`LatencyModel.vmem_budget_bytes`
prices it, so :func:`predict_ns` and a loaded profile stay in lock-step.
Profiles resolve only the port's chips (:mod:`repro_torch.core.hardware`):
one fitted against another chip's constants fails to load.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .latency import LatencyModel
from .opstats import _PASSES, TILE_ELEMS, op_pass_class

SCHEMA_VERSION = 1
SPEARMAN_FLOOR = 0.8          # acceptance floor for a committed profile
PASS_CLASSES = tuple(sorted(k for k, v in _PASSES.items() if v > 0))

# Calibration-only pseudo-class: serial per-load dispatch cost in
# vector-pass-equivalents. The analytic model prices loads purely on the
# memory axis (bytes/bandwidth); a device may charge a per-*instruction*
# cost for a load that bytes-linear pricing cannot express (a
# broadcast-row load moves a fraction of a tile load's bytes but costs
# the same dispatch). The default coefficient is 0.0, so uncalibrated
# predictions are unchanged.
MEM_DISPATCH_CLASS = "memory_dispatch"
_DEFAULT_COEFFS = {MEM_DISPATCH_CLASS: 0.0}


class CalibrationError(ValueError):
    """Unusable profile/measurement data (schema drift, bad fit input)."""


def schedule_paired_pct(entry: Mapping) -> Optional[float]:
    """The gated cost-vs-bulk statistic of one ``schedule_medians``
    entry: the paired per-rep median when the measurement recorded it,
    else the raw median delta; None when bulk/cost are missing. Single
    owner — the bench-regression gate and the rendered latency table
    must report the same number."""
    p = entry.get("cost_vs_bulk_paired_pct")
    if p is not None:
        return float(p)
    bulk, cost = entry.get("bulk"), entry.get("cost")
    if not bulk or cost is None:
        return None
    return 100.0 * (float(cost) - float(bulk)) / float(bulk)


# ---------------------------------------------------------------------------
# Feature extraction
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelFeatures:
    """Per-tile-instance hardware features of one extracted kernel.

    The schedule features describe the *emitted statement order*:
    ``sched_loads`` carries, per load, ``(bytes, gap_passes,
    gap_loads)`` — the load's HBM bytes and the unweighted VPU passes /
    load-dispatch slots issued between it and its first consumer under
    the generated schedule — and ``peak_live_bytes`` the schedule's peak
    on-chip working set. ``None``/0 (a measurement without a schedule)
    keeps the position-independent formula.
    """
    kernel: str
    class_passes: Mapping[str, float]   # op-class -> total VPU passes
    mxu_flops: float = 0.0
    hbm_bytes: float = 0.0              # loads + root stores, dtype-aware
    flops: float = 0.0                  # reporting only
    sched_loads: Optional[Tuple[Tuple[float, float, float], ...]] = None
    peak_live_bytes: float = 0.0
    sched_mode: Optional[str] = None    # provenance: bulk|source|cost
    # trip-count features: per-loop (trip_count, body_units) from
    # repro_torch.core.schedule.loop_profile. None/() keeps the
    # once-through formula bit-identical.
    loop_trips: Optional[Tuple[Tuple[float, float], ...]] = None

    @property
    def vpu_passes(self) -> float:
        return sum(self.class_passes.values())

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["class_passes"] = dict(self.class_passes)
        if self.sched_loads is not None:
            d["sched_loads"] = [list(t) for t in self.sched_loads]
        if self.loop_trips is not None:
            d["loop_trips"] = [list(t) for t in self.loop_trips]
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "KernelFeatures":
        sl = d.get("sched_loads")
        lt = d.get("loop_trips")
        return cls(kernel=d["kernel"],
                   class_passes={k: float(v)
                                 for k, v in d["class_passes"].items()},
                   mxu_flops=float(d.get("mxu_flops", 0.0)),
                   hbm_bytes=float(d.get("hbm_bytes", 0.0)),
                   flops=float(d.get("flops", 0.0)),
                   sched_loads=(None if sl is None else
                                tuple(tuple(float(x) for x in t)
                                      for t in sl)),
                   peak_live_bytes=float(d.get("peak_live_bytes", 0.0)),
                   sched_mode=d.get("sched_mode"),
                   loop_trips=(None if lt is None else
                               tuple(tuple(float(x) for x in t)
                                     for t in lt)))


def kernel_features(sk, schedule=None,
                    scalars: Optional[Mapping[str, float]] = None
                    ) -> KernelFeatures:
    """Calibration features of a pipeline result (``SaturatedKernel``).

    Prices the *extracted* choice — the exact nodes the beam committed
    to — with the same shape/dtype-aware model extraction used, plus the
    root stores' write traffic, so fitted coefficients talk about the
    code that actually ran. ``schedule`` (a
    :class:`repro_torch.core.schedule.ScheduleResult`) additionally
    records the emitted order's per-load overlap windows and peak live
    set, enabling the position-dependent fit. ``scalars`` (runtime
    scalar bindings, e.g. ``cg_like``'s ``nnz``) lets
    :func:`repro_torch.core.schedule.loop_profile` resolve scalar-bounded
    trip counts for the trip-count-aware term.
    """
    from repro_torch.core.extract import choice_nodes  # deferred cycle
    from .cost_model import RooflineCostModel
    from .opstats import store_stats

    ssa = sk.ssa
    eg = ssa.egraph
    ex = sk.extraction
    cm = RooflineCostModel(dtype=getattr(ssa.prog, "dtype", None) or "f32",
                           egraph=eg)
    nodes = choice_nodes(eg, ex.choice, ex.roots)
    if nodes is None:
        raise CalibrationError(
            f"kernel {ssa.prog.name!r}: extraction choice is not a valid "
            "acyclic selection")
    stats = cm.choice_stats(nodes)
    n_stores = sk.kernel.stats.n_stores
    infos = ssa.store_infos()
    stats = stats + store_stats(
        n_stores, infos=infos if len(infos) == n_stores else None)
    classes: Dict[str, float] = {}
    for n in nodes:
        if n.op == "load":
            # one dispatch-equivalent per load instruction (fitted
            # coefficient, 0 in the analytic model) — loads only, to
            # stay consistent with the extraction-side objective where
            # store traffic is a constant outside the minimized term
            classes[MEM_DISPATCH_CLASS] = \
                classes.get(MEM_DISPATCH_CLASS, 0.0) + 1.0
            continue
        kls = op_pass_class(n.op)
        p = _PASSES[kls]
        if p > 0:
            classes[kls] = classes.get(kls, 0.0) + p
    sched_loads = peak_live = mode = None
    if schedule is not None:
        sched_loads = tuple(schedule.load_windows())
        peak_live = schedule.peak_live_bytes
        mode = schedule.mode
    from repro_torch.core.schedule import loop_profile
    trips = loop_profile(ssa, scalars=dict(scalars) if scalars else None)
    return KernelFeatures(kernel=ssa.prog.name, class_passes=classes,
                          mxu_flops=stats.mxu_flops,
                          hbm_bytes=stats.total_bytes,
                          flops=stats.total_flops,
                          sched_loads=sched_loads,
                          peak_live_bytes=peak_live or 0.0,
                          sched_mode=mode,
                          loop_trips=trips or None)


# ---------------------------------------------------------------------------
# Parameters + the calibrated latency formula over features
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CalibrationParams:
    overlap_slack_compute: float = 0.05
    overlap_slack_memory: float = 0.05
    hbm_efficiency: float = 1.0
    base_ns: float = 0.0
    vpu_pass_coeffs: Mapping[str, float] = dataclasses.field(
        default_factory=dict)   # missing: 1.0 (0.0 for memory_dispatch)
    # -- schedule-aware terms (None/0 == the aggregate formula) ------------
    # Fraction of the issue time between a load and its first consumer
    # that hides the load's transfer (fitted against schedule features).
    overlap_efficiency: Optional[float] = None
    # Spill-traffic multiplier on the working set beyond the budget.
    vmem_pressure_coeff: float = 0.0
    # -- trip-count term (0.0 == the once-through formula) -----------------
    # Per-(extra-iteration × body-unit) cost in VPU-pass-equivalents:
    # loop bodies are priced once by class_passes, so a loop running T
    # times adds (T-1) × body_units × coeff extra passes. Identifiable
    # only from measurements whose features carry loop_trips (cg_like).
    trip_count_coeff: float = 0.0

    def coeff(self, kls: str) -> float:
        d = self.vpu_pass_coeffs.get(kls)
        if d is None:
            return _DEFAULT_COEFFS.get(kls, 1.0)
        return float(d)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["vpu_pass_coeffs"] = dict(self.vpu_pass_coeffs)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "CalibrationParams":
        eff = d.get("overlap_efficiency")
        return cls(overlap_slack_compute=float(d["overlap_slack_compute"]),
                   overlap_slack_memory=float(d["overlap_slack_memory"]),
                   hbm_efficiency=float(d["hbm_efficiency"]),
                   base_ns=float(d["base_ns"]),
                   vpu_pass_coeffs={k: float(v) for k, v in
                                    d.get("vpu_pass_coeffs", {}).items()},
                   overlap_efficiency=None if eff is None else float(eff),
                   vmem_pressure_coeff=float(
                       d.get("vmem_pressure_coeff", 0.0)),
                   trip_count_coeff=float(d.get("trip_count_coeff", 0.0)))


DEFAULT_PARAMS = CalibrationParams()


def _chip():
    from repro_torch.core.hardware import DEFAULT_CHIP
    return DEFAULT_CHIP


def chip_by_name(name: str):
    """Resolve a stored ``model_chip`` name back to its ChipSpec, so a
    profile's coefficients are always combined with the constants they
    were fitted against (unknown names fail loudly, never fall back)."""
    from repro_torch.core import hardware
    for v in vars(hardware).values():
        if isinstance(v, hardware.ChipSpec) and v.name == name:
            return v
    known = sorted({v.name for v in vars(hardware).values()
                    if isinstance(v, hardware.ChipSpec)})
    raise CalibrationError(
        f"profile references unknown model_chip {name!r}; known: {known}")


def predict_ns(feat: KernelFeatures, params: CalibrationParams,
               chip=None, tile_elems: int = TILE_ELEMS) -> float:
    """Latency of one kernel under ``params`` — the same formula
    :class:`LatencyModel` computes once a profile is loaded (kept in
    lock-step by ``tests/test_torch_calibration.py``).

    With a fitted ``overlap_efficiency`` the memory axis is reduced by
    the schedule's hidden transfer time before the roofline max: the
    per-load windows in ``feat.sched_loads`` when the measurement
    recorded them (position-dependent — each load hides at most
    ``eff × gap``), else the aggregate best-schedule bound
    ``min(memory, eff × compute)``. ``overlap_efficiency=None`` (a
    profile fitted without schedule features) is bit-identical to the
    aggregate formula.
    """
    chip = chip if chip is not None else _chip()
    per_pass_ns = tile_elems / chip.vpu_elems_per_s * 1e9
    compute = sum(p * params.coeff(k)
                  for k, p in feat.class_passes.items()) * per_pass_ns
    compute += feat.mxu_flops / chip.peak_flops_bf16 * 1e9
    if params.trip_count_coeff and feat.loop_trips:
        extra = sum(max(t - 1.0, 0.0) * units
                    for t, units in feat.loop_trips)
        compute += params.trip_count_coeff * extra * per_pass_ns
    bw = chip.hbm_bw * params.hbm_efficiency
    memory = feat.hbm_bytes / bw * 1e9
    if params.overlap_efficiency is not None:
        eff = params.overlap_efficiency
        if feat.sched_loads:
            # gap windows are recorded as unweighted pass counts; price
            # them with the fitted coefficients (the "simple" class as
            # the stand-in for the window's compute mix) so the overlap
            # term lives on the same scale as the fitted memory axis
            dispatch = params.coeff(MEM_DISPATCH_CLASS)
            gap_coeff = params.coeff("simple")
            hidden = 0.0
            for nbytes, gap_passes, gap_loads in feat.sched_loads:
                m_i = nbytes / bw * 1e9
                gap_ns = (gap_passes * gap_coeff
                          + gap_loads * dispatch) * per_pass_ns
                hidden += min(m_i, eff * gap_ns)
            hidden = min(hidden, memory)
        else:
            hidden = min(memory, eff * compute)
        memory -= hidden
    pressure = 0.0
    if params.vmem_pressure_coeff and feat.peak_live_bytes:
        spill = max(0.0, feat.peak_live_bytes - chip.smem_bytes / 4)
        pressure = params.vmem_pressure_coeff * spill / bw * 1e9
    slack = (params.overlap_slack_compute if compute >= memory
             else params.overlap_slack_memory)
    return (params.base_ns + max(compute, memory)
            + slack * min(compute, memory) + pressure)


# ---------------------------------------------------------------------------
# Fit quality metrics
# ---------------------------------------------------------------------------
def _ranks(xs: Sequence[float]) -> List[float]:
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        avg = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (tie-averaged); 0.0 on degenerate input."""
    if len(xs) != len(ys) or len(xs) < 2:
        return 0.0
    rx, ry = _ranks(xs), _ranks(ys)
    mx = sum(rx) / len(rx)
    my = sum(ry) / len(ry)
    num = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    dx = math.sqrt(sum((a - mx) ** 2 for a in rx))
    dy = math.sqrt(sum((b - my) ** 2 for b in ry))
    if dx == 0.0 or dy == 0.0:
        return 0.0
    return num / (dx * dy)


def mape_pct(pred: Sequence[float], meas: Sequence[float]) -> float:
    """Mean absolute percentage error of predictions vs measurements."""
    if not meas:
        return float("inf")
    return 100.0 * sum(abs(p - m) / m for p, m in zip(pred, meas)) \
        / len(meas)


def evaluate_params(feats: Sequence[KernelFeatures],
                    measured_ns: Sequence[float],
                    params: CalibrationParams, chip=None,
                    tile_elems: int = TILE_ELEMS) -> dict:
    preds = [predict_ns(f, params, chip=chip, tile_elems=tile_elems)
             for f in feats]
    return {
        "predicted_ns": preds,
        "mape_pct": mape_pct(preds, measured_ns),
        "spearman": spearman(preds, list(measured_ns)),
    }


# ---------------------------------------------------------------------------
# Fitting: deterministic coordinate descent on mean squared log error
# ---------------------------------------------------------------------------
def _msle(feats, measured, params, chip, tile_elems) -> float:
    loss = 0.0
    for f, m in zip(feats, measured):
        p = predict_ns(f, params, chip=chip, tile_elems=tile_elems)
        loss += (math.log(max(p, 1e-12)) - math.log(m)) ** 2
    return loss / len(measured)


def fit_params(feats: Sequence[KernelFeatures],
               measured_ns: Sequence[float], *, chip=None,
               tile_elems: int = TILE_ELEMS, max_rounds: int = 80,
               fit_base: bool = True,
               ) -> Tuple[CalibrationParams, float, int]:
    """Fit calibration parameters to measured per-instance times.

    Coordinate descent from several deterministic starts (memory-led,
    compute-led, and no-overlap/sum-like — the loss surface has local
    minima where one roof absorbs everything): each round sweeps every
    free parameter with a multiplicative line search (slacks with an
    additive one, clipped to [0, 2]) and keeps the best value; a start
    converges when a full round improves mean squared log error by
    < 1e-15 per candidate. Fully deterministic — no RNG, no wall
    clock — so a re-fit on the same measurements is bit-identical.

    Returns ``(params, final_loss, rounds_used)`` of the best start.
    """
    if len(feats) != len(measured_ns) or not feats:
        raise CalibrationError(
            f"need matching non-empty features/measurements, got "
            f"{len(feats)}/{len(measured_ns)}")
    if any(m <= 0 for m in measured_ns):
        raise CalibrationError("measured times must be positive")
    chip = chip if chip is not None else _chip()
    classes = sorted({k for f in feats for k in f.class_passes})
    # schedule-aware terms are only identifiable when the measurements
    # recorded per-load overlap windows; starting at eff=0 makes the
    # schedule-aware fit begin exactly at the aggregate formula, so added
    # freedom can only lower the loss
    has_sched = any(f.sched_loads for f in feats)
    over_budget = any(f.peak_live_bytes > chip.smem_bytes / 4
                      for f in feats)
    # trip counts are only identifiable when some measured kernel has a
    # loop that actually iterates (trips > 1); otherwise flat at 0
    has_trips = any(t > 1.0 for f in feats
                    for t, _ in (f.loop_trips or ()))

    # scale-matched starts: uncalibrated predictions and measurements can
    # sit orders of magnitude apart; starting coefficients at the median
    # measured/predicted ratio keeps the line search short
    base0 = [predict_ns(f, DEFAULT_PARAMS, chip=chip,
                        tile_elems=tile_elems) for f in feats]
    ratios = sorted(m / max(p, 1e-12) for m, p in zip(measured_ns, base0))
    scale = max(ratios[len(ratios) // 2], 1e-12)
    mn = min(measured_ns)
    med = sorted(measured_ns)[len(measured_ns) // 2]

    def start(hbm_mul: float, coeff_mul: float, slack: float
              ) -> CalibrationParams:
        return CalibrationParams(
            overlap_slack_compute=slack, overlap_slack_memory=slack,
            hbm_efficiency=hbm_mul / scale, base_ns=0.0,
            vpu_pass_coeffs={k: scale * coeff_mul for k in classes},
            overlap_efficiency=0.0 if has_sched else None)

    starts = (
        start(1.0, 1.0, 0.05),       # balanced (the analytic prior)
        start(1.0, 1.0, 1.0),        # no-overlap: latency ~ compute+memory
        start(100.0, 1.0, 0.05),     # compute-led: memory roof negligible
        start(0.01, 1.0, 0.05),      # memory-led: compute roof negligible
    )

    def loss_of(p: CalibrationParams) -> float:
        return _msle(feats, measured_ns, p, chip, tile_elems)

    def descend(params: CalibrationParams, mul_steps, slack_steps,
                rounds0: int = 0) -> Tuple[CalibrationParams, float, int]:
        best = loss_of(params)
        rounds = rounds0
        for rounds in range(rounds0 + 1, rounds0 + max_rounds + 1):
            improved = False

            def try_param(make) -> None:
                nonlocal params, best, improved
                for cand in make():
                    lo = loss_of(cand)
                    if lo < best - 1e-15:
                        params, best = cand, lo
                        improved = True

            for kls in classes:
                try_param(lambda kls=kls: (
                    dataclasses.replace(params, vpu_pass_coeffs={
                        **params.vpu_pass_coeffs,
                        kls: params.vpu_pass_coeffs[kls] * s})
                    for s in mul_steps))
            try_param(lambda: (
                dataclasses.replace(params,
                                    hbm_efficiency=params.hbm_efficiency
                                    * s) for s in mul_steps))
            if fit_base:
                try_param(lambda: (
                    dataclasses.replace(params, base_ns=b)
                    for b in ([0.0, med * 0.01, med * 0.1, mn * 0.5,
                               mn * 0.8, mn * 0.95]
                              + [params.base_ns * s for s in mul_steps
                                 if params.base_ns > 0])))
            for field in ("overlap_slack_compute", "overlap_slack_memory"):
                try_param(lambda field=field: (
                    dataclasses.replace(params, **{
                        field: min(max(getattr(params, field) + d, 0.0),
                                   2.0)})
                    for d in slack_steps))
            if has_sched:
                try_param(lambda: (
                    dataclasses.replace(params, overlap_efficiency=min(
                        max((params.overlap_efficiency or 0.0) + d, 0.0),
                        1.0))
                    for d in slack_steps))
            if over_budget:
                # only identifiable when some kernel's peak live set
                # exceeds the budget; otherwise the term is flat at 0
                try_param(lambda: (
                    dataclasses.replace(params, vmem_pressure_coeff=max(
                        params.vmem_pressure_coeff + d, 0.0))
                    for d in slack_steps))
            if has_trips:
                # multiplicative when already non-zero, seeded from the
                # fitted "simple" pass coefficient otherwise (the body's
                # per-iteration cost should start on the compute scale)
                try_param(lambda: (
                    dataclasses.replace(params, trip_count_coeff=tc)
                    for tc in ([params.trip_count_coeff * s
                                for s in mul_steps]
                               if params.trip_count_coeff > 0 else
                               [0.0, 0.1 * scale, scale, 10.0 * scale])))
            if not improved:
                break
        return params, best, rounds

    # coarse sweep from every start, then a fine polish of each result
    # (the coarse grid's ~5% resolution caps how close it can land)
    coarse_mul = (0.125, 0.25, 0.5, 0.8, 0.95, 1.05, 1.25, 2.0, 4.0, 8.0)
    coarse_slack = (-0.5, -0.2, -0.05, -0.01, -0.002, 0.002, 0.01, 0.05,
                    0.2, 0.5)
    fine_mul = (0.98, 0.99, 0.995, 1.005, 1.01, 1.02)
    fine_slack = (-0.01, -0.003, -0.001, 0.001, 0.003, 0.01)
    results = []
    for s in starts:
        p, _, r = descend(s, coarse_mul, coarse_slack)
        results.append(descend(p, fine_mul, fine_slack, rounds0=r))
    return min(results, key=lambda r: r[1])


# ---------------------------------------------------------------------------
# Device profiles: versioned, persisted fits
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceProfile:
    """A persisted calibration: fitted parameters + the evidence.

    ``fit`` embeds the measurements the parameters were fitted on, so
    the CI gate can re-score the *current* model code against them
    deterministically — no re-timing on the CI runner needed.
    """
    name: str                      # file stem, e.g. "h100_triton_sched"
    chip: str                      # measured device (torch.cuda name)
    measured_kind: str             # e.g. triton_compiled
    params: CalibrationParams
    model_chip: str = "h100_sxm"   # ChipSpec the analytic features used
    tile_elems: int = TILE_ELEMS
    schema_version: int = SCHEMA_VERSION
    fit: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["params"] = self.params.to_dict()
        return json.dumps(d, indent=1, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str, name: Optional[str] = None
                  ) -> "DeviceProfile":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise CalibrationError(f"device profile is not valid JSON: {e}")
        ver = d.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise CalibrationError(
                f"device profile schema_version {ver!r} != supported "
                f"{SCHEMA_VERSION}; re-fit it with "
                "`python tools/calibrate.py` on the card and commit the "
                "result")
        missing = [k for k in ("chip", "measured_kind", "params")
                   if k not in d]
        if missing:
            raise CalibrationError(f"device profile missing keys {missing}")
        # a profile without the key was fitted on the JAX package's
        # default chip, which the port does not model: fail loudly here
        model_chip = d.get("model_chip", "tpu_v5e")
        chip_by_name(model_chip)
        return cls(name=name or d.get("name", "profile"), chip=d["chip"],
                   measured_kind=d["measured_kind"],
                   params=CalibrationParams.from_dict(d["params"]),
                   model_chip=model_chip,
                   tile_elems=int(d.get("tile_elems", TILE_ELEMS)),
                   schema_version=ver, fit=d.get("fit", {}))

    def save(self, path: Union[str, pathlib.Path]) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    # -- stored evidence -----------------------------------------------------
    def stored_features(self) -> List[KernelFeatures]:
        return [KernelFeatures.from_dict(r["features"])
                for r in self.fit.get("kernels", [])]

    def stored_measurements(self) -> List[float]:
        return [float(r["measured_ns"]) for r in self.fit.get("kernels", [])]

    def latency_model(self, chip=None,
                      mxu_dtype: Optional[str] = None) -> LatencyModel:
        return LatencyModel.from_profile(self, chip=chip,
                                         mxu_dtype=mxu_dtype)


def fit_profile(feats: Sequence[KernelFeatures],
                measured_ns: Sequence[float], *, name: str, chip: str,
                measured_kind: str, model_chip=None,
                tile_elems: int = TILE_ELEMS, **fit_kw) -> DeviceProfile:
    """Fit and package a :class:`DeviceProfile` with full fit evidence."""
    spec = model_chip if model_chip is not None else _chip()
    params, loss, rounds = fit_params(feats, measured_ns, chip=spec,
                                      tile_elems=tile_elems, **fit_kw)
    cal = evaluate_params(feats, measured_ns, params, chip=spec,
                          tile_elems=tile_elems)
    uncal = evaluate_params(feats, measured_ns, DEFAULT_PARAMS, chip=spec,
                            tile_elems=tile_elems)
    rows = [{"kernel": f.kernel, "measured_ns": m,
             "predicted_ns": cp, "uncalibrated_ns": up,
             "features": f.to_dict()}
            for f, m, cp, up in zip(feats, measured_ns,
                                    cal["predicted_ns"],
                                    uncal["predicted_ns"])]
    return DeviceProfile(
        name=name, chip=chip, measured_kind=measured_kind, params=params,
        model_chip=getattr(spec, "name", str(spec)), tile_elems=tile_elems,
        fit={"loss_msle": loss, "rounds": rounds,
             "mape_pct": cal["mape_pct"], "spearman": cal["spearman"],
             "uncalibrated_mape_pct": uncal["mape_pct"],
             "uncalibrated_spearman": uncal["spearman"],
             "kernels": rows})


# ---------------------------------------------------------------------------
# Profile discovery / loading
# ---------------------------------------------------------------------------
def profile_dir() -> pathlib.Path:
    """Where the port's committed device profiles live (override with
    ``REPRO_PROFILE_DIR`` for out-of-tree checkouts). Not the JAX
    package's ``experiments/device_profiles/``: its tests hold every
    profile there to its own chips."""
    env = os.environ.get("REPRO_PROFILE_DIR")
    if env:
        return pathlib.Path(env)
    return (pathlib.Path(__file__).resolve().parents[3]
            / "experiments" / "device_profiles_torch")


def load_profile(spec: Union["DeviceProfile", str, pathlib.Path]
                 ) -> DeviceProfile:
    """Resolve a profile: an instance passes through; a path loads it; a
    bare name resolves against :func:`profile_dir`."""
    if isinstance(spec, DeviceProfile):
        return spec
    path = pathlib.Path(spec)
    if not path.suffix:
        path = profile_dir() / f"{path.name}.json"
    if not path.exists():
        known = sorted(p.stem for p in profile_dir().glob("*.json")) \
            if profile_dir().exists() else []
        raise CalibrationError(
            f"no device profile at {path}; known profiles: {known or 'none'}"
            " (generate one with `python tools/calibrate.py` on the card)")
    return DeviceProfile.from_json(path.read_text(), name=path.stem)


def check_profile(profile: Union[DeviceProfile, str, pathlib.Path],
                  spearman_floor: float = SPEARMAN_FLOOR,
                  degrade_tol: float = 1e-9) -> List[str]:
    """Re-score a committed profile against its stored measurements with
    the *current* model code. Returns human-readable failures when

    * calibrated Spearman rank correlation < ``spearman_floor``,
    * calibrated rank correlation degraded vs the value stored at fit
      time (the committed baseline), or
    * calibrated MAPE is not strictly better than the uncalibrated
      defaults.

    Empty list = the calibrated objective still ranks kernels at least
    as faithfully as when the profile was fitted.
    """
    prof = load_profile(profile)
    feats = prof.stored_features()
    meas = prof.stored_measurements()
    if len(feats) < 2:
        return [f"profile {prof.name}: fewer than 2 stored kernels — "
                "cannot assess ranking quality"]
    chip = chip_by_name(prof.model_chip)
    cal = evaluate_params(feats, meas, prof.params, chip=chip,
                          tile_elems=prof.tile_elems)
    uncal = evaluate_params(feats, meas, DEFAULT_PARAMS, chip=chip,
                            tile_elems=prof.tile_elems)
    fails: List[str] = []
    if cal["spearman"] < spearman_floor:
        fails.append(
            f"profile {prof.name}: calibrated Spearman {cal['spearman']:.3f}"
            f" < floor {spearman_floor}")
    stored = prof.fit.get("spearman")
    if stored is not None and cal["spearman"] < stored - degrade_tol:
        fails.append(
            f"profile {prof.name}: calibrated Spearman degraded "
            f"{stored:.3f} -> {cal['spearman']:.3f} vs committed baseline "
            "(model code drifted; re-fit with "
            "`python tools/calibrate.py` on the card if intentional)")
    if not cal["mape_pct"] < uncal["mape_pct"]:
        fails.append(
            f"profile {prof.name}: calibrated MAPE {cal['mape_pct']:.1f}% "
            f"not better than uncalibrated {uncal['mape_pct']:.1f}%")
    return fails
