"""Hardware latency model: OpStats → predicted nanoseconds on a chip.

Classic roofline with three ceilings derived from the
:class:`repro.core.hardware.ChipSpec` peaks:

  compute  = VPU passes × tile cycles / clock  +  MXU FLOPs / peak
  memory   = HBM bytes / (HBM bandwidth × efficiency)
  latency  = base + max(compute, memory) + slack × min(compute, memory)

The ``overlap_slack`` term models imperfect compute/memory overlap (DMA
issue, semaphore waits). It is deliberately small — the roofline maximum
still dominates — but it makes the objective strictly monotone in both
axes, so extraction always prefers "less computation, less memory access"
even for terms pinned against one roof (the paper's §V-B motivation:
ties under a flat weight table are exactly where extraction quality is
lost).

The model is *calibratable*: :meth:`LatencyModel.from_profile` loads a
fitted :class:`repro.analysis.calibrate.DeviceProfile` whose measured
parameters replace the analytic guesses — per-bound overlap slack
(compute-bound and memory-bound kernels hide traffic differently), an
HBM-efficiency factor (achieved vs peak bandwidth), a constant
per-instance launch overhead ``base_ns``, and per-op-class VPU pass
coefficients (``pass_coeffs``, applied at node-pricing time by
:class:`repro.analysis.cost_model.RooflineCostModel` so the aggregate
``vpu_passes`` arriving here is already coefficient-weighted). With the
default values the formula reduces exactly to the uncalibrated model.

Schedule awareness
------------------
Statement order matters on real machines: a load issued far ahead of its
first consumer hides its HBM transfer behind the intervening compute,
one issued right before it stalls. Two layers model this:

* :meth:`LatencyModel.schedule_ns` prices an explicit issue *order* — a
  sequence of :class:`ScheduleEvent` — with a position-dependent overlap
  term (per-load exposed transfer = ``max(0, mem − eff × gap)`` where
  ``gap`` is the issue time between the load and its first consumer)
  plus a VMEM live-range pressure penalty when the peak live working
  set exceeds the budget. :mod:`repro.core.schedule` minimizes this
  objective when searching over legal topological orders.
* when a fitted ``overlap_efficiency`` is present (schedule-aware device
  profiles), the *aggregate* :meth:`latency_ns` replaces the scalar
  ``overlap_slack`` coupling with the best-schedule bound
  ``memory − min(memory, eff × compute)`` — the extraction beam then
  optimizes the same objective the downstream scheduler realizes. With
  ``overlap_efficiency=None`` (the default, and every profile fitted without
  schedule features) the formula reduces exactly to the aggregate model.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Mapping, Optional, Sequence

from .opstats import OpStats, TILE_ELEMS, dtype_byte_width

if TYPE_CHECKING:
    from repro_torch.core.hardware import ChipSpec


def _default_chip():
    # deferred: repro.core.__init__ imports this package, so hardware must
    # not be pulled in at module load time
    from repro_torch.core.hardware import DEFAULT_CHIP
    return DEFAULT_CHIP


@dataclasses.dataclass(frozen=True)
class ScheduleEvent:
    """One issue slot of an explicit kernel schedule.

    ``issue_ns`` is how long the slot occupies the issue pipeline
    (compute: its VPU/MXU time; load/store: the calibrated per-access
    dispatch cost). ``mem_ns`` is the asynchronous HBM transfer the slot
    starts (0 for compute). ``first_use``/``last_use`` index the event
    list: the transfer must complete before ``first_use`` issues, and
    ``bytes_live`` stays resident in VMEM through ``last_use``.
    ``first_use=-1`` means no later consumer (the transfer drains
    against everything issued afterwards — how stores behave).
    """
    kind: str                    # "load" | "compute" | "store"
    issue_ns: float = 0.0
    mem_ns: float = 0.0
    bytes_live: float = 0.0
    first_use: int = -1
    last_use: int = -1


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    chip: Optional["ChipSpec"] = None   # None -> DEFAULT_CHIP
    tile_elems: int = TILE_ELEMS
    overlap_slack: float = 0.05
    # Matrix-unit dtype: the MXU peak scales with operand width (f32 runs
    # at half the bf16 rate, 8-bit at double it). None keeps the legacy
    # bf16-peak pricing for callers that never declared a dtype.
    mxu_dtype: Optional[str] = None
    # -- calibrated parameters (defaults == the analytic model) ------------
    # Per-bound overlap slack: measured kernels hide the minor axis
    # differently depending on which roof binds; ``None`` falls back to
    # the shared ``overlap_slack``.
    overlap_slack_compute: Optional[float] = None
    overlap_slack_memory: Optional[float] = None
    # Achieved/peak HBM bandwidth ratio (memory roof divisor).
    hbm_efficiency: float = 1.0
    # Constant per-instance overhead (kernel launch / interpret dispatch).
    base_ns: float = 0.0
    # Per-op-class VPU pass multipliers fitted by calibration. NOT applied
    # here (OpStats only carries aggregate passes) — RooflineCostModel
    # scales each node's passes by its class coefficient at pricing time.
    pass_coeffs: Optional[Mapping[str, float]] = None
    # -- schedule-aware parameters -----------------------------------------
    # Fraction of the issue time between a load and its first consumer
    # that actually hides the load's HBM transfer. ``None`` keeps the
    # aggregate formula (scalar per-bound slack); a fitted value
    # switches ``latency_ns`` to the best-schedule bound and is what
    # ``schedule_ns`` scales its per-load overlap windows by.
    overlap_efficiency: Optional[float] = None
    # ns of penalty per byte of VMEM working set beyond the budget,
    # expressed as a multiplier on the spill traffic's HBM time.
    vmem_pressure_coeff: float = 0.0
    # Name of the device profile these parameters came from (reporting).
    profile_name: Optional[str] = None

    def __post_init__(self):
        if self.chip is None:
            object.__setattr__(self, "chip", _default_chip())

    @classmethod
    def from_profile(cls, profile, *, chip: Optional["ChipSpec"] = None,
                     mxu_dtype: Optional[str] = None) -> "LatencyModel":
        """Calibrated model from a :class:`DeviceProfile` (or a path /
        bare profile name resolved via ``calibrate.load_profile``).

        ``chip=None`` resolves the profile's stored ``model_chip`` — the
        ChipSpec its coefficients were fitted against — so a profile
        fitted on non-default constants is never silently re-priced with
        the default ones.
        """
        from .calibrate import chip_by_name, load_profile  # deferred cycle
        prof = load_profile(profile)
        if chip is None:
            chip = chip_by_name(prof.model_chip)
        p = prof.params
        return cls(chip=chip, tile_elems=prof.tile_elems,
                   overlap_slack=p.overlap_slack_compute,
                   overlap_slack_compute=p.overlap_slack_compute,
                   overlap_slack_memory=p.overlap_slack_memory,
                   hbm_efficiency=p.hbm_efficiency, base_ns=p.base_ns,
                   pass_coeffs=dict(p.vpu_pass_coeffs),
                   overlap_efficiency=p.overlap_efficiency,
                   vmem_pressure_coeff=p.vmem_pressure_coeff,
                   mxu_dtype=mxu_dtype, profile_name=prof.name)

    @property
    def slack_compute(self) -> float:
        """Overlap slack applied when the compute roof binds."""
        s = self.overlap_slack_compute
        return self.overlap_slack if s is None else s

    @property
    def slack_memory(self) -> float:
        """Overlap slack applied when the memory roof binds."""
        s = self.overlap_slack_memory
        return self.overlap_slack if s is None else s

    def mxu_peak_flops(self) -> float:
        peak = self.chip.peak_flops_bf16
        if self.mxu_dtype is None:
            return peak
        width = dtype_byte_width(self.mxu_dtype)
        if width >= 4:
            return peak / 2.0
        if width == 1:
            return peak * 2.0
        return peak

    def compute_ns(self, stats: OpStats) -> float:
        vpu_s = stats.vpu_passes * self.tile_elems / self.chip.vpu_elems_per_s
        mxu_s = stats.mxu_flops / self.mxu_peak_flops()
        return (vpu_s + mxu_s) * 1e9

    def memory_ns(self, stats: OpStats) -> float:
        return stats.total_bytes / (self.chip.hbm_bw
                                    * self.hbm_efficiency) * 1e9

    def latency_ns(self, stats: OpStats) -> float:
        c = self.compute_ns(stats)
        m = self.memory_ns(stats)
        if self.overlap_efficiency is not None:
            # best-schedule bound: the downstream scheduler can hide at
            # most eff × compute of the memory traffic behind compute
            # issue slots; the exposed remainder couples via the fitted
            # per-bound slack exactly as in the aggregate formula (eff=0
            # reduces to it bit-for-bit)
            m = m - min(m, self.overlap_efficiency * c)
        slack = self.slack_compute if c >= m else self.slack_memory
        return self.base_ns + max(c, m) + slack * min(c, m)

    # -- schedule-aware objective -------------------------------------------
    def vmem_budget_bytes(self) -> int:
        """Working-set budget for the pressure term: a quarter of the
        on-chip memory one block can use (shared memory on Hopper)."""
        return int(self.chip.smem_bytes) // 4

    def schedule_ns(self, events: Sequence[ScheduleEvent], *,
                    vmem_budget_bytes: Optional[int] = None
                    ) -> Dict[str, float]:
        """Price an explicit issue order (position-dependent roofline).

        The issue pipeline executes ``events`` in order; each load/store
        starts an asynchronous HBM transfer at issue time. A transfer is
        hidden by ``overlap_efficiency`` × the issue time between it and
        its first consumer (end of schedule for consumer-less stores);
        the un-hidden remainder is exposed stall time. Loads hold
        ``bytes_live`` of VMEM from issue through ``last_use``; the peak
        live set beyond the budget is charged as spill traffic scaled by
        ``vmem_pressure_coeff``.

        Returns a breakdown dict; ``latency_ns`` is the objective
        :mod:`repro.core.schedule` minimizes.
        """
        eff = (self.overlap_efficiency
               if self.overlap_efficiency is not None else 1.0)
        budget = (self.vmem_budget_bytes() if vmem_budget_bytes is None
                  else vmem_budget_bytes)
        n = len(events)
        cum = [0.0] * (n + 1)   # issue time elapsed before slot i
        for i, ev in enumerate(events):
            cum[i + 1] = cum[i] + ev.issue_ns
        exposed = 0.0
        peak_live = live = 0.0
        # bytes whose live range ends after slot i (swept in order)
        drops = [0.0] * (n + 1)
        for i, ev in enumerate(events):
            if ev.mem_ns > 0.0:
                end = ev.first_use if ev.first_use >= 0 else n
                gap = max(0.0, cum[end] - cum[i + 1])
                exposed += max(0.0, ev.mem_ns - eff * gap)
            if ev.bytes_live > 0.0:
                live += ev.bytes_live
                last = ev.last_use if ev.last_use >= 0 else n - 1
                drops[min(last, n - 1) + 1] += ev.bytes_live
            peak_live = max(peak_live, live)
            live -= drops[i + 1]
        spill = max(0.0, peak_live - budget)
        pressure = (self.vmem_pressure_coeff * spill
                    / (self.chip.hbm_bw * self.hbm_efficiency) * 1e9)
        compute = cum[n]
        return {
            "latency_ns": self.base_ns + compute + exposed + pressure,
            "issue_ns": compute,
            "exposed_mem_ns": exposed,
            "peak_live_bytes": peak_live,
            "pressure_ns": pressure,
        }

    def bound(self, stats: OpStats) -> str:
        return "compute" if self.compute_ns(stats) >= self.memory_ns(stats) \
            else "memory"

    def arithmetic_intensity(self, stats: OpStats) -> float:
        return stats.total_flops / stats.total_bytes if stats.total_bytes \
            else float("inf")

    def throughput_gbps(self, stats: OpStats) -> float:
        """Achieved HBM GB/s if the term runs at predicted latency."""
        lat = self.latency_ns(stats)
        return stats.total_bytes / lat if lat > 0 else 0.0

    def report(self, stats: OpStats) -> Dict[str, float]:
        return {
            "flops": stats.total_flops,
            "vpu_passes": stats.vpu_passes,
            "bytes_read": stats.bytes_read,
            "bytes_written": stats.bytes_written,
            "compute_ns": self.compute_ns(stats),
            "memory_ns": self.memory_ns(stats),
            "latency_ns": self.latency_ns(stats),
            "bound": self.bound(stats),
            "arithmetic_intensity": self.arithmetic_intensity(stats),
            "n_ops": stats.n_ops,
            "profile": self.profile_name,
        }
