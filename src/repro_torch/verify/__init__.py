"""repro_torch.verify — static soundness & legality analysis.

The port of the JAX package's ``repro.verify``. Five passes over the
saturator's artifacts, each reporting severity-tagged
:class:`Finding`\\ s:

1. **rules** (:mod:`.rules_check`) — structural lint + random/bf16/
   adversarial differential validation that every rewrite rule is an
   actual equality;
2. **egraph** (:mod:`.egraph_check`) — union-find, hashcons/congruence
   closure and analysis-consistency invariants
   (= ``EGraph.check_invariants()``);
3. **schedule** (:mod:`.schedule_check`) — an independent re-derivation
   of RAW/WAR/store-store dependences certifying emitted statement
   orders as legal topological orders, and the persistent walks of the
   pipelined Triton kernels;
4. **codegen** (:mod:`.codegen_check`) — AST analysis of the emitted
   torch source (bounds, use-before-def, overwritten stores, dead loads,
   overlap-distance lint) and of each rendered Triton source (masks on
   ragged tails, neutral fills of reductions, offset widths,
   use-before-def);
5. **grid** (:mod:`.grid_check`) — certification of the launch plans
   themselves: the Triton tile plans and the CUDA kernels' grids and
   work lists are proven coverage-complete, write-disjoint, in bounds,
   inside CUDA's grid limits and the H100's register and shared-memory
   budgets.

``SaturatorConfig(verify="cheap"|"full")`` runs 2–4 on every pipeline
product (``"full"`` also re-validates the active rule set and certifies
reconstructed orders for the named schedules); ``make_tile_op`` adds
:func:`verify_triton_kernel` and :func:`verify_tile_op` when the op is
built, and the op certifies each new launch layout the first time it
compiles it. Findings are counted in ``repro_torch.core.telemetry``.
"""
from __future__ import annotations

from typing import Optional

from .codegen_check import check_generated, check_triton_source, shapes_of
from .egraph_check import check_egraph
from .findings import (PASS_CODEGEN, PASS_EGRAPH, PASS_GRID, PASS_RULES,
                       PASS_SCHEDULE, SEVERITIES, Finding, VerifyReport)
from .grid_check import (GridCheckResult, check_compiled,
                         check_flash_bwd_work, check_grid, check_tile_op,
                         check_tile_plan, flash_attention_model,
                         ssd_scan_models, tile_call_model)
from .rules_check import RuleRecord, RulesCheckResult, verify_rules
from .schedule_check import (ScheduleCheckResult, verify_persistent_walk,
                             verify_schedule, walk_blocks)

VERIFY_LEVELS = ("off", "cheap", "full")

__all__ = [
    "Finding", "VerifyReport", "SEVERITIES", "VERIFY_LEVELS",
    "PASS_RULES", "PASS_EGRAPH", "PASS_SCHEDULE", "PASS_CODEGEN",
    "PASS_GRID",
    "verify_rules", "RulesCheckResult", "RuleRecord",
    "check_egraph", "verify_schedule", "ScheduleCheckResult",
    "verify_persistent_walk", "walk_blocks",
    "check_generated", "check_triton_source", "shapes_of",
    "check_grid", "check_tile_op", "check_tile_plan", "tile_call_model",
    "GridCheckResult", "check_compiled", "check_flash_bwd_work",
    "flash_attention_model", "ssd_scan_models",
    "verify_saturated", "verify_triton_kernel", "verify_tile_op",
    "verify_tile_layout", "record",
]


def record(rep: VerifyReport) -> VerifyReport:
    """Fold ``rep`` into the process telemetry and return it."""
    from repro_torch.core.telemetry import telemetry
    telemetry().record_verify(rep)
    return rep


def verify_saturated(sk, level: Optional[str] = None) -> VerifyReport:
    """Run the static passes over one pipeline product.

    ``level`` defaults to ``sk.config.verify``. ``"cheap"`` checks the
    e-graph, certifies the schedule actually attached to the generated
    kernel, and lints the emitted torch source; ``"full"`` additionally
    re-validates the active rule set differentially and reconstructs a
    searchless schedule for the named (source/bulk) orders so those
    orders are certified too. Findings are recorded in the process
    telemetry; the report is also attached to ``sk.verify_report`` by
    the pipeline."""
    level = sk.config.verify if level is None else level
    if level not in VERIFY_LEVELS:
        raise ValueError(f"verify level must be one of {VERIFY_LEVELS}, "
                         f"got {level!r}")
    rep = VerifyReport()
    if level == "off":
        return rep

    # pass 2: e-graph invariants (post run_rules / post graft)
    rep.extend(check_egraph(sk.ssa.egraph))
    rep.egraphs_checked += 1

    # pass 3: schedule legality (explicit orders always; at "full",
    # named implicit emissions get a searchless reconstruction so the
    # certified order is exactly what a cache entry would replay)
    sched = sk.kernel.schedule
    if sched is None and level == "full":
        from repro_torch.core.pipeline import _schedule_cm
        from repro_torch.core.schedule import compute_schedule
        try:
            sched = compute_schedule(
                sk.ssa, dict(sk.extraction.choice),
                mode=sk.config.schedule_mode,
                cost_model=_schedule_cm(sk.config, sk.ssa.prog,
                                        sk.ssa.egraph),
                move_budget=0)
        except ValueError as e:
            rep.add(Finding(
                PASS_SCHEDULE, "error", "unschedulable",
                f"no legal order could be reconstructed: {e}"))
    if sched is not None:
        scr = verify_schedule(sk.ssa, sk.extraction.choice, sched)
        rep.extend(scr.findings)
        rep.schedules_certified += scr.regions_certified

    # pass 4: emitted-source analysis
    rep.extend(check_generated(sk.kernel.source, shapes_of(sk.ssa.prog),
                               subject=sk.kernel.name))
    rep.sources_checked += 1

    # pass 1 (full only — rule sets don't change per kernel)
    if level == "full":
        rres = verify_rules(sk.config.rules())
        rep.extend(rres.findings)
        rep.rules_checked += rres.rules_checked
    return record(rep)


def verify_triton_kernel(tk, layout, sk=None) -> VerifyReport:
    """Certify one emitted :class:`~repro_torch.core.tritongen.TritonKernel`
    in one launch layout (the counterpart of the JAX package's
    ``verify_pallas_kernel``): its source for that layout, the pipelined
    kernel's sync twin in the same layout (which walks no blocks), and,
    given the pipeline product ``sk``, the explicit schedule its loads
    follow."""
    rep = VerifyReport()
    for k in [tk] + ([tk.twin] if tk.twin is not None else []):
        lay = tuple(layout) if k is tk else \
            (layout[0], layout[1], False, layout[3])
        rep.extend(check_triton_source(
            k.render(*lay), lay,
            subject=k.kernel_name + ("" if k is tk else ":twin")))
        rep.sources_checked += 1
    if sk is not None and tk.schedule is not None:
        scr = verify_schedule(sk.ssa, sk.extraction.choice, tk.schedule)
        rep.extend(scr.findings)
        rep.schedules_certified += scr.regions_certified
    return record(rep)


def verify_tile_op(op, rows: Optional[int] = None,
                   d: Optional[int] = None) -> VerifyReport:
    """Certify one :class:`~repro_torch.core.tritongen.TileOp` when it is
    built: its launch plan at a synthetic ragged geometry
    (:func:`check_tile_op`: coverage, write disjointness, bounds, grid
    limits, offsets, walks, register fit), its Triton source in that
    plan's layout and the schedule the source follows. Wired into
    ``make_tile_op`` for every ``verify`` level above ``"off"``."""
    res, plan = check_tile_op(op, rows=rows, d=d)
    return _plan_and_source(op, res, plan, op.sk)


def verify_tile_layout(op, plan, in_shapes) -> VerifyReport:
    """Certify one launch layout of a tile op the first time the op
    compiles it: the plan at the call's own shapes, and the source
    rendered for it."""
    res = check_tile_plan(op.tk, plan, in_shapes, name=op.name)
    return _plan_and_source(op, res, plan)


def _plan_and_source(op, res, plan, sk=None) -> VerifyReport:
    rep = VerifyReport()
    rep.extend(res.findings)
    rep.grids_checked += res.grids_checked
    record(rep)
    rep.merge(verify_triton_kernel(op.tk, plan.layout, sk))
    return rep
