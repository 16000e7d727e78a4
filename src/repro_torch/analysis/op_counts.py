"""The op counter's side of the unified analysis subsystem: the port of
:mod:`repro.analysis.hlo`.

Bridges the op counter's run of a step on ``meta`` tensors
(:mod:`repro_torch.roofline.op_analysis`) into the same :class:`OpStats`
/ :class:`LatencyModel` currency the e-graph extractor prices terms
with, so predicted and measured throughput can be tracked in one unit
system from a single tile body up to a whole training step.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.roofline.op_analysis import OpReport, count_ops

from .latency import LatencyModel
from .opstats import OpStats


def stats_from_report(rep: OpReport) -> OpStats:
    """Collapse a count into OpStats (the traffic model counts reads and
    writes together, so it all lands in ``bytes_read``)."""
    return OpStats(mxu_flops=rep.dot_flops, bytes_read=rep.hbm_bytes)


def stats_from_fn(fn, *args, n_devices: int = 1, **kwargs) -> OpStats:
    """OpStats of one call of ``fn`` on ``meta`` arguments (the
    reference's ``stats_from_hlo``)."""
    return stats_from_report(count_ops(fn, *args, n_devices=n_devices,
                                       **kwargs))


def latency_from_fn(fn, *args, chip: ChipSpec = DEFAULT_CHIP,
                    n_devices: int = 1, **kwargs) -> Dict[str, Any]:
    """Three-term roofline of one call of ``fn`` on ``meta`` arguments in
    the unified ns units (the reference's ``latency_from_hlo``)."""
    rep = count_ops(fn, *args, n_devices=n_devices, **kwargs)
    stats = stats_from_report(rep)
    out = LatencyModel(chip).report(stats)
    out["collective_ns"] = (rep.collective_wire_bytes / chip.link_bw * 1e9
                            if rep.collective_wire_bytes else 0.0)
    out["latency_ns"] = max(out["latency_ns"], out["collective_ns"])
    if out["collective_ns"] >= max(out["compute_ns"], out["memory_ns"]):
        out["bound"] = "collective"
    out["trip_counts"] = list(rep.trip_counts)
    return out
