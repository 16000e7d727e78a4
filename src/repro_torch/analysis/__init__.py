"""Operation statistics and the roofline extraction objective.

The port's copy of :mod:`repro.analysis`, limited to what the
saturator's search needs: per-node FLOP/byte/pass statistics
(:mod:`.opstats`), the latency model over the chip peaks
(:mod:`.latency`), and the extraction objective (:mod:`.cost_model`);
the verifier's grid analysis is :mod:`.access`. The HLO bridge and
calibration are not ported (ROADMAP queue A).
"""
from .opstats import (DTYPE_BYTES, TILE_ELEMS, TILE_SHAPE, ArrayInfo,
                      OpStats, dtype_byte_width, node_stats, op_pass_class,
                      store_stats)
from .latency import LatencyModel, ScheduleEvent
from .cost_model import RooflineCostModel

__all__ = [
    "OpStats", "node_stats", "op_pass_class", "store_stats",
    "TILE_ELEMS", "TILE_SHAPE", "DTYPE_BYTES",
    "ArrayInfo", "dtype_byte_width",
    "LatencyModel", "ScheduleEvent", "RooflineCostModel",
]
