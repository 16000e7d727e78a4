"""Operation statistics and the roofline extraction objective.

The port's copy of :mod:`repro.analysis`, limited to what the
saturator's search needs: per-node FLOP/byte/pass statistics
(:mod:`.opstats`), the latency model over the chip peaks
(:mod:`.latency`), and the extraction objective (:mod:`.cost_model`);
calibration of that model against measured kernel times
(:mod:`.calibrate`); the op counter's bridge into those units
(:mod:`.op_counts`, the reference's HLO bridge); the verifier's grid
analysis is :mod:`.access`.
"""
from .opstats import (DTYPE_BYTES, TILE_ELEMS, TILE_SHAPE, ArrayInfo,
                      OpStats, dtype_byte_width, node_stats, op_pass_class,
                      store_stats)
from .latency import LatencyModel, ScheduleEvent
from .cost_model import RooflineCostModel
from .op_counts import latency_from_fn, stats_from_fn, stats_from_report
from .calibrate import (DEFAULT_PARAMS, SPEARMAN_FLOOR, CalibrationError,
                        CalibrationParams, DeviceProfile, KernelFeatures,
                        check_profile, evaluate_params, fit_params,
                        fit_profile, kernel_features, load_profile, mape_pct,
                        predict_ns, schedule_paired_pct, spearman)

__all__ = [
    "OpStats", "node_stats", "op_pass_class", "store_stats",
    "TILE_ELEMS", "TILE_SHAPE", "DTYPE_BYTES",
    "ArrayInfo", "dtype_byte_width",
    "LatencyModel", "ScheduleEvent", "RooflineCostModel",
    "latency_from_fn", "stats_from_fn", "stats_from_report",
    "DEFAULT_PARAMS", "SPEARMAN_FLOOR",
    "CalibrationError", "CalibrationParams", "DeviceProfile",
    "KernelFeatures", "check_profile", "evaluate_params", "fit_params",
    "fit_profile", "kernel_features", "load_profile", "mape_pct",
    "predict_ns", "schedule_paired_pct", "spearman",
]
