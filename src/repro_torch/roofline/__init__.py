"""The roofline of a step, counted without running it: the port of
:mod:`repro.roofline`. :mod:`.op_analysis` counts a step run on ``meta``
tensors (the counterpart of the reference's HLO walk),
:mod:`.kernel_work` each hand-written kernel's own work, :mod:`.report`
the three terms."""
from .op_analysis import OpCounter, OpReport, count_ops
from .report import RooflineTerms, model_flops_for, roofline_from_counts

__all__ = ["OpCounter", "OpReport", "count_ops", "RooflineTerms",
           "model_flops_for", "roofline_from_counts"]
