"""Three-term roofline report from a counted dry run: the port of
:mod:`repro.roofline.report`.

  compute    = FLOPs / (peak FLOP/s)          [per chip]
  memory     = HBM bytes / HBM bandwidth
  collective = wire bytes / link bandwidth

FLOPs and bytes come from the op counter's run of the step on ``meta``
tensors (:mod:`repro_torch.roofline.op_analysis`), each hand-written
kernel counted by its own work (:mod:`repro_torch.roofline.kernel_work`).
The chip is the port's :class:`~repro_torch.core.hardware.ChipSpec`
(the H100 SXM data sheet's peaks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.core.hardware import DEFAULT_CHIP, ChipSpec

from .op_analysis import OpReport


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    wire_bytes: float
    # seconds
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # model-level accounting
    model_flops: float            # 6·N_active·tokens (train) / 2·N·tokens
    useful_ratio: float           # model_flops / (flops × devices)
    step_time_s: float            # max of the three terms (no overlap)
    roofline_frac: float          # compute_s / step_time_s
    # memory fit
    bytes_per_device: int = 0
    fits_hbm: bool = True
    # the reference's raw XLA numbers: eager torch has no compiler's
    # count, so 0
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    trip_counts: tuple = ()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["trip_counts"] = list(self.trip_counts)[:12]
        return d


def roofline_from_counts(rep: OpReport, *, arch: str, shape: str,
                         mesh_name: str, n_devices: int,
                         model_flops_global: float,
                         bytes_per_device: int = 0,
                         chip: ChipSpec = DEFAULT_CHIP) -> RooflineTerms:
    """The counterpart of the reference's ``roofline_from_compiled``: the
    three terms of a counted step over ``chip``'s rates.
    ``bytes_per_device`` is the step's memory (arguments, the peak of
    temporaries and the outputs that alias no argument), held against
    the chip's HBM."""
    compute_s = rep.dot_flops / chip.peak_flops_bf16
    memory_s = rep.hbm_bytes / chip.hbm_bw
    collective_s = (rep.collective_wire_bytes / chip.link_bw
                    if rep.collective_wire_bytes else 0.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(compute_s, memory_s, collective_s)
    model_flops_dev = model_flops_global / max(n_devices, 1)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops=rep.dot_flops, hbm_bytes=rep.hbm_bytes,
        wire_bytes=rep.collective_wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_global,
        useful_ratio=(model_flops_dev / rep.dot_flops
                      if rep.dot_flops else 0.0),
        step_time_s=step,
        roofline_frac=(model_flops_dev / chip.peak_flops_bf16) / step
        if step > 0 else 0.0,
        bytes_per_device=bytes_per_device,
        fits_hbm=bytes_per_device <= chip.hbm_bytes,
        collective_breakdown=dict(rep.collective_breakdown),
        trip_counts=tuple(rep.trip_counts),
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D_tokens for training, 2·N_active·tokens for
    one decode step, 2·N_active·tokens for prefill."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence (+ attention over the cache, excluded
    # from the 2ND model-flops convention)
    return 2.0 * n_act * shape.global_batch
