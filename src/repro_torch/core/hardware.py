"""Hardware constants of the port's target, for the analysis layer.

One chip: the NVIDIA H100 SXM, filled from NVIDIA's data sheet (dense
rates, no sparsity, at the full 700 W power limit). These are published
peaks, not measurements; a card set below 700 W runs slower under load.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s (tensor cores, dense)
    hbm_bw: float               # bytes/s
    hbm_bytes: int              # device memory capacity
    smem_bytes: int             # shared memory one thread block can use
    sm_count: int
    # Vector issue model (prices elementwise tile passes in the analysis
    # layer): `vpu_lanes` elements retire per cycle at `clock_hz` — on
    # Hopper the FP32 CUDA cores of all SMs at the boost clock.
    vpu_lanes: int
    clock_hz: float

    @property
    def vpu_elems_per_s(self) -> float:
        """Elementwise lanes/sec — the vector-issue roofline ceiling."""
        return self.vpu_lanes * self.clock_hz


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    smem_bytes=232_448,         # 227 KB per block (dynamic shared memory)
    sm_count=132,
    vpu_lanes=132 * 128,        # 128 FP32 lanes per SM
    clock_hz=1.98e9,
)

DEFAULT_CHIP = H100_SXM
