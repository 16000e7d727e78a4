"""Roofline-calibrated extraction cost model.

The extractor minimizes *predicted latency* of the whole selected term,
not a sum of abstract per-op weights. Two hooks drive it:

* ``node_cost`` — additive surrogate (compute_ns + memory_ns of one
  node). Used by the bottom-up tree fixed point to seed a valid
  selection; since ``max(Σc, Σm) + s·min ≤ Σ(c+m)``, the surrogate upper-
  bounds the true objective, so seeding with it is sound.
* ``aggregate_cost`` — the real objective: roofline latency of the summed
  statistics of all chosen nodes (shared e-classes counted once). The
  DAG evaluator, beam search, and hill-climb polish in
  :mod:`repro.core.extract` call this when present.

Costs are shape/dtype-aware when the model is *bound to an e-graph*
(``bind_egraph`` — done automatically by ``extract_dag``): a ``load``
node resolves its array operand's :class:`ArrayInfo` through the e-class
analysis, so a broadcast scalar is priced at one element, a row at one
row, and bf16/f8 arrays at half/quarter f32 HBM bytes. Unbound models
keep the full-f32-tile pricing.

Models may additionally be *calibrated*: constructing with
``profile=<DeviceProfile | name | path>`` (see
:mod:`repro.analysis.calibrate`) swaps in a measured
:class:`LatencyModel` — fitted per-bound overlap slack, HBM efficiency,
launch overhead — and scales every node's VPU passes by its op-class's
fitted coefficient, so beam/hill-climb extraction minimizes the
calibrated objective rather than the analytic guess.

Duck-typed against :class:`repro.core.cost.CostModel` (same ``node_cost``
signature) so every existing call site keeps working.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterable, Optional

from .latency import LatencyModel, _default_chip
from .opstats import (TILE_ELEMS, ArrayInfo, OpStats, dtype_byte_width,
                      node_stats, op_pass_class)

if TYPE_CHECKING:
    from repro_torch.core.egraph import EGraph
    from repro_torch.core.hardware import ChipSpec
    from repro_torch.core.ir import ENode


class RooflineCostModel:
    """Extraction objective = roofline-predicted latency (ns)."""

    name = "roofline"

    def __init__(self, chip: Optional["ChipSpec"] = None, *,
                 tile_elems: int = TILE_ELEMS,
                 dtype: Optional[str] = None,
                 dtype_bytes: Optional[int] = None,
                 latency: Optional[LatencyModel] = None,
                 profile=None,
                 egraph: Optional["EGraph"] = None):
        self.chip = chip if chip is not None else _default_chip()
        self.tile_elems = tile_elems
        self.dtype = dtype or "f32"
        self.dtype_bytes = (dtype_bytes if dtype_bytes is not None
                            else dtype_byte_width(self.dtype))
        # the MXU roof scales with the kernel's operand width (only
        # matters for terms carrying mxu_flops, i.e. the HLO bridge —
        # e-graph tile terms are pure VPU); an explicit `latency`
        # override keeps whatever the caller configured, and a device
        # profile swaps in the calibrated model fitted to measured times
        if latency is not None:
            self.latency = latency
        elif profile is not None:
            self.latency = LatencyModel.from_profile(
                profile, chip=chip, mxu_dtype=self.dtype)
            # one tile size / chip for both axes: node pricing
            # (bytes/flops) must use the same tile_elems the calibrated
            # compute roof uses, and chip=None resolves to the
            # profile's fitted model_chip — or the objective mixes units
            self.tile_elems = self.latency.tile_elems
            self.chip = self.latency.chip
        else:
            self.latency = LatencyModel(self.chip, tile_elems=tile_elems,
                                        mxu_dtype=self.dtype)
        # fitted per-op-class VPU pass multipliers (calibration); applied
        # at node-pricing time so every aggregate downstream — beam
        # Evaluator fast path included — sees coefficient-weighted passes
        self._pass_coeffs = dict(self.latency.pass_coeffs or {})
        self._node_cache: Dict["ENode", OpStats] = {}
        self._eg: Optional["EGraph"] = None
        self._eg_version: Optional[int] = None
        if egraph is not None:
            self.bind_egraph(egraph)

    # -- e-graph binding (shape/dtype resolution) -----------------------------
    def bind_egraph(self, eg: Optional["EGraph"]) -> "RooflineCostModel":
        """Attach the e-graph whose array table prices load operands.

        Cached node statistics depend on the bound graph's analysis
        data, so the cache is cleared when the graph changes — or when
        the same graph's array table was re-declared since the last
        bind (tracked via ``EGraph.ainfo_version``).
        """
        version = getattr(eg, "ainfo_version", None)
        if eg is not self._eg or version != self._eg_version:
            self._eg = eg
            self._eg_version = version
            self._node_cache.clear()
        return self

    def _load_info(self, node: "ENode") -> Optional[ArrayInfo]:
        """ArrayInfo of the operand a ``load`` node actually moves."""
        if self._eg is None:
            return None
        return self._eg.load_operand_info(node)

    # -- per-node statistics --------------------------------------------------
    def node_stats(self, node: ENode) -> OpStats:
        st = self._node_cache.get(node)
        if st is None:
            info = self._load_info(node) if node.op == "load" else None
            if info is not None:
                # declared array: honor its dtype always, its extent when
                # a shape was declared (ArrayInfo falls back to a full
                # tile for unknown/symbolic shapes)
                st = node_stats(node, tile_elems=self.tile_elems,
                                dtype_bytes=info.byte_width, info=info)
            else:
                st = node_stats(node, tile_elems=self.tile_elems,
                                dtype_bytes=self.dtype_bytes)
            if self._pass_coeffs:
                if st.vpu_passes:
                    k = self._pass_coeffs.get(op_pass_class(node.op), 1.0)
                    if k != 1.0:
                        st = dataclasses.replace(
                            st, vpu_passes=st.vpu_passes * k)
                elif node.op == "load":
                    # calibrated per-load dispatch cost (serial issue
                    # slot, not bandwidth) — 0 in the analytic model
                    k = self._pass_coeffs.get("memory_dispatch", 0.0)
                    if k:
                        st = dataclasses.replace(st, vpu_passes=k)
            self._node_cache[node] = st
        return st

    def choice_stats(self, nodes: Iterable[ENode]) -> OpStats:
        # hot path for beam search: accumulate into floats and build ONE
        # OpStats instead of allocating a dataclass per node
        flops = mxu = br = bw = passes = 0.0
        n_ops = 0
        cache = self._node_cache
        for n in nodes:
            st = cache.get(n)
            if st is None:
                st = self.node_stats(n)
            flops += st.flops
            mxu += st.mxu_flops
            br += st.bytes_read
            bw += st.bytes_written
            passes += st.vpu_passes
            n_ops += st.n_ops
        return OpStats(flops=flops, mxu_flops=mxu, bytes_read=br,
                       bytes_written=bw, vpu_passes=passes, n_ops=n_ops)

    # -- extraction hooks -----------------------------------------------------
    def node_cost(self, node: ENode) -> float:
        st = self.node_stats(node)
        return self.latency.compute_ns(st) + self.latency.memory_ns(st)

    def aggregate_cost(self, nodes: Iterable[ENode]) -> float:
        return self.latency.latency_ns(self.choice_stats(nodes))

    # -- reporting ------------------------------------------------------------
    def report(self, nodes: Iterable[ENode]) -> Dict[str, float]:
        return self.latency.report(self.choice_stats(nodes))
