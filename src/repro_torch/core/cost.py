"""Cost models (paper §V-B) — thin adapters over the unified analysis
subsystem.

The operator classification lives in :mod:`repro.analysis.opstats`; the
classes here map those classes onto the paper's abstract weights, so the
flat-weight models and the roofline-calibrated extraction objective
(:class:`repro.analysis.RooflineCostModel`) can never disagree about
what an operator *is* — only about what it costs.

The paper's model: constants cost 0, each input variable or phi costs 1,
every computational operation costs 10 except division and modular
arithmetic, and each memory access, division, modular arithmetic, or
function call costs 100.

``TPUCostModel`` is the beyond-paper variant the JAX package tuned for
its TPU: transcendentals are mid-cost, fma equals one op, loads keep the
paper's 10x-over-compute ratio.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis.opstats import (CALL_OPS, FREE_OPS, INPUT_OPS,
                                    MEMORY_OPS, PHI_OPS, ROOTLIKE,
                                    SERIAL_ARITH, TRANSCENDENTALS)

from .ir import ENode

_EXPENSIVE_OPS = MEMORY_OPS | CALL_OPS | SERIAL_ARITH


class CostModel:
    """Paper cost model. Cost of one e-node, excluding children."""

    name = "paper"
    CONST = 0.0
    VAR = 1.0
    PHI = 1.0
    OP = 10.0
    EXPENSIVE = 100.0  # memory access, div, mod, call

    def node_cost(self, node: ENode) -> float:
        op = node.op
        if op in FREE_OPS:
            return self.CONST
        if op in INPUT_OPS:
            return self.VAR
        if op in PHI_OPS:
            return self.PHI
        if op in _EXPENSIVE_OPS:
            return self.EXPENSIVE
        return self.OP


class TPUCostModel(CostModel):
    """The JAX package's TPU-tuned flat weights (beyond-paper), kept as
    relative op weights so the port extracts the same terms as the
    reference: transcendentals are priced between plain ops and memory,
    memory keeps the paper's 10:1 over plain ops, and a sign flip is free
    (it folds into an FMA operand). An H100 pricing of the search is
    ROADMAP queue A item 13.
    """

    name = "tpu_v5e"
    TRANSCENDENTAL = 40.0

    def node_cost(self, node: ENode) -> float:
        op = node.op
        if op in TRANSCENDENTALS:
            return self.TRANSCENDENTAL
        if op in ROOTLIKE:
            return self.TRANSCENDENTAL / 2
        if op == "neg":
            # sign flips fold into FMA operands on the VPU/MXU — free.
            # This is what makes FMA2/FMA3 (paper Table I) strictly win
            # over sub+mul under the TPU model (they tie under the paper's).
            return 0.0
        return super().node_cost(node)


def instruction_mix(node_choice: Dict[int, ENode]) -> Dict[str, int]:
    """Instruction histogram of an extraction choice (Table IV analog)."""
    mix: Dict[str, int] = {}
    for node in node_choice.values():
        mix[node.op] = mix.get(node.op, 0) + 1
    return mix


def count_ops(node_choice: Dict[int, ENode]) -> int:
    """Executed 'instructions': everything but consts/vars/arrays/tuples."""
    skip = ("const", "var", "array", "tuple")
    return sum(1 for n in node_choice.values() if n.op not in skip)


def count_flops(node_choice: Dict[int, ENode]) -> int:
    """Arithmetic op count with fma=2 (for roofline-style accounting)."""
    flops = 0
    for n in node_choice.values():
        if n.op == "fma":
            flops += 2
        elif n.op in ("add", "sub", "mul", "div", "neg", "min", "max",
                      "square", "recip"):
            flops += 1
        elif n.op in ("exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid",
                      "pow"):
            flops += 8  # polynomial-expansion estimate
    return flops
