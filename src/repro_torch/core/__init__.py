# The paper's contribution, equality saturation of tile programs, as
# the port runs it: DSL -> SSA -> e-graph -> extraction -> schedule ->
# torch source (the plain version) and Triton kernels (Hopper).
from repro_torch.analysis import (LatencyModel, OpStats, RooflineCostModel,
                                  node_stats)
from .beam import BeamStats, beam_search
from .cost import (CostModel, TPUCostModel, count_flops, count_ops,
                   instruction_mix)
from .dsl import (ArrayHandle, Expr, KernelProgram, c, call, exp, fma,
                  gelu_tanh, log, maximum, minimum, recip, rmax, rmean,
                  rothalf, rsqrt, rsum, select, sigmoid, silu, softplus,
                  sqrt, square, tanh, toint, v)
from .egraph import EGraph, P, Pattern, PatVar, V, add_expr
from .emit import EMITTER_NAMES, Emitter, EmitterInfo, get_emitter
from .extract import (ExtractionResult, extract_dag, extract_exact,
                      optimality_gap)
from .fx_bridge import BridgeUnsupported, maybe_saturate, saturate_torch_fn
from .ir import ENode
from .pipeline import (CACHE_ENV_VAR, MODES, VERIFY_ENV_VAR, CacheConfig,
                       SaturatedKernel, SaturatorConfig, ScheduleConfig,
                       SearchConfig, VerifyConfig, saturate_all_modes,
                       saturate_program)
from .reference import run_reference
from .rules import EXTENDED_RULES, PAPER_RULES, TPU_RULES, Rule, run_rules
from .schedule import (SCHEDULE_MODES, ScheduleResult, compute_schedule,
                       is_legal_order, random_topological_order)
from .ssa import SSAResult, build_ssa
from .telemetry import SaturationTelemetry, reset_telemetry, telemetry
from .tritongen import TileOp, make_tile_op

__all__ = [
    "CACHE_ENV_VAR", "SaturationTelemetry", "reset_telemetry", "telemetry",
    "LatencyModel", "OpStats", "RooflineCostModel", "node_stats",
    "CostModel", "TPUCostModel", "count_flops", "count_ops",
    "instruction_mix", "ArrayHandle", "Expr", "KernelProgram", "EGraph",
    "ENode", "ExtractionResult", "extract_dag", "extract_exact",
    "BeamStats", "beam_search", "optimality_gap",
    "BridgeUnsupported", "maybe_saturate", "saturate_torch_fn",
    "EMITTER_NAMES", "Emitter", "EmitterInfo", "get_emitter",
    "TileOp", "make_tile_op", "MODES", "VERIFY_ENV_VAR",
    "SearchConfig", "ScheduleConfig", "CacheConfig", "VerifyConfig",
    "SaturatedKernel", "SaturatorConfig", "saturate_all_modes",
    "saturate_program", "run_reference", "PAPER_RULES", "EXTENDED_RULES",
    "TPU_RULES", "Rule", "run_rules", "build_ssa", "SSAResult",
    "add_expr", "P", "V", "Pattern", "PatVar", "toint",
    "SCHEDULE_MODES", "ScheduleResult", "compute_schedule",
    "is_legal_order", "random_topological_order",
    "c", "call", "exp", "fma", "gelu_tanh", "log", "maximum", "minimum",
    "recip", "rmax", "rmean", "rothalf", "rsqrt", "rsum", "select",
    "sigmoid", "silu", "softplus", "sqrt", "square", "tanh", "v",
]
