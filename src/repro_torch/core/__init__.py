# The paper's contribution, equality saturation of tile programs, as
# the port runs it: DSL -> SSA -> e-graph -> extraction -> schedule ->
# torch source (the plain version) and Triton kernels (Hopper).
from .dsl import (ArrayHandle, Expr, KernelProgram, c, call, exp, fma,
                  gelu_tanh, log, maximum, minimum, recip, rmax, rmean,
                  rothalf, rsqrt, rsum, select, sigmoid, silu, softplus,
                  sqrt, square, tanh, toint, v)
from .fx_bridge import BridgeUnsupported, maybe_saturate, saturate_torch_fn
from .pipeline import (CACHE_ENV_VAR, EMITTER_NAMES, MODES, VERIFY_ENV_VAR,
                       CacheConfig, SaturatedKernel, SaturatorConfig,
                       ScheduleConfig, SearchConfig, VerifyConfig,
                       saturate_all_modes, saturate_program)
from .reference import run_reference
from .telemetry import SaturationTelemetry, reset_telemetry, telemetry
from .tritongen import TileOp, make_tile_op

__all__ = [
    "ArrayHandle", "Expr", "KernelProgram", "c", "call", "exp", "fma",
    "gelu_tanh", "log", "maximum", "minimum", "recip", "rmax", "rmean",
    "rothalf", "rsqrt", "rsum", "select", "sigmoid", "silu", "softplus",
    "sqrt", "square", "tanh", "toint", "v", "CACHE_ENV_VAR",
    "EMITTER_NAMES", "MODES", "VERIFY_ENV_VAR",
    "CacheConfig", "SaturatedKernel", "SaturatorConfig", "ScheduleConfig",
    "SearchConfig", "VerifyConfig", "saturate_all_modes",
    "saturate_program", "run_reference",
    "SaturationTelemetry", "reset_telemetry", "telemetry", "TileOp",
    "make_tile_op", "BridgeUnsupported", "maybe_saturate",
    "saturate_torch_fn",
]
