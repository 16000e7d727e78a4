"""The framework's elementwise hot-spots, written in the saturator DSL.

The port's own copy of :mod:`repro.kernels.tile_programs`. Every program
here is the 'sequential body' the paper optimizes: it is saturated
(Table I rules + cost model), extracted with CSE, and emitted twice — as
a Triton kernel for Hopper with bulk-load scheduling and as a saturated
torch function (the CPU path and the kernel's plain version).

These are the TPU analogues of the paper's NPB/SPEC kernel bodies: heavy
on FMA opportunities, shared subexpressions, and front-loadable loads.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import (CacheConfig, KernelProgram, SaturatorConfig,
                              ScheduleConfig, TileOp, VerifyConfig, c, exp,
                              gelu_tanh, log, make_tile_op, minimum, recip,
                              rmax, rmean, rothalf, rsqrt, rsum, silu, sqrt)

# Declared operand geometry for the analysis layer: the model hot-spots
# run on one (8, 128) vreg tile; norm gains/biases are broadcast rows,
# so a load of them moves one row of HBM, not a full tile.
TILE = (8, 128)
ROW = (1, 128)


def rmsnorm_program() -> KernelProgram:
    """y = x * rsqrt(mean(x^2) + eps) * g   (pre-norm used by all LMs here)."""
    p = KernelProgram("rmsnorm")
    x = p.array_in("x", shape=TILE)
    g = p.array_in("g", shape=ROW)   # gain: one broadcast row per tile
    p.array_out("o", shape=TILE)
    eps = p.scalar("eps")
    xv = x.load()
    inv = rsqrt(rmean(xv * xv) + eps)
    p.store("o", xv * inv * g.load())
    return p


def rmsnorm_gated_program() -> KernelProgram:
    """Mamba2 gated norm: y = rmsnorm(x * silu(z)) * g."""
    p = KernelProgram("rmsnorm_gated")
    x = p.array_in("x", shape=TILE)
    z = p.array_in("z", shape=TILE)
    g = p.array_in("g", shape=ROW)
    p.array_out("o", shape=TILE)
    eps = p.scalar("eps")
    xg = x.load() * silu(z.load())
    inv = rsqrt(rmean(xg * xg) + eps)
    p.store("o", xg * inv * g.load())
    return p


def layernorm_program() -> KernelProgram:
    """Whisper uses true LayerNorm: y = (x - mu) * rsqrt(var + eps) * g + b."""
    p = KernelProgram("layernorm")
    x = p.array_in("x", shape=TILE)
    g = p.array_in("g", shape=ROW)
    b = p.array_in("b", shape=ROW)
    p.array_out("o", shape=TILE)
    eps = p.scalar("eps")
    xv = x.load()
    mu = rmean(xv)
    xc = xv - mu
    inv = rsqrt(rmean(xc * xc) + eps)
    p.store("o", xc * inv * g.load() + b.load())
    return p


def swiglu_program() -> KernelProgram:
    """SwiGLU combine: o = silu(a) * b (a = gate proj, b = up proj)."""
    p = KernelProgram("swiglu")
    a = p.array_in("a", shape=TILE)
    b = p.array_in("b", shape=TILE)
    p.array_out("o", shape=TILE)
    p.store("o", silu(a.load()) * b.load())
    return p


def geglu_program() -> KernelProgram:
    """GELU(tanh) combine for whisper MLP: o = gelu(a) * 1 + b*0 — plain gelu."""
    p = KernelProgram("gelu")
    a = p.array_in("a")
    p.array_out("o")
    p.store("o", gelu_tanh(a.load()))
    return p


def rotary_program() -> KernelProgram:
    """RoPE application: o = q*cos + rotate_half(q)*sin — a pure FMA chain."""
    p = KernelProgram("rotary")
    q = p.array_in("q")
    cos = p.array_in("cos")
    sin = p.array_in("sin")
    p.array_out("o")
    qv = q.load()
    p.store("o", qv * cos.load() + rothalf(qv) * sin.load())
    return p


def residual_scale_program() -> KernelProgram:
    """o = x + alpha * y (residual with scale; alpha=1 folds)."""
    p = KernelProgram("residual_scale")
    x = p.array_in("x")
    y = p.array_in("y")
    p.array_out("o")
    alpha = p.scalar("alpha")
    p.store("o", x.load() + alpha * y.load())
    return p


def softmax_program() -> KernelProgram:
    """Row softmax via reciprocal-multiply (div is 100-cost, §V-B)."""
    p = KernelProgram("softmax")
    x = p.array_in("x", shape=TILE)
    p.array_out("o", shape=TILE)
    xv = x.load()
    e = exp(xv - rmax(xv))
    p.store("o", e * recip(rsum(e)))
    return p


def adamw_program() -> KernelProgram:
    """Fused AdamW update — the optimizer's hot loop, saturated.

    Inputs are precomputed scalars: inv_bc1 = 1/(1-b1^t), inv_bc2 likewise,
    so the kernel body is pure FMA + rsqrt territory.
    Outputs: new param, new m, new v.
    """
    p = KernelProgram("adamw")
    w = p.array_in("param")
    gr = p.array_in("grad")
    m = p.array_in("m")
    vv = p.array_in("v")
    p.array_out("m_out")
    p.array_out("v_out")
    p.array_out("param_out")
    lr = p.scalar("lr")
    b1 = p.scalar("b1")
    b2 = p.scalar("b2")
    eps = p.scalar("eps")
    wd = p.scalar("wd")
    inv_bc1 = p.scalar("inv_bc1")
    inv_bc2 = p.scalar("inv_bc2")
    g_ = gr.load()
    m_new = b1 * m.load() + (c(1.0) - b1) * g_
    v_new = b2 * vv.load() + (c(1.0) - b2) * g_ * g_
    p.store("m_out", m_new)
    p.store("v_out", v_new)
    mhat = m_new * inv_bc1
    vhat = v_new * inv_bc2
    wv = w.load()
    update = mhat * recip(sqrt(vhat) + eps) + wd * wv
    p.store("param_out", wv - lr * update)
    return p


def sgd_momentum_program() -> KernelProgram:
    """Fused SGD+momentum (baseline optimizer): m' = mu*m + g; w' = w - lr*m'."""
    p = KernelProgram("sgd_momentum")
    w = p.array_in("param")
    gr = p.array_in("grad")
    m = p.array_in("m")
    p.array_out("m_out")
    p.array_out("param_out")
    lr = p.scalar("lr")
    mu = p.scalar("mu")
    m_new = mu * m.load() + gr.load()
    p.store("m_out", m_new)
    p.store("param_out", w.load() - lr * m_new)
    return p


def ssd_gate_program() -> KernelProgram:
    """Mamba2 input gating: dt = softplus(dt_raw + bias); decay = exp(dt*A).

    Emits both dt (for dB·x) and the per-step decay — shares the softplus.
    """
    p = KernelProgram("ssd_gate")
    dtr = p.array_in("dt_raw")
    a = p.array_in("a_log")       # A = -exp(a_log), stored log-space
    p.array_out("dt")
    p.array_out("decay")
    bias = p.scalar("bias")
    x = dtr.load() + bias
    dt = log(c(1.0) + exp(x))  # softplus
    p.store("dt", dt)
    p.store("decay", exp(dt * (c(0.0) - exp(a.load()))))
    return p


def moe_router_program() -> KernelProgram:
    """Router logits → probabilities (softmax) with jitter-free scaling."""
    p = KernelProgram("moe_router")
    x = p.array_in("logits")
    p.array_out("probs")
    xv = x.load()
    e = exp(xv - rmax(xv))
    p.store("probs", e * recip(rsum(e)))
    return p


def l2_clip_program() -> KernelProgram:
    """Gradient scale for global-norm clipping: o = g * min(1, c/ (n + eps))."""
    p = KernelProgram("l2_clip")
    g = p.array_in("g")
    p.array_out("o")
    norm = p.scalar("norm")
    max_norm = p.scalar("max_norm")
    eps = p.scalar("eps")
    scale = minimum(c(1.0), max_norm * recip(norm + eps))
    p.store("o", g.load() * scale)
    return p


PROGRAMS: Dict[str, Callable[[], KernelProgram]] = {
    "rmsnorm": rmsnorm_program,
    "rmsnorm_gated": rmsnorm_gated_program,
    "layernorm": layernorm_program,
    "swiglu": swiglu_program,
    "gelu": geglu_program,
    "rotary": rotary_program,
    "residual_scale": residual_scale_program,
    "softmax": softmax_program,
    "adamw": adamw_program,
    "sgd_momentum": sgd_momentum_program,
    "ssd_gate": ssd_gate_program,
    "moe_router": moe_router_program,
    "l2_clip": l2_clip_program,
}


# Process-wide saturation settings for tile ops built without their own
# (set through repro_torch.kernels.ops.set_saturation_cache and
# set_saturation_verify). A cache_dir of None leaves the cache to the
# REPRO_SAT_CACHE environment variable at the pipeline level, and False
# turns it off even there (--no-cache).
_SETTINGS: Dict[str, Any] = {"cache_dir": None, "verify": None}


def get_tile_op(name: str, mode: str = "accsat",
                schedule: str = None, emitter: str = None,
                cache_dir: str = None, verify: str = None,
                device_profile: str = None) -> TileOp:
    """Build (and cache) the saturated TileOp for a named program, with
    the JAX package's ``get_tile_op`` configuration: the flat TPU-weight
    extraction model (relative op weights, so the port extracts the same
    terms as the reference) with the TPU rule set in the saturating
    modes. ``schedule`` picks the statement order of the emitted kernel
    (``"source" | "bulk" | "cost"``; None keeps the mode's default —
    bulk for accsat). Extraction stays on the flat model either way, so
    the *selected term* is identical across schedules; only the emission
    order moves. ``device_profile`` (the name or path of a profile under
    ``experiments/device_profiles_torch/``, see
    :mod:`repro_torch.analysis.calibrate`) prices the cost-driven
    schedule search with a calibrated model. ``emitter`` picks the
    kernel's form (``"triton" | "triton_pipelined"``; None = the sync
    ``"triton"``).

    ``cache_dir`` (see :mod:`repro_torch.cache`) persists the saturation
    result on disk: an exact hit in another process replays the same
    choice and statement order, so it emits the same sources whatever
    its hash seed. ``verify`` ("off" | "cheap" | "full", see
    :mod:`repro_torch.verify`) audits the build and certifies the op's
    launch plans. None takes the process-wide setting of
    ``repro_torch.kernels.ops.set_saturation_cache`` and
    ``set_saturation_verify``. One op (and one launch counter) per
    distinct configuration, however the arguments are passed."""
    if cache_dir is None:
        cache_dir = _SETTINGS["cache_dir"]
    if verify is None:
        verify = _SETTINGS["verify"]
    return _tile_op(name, mode, schedule,
                    None if emitter == "triton" else emitter,
                    cache_dir if cache_dir in (None, False)
                    else str(cache_dir),
                    None if verify in (None, "off") else verify,
                    None if device_profile is None else str(device_profile))


# The built ops, one per configuration (name, mode, schedule, emitter,
# cache_dir, verify, device_profile): what this process has built, e.g.
# for a second process to rebuild from the same cache.
_OPS: Dict[Tuple[Any, ...], TileOp] = {}
_OPS_LOCK = threading.Lock()


def _tile_op(*key) -> TileOp:
    with _OPS_LOCK:
        op = _OPS.get(key)
        if op is None:
            (name, mode, schedule, emitter, cache_dir, verify,
             device_profile) = key
            cfg = SaturatorConfig(
                mode=mode, cost_model="tpu_v5e",
                tpu_rules=(mode in ("cse_sat", "accsat")),
                schedule_cfg=ScheduleConfig(schedule=schedule,
                                            device_profile=device_profile,
                                            emitter=emitter),
                cache_cfg=CacheConfig(cache_dir=cache_dir),
                verify_cfg=VerifyConfig(verify=verify) if verify else None)
            op = _OPS[key] = make_tile_op(PROGRAMS[name](), cfg)
        return op


def built_tile_ops() -> Dict[Tuple[Any, ...], TileOp]:
    """Every op this process has built since the last ``cache_clear``,
    by its configuration ``(name, mode, schedule, emitter, cache_dir,
    verify, device_profile)``."""
    with _OPS_LOCK:
        return dict(_OPS)


# drop every built op (a simulated host restart re-saturates)
get_tile_op.cache_clear = _OPS.clear
