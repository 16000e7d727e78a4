"""Public kernel API — wrappers dispatching per implementation.

The port of :mod:`repro.kernels.ops`. Every op has three
implementations:

  * ``triton`` — the generated Triton tile kernels of
                 :mod:`repro_torch.core.tritongen` and the hand-written CUDA
                 flash-attention and SSD-scan kernels;
  * ``torch``  — the *saturated generated torch code* (the paper's
                 optimized output as plain torch; each kernel's plain
                 version), masked f32 softmax attention and the chunked
                 torch SSD scan;
  * ``ref``    — the independent oracles in :mod:`repro_torch.kernels.ref`.

Default: ``triton`` for CUDA tensors, ``torch`` for CPU tensors. On
``meta`` tensors (the dry run, :mod:`repro_torch.roofline`) the
``triton`` path runs and each kernel records its work in place of a
launch.
``set_impl(...)`` overrides globally (the tests and chip_smoke.py's
parity phase use it). ``set_tile_emitter(...)`` picks the form of the
tile kernels the ``triton`` implementation launches: the sync kernels
(default) or their persistent, pipelined form.

DTensor arguments (the multi-device layer, :mod:`repro_torch.parallel`)
run each op on this rank's shards in a ``local_map`` region
(:func:`on_shards`), placed as the reference's constraints place the
op's operands: the same kernel launches on the local tensors.

No fallback on the card: on CUDA (and ``meta``) tensors an op runs what
it was asked to run and raises if that fails. The runtime floor of the
JAX package (catch, fall back to the oracle, count a runtime fallback,
trip the breaker) applies to CPU tensors only.

Gradients. On CPU tensors autograd differentiates the saturated torch
code (``torch_ref``) directly, as JAX differentiates ``jax_ref``. Under
the ``triton`` implementation (CUDA tensors) that want a gradient,
every tile op on a model's path launches its kernel through a
``torch.autograd.Function``: rotary's backward is the same kernel with
``-sin`` (exact: both RoPE tables repeat their first half), the others'
are the analytic derivatives in f32 torch (:func:`rmsnorm_backward`,
:func:`rmsnorm_gated_backward`, :func:`layernorm_backward`,
:func:`swiglu_backward`, :func:`gelu_backward`,
:func:`moe_router_backward`; the JAX package's gradient of these ops is
XLA's autodiff of ``jax_ref``, no kernel either). The ops on no model's
path take gradients the same way: ``residual_scale`` (``dy``, ``alpha
dy``), ``softmax`` (the router's backward) and ``ssd_gate``
(:func:`ssd_gate_backward`). The SSD scan's
gradient is its backward kernel (``_SsdFn``: the forward kernel keeps
the state entering each chunk, :func:`ssd_scan_bwd` reads it).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.telemetry import telemetry
from repro_torch.runtime.guard import breaker_for

from . import ref as _ref
from . import tile_programs as _tp
from .flash_attention import decode_attention, flash_attention
from .ssd_scan import (ssd_decode_step, ssd_scan, ssd_scan_bwd,
                       ssd_scan_plain, ssd_scan_with_states)
from .tile_programs import get_tile_op

IMPLS = ("triton", "torch", "ref")
TILE_EMITTERS = ("triton", "triton_pipelined")
_IMPL: Optional[str] = None  # None = auto
_TILE_EMITTER: Optional[str] = None  # None = "triton"

# runtime degradation floor on CPU tensors: the named oracle each tile op
# falls back to when building or applying the saturated op fails (the
# ops the model families and the optimizer call)
_REF_FNS: dict = {"rmsnorm": _ref.rmsnorm_ref,
                  "rmsnorm_gated": _ref.rmsnorm_gated_ref,
                  "layernorm": _ref.layernorm_ref,
                  "swiglu": _ref.swiglu_ref,
                  "gelu": _ref.gelu_ref,
                  "moe_router": _ref.softmax_ref,
                  "residual_scale": _ref.residual_scale_ref,
                  "softmax": _ref.softmax_ref,
                  "ssd_gate": _ref.ssd_gate_ref,
                  "adamw": _ref.adamw_ref,
                  "l2_clip": _ref.l2_clip_ref}


def set_impl(impl: Optional[str]):
    """impl in {None/'auto', 'triton', 'torch', 'ref'}."""
    global _IMPL
    if impl not in (None, "auto") + IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None/'auto', "
                         f"got {impl!r}")
    _IMPL = None if impl == "auto" else impl


def set_saturation_cache(path):
    """Point every tile op built after this call at a persistent
    saturation cache directory (:mod:`repro_torch.cache`): saturation
    results are replayed from disk instead of re-searched per process,
    and a replay emits the same kernel sources in any process. None
    leaves the cache to the ``REPRO_SAT_CACHE`` environment variable
    (the default); False turns it off even there (``--no-cache``). The
    launch entry points call this at startup."""
    _tp._SETTINGS["cache_dir"] = path if path in (None, False) \
        else str(path)


def current_saturation_cache():
    return _tp._SETTINGS["cache_dir"]


def set_saturation_verify(level: Optional[str]):
    """Static-verification level ("off" | "cheap" | "full", see
    :mod:`repro_torch.verify`) applied to every tile op built after this
    call. The launch entry points resolve --verify / REPRO_VERIFY through
    ``SaturatorConfig.from_env`` and pass the result here; None/"off"
    adds no work (the default)."""
    if level not in (None, "off", "cheap", "full"):
        raise ValueError(f"verify must be None, 'off', 'cheap' or 'full', "
                         f"got {level!r}")
    _tp._SETTINGS["verify"] = None if level in (None, "off") else level


def current_saturation_verify() -> Optional[str]:
    return _tp._SETTINGS["verify"]


def set_tile_emitter(emitter: Optional[str]):
    """emitter in {None, 'triton', 'triton_pipelined'}: the tile kernels
    launched on CUDA tensors (their plain versions are the same)."""
    global _TILE_EMITTER
    if emitter not in (None,) + TILE_EMITTERS:
        raise ValueError(f"emitter must be one of {TILE_EMITTERS} or None, "
                         f"got {emitter!r}")
    _TILE_EMITTER = emitter


def _kernel_op(name: str):
    return get_tile_op(name, emitter=_TILE_EMITTER)


def current_impl(x) -> str:
    """The implementation an op on tensor ``x`` runs: ``triton`` on any
    tensor but a CPU one (on ``meta``, the kernels' paths, whose work the
    op counter records)."""
    if _IMPL is not None:
        return _IMPL
    return "torch" if x.device.type == "cpu" else "triton"


def _guarded(name: str, x, optimized: Callable, reference: Callable):
    """CPU tensors: run the optimized path under the runtime floor — a
    failure falls back to the named oracle, and a per-kernel circuit
    breaker skips the optimized attempt after repeated failures. CUDA
    and ``meta`` tensors: run it, and let a failure raise."""
    if x.device.type != "cpu":
        return optimized()
    br = breaker_for(("apply", name))
    if br.admit() is not None:
        telemetry().record_runtime_fallback(name, "breaker_open")
        return reference()
    try:
        out = optimized()
    except Exception as e:  # CPU ladder floor: degrade, never raise
        br.record_failure(fallback_level="ref")
        telemetry().record_runtime_fallback(name, type(e).__name__)
        return reference()
    br.record_success()
    return out


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _tile(name: str, *arrays, out_dtype=None, **scalars):
    """The tile op on ``arrays``, its outputs in the lead's dtype or in
    ``out_dtype``: the kernel then reads each operand in its own dtype,
    and the plain versions run on the operands cast to ``out_dtype``."""
    x = arrays[0]
    impl = current_impl(x)

    def plain(fn):
        args = arrays if out_dtype is None else \
            [a.to(out_dtype) for a in arrays]
        return fn(*args, **scalars)

    ref_fn = _REF_FNS[name]
    if impl == "ref":
        return plain(ref_fn)
    if impl == "triton":
        return _guarded(name, x,
                        lambda: _kernel_op(name).apply(
                            *arrays, out_dtype=out_dtype, **scalars),
                        lambda: plain(ref_fn))
    return _guarded(name, x, lambda: plain(get_tile_op(name).torch_ref),
                    lambda: plain(ref_fn))


# -- backward of the tile ops on the card ---------------------------------------
def rmsnorm_backward(x, g, dy, eps=1e-6):
    """``(dx, dg)`` of ``y = x * r * g``, ``r = rsqrt(mean(x^2) + eps)``,
    in f32: ``dx = r (g dy) - x r^3 mean(x g dy)``, ``dg = sum over rows of
    dy x r``; cast to the dtypes of x and g."""
    xf, gf, dyf = x.float(), g.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gdy = gf * dyf
    dx = r * gdy - xf * (r * r * r) * torch.mean(xf * gdy, dim=-1,
                                                 keepdim=True)
    dg = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dg.reshape(g.shape).to(g.dtype)


def rmsnorm_gated_backward(x, z, g, dy, eps=1e-6):
    """``(dx, dz, dg)`` of ``y = xg * r * g`` with ``xg = x silu(z)`` and
    ``r = rsqrt(mean(xg^2) + eps)``, in f32: rmsnorm's backward on ``xg``,
    ``dxg = r (g dy) - xg r^3 mean(xg g dy)``, then ``dx = dxg silu(z)``
    and ``dz = dxg x s (1 + z (1 - s))`` with ``s = sigmoid(z)``; ``dg``
    sums ``dy xg r`` over rows. Cast to the dtypes of x, z and g."""
    xf, zf, gf, dyf = x.float(), z.float(), g.float(), dy.float()
    s = torch.sigmoid(zf)
    gate = zf * s
    xg = xf * gate
    r = torch.rsqrt(torch.mean(xg * xg, dim=-1, keepdim=True) + eps)
    gdy = gf * dyf
    dxg = r * gdy - xg * (r * r * r) * torch.mean(xg * gdy, dim=-1,
                                                  keepdim=True)
    dg = (dyf * xg * r).reshape(-1, x.shape[-1]).sum(0)
    return ((dxg * gate).to(x.dtype),
            (dxg * xf * s * (1.0 + zf * (1.0 - s))).to(z.dtype),
            dg.reshape(g.shape).to(g.dtype))


def layernorm_backward(x, g, b, dy, eps=1e-6):
    """``(dx, dg, db)`` of ``y = xh * g + b``, ``xh = (x - mean(x)) r``,
    ``r = rsqrt(var(x) + eps)``, in f32: ``dx = r (g dy - mean(g dy) -
    xh mean(g dy xh))``, ``dg`` and ``db`` sum ``dy xh`` and ``dy`` over
    rows; cast to the dtypes of x, g and b."""
    xf, gf, dyf = x.float(), g.float(), dy.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    r = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    xh = xc * r
    gdy = gf * dyf
    dx = r * (gdy - torch.mean(gdy, dim=-1, keepdim=True)
              - xh * torch.mean(gdy * xh, dim=-1, keepdim=True))
    d = x.shape[-1]
    dg = (dyf * xh).reshape(-1, d).sum(0)
    db = dyf.reshape(-1, d).sum(0)
    return (dx.to(x.dtype), dg.reshape(g.shape).to(g.dtype),
            db.reshape(b.shape).to(b.dtype))


def swiglu_backward(a, b, dy):
    """``(da, db)`` of ``y = silu(a) b`` in f32: ``da = dy b s (1 + a (1 -
    s))``, ``db = dy a s`` with ``s = sigmoid(a)``; cast to a's and b's
    dtypes."""
    af, bf, dyf = a.float(), b.float(), dy.float()
    s = torch.sigmoid(af)
    da = dyf * bf * s * (1.0 + af * (1.0 - s))
    return da.to(a.dtype), (dyf * af * s).to(b.dtype)


def gelu_backward(a, dy):
    """``da`` of gelu's tanh form ``y = a (1 + t) / 2``, ``t = tanh(u)``,
    ``u = c (a + 0.044715 a^3)``, ``c = sqrt(2 / pi)``, in f32: ``da = dy
    ((1 + t) / 2 + a (1 - t^2) c (1 + 3 * 0.044715 a^2) / 2)``; cast to
    a's dtype."""
    af, dyf = a.float(), dy.float()
    c = 0.7978845608028654
    t = torch.tanh(c * (af + 0.044715 * af * af * af))
    da = dyf * (0.5 * (1.0 + t) + 0.5 * af * (1.0 - t * t) * c
                * (1.0 + 3.0 * 0.044715 * af * af))
    return da.to(a.dtype)


def moe_router_backward(p, dy):
    """``dlogits`` of the softmax over the last axis from its output
    ``p``, in f32: ``p (dy - sum(dy p))``; cast to p's dtype."""
    pf, dyf = p.float(), dy.float()
    return (pf * (dyf - torch.sum(dyf * pf, dim=-1, keepdim=True))
            ).to(p.dtype)


def ssd_gate_backward(dt_raw, a_log, dt, decay, g_dt, g_decay, bias=0.0):
    """``(d dt_raw, d a_log)`` of ``dt = softplus(dt_raw + bias)``,
    ``decay = exp(dt A)``, ``A = -exp(a_log)``, from the forward's
    outputs, in f32: ``d dt_raw = (g_dt + g_decay decay A)
    sigmoid(dt_raw + bias)``, ``d a_log`` sums ``g_decay decay dt A`` over
    what ``a_log`` broadcasts against; cast to the inputs' dtypes."""
    af = a_log.float()
    A = -torch.exp(af)
    gd = g_decay.float() * decay.float()
    d_raw = (g_dt.float() + gd * A) * torch.sigmoid(dt_raw.float() + bias)
    da = (gd * dt.float() * A).sum_to_size(a_log.shape)
    return d_raw.to(dt_raw.dtype), da.to(a_log.dtype)


class _ResidualScaleFn(torch.autograd.Function):
    """The residual_scale kernel forward; its backward is ``(dy, alpha
    dy)`` (the same linear map's transpose), summed to a broadcast
    ``y``'s shape."""

    @staticmethod
    def forward(ctx, x, y, alpha):
        ctx.alpha, ctx.y_shape = alpha, y.shape
        return _kernel_op("residual_scale").apply(x, y, alpha=alpha)

    @staticmethod
    def backward(ctx, dy):
        return dy, (ctx.alpha * dy).sum_to_size(ctx.y_shape), None


class _SoftmaxFn(torch.autograd.Function):
    """The softmax kernel forward, :func:`moe_router_backward` (the same
    function's) backward from the saved output."""

    @staticmethod
    def forward(ctx, x):
        p = _kernel_op("softmax").apply(x)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dy):
        p, = ctx.saved_tensors
        with torch.profiler.record_function("softmax_backward"):
            return moe_router_backward(p, dy)


class _SsdGateFn(torch.autograd.Function):
    """The ssd_gate kernel forward (a_log a broadcast row), its
    :func:`ssd_gate_backward` backward."""

    @staticmethod
    def forward(ctx, dt_raw, a_log, bias):
        dt, decay = _kernel_op("ssd_gate").apply(dt_raw, a_log, bias=bias)
        ctx.save_for_backward(dt_raw, a_log, dt, decay)
        ctx.bias = bias
        return dt, decay

    @staticmethod
    def backward(ctx, g_dt, g_decay):
        dt_raw, a_log, dt, decay = ctx.saved_tensors
        with torch.profiler.record_function("ssd_gate_backward"):
            d_raw, da = ssd_gate_backward(
                dt_raw, a_log, dt, decay,
                torch.zeros_like(dt) if g_dt is None else g_dt,
                torch.zeros_like(decay) if g_decay is None else g_decay,
                ctx.bias)
        return d_raw, da, None


class _RmsnormFn(torch.autograd.Function):
    """The rmsnorm kernel forward, :func:`rmsnorm_backward` backward."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _kernel_op("rmsnorm").apply(x, g, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        with torch.profiler.record_function("rmsnorm_backward"):
            dx, dg = rmsnorm_backward(x, g, dy, ctx.eps)
        return dx, dg, None


class _RmsnormGatedFn(torch.autograd.Function):
    """The rmsnorm_gated kernel forward, :func:`rmsnorm_gated_backward`
    backward."""

    @staticmethod
    def forward(ctx, x, z, g, eps):
        ctx.save_for_backward(x, z, g)
        ctx.eps = eps
        return _kernel_op("rmsnorm_gated").apply(x, z, g, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, z, g = ctx.saved_tensors
        with torch.profiler.record_function("rmsnorm_gated_backward"):
            dx, dz, dg = rmsnorm_gated_backward(x, z, g, dy, ctx.eps)
        return dx, dz, dg, None


class _LayernormFn(torch.autograd.Function):
    """The layernorm kernel forward, :func:`layernorm_backward`
    backward."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g, b)
        ctx.eps = eps
        return _kernel_op("layernorm").apply(x, g, b, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, g, b = ctx.saved_tensors
        with torch.profiler.record_function("layernorm_backward"):
            dx, dg, db = layernorm_backward(x, g, b, dy, ctx.eps)
        return dx, dg, db, None


class _SsdFn(torch.autograd.Function):
    """The SSD scan's kernels both ways: the forward kernel, which also
    writes the state entering each chunk, and the backward kernels
    (:func:`ssd_scan_bwd`), which read it. With ``return_state`` the
    final state is an output too, and its gradient enters the backward's
    reverse pass. Any chunk the forward takes has a gradient: over 128
    steps the backward kernels run at 128-step sub-chunks. On CPU tensors
    both are the plain versions."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_skip, chunk,
                return_state):
        y, h, states = ssd_scan_with_states(x, dt, a_log, b_mat, c_mat,
                                            d_skip, chunk=chunk,
                                            return_state=return_state)
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_skip, states)
        ctx.chunk = chunk
        return (y, h) if return_state else y

    @staticmethod
    def backward(ctx, dy, dh=None):
        *ins, states = ctx.saved_tensors
        grads = ssd_scan_bwd(*ins, dy.contiguous(), states, chunk=ctx.chunk,
                             dh_final=None if dh is None
                             else dh.contiguous())
        return (*grads, None, None)


class _SwigluFn(torch.autograd.Function):
    """The swiglu kernel forward, :func:`swiglu_backward` backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _kernel_op("swiglu").apply(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        with torch.profiler.record_function("swiglu_backward"):
            return swiglu_backward(a, b, dy)


class _GeluFn(torch.autograd.Function):
    """The gelu kernel forward, :func:`gelu_backward` backward."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _kernel_op("gelu").apply(a)

    @staticmethod
    def backward(ctx, dy):
        a, = ctx.saved_tensors
        with torch.profiler.record_function("gelu_backward"):
            return gelu_backward(a, dy)


class _MoeRouterFn(torch.autograd.Function):
    """The moe_router kernel forward, :func:`moe_router_backward`
    backward, which reads the forward's output (the probabilities), not
    its input."""

    @staticmethod
    def forward(ctx, logits):
        p = _kernel_op("moe_router").apply(logits)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dy):
        p, = ctx.saved_tensors
        with torch.profiler.record_function("moe_router_backward"):
            return moe_router_backward(p, dy)


class _RotaryFn(torch.autograd.Function):
    """The rotary kernel both ways. RoPE is linear in q, and its cos/sin
    tables repeat their first half (``rope_cos_sin``, M-RoPE's
    ``ang2``), so ``rotate_half(dy * sin) = rotate_half(dy) * sin`` and
    the gradient ``dy cos + rotate_half^T(dy sin)`` is
    ``rotary(dy, cos, -sin)``: the same kernel, in the same ``cycle`` or
    ``bcycle`` layout. cos and sin take no gradient."""

    @staticmethod
    def forward(ctx, q, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _kernel_op("rotary").apply(q, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        return _kernel_op("rotary").apply(dy.contiguous(), cos, -sin), \
            None, None


# -- kernels on the local shards of DTensors --------------------------------------
def _is_dt(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def ident(x) -> dict:
    """The identity map of ``x``'s dimensions (for :func:`on_shards`)."""
    return {d: d for d in range(x.ndim)}


def on_shards(fn, args, keep, maps, outs):
    """``fn`` on the local shards of DTensor arguments (a ``local_map``
    region), so each wrapper launches its kernel on what this rank holds,
    as the reference's Pallas calls run on the shards GSPMD gives them.

    ``args[0]`` leads: it keeps its shards on the dimensions in ``keep``
    and is replicated on the others (a ``Partial`` sum reduced first,
    a shard of a dimension the kernel reads whole gathered, as GSPMD
    resolves a custom call's operands). ``maps[i]`` maps the lead's
    dimensions to argument ``i``'s: it is sharded where the lead is, on
    the mapped dimension, and replicated elsewhere (a plain tensor, such
    as RoPE's tables, is replicated first); None passes an argument as it
    is (a scalar). ``outs`` is the map of the output, or a list of maps
    for several; an output dimension mapped to ``"sum"`` makes the output
    a ``Partial`` sum over the mesh dimensions the lead's dimension is
    sharded on (each rank adds its share of the lead into it). A
    replicated argument's local gradient covers only this rank's part of
    the work on a mesh dimension the lead is sharded on: it comes back a
    ``Partial`` sum there. With no DTensor argument, ``fn`` runs on the
    arguments as they are."""
    if not _is_dt(*args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    mesh = lead.device_mesh
    lead_pl = tuple(p if p.is_shard() and p.dim in keep else Replicate()
                    for p in lead.placements)

    def follow(dmap):
        out = []
        for p in lead_pl:
            d = dmap.get(p.dim) if p.is_shard() else None
            out.append(Replicate() if d is None else Partial()
                       if d == "sum" else Shard(d))
        return tuple(out)

    placed, in_pl, grad_pl = [], [], []
    for a, dmap in zip(args, maps):
        if dmap is None:
            placed.append(a)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = follow(dmap)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        placed.append(a)
        in_pl.append(pl)
        grad_pl.append(tuple(Partial() if q.is_replicate() and lp.is_shard()
                             else q for q, lp in zip(pl, lead_pl)))
    out_pl = tuple(follow(o) for o in outs) if isinstance(outs, list) \
        else (follow(outs),)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*placed)


# -- saturated tile ops ---------------------------------------------------------
def rmsnorm(x, g, eps=1e-6):
    if _is_dt(x, g):
        return on_shards(lambda x, g: rmsnorm(x, g, eps), (x, g),
                         range(x.ndim - 1), (ident(x), {}), ident(x))
    if current_impl(x) == "triton" and _wants_grad(x, g):
        return _RmsnormFn.apply(x, g, eps)
    return _tile("rmsnorm", x, g, eps=eps)


def rmsnorm_gated(x, z, g, eps=1e-6):
    if _is_dt(x, z, g):
        return on_shards(lambda x, z, g: rmsnorm_gated(x, z, g, eps),
                         (x, z, g), range(x.ndim - 1),
                         (ident(x), ident(x), {}), ident(x))
    if current_impl(x) == "triton" and _wants_grad(x, z, g):
        return _RmsnormGatedFn.apply(x, z, g, eps)
    return _tile("rmsnorm_gated", x, z, g, eps=eps)


def layernorm(x, g, b, eps=1e-6):
    if _is_dt(x, g, b):
        return on_shards(lambda x, g, b: layernorm(x, g, b, eps),
                         (x, g, b), range(x.ndim - 1),
                         (ident(x), {}, {}), ident(x))
    if current_impl(x) == "triton" and _wants_grad(x, g, b):
        return _LayernormFn.apply(x, g, b, eps)
    return _tile("layernorm", x, g, b, eps=eps)


def swiglu(a, b):
    if _is_dt(a, b):
        return on_shards(swiglu, (a, b), range(a.ndim),
                         (ident(a), ident(a)), ident(a))
    if current_impl(a) == "triton" and _wants_grad(a, b):
        return _SwigluFn.apply(a, b)
    return _tile("swiglu", a, b)


def gelu(a):
    """GELU in its tanh form (the saturated ``gelu`` program)."""
    if _is_dt(a):
        return on_shards(gelu, (a,), range(a.ndim), (ident(a),),
                         ident(a))
    if current_impl(a) == "triton" and _wants_grad(a):
        return _GeluFn.apply(a)
    return _tile("gelu", a)


def moe_router_probs(logits):
    """Router logits (..., E) -> softmax probabilities, the saturated
    ``moe_router`` program (one row per token, E columns)."""
    if _is_dt(logits):
        return on_shards(moe_router_probs, (logits,),
                         range(logits.ndim - 1), (ident(logits),),
                         ident(logits))
    if current_impl(logits) == "triton" and _wants_grad(logits):
        return _MoeRouterFn.apply(logits)
    return _tile("moe_router", logits)


def rotary(q, cos, sin):
    """q:(..., d); cos/sin broadcastable to q. Tile rows = flattened lead.
    The kernel reads cos/sin in place (``cycle`` operands, or ``bcycle``
    for M-RoPE's one table per batch row), without materialising their
    broadcast to q's shape."""
    if _is_dt(q, cos, sin):
        # a table follows q's shards where it is as long as q, and is
        # replicated where it broadcasts
        tab = {d: d for d in range(q.ndim) if cos.shape[d] == q.shape[d]}
        return on_shards(rotary, (q, cos, sin), range(q.ndim - 1),
                         (ident(q), tab, tab), ident(q))
    impl = current_impl(q)
    if impl == "ref":
        return _ref.rotary_ref(q, cos, sin)
    if impl == "triton" and _wants_grad(q):
        return _RotaryFn.apply(q, cos, sin)

    def _opt():
        if impl == "triton":
            return _kernel_op("rotary").apply(q, cos, sin)
        return get_tile_op("rotary").torch_ref(q, cos.expand(q.shape),
                                               sin.expand(q.shape))

    return _guarded("rotary", q, _opt, lambda: _ref.rotary_ref(q, cos, sin))


def residual_scale(x, y, alpha=1.0):
    """``x + alpha * y``: the saturated ``residual_scale`` program (``y``
    of x's shape or a broadcast row; ``alpha`` a host float)."""
    if current_impl(x) == "triton" and _wants_grad(x, y):
        return _ResidualScaleFn.apply(x, y, alpha)
    return _tile("residual_scale", x, y, alpha=alpha)


def softmax(x):
    """Softmax over the last axis: the saturated ``softmax`` program (a
    row reduction, multiplied by the sum's reciprocal)."""
    if current_impl(x) == "triton" and _wants_grad(x):
        return _SoftmaxFn.apply(x)
    return _tile("softmax", x)


def ssd_gate(dt_raw, a_log, bias=0.0):
    """Returns ``(dt, decay)``: ``dt = softplus(dt_raw + bias)`` and
    ``decay = exp(-dt exp(a_log))``, sharing the softplus (the saturated
    ``ssd_gate`` program). ``a_log`` of ``(nh,)`` against ``dt_raw`` of
    ``(..., nh)`` is read as one broadcast row, not materialised at
    ``dt_raw``'s shape; the plain versions broadcast it."""
    if current_impl(dt_raw) == "triton" and _wants_grad(dt_raw, a_log):
        return _SsdGateFn.apply(dt_raw, a_log, bias)
    return _tile("ssd_gate", dt_raw, a_log, bias=bias)


def adamw_update(param, grad, m, v, *, lr, b1, b2, eps, wd, inv_bc1,
                 inv_bc2):
    """Returns (m_new, v_new, param_new): the saturated fused update, the
    generated kernel on CUDA tensors. The scalars are host floats."""
    return _tile("adamw", param, grad, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                 wd=wd, inv_bc1=inv_bc1, inv_bc2=inv_bc2)


def l2_clip(g, *, norm, max_norm, eps=1e-9):
    """``g.float() * min(1, max_norm / (norm + eps))`` in f32 whatever
    ``g``'s dtype: the saturated ``l2_clip`` program. On CUDA tensors the
    generated kernel reads ``g`` in its own dtype (a bf16 gradient is
    upcast in registers, exactly) and writes f32, so the optimizer pays
    no separate cast; the plain versions run on ``g.float()``."""
    return _tile("l2_clip", g, out_dtype=torch.float32, norm=norm,
                 max_norm=max_norm, eps=eps)


# -- structured kernels -----------------------------------------------------------
def attention(q, k, v, *, causal=True, scale=None):
    if _is_dt(q, k, v):
        # batch and heads stay sharded; every query reads the whole
        # sequence (k and v hold q's heads, or as many kv heads per shard)
        return on_shards(
            lambda q, k, v: attention(q, k, v, causal=causal, scale=scale),
            (q, k, v), (0, 1), (ident(q), ident(q), ident(q)),
            ident(q))
    if current_impl(q) == "triton":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _ref.attention_ref(q, k, v, causal=causal, scale=scale)


def attention_decode(q, k_cache, v_cache, *, scale=None):
    """One query token against a cache, in torch on every device (as the
    JAX package's, a GEMV-shaped op with no kernel of its own)."""
    return decode_attention(q, k_cache, v_cache, scale=scale)


def ssd(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk=128,
        return_state=False):
    """Chunked SSD scan: the CUDA kernel on CUDA tensors, the plain torch
    scan on the CPU (the sequential oracle under ``set_impl("ref")``,
    which has no final state). With ``return_state`` also the final
    (B,H,N,P) state, which seeds decode. A gradient under the ``triton``
    implementation goes through the backward kernel (``_SsdFn``)."""
    if _is_dt(x, dt, a_log, b_mat, c_mat, d_skip):
        # batch and heads stay sharded, the sequence is scanned whole
        return on_shards(
            lambda *a: ssd(*a, chunk=chunk, return_state=return_state),
            (x, dt, a_log, b_mat, c_mat, d_skip), (0, 2),
            (ident(x), {0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}, {2: 0}),
            [ident(x), {0: 0, 2: 1}] if return_state else ident(x))
    impl = current_impl(x)
    if impl == "triton":
        if _wants_grad(x, dt, a_log, b_mat, c_mat, d_skip):
            return _SsdFn.apply(x, dt, a_log, b_mat, c_mat, d_skip, chunk,
                                return_state)
        return ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                        return_state=return_state)
    if impl == "ref" and not return_state:
        return _ref.ssd_ref(x, dt, a_log, b_mat, c_mat, d_skip)
    return ssd_scan_plain(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                          return_state=return_state)


def ssd_decode(h, x_t, dt_t, a_log, b_t, c_t, d_skip):
    return ssd_decode_step(h, x_t, dt_t, a_log, b_t, c_t, d_skip)
