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

Default: ``triton`` for CUDA tensors, ``torch`` for CPU tensors.
``set_impl(...)`` overrides globally (the tests and chip_smoke.py's
parity phase use it). ``set_tile_emitter(...)`` picks the form of the
tile kernels the ``triton`` implementation launches: the sync kernels
(default) or their persistent, pipelined form.

No fallback on the card: on CUDA tensors an op runs what it was asked
to run and raises if that fails. The runtime floor of the JAX package
(catch, fall back to the oracle, count a runtime fallback, trip the
breaker) applies to CPU tensors only.

Gradients. On CPU tensors autograd differentiates the saturated torch
code (``torch_ref``) directly, as JAX differentiates ``jax_ref``. Under
the ``triton`` implementation (CUDA tensors) that want a gradient,
rmsnorm, rmsnorm_gated, rotary and swiglu launch their kernels through
``torch.autograd.Function``s: rotary's backward is
the same kernel with ``-sin`` (exact: both RoPE tables repeat their
first half), the others' are the analytic derivatives in f32 torch
(:func:`rmsnorm_backward`, :func:`rmsnorm_gated_backward`,
:func:`swiglu_backward`; the JAX package's gradient of these ops is
XLA's autodiff of ``jax_ref``, no kernel either). The SSD scan's
gradient is its backward kernel (``_SsdFn``: the forward kernel keeps
the state entering each chunk, :func:`ssd_scan_bwd` reads it). The other
tile ops (layernorm, gelu, moe_router) have no backward on the card yet
and raise there rather than return a result with no gradient (ROADMAP
A12).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.telemetry import telemetry
from repro_torch.runtime.guard import breaker_for

from . import ref as _ref
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
                  "adamw": _ref.adamw_ref,
                  "l2_clip": _ref.l2_clip_ref}
# the queue item that brings each op a backward on the card
_NO_BACKWARD = {"layernorm": "A12 (layernorm backward)",
                "gelu": "A12 (gelu backward)",
                "moe_router": "A12 (moe_router backward)"}


def set_impl(impl: Optional[str]):
    """impl in {None/'auto', 'triton', 'torch', 'ref'}."""
    global _IMPL
    if impl not in (None, "auto") + IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None/'auto', "
                         f"got {impl!r}")
    _IMPL = None if impl == "auto" else impl


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
    """The implementation an op on tensor ``x`` runs."""
    if _IMPL is not None:
        return _IMPL
    return "triton" if x.is_cuda else "torch"


def _guarded(name: str, x, optimized: Callable, reference: Callable):
    """CPU tensors: run the optimized path under the runtime floor — a
    failure falls back to the named oracle, and a per-kernel circuit
    breaker skips the optimized attempt after repeated failures. CUDA
    tensors: run it, and let a failure raise."""
    if x.is_cuda:
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


def _refuse_grad(name: str, *tensors):
    """A kernel with no backward, asked for a gradient on the card."""
    if tensors[0].is_cuda and _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward on the card yet (ROADMAP "
            f"{_NO_BACKWARD[name]}); its kernel would return a result with "
            "no gradient")


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
        if name in _NO_BACKWARD:
            _refuse_grad(name, *arrays)
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


def swiglu_backward(a, b, dy):
    """``(da, db)`` of ``y = silu(a) b`` in f32: ``da = dy b s (1 + a (1 -
    s))``, ``db = dy a s`` with ``s = sigmoid(a)``; cast to a's and b's
    dtypes."""
    af, bf, dyf = a.float(), b.float(), dy.float()
    s = torch.sigmoid(af)
    da = dyf * bf * s * (1.0 + af * (1.0 - s))
    return da.to(a.dtype), (dyf * af * s).to(b.dtype)


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


class _SsdFn(torch.autograd.Function):
    """The SSD scan's kernels both ways: the forward kernel, which also
    writes the state entering each chunk, and the backward kernels
    (:func:`ssd_scan_bwd`), which read it. With ``return_state`` the
    final state is an output too, and its gradient enters the backward's
    reverse pass. On CPU tensors both are the plain versions."""

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


# -- saturated tile ops ---------------------------------------------------------
def rmsnorm(x, g, eps=1e-6):
    if current_impl(x) == "triton" and _wants_grad(x, g):
        return _RmsnormFn.apply(x, g, eps)
    return _tile("rmsnorm", x, g, eps=eps)


def rmsnorm_gated(x, z, g, eps=1e-6):
    if current_impl(x) == "triton" and _wants_grad(x, z, g):
        return _RmsnormGatedFn.apply(x, z, g, eps)
    return _tile("rmsnorm_gated", x, z, g, eps=eps)


def layernorm(x, g, b, eps=1e-6):
    return _tile("layernorm", x, g, b, eps=eps)


def swiglu(a, b):
    if current_impl(a) == "triton" and _wants_grad(a, b):
        return _SwigluFn.apply(a, b)
    return _tile("swiglu", a, b)


def gelu(a):
    """GELU in its tanh form (the saturated ``gelu`` program)."""
    return _tile("gelu", a)


def moe_router_probs(logits):
    """Router logits (..., E) -> softmax probabilities, the saturated
    ``moe_router`` program (one row per token, E columns)."""
    return _tile("moe_router", logits)


def rotary(q, cos, sin):
    """q:(..., d); cos/sin broadcastable to q. Tile rows = flattened lead.
    The kernel reads cos/sin in place (``cycle`` operands, or ``bcycle``
    for M-RoPE's one table per batch row), without materialising their
    broadcast to q's shape."""
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
