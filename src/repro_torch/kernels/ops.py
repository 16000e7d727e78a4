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
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.telemetry import telemetry
from repro_torch.runtime.guard import breaker_for

from . import ref as _ref
from .flash_attention import decode_attention, flash_attention
from .ssd_scan import ssd_decode_step, ssd_scan, ssd_scan_plain
from .tile_programs import get_tile_op

IMPLS = ("triton", "torch", "ref")
TILE_EMITTERS = ("triton", "triton_pipelined")
_IMPL: Optional[str] = None  # None = auto
_TILE_EMITTER: Optional[str] = None  # None = "triton"

# runtime degradation floor on CPU tensors: the named oracle each tile op
# falls back to when building or applying the saturated op fails
# (the ops the model families call; the optimizer's tile programs get
# their op wrappers with training, ROADMAP queue A)
_REF_FNS: dict = {"rmsnorm": _ref.rmsnorm_ref,
                  "rmsnorm_gated": _ref.rmsnorm_gated_ref,
                  "layernorm": _ref.layernorm_ref,
                  "swiglu": _ref.swiglu_ref,
                  "gelu": _ref.gelu_ref,
                  "moe_router": _ref.softmax_ref}


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


def _tile(name: str, *arrays, **scalars):
    x = arrays[0]
    impl = current_impl(x)
    ref_fn = _REF_FNS[name]
    if impl == "ref":
        return ref_fn(*arrays, **scalars)
    if impl == "triton":
        return _guarded(name, x,
                        lambda: _kernel_op(name).apply(*arrays, **scalars),
                        lambda: ref_fn(*arrays, **scalars))
    return _guarded(name, x,
                    lambda: get_tile_op(name).torch_ref(*arrays, **scalars),
                    lambda: ref_fn(*arrays, **scalars))


# -- saturated tile ops ---------------------------------------------------------
def rmsnorm(x, g, eps=1e-6):
    return _tile("rmsnorm", x, g, eps=eps)


def rmsnorm_gated(x, z, g, eps=1e-6):
    return _tile("rmsnorm_gated", x, z, g, eps=eps)


def layernorm(x, g, b, eps=1e-6):
    return _tile("layernorm", x, g, b, eps=eps)


def swiglu(a, b):
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

    def _opt():
        if impl == "triton":
            return _kernel_op("rotary").apply(q, cos, sin)
        return get_tile_op("rotary").torch_ref(q, cos.expand(q.shape),
                                               sin.expand(q.shape))

    return _guarded("rotary", q, _opt, lambda: _ref.rotary_ref(q, cos, sin))


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
    (B,H,N,P) state, which seeds decode."""
    impl = current_impl(x)
    if impl == "triton":
        return ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                        return_state=return_state)
    if impl == "ref" and not return_state:
        return _ref.ssd_ref(x, dt, a_log, b_mat, c_mat, d_skip)
    return ssd_scan_plain(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                          return_state=return_state)


def ssd_decode(h, x_t, dt_t, a_log, b_t, c_t, d_skip):
    return ssd_decode_step(h, x_t, dt_t, a_log, b_t, c_t, d_skip)
