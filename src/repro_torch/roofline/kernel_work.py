"""The work of each hand-written kernel of the port, by what the kernel
itself does: the operations and bytes that bound its time on the card
(``chip_smoke.py``'s ``bound_ms``), and what the op counter
(:mod:`repro_torch.roofline.op_analysis`) records for a launch on
``meta`` tensors.

Bytes count each input read once and each output written once; the
operations are what the call's data needs (a causal mask's kept pairs,
not the square). Rates are the H100 SXM data sheet's (dense, at the full
700 W; published peaks, not measurements): :data:`HBM_BYTES_PER_S`
and :data:`PEAK_FLOPS` by the arithmetic's type.

:func:`record` is the one way a kernel wrapper accounts for a call on
``meta``: it needs an open :class:`~repro_torch.roofline.op_analysis.
OpCounter` and raises without one, so a kernel never runs on ``meta``
uncounted.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.hardware import H100_SXM

from .op_analysis import active_counter

HBM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_FLOPS = {"bfloat16": H100_SXM.peak_flops_bf16,  # dense tensor cores
              "float32": 67e12,                      # off the tensor cores
              "tf32x3": 495e12 / 3}   # f32 as 3 TF32 tensor-core products


def bound_ms(flops: float, nbytes: float, rate: str) -> Tuple[float, str]:
    """Least time of ``flops`` operations at ``PEAK_FLOPS[rate]`` and
    ``nbytes`` at the memory rate, in ms, and which of the two bounds
    it."""
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def tile_work(op, args, out_dtype=None) -> Tuple[float, float]:
    """``(operations, bytes)`` of one tile kernel call: the body's
    operations for each element of the lead, in f32, and each input read
    once and each output (the lead's shape, in ``out_dtype`` or the
    lead's dtype) written once. A degraded op (no kernel) has no work to
    count and raises."""
    if op.tk is None:
        raise RuntimeError(f"tile op {op.name!r} has no kernel (degraded "
                           "build): no work to count")
    n_out = len(op.tk.out_arrays)
    out_size = (out_dtype or args[0].dtype).itemsize
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + n_out * args[0].numel() * out_size
    return op.tk.stats.n_ops * args[0].numel(), nbytes


def tile_bound(op, args, out_dtype=None) -> Tuple[float, str]:
    """Least time of a tile kernel: its bytes over the memory rate, or
    its operations over the f32 rate."""
    ops, nbytes = tile_work(op, args, out_dtype)
    return bound_ms(ops, nbytes, "float32")


def flash_fwd_work(b, h, kh, s, d, itemsize: int, causal: bool,
                   with_lse: bool = False) -> Tuple[float, float]:
    """``(flops, bytes)`` of one attention forward: 2 products (Q·Kᵀ,
    P·V) of 2 x pairs x D each per (b, h), pairs the (q, k) pairs the
    mask keeps; q, k, v read and o written once, and the f32 row lse
    where the training forward stores it."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * 2 * pairs * d * b * h
    nbytes = (2 * b * h * s * d + 2 * b * kh * s * d) * itemsize \
        + (4 * b * h * s if with_lse else 0)
    return flops, nbytes


def flash_bwd_work(b, h, kh, s, d, dt, causal) -> Tuple[float, float]:
    """Operations and bytes of one attention backward: 5 products of
    2 x pairs x D each per (b, h) (S, dP, dV, dK, dQ), pairs the (q, k)
    pairs the mask keeps; q, k, v, o, dO read and dq, dk, dv written once,
    lse read once. ``dt`` names the dtype (``"bfloat16"``,
    ``"float32"``)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 5 * 2 * pairs * d * b * h
    el = 2 if dt == "bfloat16" else 4
    nbytes = (4 * b * h * s * d + 4 * b * kh * s * d) * el + 4 * b * h * s
    return flops, nbytes


def ssd_work(B, S, H, P, N, chunk) -> Tuple[float, float]:
    """Bytes and operations one SSD scan with its final state needs: x,
    dt, B, C, a_log, d_skip read once, y and the state written once; per
    (b, h, chunk) of L steps the causal scores . dx (L(L+1)/2 x P MACs),
    C . h (L N P, none in the first chunk, whose state is zero) and the
    state update (L N P), and per (b, chunk) the causal half of C . B^T
    (L(L+1)/2 x N), two operations per MAC."""
    nbytes = 4 * (2 * B * S * H * P + B * H * N * P + 2 * B * S * N
                  + B * S * H + 2 * H)
    macs = 0
    for k, t0 in enumerate(range(0, S, chunk)):
        L = min(chunk, S - t0)
        tri = L * (L + 1) // 2
        macs += B * H * (tri * P + (L * N * P if k else 0) + L * N * P)
        macs += B * tri * N
    return nbytes, 2 * macs


def ssd_bwd_work(B, S, H, P, N, chunk) -> Tuple[float, float]:
    """Bytes and operations of one SSD backward as the kernels decompose
    it: x, dy, dt, B, C, a_log, d_skip and the forward's chunk states
    read once, the six gradients written once; per (b, h, chunk) of L
    steps G = dy . x^T and M^T . dy (L(L+1)/2 x P MACs each), where the
    state gradient leaving the chunk is not zero (every chunk but the
    last) B . dh and x . dh^T, where the state entering it is not (every
    chunk but the first) dy . h_in^T (which gives both dC's inter-chunk
    part and, dotted with C, that of d(seg)) and the chunk's own state
    gradient C^T . dy (L N P each); per (b, chunk) the causal halves of
    C . B^T, GE_sum . B and GE_sum^T . C (L(L+1)/2 x N each), GE summed
    over the heads before its products. The kernels do more than this
    (C . h_in per head as well), which the bound does not count."""
    n_chunks = -(-S // chunk)
    nbytes = 4 * (3 * B * S * H * P + B * n_chunks * H * N * P
                  + 2 * B * S * H + 4 * B * S * N + 4 * H)
    macs = 0
    for k, t0 in enumerate(range(0, S, chunk)):
        L = min(chunk, S - t0)
        tri = L * (L + 1) // 2
        lnp = L * N * P
        macs += B * H * (2 * tri * P
                         + (2 * lnp if k < n_chunks - 1 else 0)
                         + (2 * lnp if k else 0))
        macs += 3 * B * tri * N
    return nbytes, 2 * macs


def record(name: str, *, flops: float = 0.0, nbytes: float = 0.0,
           vector_ops: float = 0.0):
    """Account one launch of kernel ``name`` on ``meta`` tensors with the
    active op counter; raises where none is open (a kernel on ``meta``
    outside a count would be a launch nobody counts)."""
    counter = active_counter()
    if counter is None:
        raise RuntimeError(f"{name}: a kernel on the meta device runs only "
                           "under an OpCounter (repro_torch.roofline), "
                           "which counts its work")
    counter.record_kernel(name, flops=flops, nbytes=nbytes,
                          vector_ops=vector_ops)
