"""Flash attention for Hopper: the hand-written CUDA kernel and its
wrapper, the plain version, and decode attention in torch.

Replaces the TPU kernel ``_attn_kernel`` of
``repro/kernels/flash_attention.py`` (launched by ``flash_attention``
there). The kernel source is ``csrc/flash_attention.cu``; its header says
what bounds it on the H100 and what its design does about that. It is
built by :mod:`repro_torch.kernels.cuda_build` at first use and called
through ``ctypes`` on PyTorch's current stream.

The wrapper picks the kernel by dtype before it launches: bf16 (the
model's path) runs on the bf16 tensor cores (``mma.sync``), f32 on the
CUDA cores, whose full f32 products hold the f32 tolerance that TF32
would miss. Neither is a fallback for the other: a launch that fails
raises.

Training differentiates it as the JAX package's ``jax.custom_vjp`` of
``blocked_attention`` (``src/repro/models/layers.py:88-201``): the
forward also stores each row's log-sum-exp, and the backward is the
hand-written backward kernel of the same source (no TPU kernel: the JAX
package's backward is jnp), with ``flash_attention_bwd_plain`` its
plain version. In bf16 the backward runs Hopper's warpgroup products
(``wgmma``, tiles brought in by TMA, a persistent grid) at the head dims
of ``WGMMA_BWD_HEAD_DIMS`` and ``mma.sync`` at the others
(:func:`bwd_kernel`); the wgmma kernels walk work lists that
:func:`bwd_schedule` orders on the host.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import List, Optional, Tuple

import torch

from repro_torch.roofline import kernel_work

from . import cuda_build
from . import ref as _ref

HEAD_DIMS = (16, 32, 64, 80, 128)
_FWD = {torch.float32: "flash_attention_fwd_f32",
        torch.bfloat16: "flash_attention_fwd_bf16"}
# the backward's library entry of each kind of kernels (:func:`bwd_kernel`)
_BWD = {"cuda_cores": "flash_attention_bwd_f32",
        "mma_sync": "flash_attention_bwd_bf16",
        "wgmma": "flash_attention_bwd_bf16_sm90"}
# head dims whose bf16 backward runs the wgmma kernels (rows of 64-column
# TMA boxes, 80 as two with the second zero-filled past column 80); the
# others run the mma.sync kernels
WGMMA_BWD_HEAD_DIMS = (64, 80, 128)
BWD_KV_ITEM = 128    # kv rows of a dk/dv work item
BWD_KV_STEP = 64     # query rows per step of its walk
BWD_Q_ITEM = 128     # query rows of a dq work item
BWD_Q_STEP = 64      # kv rows per step of its walk
BWD_PAD = 128        # the wgmma kernels' lse and delta rows, padded


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in _FWD.values():
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    bwd = [p] * 10 + [i] * 5 + [ctypes.c_float, i]
    for kind, entry in _BWD.items():
        fn = getattr(lib, entry)
        fn.argtypes = bwd + ([p, i, p, i, p] if kind == "wgmma" else [p])
        fn.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel: "
                           + lib.flash_attention_error_string(err).decode())


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _record_fwd(q, k, causal: bool, with_lse: bool):
    """A forward on ``meta`` tensors: its work, to the op counter."""
    B, H, S, D = q.shape
    flops, nbytes = kernel_work.flash_fwd_work(
        B, H, k.shape[1], S, D, q.element_size(), causal, with_lse)
    kernel_work.record("flash_attention", flops=flops, nbytes=nbytes)


def _check(q, k, v, *more):
    """The launch's shape (B, H, KH, S, D), or an error for what the
    kernels do not take. ``more`` are further (name, tensor) operands
    shaped like q (o, dout) or lse-shaped (B, H, S) f32."""
    B, H, S, D = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.device.type not in ("cuda", "meta") or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"expected {want}")
        if t.dim() != (3 if name == "lse" else 4) or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{3 if name == 'lse' else 4}-d tensor, got "
                             f"shape {tuple(t.shape)}")
    if q.dtype not in _FWD:
        raise TypeError(f"flash_attention: dtype {q.dtype} (float32 or "
                        "bfloat16)")
    KH = k.shape[1]
    if tuple(k.shape) != (B, KH, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: k and v "
                         "must be (B, KH, S, D) with q's batch, length S "
                         "and head_dim (no cross-attention over another "
                         "length yet)")
    for name, t in more:
        want = (B, H, S) if name == "lse" else (B, H, S, D)
        if tuple(t.shape) != want:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)}, "
                             f"expected {want}")
    if D not in HEAD_DIMS or H % KH:
        raise ValueError(f"flash_attention: head_dim {D} (one of "
                         f"{HEAD_DIMS}) and {H} heads over {KH} kv heads")
    return B, H, KH, S, D


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None):
    """The kernel's plain version: masked f32 softmax attention
    (:func:`repro_torch.kernels.ref.attention_ref`)."""
    return _ref.attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None):
    """``(o, lse)``: the plain version's output and each query row's
    log-sum-exp of its scaled, masked f32 logits, natural log, (B, H, S)
    f32 (the ``m + log(l)`` of the JAX package's blocked forward,
    ``src/repro/models/layers.py:137``)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    scale = (D ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float().repeat_interleave(rep, 1)) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    return (flash_attention_plain(q, k, v, causal=causal, scale=scale),
            torch.logsumexp(logits, dim=-1))


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal: bool = True,
                              scale: Optional[float] = None,
                              block: int = 512):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)`` for the output
    gradient ``dout``, from the saved ``o`` and ``lse``: the port of
    ``_flash_bwd`` (``src/repro/models/layers.py:151-201``), blocked
    recomputation in f32 over ``block`` x ``block`` tiles (the last one
    ragged; causal tiles wholly above the diagonal add nothing and are
    skipped). GQA: k and v are repeated to H heads, and their gradients
    summed back over each group."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    rep = H // KH
    scale = (D ** -0.5) if scale is None else scale
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    delta = (dof * o.float()).sum(-1)                       # (B,H,S)
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for k0 in range(0, S, block):
        k1 = min(k0 + block, S)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        for q0 in range(k0 if causal else 0, S, block):
            q1 = min(q0 + block, S)
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q1], kt) * scale
            if causal:
                keep = (torch.arange(q0, q1, device=q.device)[:, None]
                        >= torch.arange(k0, k1, device=q.device)[None])
                s = torch.where(keep, s, -1e30)
            p = torch.exp(s - lse[:, :, q0:q1, None])
            dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, q0:q1], vt)
            ds = p * (dp - delta[:, :, q0:q1, None]) * scale
            dk[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", ds,
                                            qf[:, :, q0:q1])
            dv[:, :, k0:k1] += torch.einsum("bhqk,bhqd->bhkd", p,
                                            dof[:, :, q0:q1])
            dq[:, :, q0:q1] += torch.einsum("bhqk,bhkd->bhqd", ds, kt)
    dk = dk.reshape(B, KH, rep, S, D).sum(2)
    dv = dv.reshape(B, KH, rep, S, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_kernel(head_dim: int, dtype: torch.dtype) -> str:
    """Which backward kernels a call of this head_dim and dtype launches:
    ``"wgmma"`` (bf16 at ``WGMMA_BWD_HEAD_DIMS``), ``"mma_sync"`` (bf16
    at the other head dims) or ``"cuda_cores"`` (f32), decided before the
    launch, never after a failure."""
    if head_dim not in HEAD_DIMS or dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: head_dim {head_dim}, "
                         f"dtype {dtype}")
    if dtype == torch.float32:
        return "cuda_cores"
    return "wgmma" if head_dim in WGMMA_BWD_HEAD_DIMS else "mma_sync"


FWD_BLOCK_M = 64    # query rows of a forward block (TC_BM and BM in the source)


def fwd_launch(B: int, H: int, KH: int, S: int, dtype: torch.dtype):
    """The forward launch as ``csrc/flash_attention.cu`` makes it:
    ``(grid, item)``, ``item(x, y)`` the ``(b, h, query tile, kv head)``
    block ``(x, y)`` computes. The bf16 kernel takes (b·h, tile) blocks,
    heaviest (last) tile first; the f32 kernel (tile, b·h)."""
    n_t = -(-S // FWD_BLOCK_M)
    group = H // KH
    if dtype == torch.bfloat16:
        return (B * H, n_t), lambda x, y: (x // H, x % H, n_t - 1 - y,
                                           x % H // group)
    return (n_t, B * H), lambda x, y: (y // H, y % H, x, y % H // group)


def _lpt(work: List[int], programs: int) -> Tuple[List[int], List[int]]:
    """Items ``0 .. len(work) - 1`` dealt to at most ``programs`` programs
    heaviest first (ties by index), each to the program with the least
    work so far (ties to the lowest program): ``(starts, items)``, program
    ``p``'s items ``items[starts[p]:starts[p + 1]]`` in the order dealt,
    so in non-increasing work."""
    n = min(programs, len(work))
    heap = [(0, p) for p in range(n)]
    lists: List[List[int]] = [[] for _ in range(n)]
    for i in sorted(range(len(work)), key=lambda i: (-work[i], i)):
        load, p = heapq.heappop(heap)
        lists[p].append(i)
        heapq.heappush(heap, (load + work[i], p))
    starts = [0]
    for items in lists:
        starts.append(starts[-1] + len(items))
    return starts, [i for items in lists for i in items]


def bwd_work(B: int, H: int, KH: int, S: int, causal: bool):
    """The wgmma backward's work items and their work in steps of 64 rows:
    ``{"dkdv": [...], "dq": [...]}``. A dk/dv item ``bkh * n + t`` (b, kv
    head, ``BWD_KV_ITEM``-row kv tile t of n) walks its group's H / KH
    query heads over the query tiles that see its rows; a dq item
    ``bh * n + t`` walks the kv tiles up to its tile's last row."""
    n_q = -(-S // BWD_KV_STEP)
    n_kt = -(-S // BWD_KV_ITEM)
    dkdv = [H // KH * (n_q - (t * BWD_KV_ITEM // BWD_KV_STEP if causal
                              else 0))
            for _ in range(B * KH) for t in range(n_kt)]
    n_qt = -(-S // BWD_Q_ITEM)
    dq = [-(-(min(S, (t + 1) * BWD_Q_ITEM) if causal else S) // BWD_Q_STEP)
          for _ in range(B * H) for t in range(n_qt)]
    return {"dkdv": dkdv, "dq": dq}


@functools.lru_cache(maxsize=64)
def bwd_schedule(B: int, H: int, KH: int, S: int, causal: bool,
                 programs: int):
    """``{"dkdv": (starts, items), "dq": (starts, items)}``: each launch's
    work items (:func:`bwd_work`) dealt to at most ``programs`` programs
    of a persistent grid (one block an SM), heaviest first, each to the
    least loaded program (:func:`_lpt`), so that the causal triangle
    leaves no tail. Items of equal work keep their index order, which
    puts the heads of a group side by side."""
    return {name: _lpt(work, programs)
            for name, work in bwd_work(B, H, KH, S, causal).items()}


@functools.lru_cache(maxsize=64)
def _bwd_work_tensors(B, H, KH, S, causal, device):
    """``bwd_schedule`` on the card as int32 ``[starts | items]`` tensors,
    with their program counts, for the dk/dv and the dq launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = []
    for starts, items in bwd_schedule(B, H, KH, S, causal, sms).values():
        out += [torch.tensor(starts + items, dtype=torch.int32,
                             device=device), len(starts) - 1]
    return out


def _launch_fwd(q, k, v, causal: bool, scale: Optional[float],
                with_lse: bool):
    """One forward launch: ``(o, lse)``, lse None unless asked for (the
    serve path asks for none, and the kernel then stores none)."""
    B, H, KH, S, D = _check(q, k, v)
    scale = (D ** -0.5) if scale is None else float(scale)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0:
        return o, lse
    if q.device.type == "meta":
        _record_fwd(q, k, causal, with_lse)
        return o, lse
    lib = _load()
    _raise_on(lib, getattr(lib, _FWD[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, KH, S, D, scale,
        int(causal), torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention")
    flash_attention.launches += 1
    return o, lse


class _FlashFn(torch.autograd.Function):
    """The kernel under autograd, as ``jax.custom_vjp`` holds ``_flash``:
    the forward launches with ``lse`` and saves ``(q, k, v, o, lse)`` (as
    ``_flash_fwd``); the backward launches the backward kernels, under a
    profiler range named by the mask (``flash_attention_causal_backward``
    or ``flash_attention_full_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _launch_fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        mask = "causal" if ctx.causal else "full"
        with torch.profiler.record_function(
                f"flash_attention_{mask}_backward"):
            dq, dk, dv = flash_attention_bwd(
                q, k, v, o, lse, dout.contiguous(), causal=ctx.causal,
                scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q:(B,H,S,D) k/v:(B,KH,S,D) → (B,H,S,D); GQA when KH < H.

    CPU tensors take the plain version (which autograd differentiates);
    CUDA tensors launch the kernel or raise, under autograd through
    ``_FlashFn`` (whose backward is :func:`flash_attention_bwd`) where a
    gradient is wanted; ``meta`` tensors take the same path, which
    records the kernel's work with the op counter
    (:mod:`repro_torch.roofline.kernel_work`) in place of a launch.
    ``flash_attention.launches`` counts forward launches."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)``: the plain
    version on CPU tensors, else the backward kernels (:func:`bwd_kernel`;
    a prep or delta launch, dk/dv, dq: three launches, counted once in
    ``flash_attention_bwd.launches``; on ``meta`` their work, recorded)
    or an error."""
    if _on_cpu(q, k, v, o, lse, dout):
        return flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                         causal=causal, scale=scale)
    B, H, KH, S, D = _check(q, k, v, ("o", o), ("dout", dout), ("lse", lse))
    scale = (D ** -0.5) if scale is None else float(scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    kernel = bwd_kernel(D, q.dtype)
    # delta (and, for the wgmma kernels, lse * log2 e), rows padded there
    rows = B * H * (-(-S // BWD_PAD) * BWD_PAD if kernel == "wgmma" else S)
    scratch = torch.empty(rows * (2 if kernel == "wgmma" else 1),
                          dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        flops, nbytes = kernel_work.flash_bwd_work(
            B, H, KH, S, D, str(q.dtype)[6:], causal)
        kernel_work.record("flash_attention_bwd", flops=flops,
                           nbytes=nbytes)
        return dq, dk, dv
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KH, S, D,
            scale, int(causal)]
    if kernel == "wgmma":
        dkdv_work, n_dkdv, dq_work, n_dq = _bwd_work_tensors(
            B, H, KH, S, bool(causal), q.device)
        args += [dkdv_work.data_ptr(), n_dkdv, dq_work.data_ptr(), n_dq]
    lib = _load()
    _raise_on(lib, getattr(lib, _BWD[kernel])(
        *args, torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def decode_attention(q, k_cache, v_cache, *, scale: Optional[float] = None):
    """Single-token decode: q:(B,H,1,D) against k/v:(B,KH,S,D), in torch.
    GQA by grouped einsums (the repeated-KV materialization would dominate
    decode memory at long context)."""
    B, H, Q, D = q.shape
    KH = k_cache.shape[1]
    rep = H // KH
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, KH, rep, Q, D)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k_cache.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", probs.to(q.dtype), v_cache)
    return o.reshape(B, H, Q, D)
