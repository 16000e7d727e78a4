"""Mamba2 SSD chunked scan for Hopper: the hand-written CUDA kernels of
its forward and backward and their wrappers, their plain versions, and
the one-token decode step.

Replaces the TPU kernel ``_ssd_kernel`` of ``repro/kernels/ssd_scan.py``
(launched by ``ssd_scan`` there). The kernel source is
``csrc/ssd_scan.cu``; its header says what bounds it on the H100 and what
its design does about that: two launches per call, C·Bᵀ once per
(batch, chunk) into an f32 scratch, then the per-head scan on the TF32
tensor cores in 3xTF32 (f32 accuracy). It is built by
:mod:`repro_torch.kernels.cuda_build` at first use and called through
``ctypes`` on PyTorch's current stream. Unlike the TPU kernel it also
returns the final state, so prefill seeds decode from the kernel, and,
for training, the state entering every chunk, which the backward kernels
(:func:`ssd_scan_bwd`, same source) read. :func:`ssd_chunks_plain` and
:func:`ssd_scan_bwd_plain` spell out the kernels' decompositions in torch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.hardware import H100_SXM

from . import cuda_build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("ssd_scan.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_bwd.argtypes = [p] * 16 + [i] * 6 + [p]
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_work_floats.argtypes = [i] * 6
    lib.ssd_scan_bwd_work_floats.restype = ctypes.c_size_t
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_cb_fwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.ssd_cb_fwd.restype = i
    lib.ssd_cb_pitch.argtypes = [i]
    lib.ssd_cb_pitch.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_plain(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = 128,
                   return_state: bool = False):
    """Chunked SSD in plain torch, the port of ``ssd_scan_jnp``: the
    kernel's plain version and the CPU path. x:(B,S,H,P) dt:(B,S,H)
    a_log,d_skip:(H,) b_mat,c_mat:(B,S,N) → y:(B,S,H,P), and with
    ``return_state`` also the final (B,H,N,P) f32 state. A ragged S is
    padded to a chunk multiple with dt=0 steps (decay 1, no input), which
    leave the state and the causal outputs unchanged. Unlike
    ``ssd_scan_jnp``, the decay's exponent is masked before ``exp``:
    ``exp(seg_t - seg_s)`` overflows above the diagonal once a chunk's
    ``dt A`` sums past ~88 (mamba2's A reaches -64), and autograd of a
    mask applied after it multiplies 0 by inf there (NaN gradients)."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    chunk = min(chunk, S)
    S0 = S
    if S % chunk:
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = torch.nn.functional.pad(c_mat, (0, 0, 0, pad))
        S = S + pad
    n_chunks = S // chunk
    a = -torch.exp(a_log.float())                              # (H,)
    xc = x.reshape(B, n_chunks, chunk, H, P).float()
    dtc = dt.reshape(B, n_chunks, chunk, H).float()
    bc = b_mat.reshape(B, n_chunks, chunk, N).float()
    cc = c_mat.reshape(B, n_chunks, chunk, N).float()
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for k in range(n_chunks):
        xk, dtk, bk, ck = xc[:, k], dtc[:, k], bc[:, k], cc[:, k]
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,L,H)
        cb = torch.einsum("bln,bmn->blm", ck, bk)              # (B,L,L)
        gap = torch.where(mask[None, :, :, None],
                          seg[:, :, None, :] - seg[:, None, :, :], -torch.inf)
        scores = cb[..., None] * torch.exp(gap)                # (B,L,L,H)
        dx = dtk[..., None] * xk                               # (B,L,H,P)
        y_intra = torch.einsum("blmh,bmhp->blhp", scores, dx)
        chp = torch.einsum("bln,bhnp->blhp", ck, h)
        ys.append(y_intra + torch.exp(seg)[..., None] * chp)
        total = seg[:, -1:, :]                                 # (B,1,H)
        w = torch.exp(total - seg)                             # (B,L,H)
        bh = torch.einsum("bln,blh,blhp->bhnp", bk, w * dtk, xk)
        h = torch.exp(total[:, 0, :])[:, :, None, None] * h + bh
    y = torch.stack(ys, 1).reshape(B, S, H, P)
    out = (y + x.float() * d_skip.float()[None, None, :, None]
           ).to(x.dtype)[:, :S0]
    if return_state:
        return out, h
    return out


def ssd_chunks_plain(x, dt, a_log, b_mat, c_mat, d_skip, *,
                     chunk: int = 128):
    """The kernel's decomposition in plain torch, chunk by chunk at each
    chunk's true length: C·Bᵀ once per (batch, chunk), then per head the
    masked scores, C·h and the state update. Arguments as
    :func:`ssd_scan_plain`; returns ``(cb, states, y, h)``: cb (B,
    n_chunks, L, L) with L = min(chunk, S), zero above the diagonal
    and past a ragged chunk's end (the kernel's first launch computes its
    lower triangle); states (B, n_chunks, H, N, P), the state entering
    each chunk; y and the final state h as :func:`ssd_scan_plain`. It
    computes in f32, or in f64 for f64 inputs (a reference for the
    kernels' rounding)."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    L = min(chunk, S)
    f = torch.promote_types(x.dtype, torch.float32)
    a = -torch.exp(a_log.to(f))
    h = torch.zeros((B, H, N, P), dtype=f, device=x.device)
    cbs, states, ys = [], [], []
    for t0 in range(0, S, L):
        xk, dtk = x[:, t0:t0 + L].to(f), dt[:, t0:t0 + L].to(f)
        bk, ck = b_mat[:, t0:t0 + L].to(f), c_mat[:, t0:t0 + L].to(f)
        Lc = xk.shape[1]
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,Lc,H)
        mask = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
        cb = torch.einsum("btn,bsn->bts", ck, bk).tril()       # (B,Lc,Lc)
        # exp(seg_t - seg_s) overflows above the diagonal: select first
        gap = torch.where(mask[None, :, :, None],
                          seg[:, :, None] - seg[:, None], -torch.inf)
        scores = cb[..., None] * torch.exp(gap) * dtk[:, None]  # (B,t,s,H)
        ys.append(torch.einsum("btsh,bshp->bthp", scores, xk)
                  + torch.exp(seg)[..., None]
                  * torch.einsum("btn,bhnp->bthp", ck, h)
                  + xk * d_skip.to(f)[None, None, :, None])
        cbs.append(torch.nn.functional.pad(cb, (0, L - Lc, 0, L - Lc)))
        states.append(h)
        w = torch.exp(seg[:, -1:] - seg) * dtk                 # (B,Lc,H)
        h = torch.exp(seg[:, -1])[..., None, None] * h \
            + torch.einsum("bsn,bsh,bshp->bhnp", bk, w, xk)
    return (torch.stack(cbs, 1), torch.stack(states, 1),
            torch.cat(ys, 1).to(x.dtype), h)


def ssd_scan_bwd_plain(x, dt, a_log, b_mat, c_mat, d_skip, dy, *,
                       chunk: int = 128, dh_final=None):
    """The backward kernel's decomposition in plain torch: the gradients
    ``(dx, ddt, da_log, db, dc, dd)`` of ``y = ssd_scan(x, ...)`` for an
    output gradient ``dy`` (B, S, H, P), and ``dh_final`` (B, H, N, P)
    for the final state where it has one. Chunk by chunk at each chunk's
    true length:

    * the chunk states (the state entering each chunk, as the forward
      writes them);
    * a reverse pass carrying the state gradient, ``dh <- exp(seg_L) dh
      + sum_t exp(seg_t) C_t (x) dy_t``, which gives the gradient of the
      state leaving each chunk;
    * per chunk the transposes of the forward's products: scores^T . dy
      and B . dh for dx; G = dy . x^T under the causal mask for the score
      gradient, whose product with the decay and dt gives dC and dB
      through C . B^T; dy . h^T for dC's inter-chunk part and x . dh^T for
      dB's;
    * d(seg) from every term, its in-chunk reverse cumsum times A for
      ddt, and ``sum dt . revcumsum(d seg)`` times A for da_log (A =
      -exp(a_log), dA/da_log = A).

    In f32, or in f64 for f64 inputs, as :func:`ssd_chunks_plain`.
    """
    B, S, H, P = x.shape
    f = torch.promote_types(x.dtype, torch.float32)
    L = min(chunk, S)
    x, dt, b_mat, c_mat, dy = (t.to(f) for t in (x, dt, b_mat, c_mat, dy))
    a = -torch.exp(a_log.to(f))
    _, states, _, _ = ssd_chunks_plain(x, dt, a_log, b_mat, c_mat, d_skip,
                                       chunk=chunk)
    starts = list(range(0, S, L))
    dh = torch.zeros_like(states[:, 0]) if dh_final is None \
        else dh_final.to(f)
    dstates = [None] * len(starts)
    for c in reversed(range(len(starts))):
        dstates[c] = dh
        sl = slice(starts[c], starts[c] + L)
        seg = torch.cumsum(dt[:, sl] * a, dim=1)               # (B,Lc,H)
        dh = torch.exp(seg[:, -1])[..., None, None] * dh + torch.einsum(
            "btn,bth,bthp->bhnp", c_mat[:, sl], torch.exp(seg), dy[:, sl])
    dxs, ddts, dbs, dcs = [], [], [], []
    d_a = torch.zeros_like(a)
    for c, t0 in enumerate(starts):
        sl = slice(t0, t0 + L)
        xk, dyk, dtk, bk, ck = x[:, sl], dy[:, sl], dt[:, sl], b_mat[:, sl], \
            c_mat[:, sl]
        hin, dho = states[:, c], dstates[c]                    # (B,H,N,P)
        Lc = xk.shape[1]
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,Lc,H)
        eseg = torch.exp(seg)
        mask = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
        gap = torch.where(mask[None, :, :, None],
                          seg[:, :, None] - seg[:, None], -torch.inf)
        decay = torch.exp(gap)                                 # (B,t,s,H)
        cb = torch.einsum("btn,bsn->bts", ck, bk)
        ge = torch.einsum("bthp,bshp->btsh", dyk, xk) * decay  # G . decay
        w = torch.exp(seg[:, -1:] - seg) * dtk                 # (B,Lc,H)
        bdh = torch.einsum("bsn,bhnp->bshp", bk, dho)          # B . dh
        dxs.append(torch.einsum("btsh,bthp->bshp",
                                cb[..., None] * decay * dtk[:, None], dyk)
                   + w[..., None] * bdh
                   + d_skip.to(f)[None, None, :, None] * dyk)
        dcb = ge * dtk[:, None]                                # (B,t,s,H)
        dc_inter = torch.einsum("bth,bthp,bhnp->bthn", eseg, dyk, hin)
        dbs.append(torch.einsum("btsh,btn->bsn", dcb, ck)
                   + torch.einsum("bsh,bshp,bhnp->bsn", w, xk, dho))
        dcs.append(torch.einsum("btsh,bsn->btn", dcb, bk)
                   + dc_inter.sum(2))
        colsum = torch.einsum("btsh,bts->bsh", ge, cb)
        u = torch.einsum("bshp,bshp->bsh", bdh, xk)            # dw
        dseg = (torch.einsum("btsh,bts->bth", dcb, cb) - dtk * colsum
                + torch.einsum("bthn,btn->bth", dc_inter, ck) - u * w)
        dseg[:, -1] += eseg[:, -1] * torch.einsum("bhnp,bhnp->bh", dho, hin) \
            + (u * w).sum(1)
        rc = torch.flip(torch.cumsum(torch.flip(dseg, (1,)), 1), (1,))
        ddts.append(colsum + u * torch.exp(seg[:, -1:] - seg) + a * rc)
        d_a = d_a + (dtk * rc).sum((0, 1))
    dd = torch.einsum("bshp,bshp->h", x, dy)
    return (torch.cat(dxs, 1), torch.cat(ddts, 1), d_a * a,
            torch.cat(dbs, 1), torch.cat(dcs, 1), dd)


def _check(x, dt, a_log, b_mat, c_mat, d_skip, chunk):
    names = ("x", "dt", "a_log", "b_mat", "c_mat", "d_skip")
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    for name, t in zip(names, ts):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}; the kernel "
                            "takes float32 (the model upcasts before the "
                            "scan)")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b_mat.shape[-1] if b_mat.dim() == 3 else -1
    want = {"dt": (B, S, H), "a_log": (H,), "b_mat": (B, S, N),
            "c_mat": (B, S, N), "d_skip": (H,)}
    for name, t in zip(names[1:], ts[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]} for x "
                             f"{tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk}")
    return B, S, H, P, N


def _smem_check(name, smem, chunk, P, N):
    if smem > H100_SXM.smem_bytes:
        raise ValueError(f"{name}: chunk {chunk}, P {P}, N {N} need {smem} "
                         f"bytes of shared memory per block, over the "
                         f"{H100_SXM.smem_bytes} a block may have")


def _launch_fwd(x, dt, a_log, b_mat, c_mat, d_skip, chunk, return_state,
                with_states):
    """The forward's two launches on CUDA tensors: ``(y, h, states)``, h
    the final state where ``return_state``, states the (B, n_chunks, H,
    N, P) state entering each chunk where ``with_states`` (else None)."""
    B, S, H, P, N = _check(x, dt, a_log, b_mat, c_mat, d_skip, chunk)
    lib = _load()
    L = min(chunk, S)
    _smem_check("ssd_scan", lib.ssd_scan_smem_bytes(L, P, N), chunk, P, N)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), **f32) if return_state else None
    states = torch.empty((B, -(-S // L), H, N, P), **f32) if with_states \
        else None
    cb = torch.empty((B, -(-S // L), L, lib.ssd_cb_pitch(L)), **f32)
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), d_skip.data_ptr(), cb.data_ptr(), y.data_ptr(),
        h.data_ptr() if h is not None else None,
        states.data_ptr() if states is not None else None, B, S, H, P, N,
        chunk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan.launches += 1
    return y, h, states


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = 128,
             return_state: bool = False):
    """Chunked SSD; arguments and results as :func:`ssd_scan_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (float32, contiguous) or raise. ``ssd_scan.launches`` counts the
    calls that launched them (two launches each: C·Bᵀ, then the scan)."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(x, dt, a_log, b_mat, c_mat, d_skip,
                              chunk=chunk, return_state=return_state)
    y, h, _ = _launch_fwd(*ts, chunk, return_state, False)
    return (y, h) if return_state else y


ssd_scan.launches = 0


def ssd_scan_with_states(x, dt, a_log, b_mat, c_mat, d_skip, *,
                         chunk: int = 128, return_state: bool = False):
    """The forward for training: ``(y, h, states)``, h the final state
    (None without ``return_state``) and states the (B, n_chunks, H, N, P)
    f32 state entering each chunk, which :func:`ssd_scan_bwd` reads. CPU
    tensors take :func:`ssd_chunks_plain`; CUDA tensors launch the
    forward kernels (counted in ``ssd_scan.launches``) or raise."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts):
        _, states, y, h = ssd_chunks_plain(*ts, chunk=chunk)
        return y, h if return_state else None, states
    return _launch_fwd(*ts, chunk, return_state, True)


def ssd_scan_bwd(x, dt, a_log, b_mat, c_mat, d_skip, dy, states, *,
                 chunk: int = 128, dh_final=None):
    """The gradients ``(dx, ddt, da_log, db, dc, dd)`` of the chunked SSD
    for an output gradient ``dy`` (B, S, H, P) and, where the forward
    returned the final state, its gradient ``dh_final`` (B, H, N, P) or
    None; ``states`` are the forward's chunk states
    (:func:`ssd_scan_with_states`). CPU tensors take
    :func:`ssd_scan_bwd_plain` (which recomputes the states); CUDA
    tensors launch the backward kernels (float32, contiguous) or raise.
    ``ssd_scan_bwd.launches`` counts the calls that launched them (four
    launches each: C·Bᵀ, the state gradients, the chunks, the sums over
    heads and chunks)."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts + (dy,)):
        return ssd_scan_bwd_plain(*ts, dy, chunk=chunk, dh_final=dh_final)
    B, S, H, P, N = _check(*ts, chunk)
    L = min(chunk, S)
    want = {"dy": (dy, (B, S, H, P)),
            "states": (states, (B, -(-S // L), H, N, P))}
    if dh_final is not None:
        want["dh_final"] = (dh_final, (B, H, N, P))
    for name, (t, shape) in want.items():
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan_bwd: {name} must be a contiguous "
                             f"f32 {shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _load()
    _smem_check("ssd_scan_bwd", lib.ssd_scan_bwd_smem_bytes(L, P, N), chunk,
                P, N)
    work = torch.empty((lib.ssd_scan_bwd_work_floats(B, S, H, P, N, chunk),),
                       dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(t) for t in ts]
    err = lib.ssd_scan_bwd(
        *(t.data_ptr() for t in ts), dy.data_ptr(), states.data_ptr(),
        dh_final.data_ptr() if dh_final is not None else None,
        work.data_ptr(), *(g.data_ptr() for g in grads), B, S, H, P, N,
        chunk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan_bwd kernel: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan_bwd.launches += 1
    return tuple(grads)


ssd_scan_bwd.launches = 0


def ssd_cb_kernel(b_mat, c_mat, *, chunk: int = 128):
    """The scan's first launch alone, on the card: C·Bᵀ per (batch,
    chunk) as (B, n_chunks, L, L), zero where the kernel writes nothing
    (above the diagonal, past a ragged chunk's end). It lets the card
    tests hold the kernel's intermediate against
    :func:`ssd_chunks_plain`; the model never calls it."""
    B, S, N = b_mat.shape
    for name, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != b_mat.shape:
            raise ValueError(f"ssd_cb_kernel: {name} must be a contiguous "
                             "f32 (B, S, N) tensor on the card")
    L = min(chunk, S)
    lib = _load()
    cb = torch.zeros((B, -(-S // L), L, lib.ssd_cb_pitch(L)),
                     dtype=torch.float32, device=b_mat.device)
    err = lib.ssd_cb_fwd(b_mat.data_ptr(), c_mat.data_ptr(), cb.data_ptr(),
                         B, S, N, chunk,
                         torch.cuda.current_stream(b_mat.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_cb kernel: "
                           + lib.ssd_scan_error_string(err).decode())
    return cb[..., :L]


def ssd_decode_step(h, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One-token recurrent update for serving, in torch. h:(B,H,N,P)
    x_t:(B,H,P) dt_t:(B,H) b_t/c_t:(B,N) → (h', y_t:(B,H,P))."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_t * a)                                # (B,H)
    dbx = torch.einsum("bn,bh,bhp->bhnp", b_t, dt_t, x_t)
    h = decay[..., None, None] * h + dbx
    y = torch.einsum("bn,bhnp->bhp", c_t, h) + d_skip[None, :, None] * x_t
    return h, y
