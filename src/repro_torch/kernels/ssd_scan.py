"""Mamba2 SSD chunked scan for Hopper: the hand-written CUDA kernel and
its wrapper, the plain version, and the one-token decode step.

Replaces the TPU kernel ``_ssd_kernel`` of ``repro/kernels/ssd_scan.py``
(launched by ``ssd_scan`` there). The kernel source is
``csrc/ssd_scan.cu``; its header says what bounds it on the H100 and what
its design does about that: two launches per call, C·Bᵀ once per
(batch, chunk) into an f32 scratch, then the per-head scan on the TF32
tensor cores in 3xTF32 (f32 accuracy). It is built by
:mod:`repro_torch.kernels.cuda_build` at first use and called through
``ctypes`` on PyTorch's current stream. Unlike the TPU kernel it also
returns the final state, so prefill seeds decode from the kernel.
:func:`ssd_chunks_plain` spells out the kernel's decomposition in torch
(C·Bᵀ per chunk, the state entering every chunk).
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
    lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                 i, p]
    lib.ssd_scan_fwd.restype = i
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
    leave the state and the causal outputs unchanged."""
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
        decay = torch.exp(seg[:, :, None, :] - seg[:, None, :, :])
        scores = torch.where(mask[None, :, :, None], cb[..., None] * decay,
                             0.0)                              # (B,L,L,H)
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
    n_chunks, L, L) f32 with L = min(chunk, S), zero above the diagonal
    and past a ragged chunk's end (the kernel's first launch computes its
    lower triangle); states (B, n_chunks, H, N, P) f32, the state entering
    each chunk; y and the final state h as :func:`ssd_scan_plain`."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    L = min(chunk, S)
    a = -torch.exp(a_log.float())
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    cbs, states, ys = [], [], []
    for t0 in range(0, S, L):
        xk, dtk = x[:, t0:t0 + L].float(), dt[:, t0:t0 + L].float()
        bk, ck = b_mat[:, t0:t0 + L].float(), c_mat[:, t0:t0 + L].float()
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
                  + xk * d_skip.float()[None, None, :, None])
        cbs.append(torch.nn.functional.pad(cb, (0, L - Lc, 0, L - Lc)))
        states.append(h)
        w = torch.exp(seg[:, -1:] - seg) * dtk                 # (B,Lc,H)
        h = torch.exp(seg[:, -1])[..., None, None] * h \
            + torch.einsum("bsn,bsh,bshp->bhnp", bk, w, xk)
    return (torch.stack(cbs, 1), torch.stack(states, 1),
            torch.cat(ys, 1).to(x.dtype), h)


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
    B, S, H, P, N = _check(*ts, chunk)
    lib = _load()
    L = min(chunk, S)
    smem = lib.ssd_scan_smem_bytes(L, P, N)
    if smem > H100_SXM.smem_bytes:
        raise ValueError(f"ssd_scan: chunk {chunk}, P {P}, N {N} need "
                         f"{smem} bytes of shared memory per block, over "
                         f"the {H100_SXM.smem_bytes} a block may have")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device) \
        if return_state else None
    cb = torch.empty((B, -(-S // L), L, lib.ssd_cb_pitch(L)),
                     dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), d_skip.data_ptr(), cb.data_ptr(), y.data_ptr(),
        h.data_ptr() if h is not None else None, B, S, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan.launches += 1
    return (y, h) if return_state else y


ssd_scan.launches = 0


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
