"""Mamba2 SSD chunked scan for Hopper: the hand-written CUDA kernels of
its forward and backward and their wrappers, their plain versions, and
the one-token decode step.

Replaces the TPU kernel ``_ssd_kernel`` of ``repro/kernels/ssd_scan.py``
(launched by ``ssd_scan`` there). The kernel source is
``csrc/ssd_scan.cu``; its notes say what bounds it on the H100 and what
its designs do about that. The forward has two kinds of launches, picked
by shape before the launch (:func:`ssd_fwd_kind`): ``wgmma`` at the
Mamba2 / Zamba2 widths, four launches (C·Bᵀ once per (batch, chunk); every
chunk's own state and per-head vectors; the states passed from chunk to
chunk; each chunk's output from the state entering it), the products TF32
``wgmma`` fed by TMA; ``mma_sync`` elsewhere, two launches (C·Bᵀ, then the
per-head scan on ``mma.sync``). Every product is 3xTF32 (f32 accuracy). It
is built by
:mod:`repro_torch.kernels.cuda_build` at first use and called through
``ctypes`` on PyTorch's current stream. Unlike the TPU kernel it also
returns the final state, so prefill seeds decode from the kernel, and,
for training, the state entering every chunk, which the backward kernels
(:func:`ssd_scan_bwd`, same source) read. :func:`ssd_chunks_plain`,
:func:`ssd_passed_states_plain`, :func:`ssd_out_plain`,
:func:`ssd_scan_bwd_plain`, :func:`ssd_state_grads_plain` and
:func:`ssd_dbdc_plain` spell out the kernels' decompositions in torch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.roofline import kernel_work

from . import cuda_build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("ssd_scan.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_fwd_sm90.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.ssd_scan_fwd_sm90.restype = i
    lib.ssd_scan_fwd_sm90_work_floats.argtypes = [i] * 7
    lib.ssd_scan_fwd_sm90_work_floats.restype = ctypes.c_size_t
    lib.ssd_scan_fwd_sm90_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_fwd_sm90_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_scan_bwd.argtypes = [p] * 16 + [i] * 6 + [p]
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_work_floats.argtypes = [i] * 6
    lib.ssd_scan_bwd_work_floats.restype = ctypes.c_size_t
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_scan_bwd_sm90.argtypes = [p] * 16 + [i] * 6 + [p]
    lib.ssd_scan_bwd_sm90.restype = i
    lib.ssd_scan_bwd_sm90_work_floats.argtypes = [i] * 6
    lib.ssd_scan_bwd_sm90_work_floats.restype = ctypes.c_size_t
    lib.ssd_scan_bwd_sm90_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_bwd_sm90_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_tf32_unit_sm90.argtypes = [p, p, p, i, p]
    lib.ssd_tf32_unit_sm90.restype = i
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


def ssd_passed_states_plain(x, dt, a_log, b_mat, *, chunk: int = 128):
    """The chunk states and the final state as the forward's wgmma kind
    computes them (Dao & Gu 2024, §7's state passing): first every chunk's
    own term ``local_c = sum_s exp(seg_L - seg_s) dt_s B_s (x) x_s`` and
    its decay ``exp(seg_L)``, each chunk on its own; then a pass that is
    elementwise only, ``states[c] = decay[c - 1] states[c - 1] + local[c -
    1]`` from ``states[0] = 0``, and the final state ``decay[-1]
    states[-1] + local[-1]``. Returns ``(states, h)``, (B, n_chunks, H, N,
    P) and (B, H, N, P). Chunks at their true length; f32, or f64 for f64
    inputs, as :func:`ssd_chunks_plain`."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    L = min(chunk, S)
    a = -torch.exp(a_log.to(f))
    local, decay = [], []
    for t0 in range(0, S, L):
        dtk = dt[:, t0:t0 + L].to(f)
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,Lc,H)
        w = torch.exp(seg[:, -1:] - seg) * dtk
        local.append(torch.einsum("bsn,bsh,bshp->bhnp",
                                  b_mat[:, t0:t0 + L].to(f), w,
                                  x[:, t0:t0 + L].to(f)))
        decay.append(torch.exp(seg[:, -1]))                    # (B,H)
    h = torch.zeros((B, H, N, P), dtype=f, device=x.device)
    states = []
    for loc, dec in zip(local, decay):
        states.append(h)
        h = dec[..., None, None] * h + loc
    return torch.stack(states, 1), h


def ssd_out_plain(x, dt, a_log, b_mat, c_mat, d_skip, states, *,
                  chunk: int = 128):
    """y as the forward's wgmma kind computes it from the chunk states
    (``states[:, c]`` the state entering chunk c, (B, n_chunks, H, N, P)):
    per chunk and head ``y = M . x + (exp(seg) o C) . h_in``, M[t, s] =
    (C_t . B_s) exp(seg_t - seg_s) dt_s for s <= t (the mask applied before
    the exponential) with D added on its diagonal, which is y's ``D x``.
    Other arguments as :func:`ssd_scan_plain`; f32, or f64 for f64
    inputs."""
    B, S, H, P = x.shape
    f = torch.promote_types(x.dtype, torch.float32)
    L = min(chunk, S)
    a = -torch.exp(a_log.to(f))
    ys = []
    for c, t0 in enumerate(range(0, S, L)):
        xk, dtk = x[:, t0:t0 + L].to(f), dt[:, t0:t0 + L].to(f)
        bk, ck = b_mat[:, t0:t0 + L].to(f), c_mat[:, t0:t0 + L].to(f)
        Lc = xk.shape[1]
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,Lc,H)
        mask = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
        gap = torch.where(mask[None, :, :, None],
                          seg[:, :, None] - seg[:, None], -torch.inf)
        m = torch.einsum("btn,bsn->bts", ck, bk)[..., None] \
            * torch.exp(gap) * dtk[:, None]                    # (B,t,s,H)
        m = m + torch.eye(Lc, dtype=f, device=x.device)[None, :, :, None] \
            * d_skip.to(f)
        ys.append(torch.einsum("btsh,bshp->bthp", m, xk)
                  + torch.exp(seg)[..., None]
                  * torch.einsum("btn,bhnp->bthp", ck, states[:, c].to(f)))
    return torch.cat(ys, 1).to(x.dtype)


def ssd_state_grads_plain(dt, a_log, c_mat, dy, *, chunk: int = 128,
                          dh_final=None):
    """The gradient of the state leaving each chunk, (B, n_chunks, H, N,
    P), as the backward kernels compute it (Dao & Gu 2024, §7's state
    passing, in reverse): first every chunk's own term ``local_c = sum_t
    exp(seg_t) C_t (x) dy_t`` and its decay ``exp(seg_L)``, each chunk on
    its own; then a pass that is elementwise only, ``dh_c = exp(seg_L of
    c + 1) dh_{c+1} + local_{c+1}``, from ``dh_final`` (or zeros) for the
    last chunk. Chunks at their true length; f32, or f64 for f64 inputs,
    as :func:`ssd_chunks_plain`."""
    B, S, H, P = dy.shape
    N = c_mat.shape[-1]
    f = torch.promote_types(dy.dtype, torch.float32)
    L = min(chunk, S)
    a = -torch.exp(a_log.to(f))
    local, decay = [], []
    for t0 in range(0, S, L):
        seg = torch.cumsum(dt[:, t0:t0 + L].to(f) * a, dim=1)  # (B,Lc,H)
        local.append(torch.einsum("btn,bth,bthp->bhnp",
                                  c_mat[:, t0:t0 + L].to(f), torch.exp(seg),
                                  dy[:, t0:t0 + L].to(f)))
        decay.append(torch.exp(seg[:, -1]))                    # (B,H)
    dh = torch.zeros((B, H, N, P), dtype=f, device=dy.device) \
        if dh_final is None else dh_final.to(f)
    out = [dh]
    for c in range(len(local) - 1, 0, -1):
        dh = decay[c][..., None, None] * dh + local[c]
        out.append(dh)
    return torch.stack(out[::-1], 1)


def ssd_dbdc_plain(x, dt, a_log, b_mat, c_mat, dy, states, dstates, *,
                   chunk: int = 128, group: int):
    """``(db, dc)`` summed over the heads as the backward kernels sum
    them (``BWD_GROUP`` in ``ssd_scan.cu``). Per chunk, with GE_h[t, s]
    = (dy_t . x_s) exp(seg_t - seg_s) under the causal mask, each group
    of ``group`` heads sums ``dt_{h,s} GE_h[t, s]`` in head order into
    one partial, the partials are summed in group order into GE_sum, and

    * ``dB = GE_sum^T . C + sum_(h,p) (w x)[s, (h,p)] dh[(h,p), n]``,
    * ``dC = GE_sum . B + sum_(h,p) (exp(seg) dy)[t, (h,p)] h_in[(h,p), n]``,

    w = exp(seg_L - seg) dt; ``states`` (the state entering each chunk)
    and ``dstates`` (the gradient of the state leaving it) are (B,
    n_chunks, H, N, P). f32, or f64 for f64 inputs."""
    B, S, H, P = x.shape
    f = torch.promote_types(x.dtype, torch.float32)
    L = min(chunk, S)
    x, dt, b_mat, c_mat, dy = (t.to(f) for t in (x, dt, b_mat, c_mat, dy))
    a = -torch.exp(a_log.to(f))
    dbs, dcs = [], []
    for c, t0 in enumerate(range(0, S, L)):
        sl = slice(t0, t0 + L)
        xk, dyk, dtk = x[:, sl], dy[:, sl], dt[:, sl]
        Lc = xk.shape[1]
        seg = torch.cumsum(dtk * a, dim=1)                     # (B,Lc,H)
        mask = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
        gap = torch.where(mask[None, :, :, None],
                          seg[:, :, None] - seg[:, None], -torch.inf)
        dge = torch.einsum("bthp,bshp->btsh", dyk, xk) * torch.exp(gap) \
            * dtk[:, None]                                     # (B,t,s,H)
        ge_sum = sum(dge[..., h0:h0 + group].sum(-1)
                     for h0 in range(0, H, group))             # (B,t,s)
        w = torch.exp(seg[:, -1:] - seg) * dtk                 # (B,Lc,H)
        xw = (w[..., None] * xk).reshape(B, Lc, H * P)
        ye = (torch.exp(seg)[..., None] * dyk).reshape(B, Lc, H * P)
        dho = dstates[:, c].to(f).transpose(2, 3).reshape(B, H * P, -1)
        hin = states[:, c].to(f).transpose(2, 3).reshape(B, H * P, -1)
        dbs.append(torch.einsum("bts,btn->bsn", ge_sum, c_mat[:, sl])
                   + xw @ dho)
        dcs.append(torch.einsum("bts,bsn->btn", ge_sum, b_mat[:, sl])
                   + ye @ hin)
    return torch.cat(dbs, 1), torch.cat(dcs, 1)


def ssd_scan_bwd_plain(x, dt, a_log, b_mat, c_mat, d_skip, dy, *,
                       chunk: int = 128, dh_final=None):
    """The backward kernels' decomposition in plain torch: the gradients
    ``(dx, ddt, da_log, db, dc, dd)`` of ``y = ssd_scan(x, ...)`` for an
    output gradient ``dy`` (B, S, H, P), and ``dh_final`` (B, H, N, P)
    for the final state where it has one. Chunk by chunk at each chunk's
    true length:

    * the chunk states (the state entering each chunk, as the forward
      writes them);
    * the gradient of the state leaving each chunk
      (:func:`ssd_state_grads_plain`: local terms, then the passing);
    * per chunk the transposes of the forward's products: scores^T . dy
      and B . dh for dx; G = dy . x^T under the causal mask for the score
      gradient, whose product with the decay and dt gives dC and dB
      through C . B^T; dy . h^T for dC's inter-chunk part and x . dh^T for
      dB's; each head's dB and dC summed over the heads;
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
    dstates = ssd_state_grads_plain(dt, a_log, c_mat, dy, chunk=chunk,
                                    dh_final=dh_final)
    dxs, ddts, dbs, dcs = [], [], [], []
    d_a = torch.zeros_like(a)
    for c, t0 in enumerate(range(0, S, L)):
        sl = slice(t0, t0 + L)
        xk, dyk, dtk, bk, ck = x[:, sl], dy[:, sl], dt[:, sl], b_mat[:, sl], \
            c_mat[:, sl]
        hin, dho = states[:, c], dstates[:, c]                 # (B,H,N,P)
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
        if t.device != x.device or t.device.type not in ("cuda", "meta"):
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


# Sizes of csrc/ssd_scan.cu's shared memory and scratch, as its
# host-side functions compute them (scan_smem_floats, bwd_dims,
# local_smem_bytes, chunk_smem_bytes, dbdc_smem_bytes, bwd_work; for the
# wgmma kinds the Sm90 shared-memory structs, bwd_work_sm90 and
# fwd_work_sm90): one formula for the card and for ``meta``, where no
# library is loaded. The card tests hold them equal to the library's
# exports.
_CHUNK_WARPS = 512 // 32
_DBDC_SMEM_BYTES = 4 * 4 * ((64 + 64) * (32 + 4) + 64)
# the wgmma kind's ring stage (S9_STAGE bytes), the steps a chunk is
# padded to (S9_LP) and the floats of a head's per-step parts (S9_PARTS)
_S9_STAGE, _S9_LP = 32768, 128
_S9_PARTS = 11 * _S9_LP + 16
# the two kinds of launches of the forward (ssd_fwd_kind) and of the
# backward (ssd_bwd_kind)
SSD_BWD_KINDS = ("mma_sync", "wgmma")


def _sm90_shape(L: int, P: int, N: int) -> bool:
    return P == 64 and N in (64, 128) and 1 <= L <= _S9_LP


# The forward's mma_sync kind runs a block per (b, h), two an SM, each
# walking its chunks in order; the wgmma kind runs the chunks in parallel.
# The mma_sync kind is taken at the wgmma widths only where its B·H blocks
# keep the card's 2 x 132 block slots busier than this share, over the
# waves they take. On the H100 (PERF.md §6) the wgmma kind is the faster at
# B·H 128 and 160 (mamba2-1.3b's and zamba2-2.7b's train shapes: 48 and 61
# % busy) and at zamba2's serve prefill of 4 rows (320 blocks, two waves:
# 61 %), and the slower at mamba2's (256 blocks: 97 %).
SSD_FWD_MMA_SYNC_FILL = 0.8


def ssd_fwd_kind(L: int, P: int, N: int, bh: int = 0) -> str:
    """Which forward launches a call with chunks of L steps (min(chunk,
    S)), head dim P, state dim N and ``bh`` batch rows times heads (0: not
    known) takes: ``"wgmma"`` (four launches, the chunks in parallel, TF32
    wgmma in 3xTF32, operands by TMA) at P 64, N 64 or 128 and L at most
    128 — the Mamba2 and Zamba2 widths — unless the mma_sync kind's grid
    of bh blocks, two an SM, fills the card's block slots over its waves
    by more than ``SSD_FWD_MMA_SYNC_FILL``; else ``"mma_sync"`` (two
    launches, m16n8k8 mma.sync, a block per (b, h)), which takes every
    shape. Decided before the launch, never after a failure."""
    if not _sm90_shape(L, P, N):
        return "mma_sync"
    slots = 2 * H100_SXM.sm_count
    fill = bh / (slots * -(-bh // slots)) if bh > 0 else 0.0
    return "mma_sync" if fill > SSD_FWD_MMA_SYNC_FILL else "wgmma"


def ssd_bwd_kind(L: int, P: int, N: int) -> str:
    """Which backward launches a call with chunks of L steps (min(chunk,
    S)), head dim P and state dim N takes: ``"wgmma"`` (TF32 wgmma in
    3xTF32, operands by TMA: P 64, N 64 or 128, L at most 128 — the
    Mamba2 and Zamba2 widths) or ``"mma_sync"`` (m16n8k8 mma.sync, every
    other shape), decided before the launch, never after a failure."""
    return "wgmma" if _sm90_shape(L, P, N) else "mma_sync"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cb_pitch(L: int) -> int:
    """Row pitch of the forward's C·Bᵀ scratch (B, n_chunks, L, pitch)."""
    return _round_up(L, 2)


def scan_smem_bytes(L: int, P: int, N: int) -> int:
    """Dynamic shared memory of one forward scan block for L steps."""
    Lp, pitch = _round_up(L, 16), _round_up(P, 8) + 4
    return 4 * (2 * Lp * pitch + _round_up(N, 16) * pitch + 4 * Lp)


def _kind_of(L: int, P: int, N: int, kind, name="ssd_scan_bwd",
             bh=None) -> str:
    """``kind``, or where it is None the shape's: the backward's
    (:func:`ssd_bwd_kind`), or with ``bh`` the forward's
    (:func:`ssd_fwd_kind`). A kind that cannot take the shape raises."""
    if kind is None:
        return ssd_bwd_kind(L, P, N) if bh is None \
            else ssd_fwd_kind(L, P, N, bh)
    if kind not in SSD_BWD_KINDS:
        raise ValueError(f"{name}: kind {kind!r}, not one of "
                         f"{SSD_BWD_KINDS}")
    if kind == "wgmma" and not _sm90_shape(L, P, N):
        raise ValueError(f"{name}: the wgmma kind takes P 64, N 64 "
                         f"or 128 and chunks of at most 128 steps, not L "
                         f"{L}, P {P}, N {N}")
    return kind


def fwd_smem_bytes(L: int, P: int, N: int, kind=None) -> int:
    """Dynamic shared memory of the forward's largest block for L steps,
    for ``kind`` (default: the wgmma kind where the widths allow it)."""
    if _kind_of(L, P, N, kind, "ssd_scan", 0) == "wgmma":
        # StateSm90Smem<N> (Bᵀ's hi / lo A tiles, a ring of 3 stages at N
        # 128 and 4 at N 64, x's hi / lo B tiles: both warpgroups' at N
        # 128, each one's at N 64; each warpgroup's 64 x 64 result for its
        # TMA store; the heads' w; the barriers) and OutSm90Smem<N> (C·Bᵀ's
        # 10 boxes on and
        # below the diagonal and C once a block, a ring of 2 stages at N 128
        # and 6 at N 64, two hi / lo B tiles both warpgroups share, each
        # warpgroup's two hi / lo A tiles, two heads' dt, seg and exp(seg),
        # the barriers), + 1024 bytes to align its base
        tile = 32 * 128                    # a 32 x 32 f32 box
        sst = 3 if N == 128 else 4
        state = 2 * 4 * N * 128 + sst * 2 * tile \
            + (1 if N == 128 else 2) * 2 * 2 * 64 * 128 + 2 * 64 * 64 * 4 \
            + 4 * 8 * _S9_LP + 8 * (2 + 2 * sst)
        st = 2 if N == 128 else 6
        out = (10 + (N // 32) * 4 + st * 2) * tile + 3 * 2 * 2 * 64 * 128 \
            + 4 * 2 * 3 * _S9_LP + 8 * (1 + 2 * st + 4)
        return 1024 + max(state, out)
    return scan_smem_bytes(L, P, N)


def fwd_work_floats(B: int, S: int, H: int, P: int, N: int,
                    chunk: int = 128, kind=None, states: bool = False) -> int:
    """Floats of one forward call's scratch for ``kind`` (default:
    :func:`ssd_fwd_kind`'s at B·H). ``mma_sync``: C·Bᵀ (B, n_chunks, L,
    cb_pitch(L)). ``wgmma``: C·Bᵀ in rows of 128, the chunks' decays, dt,
    seg and exp(seg) in rows of 128, and, where the call keeps no chunk
    states (``states`` False: the serve path), the states themselves,
    each rounded up to 32 floats."""
    L = min(chunk, S)
    bnc = B * -(-S // L)
    if _kind_of(L, P, N, kind, "ssd_scan", B * H) == "wgmma":
        vec = bnc * H * _S9_LP
        sizes = (bnc * L * _S9_LP, bnc * H, vec, vec, vec,
                 0 if states else bnc * H * N * P)
        return sum(_round_up(n, 32) for n in sizes)
    return bnc * L * cb_pitch(L)


def bwd_smem_bytes(L: int, P: int, N: int, kind=None) -> int:
    """Dynamic shared memory of the backward's largest block for L steps,
    for ``kind`` (default: :func:`ssd_bwd_kind`'s)."""
    if _kind_of(L, P, N, kind) == "wgmma":
        # LocalSm90Smem<N>, ChunkSm90Smem<N>, DbdcSm90Smem<N> (their rings
        # of 4, 3 and 3 stages), each + 1024 bytes to align its base
        tile = 32 * 128                    # a 32 x 32 f32 box
        local = (N // 32) * 4 * tile + 4 * 2 * tile + 2 * 2 * 2 * 64 * 128 \
            + 4 * 8 * _S9_LP + 8 * (1 + 2 * 4)
        chunk = 3 * _S9_STAGE + 2 * (2 * 2 * 64 * 128) \
            + 4 * 64 * (64 + 8 + 128 + 8) + 4 * 2 * 4 * _S9_LP \
            + 8 * (2 * 3 + 4)
        dbdc = 3 * _S9_STAGE + 2 * 2 * 2 * N * 128 + 4 * 3 * _S9_LP \
            + 8 * 2 * 3
        return 1024 + max(local, chunk, dbdc)
    Lp, Pp, Nk = _round_up(L, 32), _round_up(P, 32), _round_up(N, 8)
    pitch2 = Pp + 4
    local = 8 * Lp * pitch2 + 4 * 3 * Lp
    floats = 10 * Lp + Lp * (Lp // 32) + Lp * (Lp // 16) \
        + 2 * Lp * (Pp // 32) + 2 * _CHUNK_WARPS
    chunk = 8 * (2 * Lp + Nk) * pitch2 + 4 * floats
    return max(local, chunk, _DBDC_SMEM_BYTES)


def bwd_work_floats(B: int, S: int, H: int, P: int, N: int,
                    chunk: int = 128, kind=None) -> int:
    """Floats of one backward call's workspace for ``kind`` (default:
    :func:`ssd_bwd_kind`'s). ``mma_sync``: C·Bᵀ, the state gradients, the
    chunks' decays, w and exp(seg), the head groups' GE sums, the
    per-chunk dD and dA sums, each rounded up to 4 floats. ``wgmma``: C·Bᵀ
    in rows of 128, the state gradients, the decays, dt, seg, exp(seg)
    and w in rows of 128, the GE sums, each head's per-step parts, the
    per-chunk sums, each rounded up to 32 floats."""
    L = min(chunk, S)
    bnc = B * -(-S // L)
    ng = -(-H // SSD_BWD_GROUP)
    if _kind_of(L, P, N, kind) == "wgmma":
        vec = bnc * H * _S9_LP
        sizes = (bnc * L * _S9_LP, bnc * H * N * P, bnc * H, vec, vec, vec,
                 vec, bnc * ng * _S9_LP * _S9_LP, bnc * H * _S9_PARTS,
                 bnc * H * 2)
        return sum(_round_up(n, 32) for n in sizes)
    Lp = _round_up(L, 32)
    sizes = (bnc * L * cb_pitch(L), bnc * H * N * P, bnc * H, bnc * H * L,
             bnc * H * L, bnc * ng * Lp * Lp, bnc * H * 2)
    return sum(_round_up(n, 4) for n in sizes)


def _smem_check(name, smem, chunk, P, N):
    if smem > H100_SXM.smem_bytes:
        raise ValueError(f"{name}: chunk {chunk}, P {P}, N {N} need {smem} "
                         f"bytes of shared memory per block, over the "
                         f"{H100_SXM.smem_bytes} a block may have")


def _launch_fwd(x, dt, a_log, b_mat, c_mat, d_skip, chunk, return_state,
                with_states, kind):
    """The forward's launches of ``kind`` on CUDA tensors: ``(y, h,
    states)``, h the final state where ``return_state``, states the (B,
    n_chunks, H, N, P) state entering each chunk where ``with_states``
    (else None)."""
    B, S, H, P, N = _check(x, dt, a_log, b_mat, c_mat, d_skip, chunk)
    L = min(chunk, S)
    kind = _kind_of(L, P, N, kind, "ssd_scan", B * H)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), **f32) if return_state else None
    states = torch.empty((B, -(-S // L), H, N, P), **f32) if with_states \
        else None
    _smem_check("ssd_scan", fwd_smem_bytes(L, P, N, kind), chunk, P, N)
    work = torch.empty((fwd_work_floats(B, S, H, P, N, chunk, kind,
                                        with_states),), **f32)
    if x.device.type == "meta":
        nbytes, flops = kernel_work.ssd_work(B, S, H, P, N, L)
        if with_states:      # the chunk states, written once
            nbytes += 4 * states.numel()
        kernel_work.record("ssd_scan", flops=flops, nbytes=nbytes)
        return y, h, states
    lib = _load()
    opt = [t.data_ptr() if t is not None else None for t in (h, states)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ins = [t.data_ptr() for t in (x, dt, a_log, b_mat, c_mat, d_skip)]
    if kind == "wgmma":
        err = lib.ssd_scan_fwd_sm90(*ins, work.data_ptr(), y.data_ptr(), *opt,
                                    B, S, H, P, N, chunk, stream)
    else:
        err = lib.ssd_scan_fwd(*ins, work.data_ptr(), y.data_ptr(), *opt, B,
                               S, H, P, N, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel ({kind}): "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan.launches += 1
    return y, h, states


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = 128,
             return_state: bool = False, kind=None):
    """Chunked SSD; arguments and results as :func:`ssd_scan_plain`.

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    ``kind`` (default: :func:`ssd_fwd_kind`'s; float32, contiguous) or
    raise; ``meta`` tensors record the kernels' work with the op counter
    (:mod:`repro_torch.roofline.kernel_work`). ``ssd_scan.launches`` counts
    the calls that launched them (``SSD_FWD_LAUNCHES[kind]`` each: the
    wgmma kind's four, C·Bᵀ, the chunks' own states, their passing, the
    outputs; the mma_sync kind's two, C·Bᵀ and the scan). The wgmma kind
    keeps the chunk states in its workspace here: 21 MB at zamba2-2.7b's
    serve prefill of 4 rows of 512 steps, 33.5 MB at mamba2-1.3b's widths
    (where the dispatch takes mma_sync)."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(x, dt, a_log, b_mat, c_mat, d_skip,
                              chunk=chunk, return_state=return_state)
    y, h, _ = _launch_fwd(*ts, chunk, return_state, False, kind)
    return (y, h) if return_state else y


ssd_scan.launches = 0


def ssd_scan_with_states(x, dt, a_log, b_mat, c_mat, d_skip, *,
                         chunk: int = 128, return_state: bool = False,
                         kind=None):
    """The forward for training: ``(y, h, states)``, h the final state
    (None without ``return_state``) and states the (B, n_chunks, H, N, P)
    f32 state entering each chunk, which :func:`ssd_scan_bwd` reads. CPU
    tensors take :func:`ssd_chunks_plain`; CUDA tensors launch the forward
    kernels of ``kind`` (default: :func:`ssd_fwd_kind`'s; counted in
    ``ssd_scan.launches``) or raise; ``meta`` tensors record their
    work."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts):
        _, states, y, h = ssd_chunks_plain(*ts, chunk=chunk)
        return y, h if return_state else None, states
    return _launch_fwd(*ts, chunk, return_state, True, kind)


# the kernels one forward call of each kind launches, in order, as the
# profiler names them
SSD_FWD_LAUNCHES = {
    "mma_sync": ("ssd_cb_kernel", "ssd_scan_kernel"),
    "wgmma": ("ssd_cb_kernel", "ssd_fwd_state_sm90_kernel",
              "ssd_fwd_pass_kernel", "ssd_fwd_out_sm90_kernel")}


def bwd_chunk(chunk: int, S: int) -> int:
    """The chunk the backward kernels run at for a call with ``chunk`` over
    S steps: ``chunk`` itself where its chunks have at most ``_S9_LP``
    (128) steps, else ``_S9_LP``. The chunked SSD's gradients do not
    depend on the chunk length in exact arithmetic, so a longer chunk's
    are those of its 128-step sub-chunks (the last one partial where S is
    not a multiple of 128)."""
    return chunk if min(chunk, S) <= _S9_LP else _S9_LP


def ssd_scan_bwd(x, dt, a_log, b_mat, c_mat, d_skip, dy, states, *,
                 chunk: int = 128, dh_final=None, kind=None):
    """The gradients ``(dx, ddt, da_log, db, dc, dd)`` of the chunked SSD
    for an output gradient ``dy`` (B, S, H, P) and, where the forward
    returned the final state, its gradient ``dh_final`` (B, H, N, P) or
    None; ``states`` are the forward's chunk states
    (:func:`ssd_scan_with_states`). CPU tensors take
    :func:`ssd_scan_bwd_plain` at the kernels' chunk (it recomputes the
    states); CUDA tensors launch the backward kernels of ``kind`` (default:
    :func:`ssd_bwd_kind`'s; float32, contiguous) or raise; ``meta``
    tensors record their work. The kernels take chunks of at most 128
    steps: a longer chunk runs them at 128-step sub-chunks
    (:func:`bwd_chunk`), from the states at the sub-chunks' boundaries,
    which the forward kernels recompute first (one more forward call,
    counted in ``ssd_scan.launches``; ``states`` is then checked and not
    read). ``ssd_scan_bwd.launches`` counts the calls that launched them
    (``SSD_BWD_LAUNCHES[kind]``: C·Bᵀ, the chunks' local state gradients
    (and, in the wgmma kind, every chunk's per-head vectors), their
    passing, the per-head chunk gradients (in the wgmma kind two
    launches: the products, then each head's d(seg) and ddt), dB and dC,
    the sums over chunks)."""
    ts = (x, dt, a_log, b_mat, c_mat, d_skip)
    if all(t.device.type == "cpu" for t in ts + (dy,)):
        return ssd_scan_bwd_plain(*ts, dy, chunk=bwd_chunk(chunk, x.shape[1]),
                                  dh_final=dh_final)
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
    bchunk = bwd_chunk(chunk, S)
    Lb = min(bchunk, S)
    kind = _kind_of(Lb, P, N, kind)
    _smem_check("ssd_scan_bwd", bwd_smem_bytes(Lb, P, N, kind), chunk, P, N)
    if bchunk != chunk:
        # the states entering each 128-step sub-chunk, from the forward
        # kernels at that chunk (their output y is not needed)
        states = _launch_fwd(*ts, bchunk, False, True, None)[2]
    work = torch.empty((bwd_work_floats(B, S, H, P, N, bchunk, kind),),
                       dtype=torch.float32, device=x.device)
    grads = [torch.empty_like(t) for t in ts]
    if x.device.type == "meta":
        nbytes, flops = kernel_work.ssd_bwd_work(B, S, H, P, N, Lb)
        kernel_work.record("ssd_scan_bwd", flops=flops, nbytes=nbytes)
        return tuple(grads)
    lib = _load()
    entry = lib.ssd_scan_bwd_sm90 if kind == "wgmma" else lib.ssd_scan_bwd
    err = entry(
        *(t.data_ptr() for t in ts), dy.data_ptr(), states.data_ptr(),
        dh_final.data_ptr() if dh_final is not None else None,
        work.data_ptr(), *(g.data_ptr() for g in grads), B, S, H, P, N,
        bchunk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel ({kind}): "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan_bwd.launches += 1
    return tuple(grads)


ssd_scan_bwd.launches = 0
# the kernels one ssd_scan_bwd call of each kind launches, in order, as the
# profiler names them (the mma_sync kind's local one only where there is
# more than one chunk)
SSD_BWD_LAUNCHES = {
    "mma_sync": ("ssd_cb_kernel", "ssd_bwd_local_kernel",
                 "ssd_bwd_pass_kernel", "ssd_bwd_chunk_kernel",
                 "ssd_bwd_dbdc_kernel", "ssd_bwd_reduce_kernel"),
    "wgmma": ("ssd_cb_kernel", "ssd_bwd_local_sm90_kernel",
              "ssd_bwd_pass_kernel", "ssd_bwd_chunk_sm90_kernel",
              "ssd_bwd_finish_kernel", "ssd_bwd_dbdc_sm90_kernel",
              "ssd_bwd_reduce_kernel")}


# Launch geometry of csrc/ssd_scan.cu, for the static verifier
# (repro_torch.verify.grid_check.ssd_scan_models): threads of an
# elementwise block, C·Bᵀ tiles of a block, heads a chunk block sums
# over, dB/dC output tiles of an mma_sync block, heads of a wgmma local
# (and forward state) block and of a forward output block.
SSD_THREADS = 256
SSD_CB_TILE = (16, 32)
SSD_BWD_GROUP = 8
SSD_DBDC_TILE = (64, 64)
SSD_LOCAL_GROUP = 8
SSD_OUT_GROUP = 8


def launch_grids(B, S, H, P, N, chunk: int = 128, sms: int = 132,
                 kind=None):
    """Each launch of a forward and a backward call of ``kind`` (default:
    each direction's own, :func:`ssd_fwd_kind` at B·H and
    :func:`ssd_bwd_kind`) at these sizes, as the CUDA source launches
    them: ``{name: (grid,
    item)}``, ``item(*block_index)`` the work the block does as the
    source decodes its index. ``ssd_scan_kernel`` (the mma_sync forward)
    walks its chunks in a loop, so its grid carries the chunk as a second
    axis; the chunk kernels are persistent (``sms`` programs at most) and
    are given as their item count and programs instead. A backward at a
    chunk over 128 steps runs as at 128 (:func:`bwd_chunk`)."""
    L = min(chunk, S)
    fkind = _kind_of(L, P, N, kind, "ssd_scan", B * H)
    kind = _kind_of(L, P, N, kind)
    n_chunks = -(-S // L)
    nrt = -(-L // SSD_CB_TILE[0])
    tiles = nrt * -(-L // SSD_CB_TILE[1])
    n_groups = -(-H // SSD_BWD_GROUP)
    items = B * n_chunks * n_groups
    out = {
        # (chunk, batch, tile) -> (b, chunk, row tile, column tile)
        "ssd_cb_kernel": ((n_chunks, B, tiles),
                          lambda c, b, z: (b, c, z % nrt, z // nrt)),
        # elementwise over (b, h, N x P), the chunks in its loop
        "ssd_bwd_pass_kernel": ((-(-B * H * N * P // SSD_THREADS),),
                                lambda e: (e,)),
        "ssd_bwd_reduce_kernel": ((-(-H // SSD_THREADS),), lambda i: (i,)),
    }
    ngl = -(-H // SSD_LOCAL_GROUP)

    def groups(n):
        # -> (b, chunk, group of heads), every chunk
        return lambda x: (x // n // n_chunks, x // n % n_chunks, x % n)

    if fkind == "wgmma":
        ngo = -(-H // SSD_OUT_GROUP)
        out["ssd_fwd_state_sm90_kernel"] = ((B * n_chunks * ngl,),
                                            groups(ngl))
        out["ssd_fwd_pass_kernel"] = out["ssd_bwd_pass_kernel"]
        out["ssd_fwd_out_sm90_kernel"] = ((B * n_chunks * ngo,), groups(ngo))
    else:
        # (b·h, chunk of its loop) -> (b, h, chunk)
        out["ssd_scan_kernel"] = ((B * H, n_chunks),
                                  lambda bh, c: (bh // H, bh % H, c))
    if kind == "wgmma":
        out["ssd_bwd_local_sm90_kernel"] = ((B * n_chunks * ngl,),
                                            groups(ngl))
        out["ssd_bwd_chunk_sm90_kernel"] = (items, min(items, sms))
        # a warp a (b, chunk, h), SSD_THREADS / 32 of them a block
        per = SSD_THREADS // 32
        out["ssd_bwd_finish_kernel"] = (
            (-(-B * n_chunks * H // per),), lambda x: (x,))
        # -> (b, chunk, dB or dC): the whole (L, N) output of one
        out["ssd_bwd_dbdc_sm90_kernel"] = (
            (B * n_chunks * 2,),
            lambda x: (x // 2 // n_chunks, x // 2 % n_chunks, x % 2))
        return out
    nmb = -(-L // SSD_DBDC_TILE[0])
    nnb = -(-N // SSD_DBDC_TILE[1])

    def dbdc(x):
        nb, x = x % nnb, x // nnb
        mb, x = x % nmb, x // nmb
        return (x // 2 // n_chunks, x // 2 % n_chunks, x % 2, mb, nb)

    out["ssd_bwd_chunk_kernel"] = (items, min(items, sms))
    # -> (b, chunk, dB or dC, row tile, column tile)
    out["ssd_bwd_dbdc_kernel"] = ((B * n_chunks * 2 * nmb * nnb,), dbdc)
    if n_chunks > 1:
        # (chunk - 1, h, b) -> (b, chunk - 1, h): chunks 1 .. n_chunks - 1
        out["ssd_bwd_local_kernel"] = ((n_chunks - 1, H, B),
                                       lambda c, h, b: (b, c, h))
    return out


def ssd_scan_bwd_scratch_bytes(B, S, H, P, N, chunk: int = 128,
                               kind=None) -> int:
    """Bytes of the workspace one ssd_scan_bwd call of ``kind`` allocates
    on the card (:func:`bwd_work_floats` at :func:`bwd_chunk`'s chunk),
    with, for a chunk over 128 steps, the sub-chunks' states it
    recomputes."""
    bchunk = bwd_chunk(chunk, S)
    states = 0 if bchunk == chunk else B * -(-S // bchunk) * H * N * P
    return 4 * (bwd_work_floats(B, S, H, P, N, bchunk, kind) + states)


def tf32_unit(a, b, *, raw: bool = False):
    """One k-tile through the wgmma kind's building blocks on the card, for
    the card tests: ``a (64, 32) . b (64, 32)^T`` in 3xTF32 (A split in
    registers, b split into hi and lo tiles in shared memory, three
    m64n64k8 products), or with ``raw`` one TF32 product of the unsplit
    f32 operands (which shows whether the tensor core rounds or truncates
    an f32 operand). f32, contiguous, on the card."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != (64, 32):
            raise ValueError(f"tf32_unit: {name} must be a contiguous f32 "
                             "(64, 32) tensor on the card")
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    lib = _load()
    err = lib.ssd_tf32_unit_sm90(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                 int(raw),
                                 torch.cuda.current_stream(a.device)
                                 .cuda_stream)
    if err != 0:
        raise RuntimeError("tf32_unit kernel: "
                           + lib.ssd_scan_error_string(err).decode())
    return d


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
