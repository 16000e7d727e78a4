"""The 3xTF32 flash kernels' arithmetic and layouts on the CPU, in numpy.

The kernels themselves (``flash_fwd_sm90_f32_kernel``, the f32 backward's
dk/dv and dq kernels in ``csrc/flash_attention.cu``) run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). What they compute is
modelled here as the source does it:

- the split: the tensor core reads an f32 operand as its top 19 bits
  (truncated to TF32), so the raw value serves as hi and lo = x -
  trunc(x), rounded to TF32, is written; a product is a_lo.b_hi +
  a_hi.b_lo + a_hi.b_hi, every operand truncated as the tensor core
  reads it;
- the register A fragment an f32 accumulator makes (``acc_to_tf32``) and
  the transposed copies (``transpose_split``), whose columns are stored in
  the accumulator's k order;
- the forward's walk (128-row items, 64 rows a warpgroup, 32-row kv tiles,
  the online softmax in the exp2 domain) against the JAX package's Pallas
  flash attention in interpret mode, and the backward's (64-row items,
  32-row steps, the delta and lse rows) against ``jax.vjp`` of its
  ``blocked_attention``, at f32 flash's 2e-3 (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.layers import blocked_attention

LOG2E = np.float32(1.4426950408889634)


def _trunc(x):
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def _round(x):
    return ((np.asarray(x, np.float32).view(np.uint32) + np.uint32(0x1000))
            & np.uint32(0xffffe000)).view(np.float32)


def _lo(x):
    """tf32_lo: x - trunc(x), rounded to TF32."""
    x = np.asarray(x, np.float32)
    return _round((x - _trunc(x)).astype(np.float32))


def _tc(a, b):
    """One TF32 pass as the tensor core takes it: both operands truncated
    to TF32, the products summed (in f64 here)."""
    return _trunc(a).astype(np.float64) @ _trunc(b).astype(np.float64)


def _mm3(a, b):
    """a (m, k) . b (k, n) in 3xTF32 as the kernels split it: the raw
    values as hi, lo = x - trunc(x) rounded; the small terms first."""
    return (_tc(_lo(a), b) + _tc(a, _lo(b)) + _tc(a, b)).astype(np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the split -----------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(64, 80, 64), (64, 128, 64), (64, 64, 64),
                                   (64, 32, 80), (64, 32, 128)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_tf32_pass_misses_and_three_hold(m, k, n, seed):
    """On seeded normal tiles of the parity shapes (Q.K^T over the head
    dim, P.V over 32 kv rows): one TF32 pass misses 2e-4 norm-relative
    against f64, three passes land within 1e-6, within 2.5e-7 (a plain
    f32 product's distance is 1.0e-7 to 2.0e-7 here): rounding lo is
    what keeps them there; truncated by the tensor core, it would leave
    every product biased toward zero, over 1.5x farther."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(_tc(a, b), want) > 2e-4
    three = _rel(_mm3(a, b).astype(np.float64), want)
    assert three <= 1e-6
    assert three <= 2.5e-7
    truncated = (_tc(a - _trunc(a), b) + _tc(a, b - _trunc(b))
                 + _tc(a, b))
    assert _rel(truncated, want) > 1.5 * three


def test_lo_is_exact_to_tf32_and_below_hi():
    """hi + lo gives x back within x's own 2^-21 (lo keeps 11 of the 13
    bits below tf32's 10: rounded, it is exact in TF32, which the tensor
    core then reads whole), lo is at most 2^-10 of |x|, and lo's sign is
    x's."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    hi, lo = _trunc(x), _lo(x)
    assert np.array_equal(_trunc(lo), lo)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x)
                  <= np.abs(x) * 2.0 ** -21)
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -10)
    assert np.all(lo * x >= 0)


# -- layouts -------------------------------------------------------------


def _acc_regs(P):
    """A 64 x 2NH accumulator's registers, thread (w, g, q) register x:
    row 16w + g + 8 (x >> 1 & 1), column 8 (x >> 2) + 2q + (x & 1)."""
    nh = P.shape[1] // 2
    regs = np.zeros((4, 8, 4, nh), P.dtype)
    for w in range(4):
        for g in range(8):
            for q in range(4):
                for x in range(nh):
                    regs[w, g, q, x] = P[16 * w + g + 8 * ((x >> 1) & 1),
                                         8 * (x >> 2) + 2 * q + (x & 1)]
    return regs


def _a_seen(regs):
    """The 64 x 8KS A operand the tensor core reads from register A
    fragments made as acc_to_tf32 makes them (k-step kk: registers 4kk,
    4kk + 2, 4kk + 1, 4kk + 3 as a[0..3]; a[0] at (row g, k q), a[1]
    (g + 8, q), a[2] (g, q + 4), a[3] (g + 8, q + 4))."""
    ks = regs.shape[-1] // 4
    A = np.zeros((64, 8 * ks), regs.dtype)
    for w in range(4):
        for g in range(8):
            for q in range(4):
                for kk in range(ks):
                    a = [regs[w, g, q, 4 * kk + i] for i in (0, 2, 1, 3)]
                    r, k = 16 * w + g, 8 * kk + q
                    A[r, k], A[r + 8, k] = a[0], a[1]
                    A[r, k + 4], A[r + 8, k + 4] = a[2], a[3]
    return A


def _transposed(raw):
    """transpose_split's tile of a raw R x D tile (R = 32): row d,
    position p = 4kc + j holds raw row 8 (kc >> 1) + 2j + (kc & 1)."""
    R, D = raw.shape
    T = np.zeros((D, R), raw.dtype)
    for d in range(D):
        for kc in range(R // 4):
            for j in range(4):
                T[d, 4 * kc + j] = raw[8 * (kc >> 1) + 2 * j + (kc & 1), d]
    return T


@pytest.mark.parametrize("D", [64, 80, 128])
def test_accumulator_times_transposed_copy_is_the_product(D):
    """P (a 64 x 32 accumulator) as acc_to_tf32's A fragments, against
    transpose_split's copy of a 32 x D tile V: the tensor core's
    sum over positions, A[r, p] T[d, p], is P.V exactly (the two k
    orders agree)."""
    rng = np.random.default_rng(D)
    P = rng.standard_normal((64, 32))
    V = rng.standard_normal((32, D))
    A, T = _a_seen(_acc_regs(P)), _transposed(V)
    np.testing.assert_allclose(A @ T.T, P @ V, rtol=1e-12, atol=1e-12)
    assert sorted(A[0]) == sorted(P[0])     # a permutation of each row


def test_transposed_copy_is_a_permutation_of_each_group_of_8():
    """Within each 8 columns the copy holds each raw row once: rows 2p at
    positions p < 4, rows 2p + 1 at 4 + p."""
    raw = np.arange(32 * 8, dtype=np.float64).reshape(32, 8)
    T = _transposed(raw)
    for d in range(8):
        for g8 in range(4):
            rows = (T[d, 8 * g8:8 * g8 + 8] - d) / 8 - 8 * g8
            assert rows.tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


# -- the walks -----------------------------------------------------------


def _pad(t, r0, n):
    """Rows [r0, r0 + n) of t (S, D), zeros past its end (TMA's fill)."""
    out = np.zeros((n, t.shape[1]), np.float32)
    rows = t[r0:r0 + n]
    out[:len(rows)] = rows
    return out


def _model_fwd(q, k, v, causal):
    """flash_fwd_sm90_f32_kernel's walk: 128-row items, a consumer's 64
    rows, 32-row kv tiles up to the item's last row if causal (a consumer
    whose rows all come before a tile's first key takes it too, p = 0),
    S and P.V in 3xTF32, the online softmax in the exp2 domain with m in
    raw units, a row with l == 0 divided by 1. Returns (o, lse)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    scale = np.float32(D ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    o = np.zeros_like(q)
    lse = np.zeros((B, H, S), np.float32)
    for b in range(B):
        for h in range(H):
            kh = h // rep
            for q0 in range(0, S, 128):
                kv_end = min(S, q0 + 128) if causal else S
                for r_lo in (q0, q0 + 64):
                    if r_lo >= S:
                        continue
                    Q = _pad(q[b, h], r_lo, 64)
                    rows = r_lo + np.arange(64)[:, None]
                    m = np.full((64, 1), -np.inf, np.float32)
                    l = np.zeros((64, 1), np.float32)
                    acc = np.zeros((64, D), np.float32)
                    for k0 in range(0, kv_end, 32):
                        s = _mm3(Q, _pad(k[b, kh], k0, 32).T)
                        cols = k0 + np.arange(32)[None]
                        dead = (cols >= S) | (causal & (cols > rows))
                        s = np.where(dead, -np.inf, s)
                        m_new = np.maximum(m, s.max(1, keepdims=True))
                        mu = np.where(m_new == -np.inf, 0, m_new * sl2)
                        alpha = np.exp2(m * sl2 - mu)
                        p = np.exp2(s * sl2 - mu).astype(np.float32)
                        l = l * alpha + p.sum(1, keepdims=True)
                        acc = acc * alpha + _mm3(p, _pad(v[b, kh], k0, 32))
                        m = m_new
                    n = min(64, S - r_lo)
                    o[b, h, r_lo:r_lo + n] = (acc / np.where(l == 0, 1, l))[:n]
                    lse[b, h, r_lo:r_lo + n] = (m * scale + np.log(l))[:n, 0]
    return o, lse


def _model_bwd(q, k, v, o, lse, do, causal):
    """The f32 backward's walks: delta and lse2 rows (+inf past S); dk/dv
    items of 64 kv rows over the group's heads and 32-query steps from the
    item's first row if causal (S^T = K Q^T, P^T, dP^T = V dO^T, dS^T,
    dV += P^T dO, dK += dS^T Q); dq items of 64 query rows over 32-row kv
    steps up to their last row (S, P, dP, dS, dQ += dS K); every product
    3xTF32."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    rep = H // KH
    scale = np.float32(D ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    S_pad = -(-S // 128) * 128
    delta = np.zeros((B, H, S_pad), np.float32)
    delta[..., :S] = (do * o).sum(-1)
    lse2 = np.full((B, H, S_pad), np.inf, np.float32)
    lse2[..., :S] = lse * LOG2E
    dq, dk, dv = (np.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S, 64):
                Q, dO = _pad(q[b, h], q0, 64), _pad(do[b, h], q0, 64)
                rows = q0 + np.arange(64)[:, None]
                acc = np.zeros((64, D), np.float32)
                for k0 in range(0, min(S, q0 + 64) if causal else S, 32):
                    K = _pad(k[b, h // rep], k0, 32)
                    V = _pad(v[b, h // rep], k0, 32)
                    cols = k0 + np.arange(32)[None]
                    p = np.exp2(_mm3(Q, K.T) * sl2
                                - lse2[b, h, q0:q0 + 64, None])
                    p = np.where((cols >= S) | (causal & (cols > rows)), 0, p)
                    ds = (p * (_mm3(dO, V.T) - delta[b, h, q0:q0 + 64, None])
                          * scale).astype(np.float32)
                    acc += _mm3(ds, K)
                n = min(64, S - q0)
                dq[b, h, q0:q0 + n] = acc[:n]
        for kh in range(KH):
            for kv0 in range(0, S, 64):
                K, V = _pad(k[b, kh], kv0, 64), _pad(v[b, kh], kv0, 64)
                kv = kv0 + np.arange(64)[:, None]
                dk_acc = np.zeros((64, D), np.float32)
                dv_acc = np.zeros((64, D), np.float32)
                for h in range(kh * rep, (kh + 1) * rep):
                    for q0 in range(kv0 if causal else 0, S, 32):
                        Q, dO = _pad(q[b, h], q0, 32), _pad(do[b, h], q0, 32)
                        cols = q0 + np.arange(32)[None]
                        pt = np.exp2(_mm3(K, Q.T) * sl2
                                     - lse2[b, h, None, q0:q0 + 32])
                        pt = np.where(causal & (kv > cols), 0,
                                      pt).astype(np.float32)
                        dst = (pt * (_mm3(V, dO.T)
                                     - delta[b, h, None, q0:q0 + 32])
                               * scale).astype(np.float32)
                        dv_acc += _mm3(pt, dO)
                        dk_acc += _mm3(dst, Q)
                n = min(64, S - kv0)
                dk[b, kh, kv0:kv0 + n] = dk_acc[:n]
                dv[b, kh, kv0:kv0 + n] = dv_acc[:n]
    return dq, dk, dv


def _qkv(B, H, KH, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KH, S, D)).astype(np.float32),
            rng.standard_normal((B, KH, S, D)).astype(np.float32))


# (B, H, KH, S, D, causal, the Pallas kernel's block: it takes S in whole
# blocks of 32 or 64); S past the forward's 64-row halves and 128-row
# items (96, 160) and over one item (192); rows past S, which TMA fills
# with zeros, are the card's checks (chip_smoke.FLASH_F32_EDGES)
FWD_CASES = [(1, 4, 2, 96, 80, True, 32), (1, 2, 2, 192, 128, False, 64),
             (1, 6, 6, 64, 64, True, 32), (1, 3, 1, 160, 64, False, 32)]


@pytest.mark.parametrize("B,H,KH,S,D,causal,block", FWD_CASES)
def test_model_forward_matches_pallas_flash(B, H, KH, S, D, causal, block):
    """The kernel's walk against the JAX package's Pallas flash (interpret
    mode) at f32 flash's 2e-3, and within 1e-5 norm-relative; its lse
    against the JAX blocked forward's."""
    from repro.models.layers import _flash_fwd_impl
    q, k, v = _qkv(B, H, KH, S, D, seed=S + D)
    o, lse = _model_fwd(q, k, v, causal)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_block=block, kv_block=block,
                                interpret=True))
    np.testing.assert_allclose(o, want, atol=2e-3, rtol=2e-3)
    assert _rel(o, want) <= 1e-5
    rep = H // KH
    _, jlse = _flash_fwd_impl(jnp.asarray(q),
                              jnp.repeat(jnp.asarray(k), rep, axis=1),
                              jnp.repeat(jnp.asarray(v), rep, axis=1),
                              causal, D ** -0.5, 32, 32)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=2e-3, rtol=2e-3)


BWD_CASES = [(1, 4, 2, 96, 80, True), (1, 2, 2, 64, 128, False),
             (1, 2, 1, 160, 64, True)]


@pytest.mark.parametrize("B,H,KH,S,D,causal", BWD_CASES)
def test_model_backward_matches_jax_vjp(B, H, KH, S, D, causal):
    """The backward kernels' walks, from the modelled forward's o and lse,
    against jax.vjp of blocked_attention (the JAX package's custom VJP)
    at f32 flash's 2e-3, and within 1e-5 norm-relative."""
    q, k, v = _qkv(B, H, KH, S, D, seed=3 * S + D)
    do = np.random.default_rng(S).standard_normal(q.shape).astype(np.float32)
    o, lse = _model_fwd(q, k, v, causal)
    got = _model_bwd(q, k, v, o, lse, do, causal)
    _, vjp = jax.vjp(lambda a, b, c: blocked_attention(
        a, b, c, causal=causal, q_block=32, kv_block=32),
        *(jnp.asarray(a) for a in (q, k, v)))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=2e-3,
                                   err_msg=f"d{name}")
        assert _rel(g, w) <= 1e-5, name
