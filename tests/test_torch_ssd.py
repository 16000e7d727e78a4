"""The port's SSD scan (the CUDA kernel's plain version and CPU path),
its sequential oracle and the decode step against the JAX package's, on
the same seeded numpy inputs, at the SSD tolerance of
tests/test_kernels.py (f32 2e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_decode_step as jax_decode_step
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_jnp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (ssd_chunks_plain, ssd_decode_step,
                                          ssd_scan, ssd_scan_plain)

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(B, S, H, P, N, seed=0):
    """x, dt, a_log, b, c, d_skip as the JAX package's SSD tests draw them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, S, H, P)).astype(f),
            rng.uniform(0.01, 0.3, size=(B, S, H)).astype(f),
            rng.uniform(-1, 1, size=(H,)).astype(f),
            (rng.normal(size=(B, S, N)) * 0.3).astype(f),
            (rng.normal(size=(B, S, N)) * 0.3).astype(f),
            rng.normal(size=(H,)).astype(f))


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 16, 16, 16), (1, 128, 4, 32, 64, 32), (2, 96, 3, 16, 8, 32)])
def test_plain_scan_matches_pallas_and_oracles(B, S, H, P, N, chunk):
    xs = _inputs(B, S, H, P, N)
    want_pl = np.asarray(jax_ssd_scan(*_j(xs), chunk=chunk, interpret=True))
    want_ref = np.asarray(jax_ref.ssd_ref(*_j(xs)))
    got = ssd_scan_plain(*_t(xs), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want_pl, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    # the port's sequential oracle, and the wrapper's CPU path
    np.testing.assert_allclose(ref.ssd_ref(*_t(xs)).numpy(), want_ref, **TOL)
    np.testing.assert_allclose(ssd_scan(*_t(xs), chunk=chunk).numpy(), got,
                               atol=0, rtol=0)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 100, 3, 16, 8, 32), (1, 7, 2, 8, 4, 16), (2, 1, 2, 8, 4, 16)])
def test_ragged_scan_and_final_state_match_jnp(B, S, H, P, N, chunk):
    """A ragged S (and S < chunk, S = 1) pads with dt=0 steps: y and the
    final state both equal ssd_scan_jnp's."""
    xs = _inputs(B, S, H, P, N, seed=1)
    want_y, want_h = ssd_scan_jnp(*_j(xs), chunk=chunk, return_state=True)
    got_y, got_h = ssd_scan_plain(*_t(xs), chunk=chunk, return_state=True)
    assert got_h.shape == (B, H, N, P) and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 96, 3, 16, 8, 32), (2, 100, 3, 16, 8, 32), (1, 7, 2, 8, 4, 16)])
def test_kernel_decomposition_matches_jnp(B, S, H, P, N, chunk):
    """The CUDA kernel's algebra in plain torch: C·Bᵀ once per (batch,
    chunk), the state entering chunk c equal to ssd_scan_jnp's final
    state over the first c·chunk steps, and y and the final state equal
    to ssd_scan_jnp's, at a chunk multiple, a ragged S and S < chunk."""
    xs = _inputs(B, S, H, P, N, seed=5)
    cb, states, y, h = ssd_chunks_plain(*_t(xs), chunk=chunk)
    L = min(chunk, S)
    n_chunks = -(-S // L)
    assert cb.shape == (B, n_chunks, L, L)
    assert states.shape == (B, n_chunks, H, N, P)
    x, _, _, bm, cm, _ = xs
    for c in range(n_chunks):
        t0, t1 = c * L, min(S, c * L + L)
        want = np.zeros((B, L, L), np.float32)
        want[:, :t1 - t0, :t1 - t0] = np.tril(np.einsum(
            "btn,bsn->bts", cm[:, t0:t1], bm[:, t0:t1]))
        np.testing.assert_allclose(cb[:, c].numpy(), want, **TOL)
        if c == 0:
            assert not states[:, 0].any()
            continue
        _, want_h = ssd_scan_jnp(*_j([a[:, :t0] if a.ndim > 1 else a
                                     for a in xs]),
                                 chunk=chunk, return_state=True)
        np.testing.assert_allclose(states[:, c].numpy(), np.asarray(want_h),
                                   **TOL)
    want_y, want_h = ssd_scan_jnp(*_j(xs), chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_decode_step_matches_jax():
    B, H, P, N = 2, 3, 8, 16
    rng = np.random.default_rng(2)
    f = np.float32
    h = rng.normal(size=(B, H, N, P)).astype(f)
    x_t = rng.normal(size=(B, H, P)).astype(f)
    dt_t = rng.uniform(0.01, 0.3, size=(B, H)).astype(f)
    a_log = rng.uniform(-1, 1, size=(H,)).astype(f)
    b_t = rng.normal(size=(B, N)).astype(f)
    c_t = rng.normal(size=(B, N)).astype(f)
    d = rng.normal(size=(H,)).astype(f)
    args = (h, x_t, dt_t, a_log, b_t, c_t, d)
    want = jax_decode_step(*_j(args))
    got = ssd_decode_step(*_t(args))
    got_ops = ops.ssd_decode(*_t(args))
    for g, go, w in zip(got, got_ops, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(go.numpy(), g.numpy(), atol=0, rtol=0)


def test_prefill_state_hands_off_to_decode():
    """Scan the first 40 steps with the final state, then decode the last
    24 one at a time from it: the outputs equal the sequential oracle
    over all 64 steps."""
    B, S, H, P, N, S0 = 1, 64, 2, 16, 16, 40
    xs = _t(_inputs(B, S, H, P, N, seed=3))
    x, dt, a_log, bm, cm, d = xs
    want = ref.ssd_ref(*xs)
    y0, h = ops.ssd(x[:, :S0], dt[:, :S0], a_log, bm[:, :S0], cm[:, :S0], d,
                    chunk=16, return_state=True)
    outs = [y0]
    for t in range(S0, S):
        h, y = ops.ssd_decode(h, x[:, t], dt[:, t], a_log, bm[:, t],
                              cm[:, t], d)
        outs.append(y[:, None])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(),
                               **TOL)


def test_ops_ssd_dispatch_on_cpu():
    xs = _t(_inputs(1, 32, 2, 8, 8, seed=4))
    plain = ssd_scan_plain(*xs, chunk=16)
    torch.testing.assert_close(ops.ssd(*xs, chunk=16), plain, atol=0, rtol=0)
    ops.set_impl("ref")
    try:
        oracle = ops.ssd(*xs, chunk=16)
        # the oracle has no state: with return_state the plain scan runs
        _, h = ops.ssd(*xs, chunk=16, return_state=True)
    finally:
        ops.set_impl(None)
    torch.testing.assert_close(oracle, ref.ssd_ref(*xs), atol=0, rtol=0)
    assert h.shape == (1, 2, 8, 8)
