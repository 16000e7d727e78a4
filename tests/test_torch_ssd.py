"""The port's SSD scan (the CUDA kernel's plain version and CPU path),
its sequential oracle, the decode step and the backward (the backward
kernels' plain version, autograd of the plain scan, the autograd
Function) against the JAX package's, on the same seeded numpy inputs, at
the SSD tolerance of tests/test_kernels.py (f32 2e-4)."""
import jax
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
                                          ssd_scan, ssd_scan_bwd_plain,
                                          ssd_scan_plain)

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


# -- the backward ------------------------------------------------------------------
GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd")


def _jax_vjp(xs, dy, chunk, dh=None):
    """The six gradients by jax.vjp of ssd_scan_jnp (with the final state's
    gradient ``dh`` where given)."""
    if dh is None:
        _, vjp = jax.vjp(lambda *a: ssd_scan_jnp(*a, chunk=chunk), *_j(xs))
        return [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    _, vjp = jax.vjp(lambda *a: ssd_scan_jnp(*a, chunk=chunk,
                                            return_state=True), *_j(xs))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


BWD_CASES = [(2, 64, 2, 16, 16, 16), (2, 100, 3, 16, 8, 32),
             (1, 7, 2, 8, 4, 16), (2, 96, 3, 8, 24, 32), (1, 1, 2, 8, 4, 16),
             (2, 50, 2, 6, 5, 16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", BWD_CASES)
def test_backward_decomposition_matches_jax_vjp(B, S, H, P, N, chunk):
    """The backward kernels' decomposition in plain torch (chunk states, the
    reverse state-gradient pass, the per-chunk products) against jax.vjp
    of ssd_scan_jnp, every gradient, at chunk 16 and 32, a ragged S, S <
    chunk, S = 1 and N != P (2e-4)."""
    xs = _inputs(B, S, H, P, N, seed=6)
    dy = np.random.default_rng(7).normal(size=(B, S, H, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk)
    got = ssd_scan_bwd_plain(*_t(xs), torch.from_numpy(dy), chunk=chunk)
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", BWD_CASES[:3])
def test_backward_decomposition_in_f64_matches_jax_vjp(B, S, H, P, N, chunk):
    """The decomposition on f64 inputs (the reference the card holds the
    kernels against) computes in f64 and returns f64 gradients within
    2e-4 of jax.vjp of ssd_scan_jnp, and its chunk states are f64."""
    xs = _inputs(B, S, H, P, N, seed=6)
    dy = np.random.default_rng(7).normal(size=(B, S, H, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk)
    x64 = [t.double() for t in _t(xs)]
    got = ssd_scan_bwd_plain(*x64, torch.from_numpy(dy).double(),
                             chunk=chunk)
    assert ssd_chunks_plain(*x64, chunk=chunk)[1].dtype == torch.float64
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", BWD_CASES[:3])
def test_autograd_of_the_plain_scan_matches_jax_vjp(B, S, H, P, N, chunk):
    """Autograd through ssd_scan_plain (the CPU path of training) against
    jax.vjp of ssd_scan_jnp (2e-4)."""
    xs = _inputs(B, S, H, P, N, seed=8)
    dy = np.random.default_rng(9).normal(size=(B, S, H, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk)
    leaves = [t.requires_grad_() for t in _t(xs)]
    (ssd_scan_plain(*leaves, chunk=chunk) * torch.from_numpy(dy)).sum() \
        .backward()
    for name, t, w in zip(GRADS, leaves, want, strict=True):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 64, 2, 16, 16, 16),
                                             (2, 100, 3, 16, 8, 32)])
def test_final_state_gradient_enters_the_reverse_pass(B, S, H, P, N, chunk):
    """With the final state an output (prefill's), its gradient seeds the
    reverse pass: ssd_scan_bwd_plain with ``dh_final``, and ops._SsdFn on
    CPU tensors (the forward with its chunk states, then the wrapper's
    CPU path), against jax.vjp of ssd_scan_jnp(return_state=True)."""
    xs = _inputs(B, S, H, P, N, seed=10)
    rng = np.random.default_rng(11)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dh = rng.normal(size=(B, H, N, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk, dh)
    got = ssd_scan_bwd_plain(*_t(xs), torch.from_numpy(dy), chunk=chunk,
                             dh_final=torch.from_numpy(dh))
    leaves = [t.requires_grad_() for t in _t(xs)]
    y, h = ops._SsdFn.apply(*leaves, chunk, True)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()) \
        .backward()
    for name, g, t, w in zip(GRADS, got, leaves, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL, err_msg=name)


def test_ops_ssd_takes_the_backward_function_under_the_kernels():
    """Under the kernel implementation, a gradient goes through ops._SsdFn
    (the CPU tensors' wrappers run the plain versions) and equals autograd
    of the plain scan; without one, ops.ssd returns a plain tensor."""
    xs = _t(_inputs(1, 40, 2, 8, 8, seed=12))
    dy = torch.from_numpy(np.random.default_rng(13).normal(
        size=(1, 40, 2, 8)).astype(np.float32))
    grads = {}
    for impl in ("torch", "triton"):
        leaves = [t.clone().requires_grad_() for t in xs]
        ops.set_impl(impl)
        try:
            y = ops.ssd(*leaves, chunk=16)
        finally:
            ops.set_impl(None)
        assert (y.grad_fn.name() == "_SsdFnBackward") == (impl == "triton")
        (y * dy).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for name, a, b in zip(GRADS, grads["triton"], grads["torch"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL, err_msg=name)
    with torch.no_grad():
        ops.set_impl("triton")
        try:
            assert ops.ssd(*xs, chunk=16).grad_fn is None
        finally:
            ops.set_impl(None)


def test_gradient_is_finite_where_the_decay_overflows():
    """ROADMAP C3: where a chunk's dt A sums past ~88 (dt 1 against
    mamba2's A = -64 here), exp(seg_t - seg_s) overflows above the
    diagonal. ssd_scan_jnp masks after the exponential, so jax.vjp of it
    multiplies 0 by inf there: dt, a_log, B and C come back NaN. The
    port masks the exponent first: autograd of ssd_scan_plain, the
    backward kernels' decomposition and the autograd Function give finite
    gradients that agree (2e-4), and the forward is the reference's."""
    B, S, H, P, N, chunk = 1, 64, 2, 4, 4, 64
    xs = list(_inputs(B, S, H, P, N, seed=14))
    xs[1] = np.ones((B, S, H), np.float32)
    xs[2] = np.log(np.array([1.0, 64.0], np.float32))
    dy = np.random.default_rng(15).normal(size=(B, S, H, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk)
    assert [bool(np.isfinite(g).all()) for g in want] == \
        [True, False, False, False, False, True]
    leaves = [t.requires_grad_() for t in _t(xs)]
    y = ssd_scan_plain(*leaves, chunk=chunk)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(ssd_scan_jnp(*_j(xs), chunk=chunk)),
        **TOL)
    (y * torch.from_numpy(dy)).sum().backward()
    plain = ssd_scan_bwd_plain(*_t(xs), torch.from_numpy(dy), chunk=chunk)
    fn_leaves = [t.requires_grad_() for t in _t(xs)]
    (ops._SsdFn.apply(*fn_leaves, chunk, False) * torch.from_numpy(dy)) \
        .sum().backward()
    for name, t, g, f in zip(GRADS, leaves, plain, fn_leaves, strict=True):
        assert bool(t.grad.isfinite().all()), name
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(f.grad.numpy(), g.numpy(), **TOL,
                                   err_msg=name)
    # where the reference is finite, it agrees
    for name, g, w in zip(GRADS, plain, want):
        if np.isfinite(w).all():
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
