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
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import (ssd_chunks_plain, ssd_dbdc_plain,
                                          ssd_decode_step, ssd_scan,
                                          ssd_scan_bwd_plain, ssd_scan_plain,
                                          ssd_state_grads_plain)

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


def _sequential_state_grads(dt, a_log, c_mat, dy, chunk, dh_final=None):
    """The state gradients by the sequential reverse recurrence over the
    chunks (ssd_scan_bwd_plain's before the kernels' passing split):
    the last chunk's is dh_final (or zeros), then, walking back, dh <-
    exp(seg_L) dh + sum_t exp(seg_t) C_t (x) dy_t of the chunk after."""
    B, S, H, P = dy.shape
    L = min(chunk, S)
    a = -torch.exp(a_log)
    starts = list(range(0, S, L))
    dh = torch.zeros((B, H, c_mat.shape[-1], P)) if dh_final is None \
        else dh_final
    out = [None] * len(starts)
    for c in reversed(range(len(starts))):
        out[c] = dh
        sl = slice(starts[c], starts[c] + L)
        seg = torch.cumsum(dt[:, sl] * a, dim=1)
        dh = torch.exp(seg[:, -1])[..., None, None] * dh + torch.einsum(
            "btn,bth,bthp->bhnp", c_mat[:, sl], torch.exp(seg), dy[:, sl])
    return torch.stack(out, 1)


@pytest.mark.parametrize("with_dh", [False, True], ids=["no_dh", "dh_final"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 100, 3, 16, 8, 32), (1, 70, 2, 8, 6, 16), (2, 64, 2, 16, 16, 16),
    (1, 7, 2, 8, 4, 16)])
def test_state_gradient_passing_matches_the_recurrence_and_jax(
        B, S, H, P, N, chunk, with_dh):
    """ssd_state_grads_plain (every chunk's local term and decay, then an
    elementwise passing) equals the sequential recurrence, with a ragged
    last chunk and with a final-state gradient; and the backward built on
    it, ssd_scan_bwd_plain, equals jax.vjp of ssd_scan_jnp (its final
    state an output where dh_final is given), every gradient (2e-4)."""
    xs = _inputs(B, S, H, P, N, seed=16)
    rng = np.random.default_rng(17)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dh = rng.normal(size=(B, H, N, P)).astype(np.float32) if with_dh \
        else None
    x, dt, a_log, b, c, d = _t(xs)
    dh_t = None if dh is None else torch.from_numpy(dh)
    got = ssd_state_grads_plain(dt, a_log, c, torch.from_numpy(dy),
                                chunk=chunk, dh_final=dh_t)
    want = _sequential_state_grads(dt, a_log, c, torch.from_numpy(dy), chunk,
                                   dh_t)
    assert got.shape == (B, -(-S // min(chunk, S)), H, N, P)
    torch.testing.assert_close(got, want, **TOL)
    grads = ssd_scan_bwd_plain(x, dt, a_log, b, c, d, torch.from_numpy(dy),
                               chunk=chunk, dh_final=dh_t)
    for name, g, w in zip(GRADS, grads, _jax_vjp(xs, dy, chunk, dh),
                          strict=True):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("group", [1, 2, 3, 8])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 100, 5, 8, 6, 32),
                                             (1, 70, 3, 16, 8, 16)])
def test_head_group_partials_of_db_dc_match_the_per_head_sum(
        B, S, H, P, N, chunk, group):
    """dB and dC from the kernels' head-group partials (ssd_dbdc_plain: GE
    summed over each group of heads, the groups in order, then one
    product over the steps and one over the (head, P) columns) equal each
    head's dB and dC summed over the heads (ssd_scan_bwd_plain), at groups
    that divide H, that do not, and that hold all of it (2e-4)."""
    x, dt, a_log, b, c, d = _t(_inputs(B, S, H, P, N, seed=18))
    rng = np.random.default_rng(19)
    dy = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(B, H, N, P)).astype(np.float32))
    _, states, _, _ = ssd_chunks_plain(x, dt, a_log, b, c, d, chunk=chunk)
    dstates = ssd_state_grads_plain(dt, a_log, c, dy, chunk=chunk,
                                    dh_final=dh)
    got = ssd_dbdc_plain(x, dt, a_log, b, c, dy, states, dstates,
                         chunk=chunk, group=group)
    want = ssd_scan_bwd_plain(x, dt, a_log, b, c, d, dy, chunk=chunk,
                              dh_final=dh)[3:5]
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], **TOL)


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


# chunks over the backward kernels' 128 steps: a multiple of 128 and not,
# each over several chunks with a ragged last one
LONG_CHUNKS = [(1, 300, 2, 8, 4, 256), (2, 200, 3, 6, 5, 192)]


@pytest.mark.parametrize("return_state", [False, True],
                         ids=["y", "y_and_state"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", LONG_CHUNKS)
def test_ssd_fn_at_a_long_chunk_matches_jax_grad(B, S, H, P, N, chunk,
                                                 return_state):
    """ops._SsdFn with the plain versions (CPU tensors): the forward at the
    long chunk, the backward at 128-step sub-chunks (kernels.ssd_scan.
    bwd_chunk), against ssd_scan_jnp and jax.vjp of it at the same chunk,
    with and without the final state's gradient (2e-4)."""
    assert ssd.bwd_chunk(chunk, S) == 128
    xs = _inputs(B, S, H, P, N, seed=16)
    rng = np.random.default_rng(17)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dh = rng.normal(size=(B, H, N, P)).astype(np.float32) \
        if return_state else None
    want = _jax_vjp(xs, dy, chunk, dh)
    leaves = [t.requires_grad_() for t in _t(xs)]
    out = ops._SsdFn.apply(*leaves, chunk, return_state)
    y = out[0] if return_state else out
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(ssd_scan_jnp(*_j(xs), chunk=chunk)),
        **TOL)
    loss = (y * torch.from_numpy(dy)).sum()
    if return_state:
        loss = loss + (out[1] * torch.from_numpy(dh)).sum()
    loss.backward()
    for name, t, w in zip(GRADS, leaves, want, strict=True):
        np.testing.assert_allclose(t.grad.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", LONG_CHUNKS)
def test_sub_chunked_backward_matches_the_plain_backward(B, S, H, P, N,
                                                         chunk):
    """ssd_scan_bwd at a long chunk runs at 128-step sub-chunks from the
    states at their boundaries: on the CPU its plain version at 128, as
    the card's kernels decompose it (the sub-chunk states, the reverse
    state-gradient pass, dB and dC by head groups), against the plain
    backward at the long chunk itself (2e-4). A chunk of at most 128
    steps, or one that S does not exceed, is run as it is."""
    assert [ssd.bwd_chunk(c, s) for c, s in ((128, 4096), (129, 129),
                                             (129, 100), (256, 256),
                                             (256, 100), (16, 4096))] == \
        [128, 128, 129, 128, 256, 16]
    x, dt, a_log, b, c, d = _t(_inputs(B, S, H, P, N, seed=18))
    rng = np.random.default_rng(19)
    dy = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(B, H, N, P)).astype(np.float32))
    want = ssd_scan_bwd_plain(x, dt, a_log, b, c, d, dy, chunk=chunk,
                              dh_final=dh)
    _, _, states = ssd.ssd_scan_with_states(x, dt, a_log, b, c, d,
                                            chunk=chunk)
    got = ssd.ssd_scan_bwd(x, dt, a_log, b, c, d, dy, states, chunk=chunk,
                           dh_final=dh)
    # the card's pieces at the sub-chunk: the states the forward kernels
    # recompute, the state gradients, dB and dC summed by head groups
    sub = ssd.bwd_chunk(chunk, S)
    sub_states, _ = ssd.ssd_passed_states_plain(x, dt, a_log, b, chunk=sub)
    torch.testing.assert_close(
        sub_states, ssd_chunks_plain(x, dt, a_log, b, c, d, chunk=sub)[1],
        **TOL)
    dstates = ssd_state_grads_plain(dt, a_log, c, dy, chunk=sub,
                                    dh_final=dh)
    dbdc = ssd_dbdc_plain(x, dt, a_log, b, c, dy, sub_states, dstates,
                          chunk=sub, group=ssd.SSD_BWD_GROUP)
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=name)
    for name, g, w in zip(("db", "dc"), dbdc, want[3:5]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=name)


# the backward's kinds (kernels.ssd_scan.ssd_bwd_kind): mamba2-1.3b's and
# zamba2-2.7b's train widths, a ragged S, one step, a shorter chunk at
# those widths take the wgmma launches; the small shapes of chip_smoke.py
# and the ones the TF32 tiles do not take keep the mma.sync launches
@pytest.mark.parametrize("B,S,H,P,N,chunk,kind", [
    (2, 4096, 64, 64, 128, 128, "wgmma"), (2, 4096, 80, 64, 64, 128, "wgmma"),
    (2, 4001, 64, 64, 128, 128, "wgmma"), (1, 1, 64, 64, 128, 128, "wgmma"),
    (1, 300, 4, 64, 64, 64, "wgmma"), (2, 100, 3, 16, 8, 32, "mma_sync"),
    (1, 50, 2, 6, 5, 16, "mma_sync"), (1, 70, 2, 72, 70, 64, "mma_sync"),
    (1, 512, 2, 64, 96, 128, "mma_sync"), (1, 512, 2, 64, 128, 256,
                                           "mma_sync")])
def test_backward_kind_by_shape(B, S, H, P, N, chunk, kind):
    assert ssd.ssd_bwd_kind(min(chunk, S), P, N) == kind


def test_a_kind_that_cannot_take_the_shape_is_refused():
    with pytest.raises(ValueError, match="wgmma kind takes"):
        ssd.bwd_work_floats(1, 64, 2, 16, 8, 32, "wgmma")
    with pytest.raises(ValueError, match="not one of"):
        ssd.bwd_smem_bytes(128, 64, 128, "hopper")


# the mirrors of csrc/ssd_scan.cu's sizes at mamba2-1.3b's and zamba2-2.7b's
# train shapes (B 2, S 4096, chunk 128), worked out by hand from the
# kernels' shared-memory structs and workspace regions:
# * wgmma, N 128: the dB/dC block's 3-stage ring (3 x 32 KB), its two
#   warpgroups' two hi/lo pairs of 128 x 32 f32 (128 KB), 3 scale rows, 6
#   barriers and 1 KB to align: 231,984; N 64: the chunk block's ring (96
#   KB), 2 x 32 KB of B tiles, the GE_sum tiles 64 x 72 and 64 x 136 (53,248
#   bytes), two heads' vectors (4 KB), 10 barriers, 1 KB: 222,288;
# * mma_sync: the chunk block's pre-split x, dy and state rows (8 bytes x
#   (2 x 128 + N) x 68) and its 3,360 floats of vectors and parts;
# * workspace floats: C.B^T (64 x 128 x 128), the state gradients (64 x H x N
#   x 64), the decays (64 x H), per-head vectors of 128 (4 of them in the
#   wgmma kind, 2 in mma_sync), the GE sums (64 x H / 8 x 128 x 128), in the
#   wgmma kind each head's per-step parts (64 x H x 1,424), the per-chunk
#   sums (64 x H x 2).
@pytest.mark.parametrize("shape,kind,smem,floats", [
    ((2, 4096, 64, 64, 128), "wgmma", 231_984, 50_933_760),
    ((2, 4096, 80, 64, 64), "wgmma", 222_288, 42_433_536),
    ((2, 4096, 64, 64, 128), "mma_sync", 222_336, 44_052_480),
    ((2, 4096, 80, 64, 64), "mma_sync", 187_520, 33_831_936)])
def test_backward_size_mirrors_at_the_train_shapes(shape, kind, smem, floats):
    B, S, H, P, N = shape
    assert ssd.bwd_smem_bytes(128, P, N, kind) == smem <= H100_SXM.smem_bytes
    assert ssd.bwd_work_floats(B, S, H, P, N, 128, kind) == floats
    assert ssd.ssd_scan_bwd_scratch_bytes(B, S, H, P, N, 128, kind) \
        == 4 * floats
    if kind == ssd.ssd_bwd_kind(128, P, N):  # the dispatch's by default
        assert ssd.bwd_smem_bytes(128, P, N) == smem
        assert ssd.bwd_work_floats(B, S, H, P, N, 128) == floats


def _covered(grid, item):
    """Each block of ``grid`` through ``item``: the work units, in order."""
    import itertools
    return [item(*ix) for ix in itertools.product(*map(range, grid))]


@pytest.mark.parametrize("kind", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("shape", [(2, 4096, 64, 64, 128),
                                   (2, 4096, 80, 64, 64),
                                   (2, 4001, 64, 64, 128)])
def test_backward_grids_cover_each_unit_once(shape, kind):
    """launch_grids of each kind at the train shapes and the ragged S:
    every launch of the backward covers its units exactly once, (b, chunk,
    group of 8 heads) for the wgmma local launch (every chunk), (b, chunk,
    dB or dC) for its dB/dC launch, (b, chunk, h) in blocks of 8 for its
    finish launch, (b, chunk >= 1, h) for the mma.sync local launch, (b,
    chunk, dB or dC, 64 x 64 tile) for its dB/dC; the persistent chunk
    launches walk their (b, chunk, group) items with one program an
    SM."""
    B, S, H, P, N = shape
    nc, ng = -(-S // 128), -(-H // 8)
    g = ssd.launch_grids(B, S, H, P, N, 128, 132, kind)
    sm90 = "_sm90" if kind == "wgmma" else ""
    assert set(ssd.SSD_BWD_LAUNCHES[kind]) <= set(g)
    local = _covered(*g[f"ssd_bwd_local{sm90}_kernel"])
    dbdc = _covered(*g[f"ssd_bwd_dbdc{sm90}_kernel"])
    if kind == "wgmma":
        assert sorted(local) == [(b, c, j) for b in range(B)
                                 for c in range(nc) for j in range(ng)]
        assert sorted(dbdc) == [(b, c, k) for b in range(B)
                                for c in range(nc) for k in range(2)]
        (blocks,), item = g["ssd_bwd_finish_kernel"]
        assert [item(x) for x in range(blocks)] == [(x,) for x in
                                                     range(blocks)]
        assert blocks == -(-B * nc * H // 8)
    else:
        assert sorted(local) == [(b, c, h) for b in range(B)
                                 for c in range(nc - 1) for h in range(H)]
        assert sorted(dbdc) == [(b, c, k, m, n) for b in range(B)
                                for c in range(nc) for k in range(2)
                                for m in range(2) for n in range(-(-N // 64))]
    items, programs = g[f"ssd_bwd_chunk{sm90}_kernel"]
    assert items == B * nc * ng and programs == min(items, 132)
    walked = sorted(i for p in range(programs)
                    for i in range(p, items, programs))
    assert walked == list(range(items))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 200, 2, 64, 128, 128),
                                             (1, 150, 3, 64, 64, 128)])
def test_plain_pieces_at_the_wgmma_widths_match_jax(B, S, H, P, N, chunk):
    """The plain pieces the wgmma launches are held to on the card, at the
    widths they take (P 64, N 128 and 64, chunk 128, ragged S):
    ssd_chunks_plain's chunk states and ssd_state_grads_plain's state
    gradients through ssd_scan_bwd_plain, and ssd_dbdc_plain's head-group
    dB and dC (groups of 8), against jax.vjp of ssd_scan_jnp (2e-4)."""
    xs = _inputs(B, S, H, P, N, seed=20)
    dy = np.random.default_rng(21).normal(size=(B, S, H, P)).astype(np.float32)
    want = _jax_vjp(xs, dy, chunk)
    x, dt, a_log, b, c, d = _t(xs)
    dyt = torch.from_numpy(dy)
    got = ssd_scan_bwd_plain(x, dt, a_log, b, c, d, dyt, chunk=chunk)
    for name, g, w in zip(GRADS, got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
    _, states, _, _ = ssd_chunks_plain(x, dt, a_log, b, c, d, chunk=chunk)
    dstates = ssd_state_grads_plain(dt, a_log, c, dyt, chunk=chunk)
    db, dc = ssd_dbdc_plain(x, dt, a_log, b, c, dyt, states, dstates,
                            chunk=chunk, group=8)
    np.testing.assert_allclose(db.numpy(), want[3], **TOL)
    np.testing.assert_allclose(dc.numpy(), want[4], **TOL)


# -- the forward's two kinds (kernels.ssd_scan.ssd_fwd_kind) -------------------
# the wgmma widths (P 64, N 128 and 64) at small B, H and S: chunk
# multiples (which the Pallas kernel takes), ragged S, S below a chunk, one
# step, a chunk of 64
FWD_WIDE = [(1, 256, 2, 64, 128, 128), (2, 192, 3, 64, 64, 64),
            (1, 200, 2, 64, 128, 128), (2, 100, 2, 64, 64, 128),
            (1, 1, 2, 64, 128, 128), (2, 300, 3, 64, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", FWD_WIDE)
def test_state_passing_forward_matches_jnp_and_pallas(B, S, H, P, N, chunk,
                                                      dtype):
    """The wgmma forward's decomposition in plain torch: every chunk's own
    state and decay, the elementwise passing (ssd_passed_states_plain),
    then each chunk's output from the state entering it with D on M's
    diagonal (ssd_out_plain). The chunk states equal ssd_scan_jnp's final
    state over each chunk's prefix (zero for the first), the final state
    and y ssd_scan_jnp's, and y the Pallas kernel's in interpret mode where
    S is a chunk multiple; in f32 and f64 (which compute in f64), 2e-4."""
    xs = _inputs(B, S, H, P, N, seed=22)
    ts = [t.to(dtype) for t in _t(xs)]
    x, dt, a_log, b, c, d = ts
    states, h = ssd.ssd_passed_states_plain(x, dt, a_log, b, chunk=chunk)
    y = ssd.ssd_out_plain(x, dt, a_log, b, c, d, states, chunk=chunk)
    L = min(chunk, S)
    assert states.shape == (B, -(-S // L), H, N, P)
    assert states.dtype == h.dtype == y.dtype == dtype
    assert not states[:, 0].any()
    for ci in range(1, states.shape[1]):
        _, want_h = ssd_scan_jnp(*_j([a[:, :ci * L] if a.ndim > 1 else a
                                     for a in xs]),
                                 chunk=chunk, return_state=True)
        np.testing.assert_allclose(states[:, ci].numpy(), np.asarray(want_h),
                                   **TOL)
    want_y, want_h = ssd_scan_jnp(*_j(xs), chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    if S % L == 0:
        want_pl = jax_ssd_scan(*_j(xs), chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_pl), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 100, 3, 16, 8, 32),
                                             (1, 7, 2, 8, 4, 16)])
def test_state_passing_forward_matches_the_mma_sync_decomposition(
        B, S, H, P, N, chunk):
    """At widths the wgmma kind does not take, the same decomposition
    equals ssd_chunks_plain's (the other kind's: the states entering
    each chunk, y and the final state), 2e-4."""
    ts = _t(_inputs(B, S, H, P, N, seed=23))
    states, h = ssd.ssd_passed_states_plain(*ts[:4], chunk=chunk)
    y = ssd.ssd_out_plain(*ts, states, chunk=chunk)
    _, want_states, want_y, want_h = ssd_chunks_plain(*ts, chunk=chunk)
    for got, want in ((states, want_states), (h, want_h), (y, want_y)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk,kind", [
    (2, 4096, 64, 64, 128, 128, "wgmma"), (2, 4096, 80, 64, 64, 128, "wgmma"),
    (2, 512, 64, 64, 128, 128, "wgmma"), (3, 4096, 64, 64, 128, 128, "wgmma"),
    (4, 510, 80, 64, 64, 128, "wgmma"), (4, 512, 64, 64, 128, 128, "mma_sync"),
    (8, 512, 64, 64, 128, 128, "mma_sync"),
    (1, 1, 64, 64, 128, 128, "wgmma"), (1, 300, 4, 64, 64, 64, "wgmma"),
    (2, 64, 2, 16, 16, 16, "mma_sync"), (1, 50, 2, 6, 5, 16, "mma_sync"),
    (1, 512, 2, 64, 96, 128, "mma_sync"),
    (1, 512, 2, 64, 128, 256, "mma_sync")])
def test_forward_kind_by_shape(B, S, H, P, N, chunk, kind):
    """mamba2-1.3b's and zamba2-2.7b's train shapes, serve prefills of 2
    rows, 192 of mamba2's heads, zamba2's serve prefill of 4 rows (320
    blocks of the mma_sync kind: two waves, the second a fifth full), one
    step and a chunk of 64 take the forward's wgmma launches; mamba2's
    serve prefill of 4 rows and of 8 (256 and 512 blocks, which fill the
    mma_sync kind's 264 slots of two an SM), the smoke configs' small
    shapes and an N and a chunk the TF32 tiles do not take keep mma.sync.
    The backward's rule is the widths' alone, and the forward's without a
    B·H."""
    L = min(chunk, S)
    assert ssd.ssd_fwd_kind(L, P, N, B * H) == kind
    wide = "wgmma" if P == 64 and N in (64, 128) and L <= 128 else "mma_sync"
    assert ssd.ssd_bwd_kind(L, P, N) == ssd.ssd_fwd_kind(L, P, N) == wide


def test_a_forward_kind_that_cannot_take_the_shape_is_refused():
    """A forced kind is checked before anything is allocated or recorded:
    the wgmma kind at P 16 and an unknown kind raise, from the size
    mirrors and from the wrappers on ``meta`` tensors."""
    with pytest.raises(ValueError, match="wgmma kind takes"):
        ssd.fwd_work_floats(1, 64, 2, 16, 8, 32, "wgmma")
    with pytest.raises(ValueError, match="not one of"):
        ssd.fwd_smem_bytes(128, 64, 128, "hopper")
    meta = [torch.empty(s, device="meta") for s in
            ((1, 64, 2, 16), (1, 64, 2), (2,), (1, 64, 8), (1, 64, 8), (2,))]
    with pytest.raises(ValueError, match="ssd_scan: the wgmma kind takes"):
        ssd.ssd_scan(*meta, chunk=32, kind="wgmma")
    with pytest.raises(ValueError, match="not one of"):
        ssd.ssd_scan_with_states(*meta, chunk=32, kind="hopper")


@pytest.mark.parametrize("kind", [None, "mma_sync"])
def test_forward_scratch_of_each_kind_is_counted_on_meta(kind):
    """On ``meta`` (the dry run) a serve call at mamba2-1.3b's widths holds
    y, the final state and its kind's scratch: the wgmma kind's workspace
    (the chunk states among it) by default, C·Bᵀ alone when mma_sync is
    forced; a training call keeps its chunk states out of the workspace."""
    from repro_torch.roofline.op_analysis import OpCounter
    B, S, H, P, N = 1, 512, 4, 64, 128
    meta = [torch.empty(s, device="meta") for s in
            ((B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N), (H,))]
    with OpCounter() as cnt:
        y, h = ssd.ssd_scan(*meta, chunk=128, return_state=True, kind=kind)
    work = ssd.fwd_work_floats(B, S, H, P, N, 128, kind)
    assert cnt.report.peak_live_bytes == 4 * (y.numel() + h.numel() + work)
    if kind is None:
        assert work > 4 * H * N * P     # the states of the 4 chunks
        assert ssd.fwd_work_floats(B, S, H, P, N, 128, states=True) \
            == work - 4 * H * N * P
    else:
        assert work == 4 * 128 * ssd.cb_pitch(128)


# the mirrors of csrc/ssd_scan.cu's forward sizes at mamba2-1.3b's and
# zamba2-2.7b's train (B 2, S 4096, with the chunk states) and serve (B 4,
# S 512, without) shapes, chunk 128, worked out by hand:
# * wgmma, N 128: the output block's C·Bᵀ boxes on and below the diagonal
#   (10 of 32 x 32 f32, 40 KB) and C (4 boxes of 128 x 32, 64 KB), its
#   2-stage ring of 32 x 64 tiles (16 KB), the two hi / lo B tiles of 64 x
#   32 both warpgroups share (32 KB) and each warpgroup's two hi / lo A
#   tiles (64 KB), two heads' dt, seg and exp(seg) (3 KB), 9 barriers and 1
#   KB to align: 225,352; the state block takes more, 226,368: Bᵀ's hi /
#   lo tiles (128 KB), a 3-stage ring (24 KB), one pair of hi / lo x tiles
#   (32 KB), the two warpgroups' 64 x 64 results for their TMA stores (32
#   KB), 8 heads' w (4 KB), 8 barriers and 1 KB; N 64: the output block's
#   two C boxes fewer and 6 stages, 17 barriers: 225,416 (the state
#   block's 201,808);
# * workspace floats: C·Bᵀ (B n_chunks x 128 x 128), the decays (B
#   n_chunks x H), dt, seg and exp(seg) (B n_chunks x H x 128 each), and
#   at the serve shapes the states (B n_chunks x H x N x 64): 1,048,576 +
#   4,096 + 3 x 524,288; 1,048,576 + 5,120 + 3 x 655,360; 262,144 + 1,024
#   + 3 x 131,072 + 8,388,608; 262,144 + 1,280 + 3 x 163,840 + 5,242,880.
@pytest.mark.parametrize("shape,states,smem,floats", [
    ((2, 4096, 64, 64, 128), True, 226_368, 2_625_536),
    ((2, 4096, 80, 64, 64), True, 225_416, 3_019_776),
    ((4, 512, 64, 64, 128), False, 226_368, 9_044_992),
    ((4, 512, 80, 64, 64), False, 225_416, 5_997_824)])
def test_forward_size_mirrors_at_the_train_and_serve_shapes(shape, states,
                                                            smem, floats):
    B, S, H, P, N = shape
    assert ssd.fwd_smem_bytes(128, P, N) == smem <= H100_SXM.smem_bytes
    assert ssd.fwd_smem_bytes(128, P, N, "wgmma") == smem
    assert ssd.fwd_work_floats(B, S, H, P, N, 128, "wgmma", states) == floats
    # the dispatch's by default: wgmma but at mamba2's serve shape (B·H 256)
    default = ssd.fwd_work_floats(B, S, H, P, N, 128, states=states)
    assert (default == floats) == ((B, H) != (4, 64))
    # the mma_sync kind's: the scan block, C·Bᵀ in rows of cb_pitch
    assert ssd.fwd_smem_bytes(128, P, N, "mma_sync") == \
        ssd.scan_smem_bytes(128, P, N)
    assert ssd.fwd_work_floats(B, S, H, P, N, 128, "mma_sync", states) == \
        B * (S // 128) * 128 * ssd.cb_pitch(128)


@pytest.mark.parametrize("shape", [(2, 4096, 64, 64, 128),
                                   (2, 4096, 80, 64, 64),
                                   (4, 510, 64, 64, 128), (1, 1, 80, 64, 64)])
def test_forward_grids_cover_each_unit_once(shape):
    """launch_grids at the wgmma widths: the forward's state and output
    launches cover (b, chunk, group of 8 heads) once each, so every (b,
    chunk, head), and the passing every (b, h, N x P) element in blocks of
    256; the mma_sync kind's scan covers (b, h, chunk) once; by default
    the forward's launches are its dispatch's; the static verifier's
    models of both kinds certify."""
    from repro_torch.verify import check_grid, ssd_scan_models
    B, S, H, P, N = shape
    nc = -(-S // 128)
    g = ssd.launch_grids(B, S, H, P, N, 128, kind="wgmma")
    assert set(ssd.SSD_FWD_LAUNCHES["wgmma"]) <= set(g)
    assert "ssd_scan_kernel" not in g
    fkind = ssd.ssd_fwd_kind(128, P, N, B * H)
    assert set(ssd.SSD_FWD_LAUNCHES[fkind]) <= \
        set(ssd.launch_grids(B, S, H, P, N, 128))
    heads = [(b, c, h) for b in range(B) for c in range(nc) for h in range(H)]
    for name, group in (("ssd_fwd_state_sm90_kernel", ssd.SSD_LOCAL_GROUP),
                        ("ssd_fwd_out_sm90_kernel", ssd.SSD_OUT_GROUP)):
        units = _covered(*g[name])
        assert sorted(units) == [(b, c, j) for b in range(B)
                                 for c in range(nc)
                                 for j in range(-(-H // group))]
        assert sorted((b, c, j * group + i) for b, c, j in units
                      for i in range(group) if j * group + i < H) == heads
    (blocks,), _ = g["ssd_fwd_pass_kernel"]
    assert (blocks - 1) * 256 < B * H * N * P <= blocks * 256
    ms = ssd.launch_grids(B, S, H, P, N, 128, kind="mma_sync")
    assert set(ssd.SSD_FWD_LAUNCHES["mma_sync"]) <= set(ms)
    assert sorted(_covered(*ms["ssd_scan_kernel"])) == \
        [(b, h, c) for b in range(B) for h in range(H) for c in range(nc)]
    for kind in (None, "wgmma", "mma_sync"):
        models, walk = ssd_scan_models(B, H, S, P, N, 128, kind=kind)
        assert not walk
        names = {m.name for m in models}
        assert set(ssd.SSD_FWD_LAUNCHES[kind or fkind]) <= names
        for m in models:
            assert not check_grid(m).errors(), m.name
