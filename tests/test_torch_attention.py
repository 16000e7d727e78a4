"""The port's attention against the JAX package's: the flash kernel's
plain version against ``repro``'s Pallas flash attention in interpret
mode, decode attention against its jnp twin, and the plain forward's
log-sum-exp and the plain backward against the JAX package's custom VJP
of ``blocked_attention``. The CUDA kernel itself
is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerances are those of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    decode_attention, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd_plain)


def _qkv(B, H, KH, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, KH, S, D)).astype(np.float32),
            rng.normal(size=(B, KH, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,KH,S,D", [
    (2, 4, 2, 128, 64), (1, 2, 2, 256, 128), (2, 8, 1, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_flash(B, H, KH, S, D, causal):
    q, k, v = _qkv(B, H, KH, S, D)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_block=64, kv_block=64, interpret=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


def test_plain_matches_pallas_flash_bf16():
    q, k, v = _qkv(1, 2, 2, 128, 64, seed=1)
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     causal=True, q_block=64, kv_block=64, interpret=True)
    got = flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 2, 64, 32), (1, 6, 2, 40, 16)])
def test_decode_attention_matches_jax(B, H, KH, S, D):
    q, k, v = _qkv(B, H, KH, S, D, seed=2)
    q1 = q[:, :, -1:]
    want = jax_decode(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v))
    got = decode_attention(*(torch.from_numpy(a) for a in (q1, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    # and the last row of full causal attention
    full = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy()[:, :, 0], full.numpy()[:, :, -1],
                               atol=2e-5, rtol=2e-5)


# -- the backward (training) ------------------------------------------------------
# The JAX package differentiates blocked_attention through its custom_vjp
# (_flash_fwd_impl saves the row log-sum-exp, _flash_bwd recomputes the
# blocks in f32); the port's plain versions hold it at flash's f32 2e-3.
BWD_CASES = [(2, 4, 2, 64, 16), (1, 4, 4, 96, 64), (2, 6, 2, 64, 80),
             (1, 8, 1, 128, 64)]


@pytest.mark.parametrize("B,H,KH,S,D", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_plain_lse_matches_jax(B, H, KH, S, D, causal):
    from repro.models.layers import _flash_fwd_impl
    q, k, v = _qkv(B, H, KH, S, D, seed=4)
    rep = H // KH
    jo, jlse = _flash_fwd_impl(jnp.asarray(q),
                               jnp.repeat(jnp.asarray(k), rep, axis=1),
                               jnp.repeat(jnp.asarray(v), rep, axis=1),
                               causal, D ** -0.5, 32, 32)
    o, lse = flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("B,H,KH,S,D", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_jax_vjp(B, H, KH, S, D, causal):
    import jax
    from repro.models.layers import blocked_attention
    q, k, v = _qkv(B, H, KH, S, D, seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: blocked_attention(
        a, b, c, causal=causal, q_block=32, kv_block=32),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do),
                                    causal=causal, block=48)
    for g, w, name in zip(got, want, "qkv"):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_bwd_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors flash_attention_bwd is its plain version and counts
    no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 40, 16, seed=7))
    do = torch.ones_like(q)
    o, lse = flash_attention_fwd_plain(q, k, v)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
