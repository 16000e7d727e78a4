"""The port's attention against the JAX package's: the flash kernel's
plain version against ``repro``'s Pallas flash attention in interpret
mode, and decode attention against its jnp twin. The CUDA kernel itself
is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerances are those of tests/test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (decode_attention,
                                                 flash_attention)


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
