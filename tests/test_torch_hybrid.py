"""The port's Zamba2 hybrid LM and server against the JAX package's, on
the zamba2 smoke config in f32 with the JAX init's parameters, and the
flash kernel's plain version at zamba2's head_dim 80 against the Pallas
flash kernel in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 flash_attention_plain)
from repro_torch.launch.serve import Request, Server
from repro_torch.models import LM, params_from_reference

ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config("zamba2_2p7b"),
                               dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return jcfg, jmodel, jparams, cfg, LM(cfg, device="cpu"), params


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def test_params_from_reference_layout(pair):
    """The mamba layers become a list; the shared block is one dict."""
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    assert set(params["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    wq = params["shared"]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.q_dim)
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jparams["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(
        params["layers"][3]["mamba"]["w_B"].numpy(),
        np.asarray(jparams["layers"]["mamba"]["w_B"][3]))
    assert "unembed" not in params       # tied embeddings
    assert cfg.param_count() == _numel(params)
    assert cfg.param_count() == jcfg.param_count() + cfg.d_model


def test_full_config_is_the_published_width():
    cfg = get_config("zamba2-2.7b")
    sc = cfg.ssm
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == \
        ("hybrid", 54, 2560, 32_000)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (32, 32, 80, 10240)
    assert (sc.n_heads(cfg.d_model), sc.head_dim, sc.state_dim,
            sc.chunk) == (80, 64, 64, 128)
    assert cfg.shared_attn_every == 6 and cfg.tie_embeddings
    assert 80 in HEAD_DIMS
    assert 2.2e9 < cfg.param_count() < 2.5e9


def test_groups_must_divide_the_layers():
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), n_layers=5)
    with pytest.raises(ValueError, match="groups of 2"):
        LM(cfg, device="cpu")


def test_forward_logits_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 40)).astype(np.int32)
    want = jmodel.logits(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match_jax(pair):
    """A ragged prefill (S = 21, chunk 16) fills 4 ssm states and 2 KV
    slots of the shared block; two decode ticks follow the JAX model's."""
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, size=(2, 21)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens))
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for name in ("h", "conv_x", "conv_b", "conv_c"):
        np.testing.assert_allclose(cache["ssm"][name].numpy(),
                                   np.asarray(jcache["ssm"][name]),
                                   atol=ATOL, err_msg=name)
    assert cache["k"].shape[0] == cfg.n_layers // cfg.shared_attn_every
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   err_msg=name)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(2):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    assert cache["pos"] == 21 + 2


def test_server_tokens_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("zamba2-2.7b", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("zamba2-2.7b", smoke=True, max_batch=2, device="cpu")
    srv.cfg, srv.model, srv.params = cfg, model, params
    srv._decode = model.decode_step
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=20 - i).astype(np.int32)
               for i in range(3)]
    want = jsrv.generate([JaxRequest(i, p.copy(), 5)
                          for i, p in enumerate(prompts)])
    got = srv.generate([Request(i, p.copy(), 5)
                        for i, p in enumerate(prompts)])
    assert got == want
    assert srv.metrics["prefills"] == 2 and srv.metrics["tokens"] == 3 * 4
    guard = srv.metrics["saturation"]["guard"]
    assert sum(guard["runtime_fallbacks"].values()) == 0


@pytest.mark.parametrize("H,KH,S", [(4, 4, 128), (4, 2, 192)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_at_head_dim_80(H, KH, S, causal):
    """The plain version the CUDA kernel is held against on the card, at
    zamba2's head_dim 80, against the Pallas kernel (f32, 2e-3)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, H, S, 80)).astype(np.float32)
    k = rng.normal(size=(2, KH, S, 80)).astype(np.float32)
    v = rng.normal(size=(2, KH, S, 80)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_block=64, kv_block=64, interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
