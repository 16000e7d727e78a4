"""The port's Mamba2 LM and server against the JAX package's, on the
mamba2 smoke config in f32 with the JAX init's parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import LM, params_from_reference

ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config("mamba2_1p3b"),
                               dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
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
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    mp = params["layers"][1]["mamba"]
    sc = cfg.ssm
    assert tuple(mp["w_x"].shape) == (cfg.d_model, sc.d_inner(cfg.d_model))
    assert tuple(mp["conv_b"].shape) == (sc.conv_width, sc.state_dim)
    np.testing.assert_array_equal(
        mp["a_log"].numpy(), np.asarray(jparams["layers"]["mamba"]["a_log"][1]))
    assert "unembed" not in params       # tied embeddings
    # the analytic count is the tree's, and the JAX count plus the final norm
    assert cfg.param_count() == _numel(params)
    assert cfg.param_count() == jcfg.param_count() + cfg.d_model


def test_full_config_is_the_published_width():
    cfg = get_config("mamba2-1.3b")
    sc = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (48, 2048, 50_280)
    assert (sc.d_inner(cfg.d_model), sc.n_heads(cfg.d_model), sc.head_dim,
            sc.state_dim, sc.chunk, sc.conv_width) == (4096, 64, 64, 128,
                                                       128, 4)
    assert 1.3e9 < cfg.param_count() < 1.4e9
    assert cfg.dtype == torch.bfloat16 and cfg.tie_embeddings


def test_forward_logits_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 40)).astype(np.int32)
    want = jmodel.logits(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match_jax(pair):
    """A ragged prefill (S = 21, chunk 16) seeds decode from the scan's
    final state; 8 decode steps follow the JAX model's."""
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
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(8):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    assert cache["pos"] == 21 + 8


def test_server_tokens_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("mamba2-1.3b", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("mamba2-1.3b", smoke=True, max_batch=2, device="cpu")
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
