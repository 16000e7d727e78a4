"""The port's MoE layer, LM and server against the JAX package's, on the
dbrx smoke config in f32 with the JAX init's parameters: ``moe_apply``
alone (a batch within capacity and batches that overflow it, where the
stable sort decides which tokens are dropped), the weight layout,
forward, prefill with two decode ticks, and served tokens."""
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
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import LM, params_from_reference
from repro_torch.models import layers as L

ATOL = 2e-4


def _configs(**moe):
    jcfg = dataclasses.replace(jax_smoke_config("dbrx_132b"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"),
                              dtype=torch.float32)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe))
    return jcfg, cfg


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg, cfg = _configs()
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return jcfg, jmodel, jparams, cfg, LM(cfg, device="cpu"), params


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _overflows(x, router, cfg):
    """Whether some expert of some token group gets more than the
    capacity C of top-k slots (so tokens are dropped)."""
    mc = cfg.moe
    T = x.shape[0] * x.shape[1]
    G = 32
    while T % G:
        G //= 2
    TG = T // G
    C = max(int(np.ceil(TG * mc.top_k / mc.n_experts
                        * mc.capacity_factor)), 1)
    logits = x.reshape(G, TG, -1) @ router
    idx = np.argsort(-logits, axis=-1)[..., :mc.top_k].reshape(G, -1)
    return max(np.bincount(g, minlength=mc.n_experts).max()
               for g in idx) > C


@pytest.mark.parametrize("shape,capacity", [
    ((2, 16), 1.5),        # G 32, TG 1: every token fits
    ((4, 24), 1.0),        # G 32, TG 3, C 2: overflow
    ((3, 40), 0.5),        # G 8, TG 15, C 4: heavy overflow
    ((1, 37), 1.25)])      # T 37: G 1, one group of 37
def test_moe_apply_matches_jax(shape, capacity):
    jcfg, cfg = _configs(capacity_factor=capacity)
    jp = jax_layers.moe_init(jax.random.PRNGKey(1), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)
    if capacity <= 1.0:
        assert _overflows(x, np.asarray(jp["router"]), cfg)
    jout, jaux = jax_layers.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = L.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6)


def test_moe_residual_ffn_matches_jax():
    """Arctic's dense residual MLP beside the experts."""
    jcfg, cfg = _configs(residual_ffn_dim=48)
    jp = jax_layers.moe_init(jax.random.PRNGKey(3), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert tuple(p["res"]["wg"].shape) == (cfg.d_model, 48)
    x = np.random.default_rng(4).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    jout, _ = jax_layers.moe_apply(jp, jnp.asarray(x), jcfg)
    out, _ = L.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    got = L.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == \
        jax.tree.map(lambda a: tuple(a.shape), got)


def test_params_from_reference_layout(pair):
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    mp = params["layers"][1]["moe"]
    mc = cfg.moe
    assert tuple(mp["wg"].shape) == (mc.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(mp["wd"].shape) == (mc.n_experts, cfg.d_ff, cfg.d_model)
    assert mp["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        mp["router"].numpy(), np.asarray(jparams["layers"]["moe"]["router"][1]))
    assert "unembed" in params            # untied embeddings
    assert cfg.param_count() == _numel(params)
    assert cfg.param_count() == jcfg.param_count() + cfg.d_model


def test_full_config_is_the_published_width():
    cfg = get_config("dbrx-132b")
    mc = cfg.moe
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == \
        ("moe", 40, 6144, 100_352)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (48, 8, 128, 10752)
    assert (mc.n_experts, mc.top_k, mc.capacity_factor) == (16, 4, 1.25)
    assert not cfg.tie_embeddings and cfg.rope_theta == 500_000.0
    assert 1.3e11 < cfg.param_count() < 1.33e11
    cut = dataclasses.replace(cfg, n_layers=4)
    assert 1.4e10 < cut.param_count() < 1.45e10


def test_forward_logits_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 24)).astype(np.int32)
    want = jmodel.logits(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _, jaux = jmodel.forward(jparams, jnp.asarray(tokens))
    _, aux = model.forward(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-5)


def test_prefill_and_decode_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, size=(2, 19)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens))
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
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
    assert cache["pos"] == 19 + 2


def test_server_tokens_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("dbrx-132b", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("dbrx-132b", smoke=True, max_batch=2, device="cpu")
    srv.cfg, srv.model, srv.params = cfg, model, params
    srv._decode = model.decode_step
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=12 - i).astype(np.int32)
               for i in range(3)]
    want = jsrv.generate([JaxRequest(i, p.copy(), 5)
                          for i, p in enumerate(prompts)])
    got = srv.generate([Request(i, p.copy(), 5)
                        for i, p in enumerate(prompts)])
    assert got == want
    assert srv.metrics["prefills"] == 2 and srv.metrics["tokens"] == 3 * 4
    guard = srv.metrics["saturation"]["guard"]
    assert sum(guard["runtime_fallbacks"].values()) == 0


def test_server_takes_a_config():
    """``cfg=`` serves a given config in place of the arch's (how a
    full-width config at a cut depth is served on one card)."""
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"), n_layers=1)
    srv = Server("dbrx-132b", device="cpu", cfg=cfg)
    assert srv.cfg is cfg and len(srv.params["layers"]) == 1
    out = srv.generate([Request(0, np.arange(1, 9, dtype=np.int32), 3)])
    assert len(out[0]) == 3
