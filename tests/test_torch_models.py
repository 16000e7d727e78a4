"""The port's dense LM and server against the JAX package's, on the
minitron smoke config in f32 with the JAX init's parameters."""
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
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import LM, params_from_reference

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config("minitron_4b"),
                               dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("minitron_4b"),
                              dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return jcfg, jmodel, jparams, cfg, LM(cfg, device="cpu"), params


def test_params_from_reference_layout(pair):
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    wq = params["layers"][1]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.q_dim)
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jparams["layers"]["attn"]["wq"][1]))
    assert params["embed"].dtype == torch.float32


def test_prefill_and_decode_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, size=(2, 16)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens))
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(8):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    assert cache["pos"] == 16 + 8


def test_forward_logits_match_jax(pair):
    _, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 12)).astype(np.int32)
    want = jmodel.logits(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_server_tokens_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("minitron-4b", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("minitron-4b", smoke=True, max_batch=2, device="cpu")
    srv.cfg, srv.model, srv.params = cfg, model, params
    srv._decode = model.decode_step
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=8 - i).astype(np.int32)
               for i in range(3)]
    want = jsrv.generate([JaxRequest(i, p.copy(), 5)
                          for i, p in enumerate(prompts)])
    got = srv.generate([Request(i, p.copy(), 5)
                        for i, p in enumerate(prompts)])
    assert got == want
    assert srv.metrics["prefills"] == 2 and srv.metrics["tokens"] == 3 * 4
    guard = srv.metrics["saturation"]["guard"]
    assert sum(guard["runtime_fallbacks"].values()) == 0


def test_decode_up_to_the_cache_end_matches_jax_then_raises(pair):
    """A prefill that reserves two decode positions (max_seq = S + 2): the
    two ticks that fill them match the JAX model's; the third, at
    position == cache length, raises instead of dropping its key and
    value (JAX clamps it onto the last slot)."""
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(5)
    S = 8
    tokens = rng.integers(1, cfg.vocab, size=(2, S)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_seq=S + 2)
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long(),
                              max_seq=S + 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(2):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    with pytest.raises(ValueError, match=f"position {S + 2} is past the KV "
                                         f"cache of length {S + 2}"):
        model.decode_step(params, cache, torch.ones((2, 1), dtype=torch.long))


@pytest.mark.parametrize("arch", ["minitron-4b", "dbrx-132b", "zamba2-2.7b",
                                  "qwen2-vl-2b", "whisper-small"])
def test_every_attention_family_refuses_decode_past_the_cache(arch):
    """Every family that decodes attention goes through attn_decode: at
    position == cache length a tick raises ValueError."""
    from repro_torch.models import get_model
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.arange(1, 7).reshape(1, 6)
    _, cache = model.prefill(params, tokens, max_seq=7)
    _, cache = model.decode_step(params, cache, tokens[:, :1])
    assert cache["pos"] == 7
    with pytest.raises(ValueError, match="past the KV cache"):
        model.decode_step(params, cache, tokens[:, :1])
