"""The port's Qwen2-VL backbone (the vlm family: the dense stack with
M-RoPE) and its server against the JAX package's, on the qwen2-vl smoke
config in f32 with the JAX init's parameters, with text positions and
with per-batch vision positions."""
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
from repro.models.common import mrope_cos_sin as jax_mrope_cos_sin
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch.serve import Request, Server
from repro_torch.models import LM, params_from_reference
from repro_torch.models.common import mrope_cos_sin

ATOL = 2e-4
S = 16
GRIDS = [(2, 3), (3, 3)]          # one image per batch row: gh x gw patches


def vision_positions(S, grids):
    """(3, B, S) M-RoPE positions standing in for Qwen2-VL's frontend:
    row b opens with an image of one temporal frame and gh x gw patches
    (t 0, h the patch row, w its column), then text whose t = h = w run
    on from max(gh, gw)."""
    pos = np.zeros((3, len(grids), S), np.int64)
    for b, (gh, gw) in enumerate(grids):
        n = gh * gw
        pos[1, b, :n] = np.arange(n) // gw
        pos[2, b, :n] = np.arange(n) % gw
        pos[:, b, n:] = max(gh, gw) + np.arange(S - n)
    return pos


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen2_vl_2b"),
                               dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("qwen2-vl-2b"),
                              dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return jcfg, jmodel, jparams, cfg, LM(cfg, device="cpu"), params


def _positions(kind, B):
    """(jax, torch) positions3, or (None, None) for text positions."""
    if kind == "text":
        return None, None
    pos = vision_positions(S, GRIDS[:B])
    return jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def test_params_from_reference_layout(pair):
    """The dense layout: a list of layers, tied embeddings."""
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    assert set(params["layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wk"].numpy(),
        np.asarray(jparams["layers"]["attn"]["wk"][1]))
    assert "unembed" not in params
    assert cfg.param_count() == _numel(params)
    assert cfg.param_count() == jcfg.param_count() + cfg.d_model


def test_full_config_is_the_published_width():
    cfg = get_config("qwen2-vl-2b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == \
        ("vlm", 28, 1536, 151_936)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (12, 2, 128, 8960)
    assert cfg.mrope_sections == (16, 24, 24) and cfg.tie_embeddings
    assert cfg.rope_theta == 1_000_000.0 and cfg.head_dim in HEAD_DIMS
    assert 1.3e9 < cfg.param_count() < 1.8e9


def test_vision_positions_stand_in_for_the_frontend():
    pos = vision_positions(12, [(2, 3)])
    np.testing.assert_array_equal(pos[:, 0, :7], [[0, 0, 0, 0, 0, 0, 3],
                                                  [0, 0, 0, 1, 1, 1, 3],
                                                  [0, 1, 2, 0, 1, 2, 3]])
    np.testing.assert_array_equal(pos[:, 0, 11], [8, 8, 8])


@pytest.mark.parametrize("kind", ["text", "vision"])
def test_mrope_cos_sin_matches_jax(kind):
    B = 2
    pos = vision_positions(S, GRIDS) if kind == "vision" else \
        np.broadcast_to(np.arange(S), (3, B, S)).copy()
    want = jax_mrope_cos_sin(jnp.asarray(pos), 16, 10_000.0, (2, 3, 3))
    got = mrope_cos_sin(torch.from_numpy(pos), 16, 10_000.0, (2, 3, 3))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == (B, S, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        mrope_cos_sin(torch.from_numpy(pos), 16, 10_000.0, (2, 3, 4))


@pytest.mark.parametrize("kind", ["text", "vision"])
def test_forward_logits_match_jax(pair, kind):
    _, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, S)).astype(np.int32)
    jpos, tpos = _positions(kind, 2)
    want = jmodel.logits(jparams, jnp.asarray(tokens), jpos)
    got = model.logits(params, torch.from_numpy(tokens).long(), tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vision_positions_change_the_logits(pair):
    """M-RoPE is active: vision positions move the hidden states away
    from the text positions' (as tests/test_models.py checks in JAX)."""
    _, _, _, cfg, model, params = pair
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab, size=(2, S))).long()
    text, _ = model.forward(params, tokens)
    vision, _ = model.forward(params, tokens, _positions("vision", 2)[1])
    assert not torch.allclose(text, vision, atol=1e-3)


@pytest.mark.parametrize("kind", ["text", "vision"])
def test_prefill_and_decode_match_jax(pair, kind):
    """Prefill fills the KV cache; two decode ticks at 1-D positions from
    cache["pos"] follow the JAX model's, caches included."""
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, size=(2, S)).astype(np.int32)
    jpos, tpos = _positions(kind, 2)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jpos)
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long(), tpos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(2):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   err_msg=name)
    assert cache["pos"] == S + 2


def test_server_tokens_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("qwen2-vl-2b", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("qwen2-vl-2b", smoke=True, max_batch=2, device="cpu")
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


@pytest.mark.parametrize("entry", ["forward", "prefill"])
@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-1.3b",
                                  "zamba2-2.7b", "dbrx-132b"])
def test_positions3_is_for_the_vlm_family(arch, entry):
    """Every other family refuses M-RoPE positions, the ssm family (which
    computes no rotary table) too."""
    model = LM(get_smoke_config(arch), device="cpu")
    with pytest.raises(ValueError, match="vlm"):
        getattr(model, entry)(model.init(0),
                              torch.ones((1, 4), dtype=torch.long),
                              torch.zeros((3, 1, 4), dtype=torch.long))
