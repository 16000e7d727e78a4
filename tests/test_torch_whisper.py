"""The port's Whisper encoder-decoder (the encdec family) and its server
against the JAX package's, on the whisper-small smoke config in f32 with
the JAX init's parameters; the layernorm and gelu tile ops against the
JAX package's saturated functions; and the flash kernel's plain version,
non-causal at whisper's head_dim 64, against the Pallas flash kernel in
interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.tile_programs import get_tile_op as jax_tile_op
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.models import get_model as jax_get_model
from repro.models.whisper import sinusoidal_pos as jax_sinusoidal_pos
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 flash_attention_plain)
from repro_torch.launch.serve import Request, Server
from repro_torch.models import EncDecLM, get_model, params_from_reference
from repro_torch.models.whisper import sinusoidal_pos

ATOL = 2e-4
TILE_TOL = {"f32": 2e-5, "bf16": 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    on the same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config("whisper_small"),
                               dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("whisper-small"),
                              dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return jcfg, jmodel, jparams, cfg, EncDecLM(cfg, device="cpu"), params


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _frames(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_params_from_reference_layout(pair):
    """Both layer stacks become lists; the decoder positions and the two
    final norms pass through."""
    jcfg, _, jparams, cfg, _, params = pair
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    assert set(params["dec_layers"][0]) == {"ln1", "self_attn", "ln2",
                                            "cross_attn", "ln3", "mlp"}
    assert set(params["enc_layers"][0]["mlp"]) == {"wi", "wd"}
    assert set(params["enc_norm"]) == {"g", "b"}
    np.testing.assert_array_equal(
        params["dec_layers"][1]["cross_attn"]["wv"].numpy(),
        np.asarray(jparams["dec_layers"]["cross_attn"]["wv"][1]))
    np.testing.assert_array_equal(params["dec_pos"].numpy(),
                                  np.asarray(jparams["dec_pos"]))
    assert get_model(cfg, device="cpu").__class__ is EncDecLM
    # the port counts every parameter it holds; the JAX count leaves out
    # the learned decoder positions, the LayerNorm biases and final norms,
    # and counts an unembedding whisper does not hold (its output is tied
    # to the embedding though its config says untied)
    d = cfg.d_model
    assert cfg.param_count() == _numel(params)
    assert cfg.param_count() == jcfg.param_count() + cfg.max_seq * d \
        + 3 * d * cfg.n_layers + 2 * d * cfg.n_enc_layers + 4 * d \
        - cfg.vocab * d


def test_full_config_is_the_published_width():
    cfg = get_config("whisper-small")
    assert (cfg.family, cfg.n_layers, cfg.n_enc_layers, cfg.d_model,
            cfg.vocab) == ("encdec", 12, 12, 768, 51_865)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (12, 12, 64, 3072)
    assert (cfg.norm, cfg.act, cfg.max_seq) == ("layernorm", "gelu", 32_768)
    assert cfg.head_dim in HEAD_DIMS
    assert 0.2e9 < cfg.param_count() < 0.35e9


def test_sinusoidal_pos_matches_jax():
    np.testing.assert_allclose(sinusoidal_pos(37, 64).numpy(),
                               np.asarray(jax_sinusoidal_pos(37, 64)),
                               atol=1e-6)


def test_encoder_matches_jax(pair):
    """The encoder: non-causal self-attention, LayerNorm, GELU."""
    _, jmodel, jparams, cfg, model, params = pair
    frames = _frames(cfg, 2, 12, 0)
    want = jmodel.encode(jparams, jnp.asarray(frames))
    got = model.encode(params, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_decoder_forward_matches_jax(pair):
    """The decoder over encoder states: causal self-attention and
    cross-attention."""
    _, jmodel, jparams, cfg, model, params = pair
    frames = _frames(cfg, 2, 12, 1)
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 12)).astype(np.int32)
    enc = jmodel.encode(jparams, jnp.asarray(frames))
    want = jmodel.forward(jparams, jnp.asarray(tokens), enc)
    got = model.forward(params, torch.from_numpy(tokens).long(),
                        torch.from_numpy(np.array(enc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("frames", ["zeros", "random"])
def test_prefill_and_decode_match_jax(pair, frames):
    """Prefill builds the self-attention k/v and the cross-attention
    xk/xv; three decode ticks follow the JAX model's, caches included."""
    _, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(0)
    S = 13
    tokens = rng.integers(1, cfg.vocab, size=(2, S)).astype(np.int32)
    fr = _frames(cfg, 2, S, 2) if frames == "random" else None
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens),
                                None if fr is None else jnp.asarray(fr))
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long(),
                              None if fr is None else torch.from_numpy(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for name in ("xk", "xv"):
        assert tuple(cache[name].shape) == tuple(jcache[name].shape)
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   err_msg=name)
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(3):
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
    assert cache["pos"] == S + 3


def test_server_tokens_match_jax(pair):
    """The server's encdec branch: zero frames of the prompt's length."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    jsrv = JaxServer("whisper-small", smoke=True, max_batch=2)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jmodel, jparams
    jsrv._decode = jax.jit(jmodel.decode_step)
    srv = Server("whisper-small", smoke=True, max_batch=2, device="cpu")
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


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_loss_matches_jax(pair, masked):
    """``EncDecLM.loss`` (encode the frames, the decoder over the tokens,
    the chunked cross-entropy over the tied embedding) against the JAX
    loss on the same frames, tokens and labels, the mask given or left to
    its default of ones (1e-4)."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {"frames": _frames(cfg, 2, 32, seed=13),
             "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        batch["mask"] = (rng.random((2, 32)) > 0.3).astype(np.float32)
    want = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model.loss(params, {k: torch.from_numpy(v) if v.dtype == np.float32
                              else torch.from_numpy(v).long()
                              for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), atol=1e-4, rtol=1e-4)


def test_remat_checkpoints_each_layer_under_autograd_only(pair, monkeypatch):
    """With ``cfg.remat`` every encoder and decoder layer runs under
    ``torch.utils.checkpoint`` when a gradient is taken, and nothing is
    checkpointed when serving (no_grad): the same loss either way."""
    import repro_torch.models.common as common
    cfg = dataclasses.replace(pair[3], remat=True)
    model, params = EncDecLM(cfg, device="cpu"), pair[5]
    calls = []
    real = common.checkpoint
    monkeypatch.setattr(common, "checkpoint", lambda fn, *a, **k: (
        calls.append(fn.__name__), real(fn, *a, **k))[1])
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 17))).long()
    batch = {"frames": torch.from_numpy(_frames(cfg, 2, 16, seed=15)),
             "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        served = model.loss(params, batch)
        model.prefill(params, batch["tokens"], batch["frames"])
    assert calls == []
    leaves = [p.requires_grad_() for p in params["dec_layers"][0]["mlp"]
              .values()]
    try:
        trained = model.loss(params, batch)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    # (the loss's chunks are checkpointed too)
    assert [c for c in calls if c.endswith("_block")] == \
        ["_enc_block"] * cfg.n_enc_layers + ["_dec_block"] * cfg.n_layers
    assert trained.item() == served.item()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["layernorm", "gelu"])
def test_whisper_tile_ops_match_jax(name, dt):
    """ops.layernorm and ops.gelu (the saturated programs' plain versions
    on the CPU) against the JAX package's saturated functions and its
    Pallas ops in interpret mode, at a ragged width."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 200)).astype(np.float32)
    vecs = [rng.normal(size=(200,)).astype(np.float32) for _ in range(2)]
    jdt, tdt = DTYPES[dt]
    if name == "layernorm":
        jargs = [jnp.asarray(a, jdt) for a in (x, *vecs)]
        got = ops.layernorm(*(torch.from_numpy(a).to(tdt)
                              for a in (x, *vecs)))
        sc = {"eps": 1e-6}
    else:
        jargs = [jnp.asarray(x, jdt)]
        got = ops.gelu(torch.from_numpy(x).to(tdt))
        sc = {}
    tol = TILE_TOL[dt]
    for want in (jax_tile_op(name).jax_ref(*jargs, **sc),
                 jax_tile_op(name).apply(*jargs, interpret=True, **sc)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("H,KH,S", [(4, 4, 128), (4, 2, 192)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_at_head_dim_64(H, KH, S, causal):
    """The plain version the CUDA kernel is held against on the card, at
    whisper's head_dim 64 and non-causal (the encoder, cross-attention)
    as well as causal, against the Pallas kernel (f32, 2e-3)."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, H, S, 64)).astype(np.float32)
    k = rng.normal(size=(2, KH, S, 64)).astype(np.float32)
    v = rng.normal(size=(2, KH, S, 64)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_block=64, kv_block=64, interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
