"""The port's last four configs against their JAX twins: granite-8b (tied
embeddings), mistral-nemo-12b (q_dim below d_model), mistral-large-123b
and arctic-480b (128 experts top 2 beside a dense residual MLP). Each
config's fields and parameter count, and its smoke model in f32 on the
JAX init's weights (``params_from_reference``): the prefill's logits and
two decode ticks within the model tests' 1e-4, arctic's within the MoE
tests' 2e-4 (its softmax over experts and top-2 weights add their
rounding), and the full-sequence logits of the same."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import LM, params_from_reference

NEW = ("granite-8b", "mistral-nemo-12b", "mistral-large-123b", "arctic-480b")
TOL = {"granite-8b": 1e-4, "mistral-nemo-12b": 1e-4,
       "mistral-large-123b": 1e-4, "arctic-480b": 2e-4}


def _fields(cfg):
    """The config's fields with dtypes by name (torch's and jnp's differ)."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = np.dtype(cfg.dtype).name if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return out


def test_every_jax_arch_is_ported():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_config_fields_and_param_count_equal_jax(arch, smoke):
    """The fields are the JAX twin's; the count is the JAX count plus the
    final norm, which the port counts and the JAX count leaves out
    (``ModelConfig.param_count``), and at smoke size the parameters a
    model holds."""
    get, jget = (get_smoke_config, jax_smoke_config) if smoke \
        else (get_config, jax_config)
    cfg, jcfg = get(arch), jget(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.param_count() == jcfg.param_count() + cfg.d_model
    if smoke:
        from repro_torch import tree as T
        params = LM(cfg, device="cpu").init(0)
        assert sum(p.numel() for p in T.leaves(params)) == cfg.param_count()


@pytest.fixture(scope="module", params=NEW)
def pair(request):
    """(arch, jax model, jax params, port cfg, port model, port params) on
    the same f32 weights."""
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    return arch, jmodel, jparams, cfg, LM(cfg, device="cpu"), params


def test_params_take_the_config_layout(pair):
    arch, _, jparams, cfg, _, params = pair
    assert ("unembed" in params) == (not cfg.tie_embeddings)
    attn = params["layers"][0]["attn"]
    assert tuple(attn["wq"].shape) == (cfg.d_model, cfg.q_dim)
    assert tuple(attn["wo"].shape) == (cfg.q_dim, cfg.d_model)
    if arch == "mistral-nemo-12b":
        assert cfg.q_dim != cfg.d_model
    if arch == "arctic-480b":
        res = params["layers"][1]["moe"]["res"]
        assert tuple(res["wg"].shape) == (cfg.d_model,
                                          cfg.moe.residual_ffn_dim)
        np.testing.assert_array_equal(
            res["wd"].numpy(),
            np.asarray(jparams["layers"]["moe"]["res"]["wd"][1]))


def test_prefill_and_two_ticks_match_jax(pair):
    arch, jmodel, jparams, cfg, model, params = pair
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, cfg.vocab, size=(2, 24)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(tokens))
    tl, cache = model.prefill(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL[arch])
    for step in range(2):
        nxt = rng.integers(1, cfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache,
                                      torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=TOL[arch], err_msg=f"tick {step}")


def test_forward_logits_match_jax(pair):
    arch, jmodel, jparams, cfg, model, params = pair
    tokens = np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 20)).astype(np.int32)
    want = jmodel.logits(jparams, jnp.asarray(tokens))
    got = model.logits(params, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[arch])
