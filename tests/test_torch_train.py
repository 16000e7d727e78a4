"""The port's training path against the JAX package's, on the CPU in f32
with seeded numpy inputs and the JAX init's weights: the tile ops'
backwards, the chunked cross-entropy, the model's loss and its
gradients (minitron, qwen2-vl, mamba2, zamba2, whisper and dbrx smoke),
``apply_updates`` (f32 and int8 moments, the stacked layout's weight
decay, the chunked update of a large leaf, int8's dropped second
moments), the trainer's losses, failure replay, checkpoints, and that
``build_trainer`` takes every arch. The kernels' own backwards run on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: tile ops 2e-5 (tests/test_kernels.py's f32), the loss 1e-5,
the model's loss and gradients and the trainer's losses 1e-4 (as the
port's model tests), the optimizer 2e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.launch.steps import make_grad_step as jax_make_grad_step
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.models import get_model as jax_get_model
from repro.models.common import chunked_softmax_xent as jax_xent
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import init_opt_state as jax_init_opt_state
import repro_torch.launch.train as train
from repro_torch import tree as T
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import (make_grad_step, make_train_step,
                                      value_and_grad)
from repro_torch.models import LM, get_model, params_from_reference
from repro_torch.models.common import chunked_softmax_xent, reference_ndim
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim import adamw

TILE_TOL = 2e-5
MODEL_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the tile ops' backwards ------------------------------------------------------
def _vjp(fn, *args, dy):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _grads(fn, *args, dy):
    """Gradients of ``sum(fn(*args) * dy)`` by autograd, for each arg."""
    leaves = [_t(a).requires_grad_() for a in args]
    (fn(*leaves) * _t(dy)).sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("rows,d", [(6, 64), (33, 96)])
def test_rmsnorm_backward_matches_jax_vjp(rows, d):
    """The analytic backward the card's rmsnorm uses, and its autograd
    Function (the kernel op, here its plain version on the CPU), against
    jax.vjp of the JAX op."""
    rng = np.random.default_rng(0)
    x, g, dy = (rng.normal(size=s).astype(np.float32)
                for s in ((rows, d), (d,), (rows, d)))
    want = _vjp(lambda a, b: jops.rmsnorm(a, b), x, g, dy=dy)
    got = ops.rmsnorm_backward(_t(x), _t(g), _t(dy))
    via_fn = _grads(lambda a, b: ops._RmsnormFn.apply(a, b, 1e-6), x, g,
                    dy=dy)
    for w, a, b in zip(want, got, via_fn):
        np.testing.assert_allclose(a.numpy(), w, atol=TILE_TOL, rtol=TILE_TOL)
        np.testing.assert_allclose(b, w, atol=TILE_TOL, rtol=TILE_TOL)


@pytest.mark.parametrize("rows,d", [(6, 64), (33, 96)])
def test_rmsnorm_gated_backward_matches_jax_vjp(rows, d):
    """The analytic backward the card's rmsnorm_gated uses (x, the gate z
    and the gain), and its autograd Function (here through the op's plain
    version), against jax.vjp of the JAX op."""
    rng = np.random.default_rng(6)
    x, z, g, dy = (rng.normal(size=s).astype(np.float32)
                   for s in ((rows, d), (rows, d), (d,), (rows, d)))
    want = _vjp(lambda a, b, c: jops.rmsnorm_gated(a, b, c), x, z, g, dy=dy)
    got = ops.rmsnorm_gated_backward(_t(x), _t(z), _t(g), _t(dy))
    via_fn = _grads(lambda a, b, c: ops._RmsnormGatedFn.apply(a, b, c, 1e-6),
                    x, z, g, dy=dy)
    for w, a, b in zip(want, got, via_fn, strict=True):
        np.testing.assert_allclose(a.numpy(), w, atol=TILE_TOL, rtol=TILE_TOL)
        np.testing.assert_allclose(b, w, atol=TILE_TOL, rtol=TILE_TOL)


@pytest.mark.parametrize("shape", [(5, 48), (2, 7, 40)])
def test_swiglu_backward_matches_jax_vjp(shape):
    rng = np.random.default_rng(1)
    a, b, dy = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = _vjp(jops.swiglu, a, b, dy=dy)
    got = ops.swiglu_backward(_t(a), _t(b), _t(dy))
    via_fn = _grads(ops._SwigluFn.apply, a, b, dy=dy)
    for w, x, y in zip(want, got, via_fn):
        np.testing.assert_allclose(x.numpy(), w, atol=TILE_TOL, rtol=TILE_TOL)
        np.testing.assert_allclose(y, w, atol=TILE_TOL, rtol=TILE_TOL)


@pytest.mark.parametrize("shape", [(6, 64), (3, 11, 96)])
def test_layernorm_backward_matches_jax_vjp(shape):
    """layernorm's analytic backward (x, the gain and the bias) and its
    autograd Function (the kernel op, here its plain version on the CPU)
    against jax.vjp of the JAX op, with a mean far from 0."""
    rng = np.random.default_rng(7)
    d = shape[-1]
    x, g, b, dy = (rng.normal(size=s).astype(np.float32)
                   for s in (shape, (d,), (d,), shape))
    x = x + 3.0
    want = _vjp(lambda a, c, e: jops.layernorm(a, c, e), x, g, b, dy=dy)
    got = ops.layernorm_backward(_t(x), _t(g), _t(b), _t(dy))
    via_fn = _grads(lambda a, c, e: ops._LayernormFn.apply(a, c, e, 1e-6),
                    x, g, b, dy=dy)
    for w, a, c in zip(want, got, via_fn, strict=True):
        np.testing.assert_allclose(a.numpy(), w, atol=TILE_TOL, rtol=TILE_TOL)
        np.testing.assert_allclose(c, w, atol=TILE_TOL, rtol=TILE_TOL)


@pytest.mark.parametrize("shape", [(5, 48), (2, 7, 40)])
def test_gelu_backward_matches_jax_vjp(shape):
    """gelu's (tanh form) analytic backward and its autograd Function
    against jax.vjp of the JAX op, over |a| up to ~12 (both tails)."""
    rng = np.random.default_rng(8)
    a, dy = (rng.normal(size=shape).astype(np.float32) * s for s in (3, 1))
    want = _vjp(jops.gelu, a, dy=dy)
    got = ops.gelu_backward(_t(a), _t(dy))
    via_fn = _grads(ops._GeluFn.apply, a, dy=dy)
    np.testing.assert_allclose(got.numpy(), want[0], atol=TILE_TOL,
                               rtol=TILE_TOL)
    np.testing.assert_allclose(via_fn[0], want[0], atol=TILE_TOL,
                               rtol=TILE_TOL)


@pytest.mark.parametrize("shape", [(4, 9, 16), (2, 1, 128)])
def test_moe_router_backward_matches_jax_vjp(shape):
    """The router softmax's backward from its output, and its autograd
    Function, against jax.vjp of the JAX op (dbrx's 16 experts, arctic's
    128 at a decode tick)."""
    rng = np.random.default_rng(9)
    logits, dy = (rng.normal(size=shape).astype(np.float32) * s
                  for s in (4, 1))
    want = _vjp(jops.moe_router_probs, logits, dy=dy)
    p = ops.moe_router_probs(_t(logits))
    got = ops.moe_router_backward(p, _t(dy))
    via_fn = _grads(ops._MoeRouterFn.apply, logits, dy=dy)
    np.testing.assert_allclose(got.numpy(), want[0], atol=TILE_TOL,
                               rtol=TILE_TOL)
    np.testing.assert_allclose(via_fn[0], want[0], atol=TILE_TOL,
                               rtol=TILE_TOL)


def _rope(B, S, hd, per_batch, seed):
    """cos/sin in the model's layouts: (1, 1, S, hd) from 1-D positions,
    or (B, 1, S, hd) from M-RoPE positions (one table per batch row)."""
    from repro_torch.models.common import mrope_cos_sin, rope_cos_sin
    if not per_batch:
        cos, sin = rope_cos_sin(torch.arange(S), hd, 10_000.0)
        return cos[None, None], sin[None, None]
    pos = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, size=(3, B, S)))
    q = hd // 4
    cos, sin = mrope_cos_sin(pos, hd, 1e6, (hd // 2 - 2 * q, q, q))
    return cos[:, None], sin[:, None]


@pytest.mark.parametrize("per_batch", [False, True], ids=["1d", "per_batch"])
@pytest.mark.parametrize("B,H,S,hd", [(2, 3, 9, 16), (1, 2, 12, 32)])
def test_rotary_backward_is_rotary_with_minus_sin(B, H, S, hd, per_batch):
    """The gradient of rotary is rotary(dy, cos, -sin) exactly (the card's
    backward launches the same kernel so), with one table for every batch
    row or one per row, against jax.vjp of the JAX op."""
    rng = np.random.default_rng(2)
    q, dy = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
             for _ in range(2))
    cos, sin = _rope(B, S, hd, per_batch, seed=3)
    want = _vjp(lambda a: jops.rotary(a, jnp.asarray(cos.numpy()),
                                      jnp.asarray(sin.numpy())), q, dy=dy)[0]
    via_fn = _grads(lambda a: ops._RotaryFn.apply(a, cos, sin), q, dy=dy)[0]
    direct = ops.rotary(_t(dy), cos, -sin).numpy()
    np.testing.assert_allclose(via_fn, want, atol=TILE_TOL, rtol=TILE_TOL)
    np.testing.assert_allclose(direct, want, atol=TILE_TOL, rtol=TILE_TOL)


# -- the loss ---------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,V", [(32, 8, 2048), (24, 16, 300),
                                       (20, 64, 4100)],
                         ids=["even", "ragged_chunk_padded_vocab",
                              "one_chunk_padded_vocab"])
def test_chunked_softmax_xent_matches_jax(S, chunk, V):
    """Loss and its gradients (hidden, unembedding) within 1e-5: chunks of
    gcd(S, chunk) where chunk does not divide S, the vocab padded to a
    multiple of 2048 with the padding masked."""
    rng = np.random.default_rng(4)
    B, D = 2, 16
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    y = rng.integers(0, V, size=(B, S)).astype(np.int32)
    m = (rng.random((B, S)) > 0.25).astype(np.float32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: jax_xent(a, b, jnp.asarray(y), jnp.asarray(m),
                              chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss = chunked_softmax_xent(th, tw, _t(y).long(), _t(m), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-5)
    with torch.no_grad():
        plain = chunked_softmax_xent(_t(h), _t(w), _t(y).long(), _t(m),
                                     chunk=chunk)
    assert plain.item() == loss.item()


# -- LM.loss and its gradients ------------------------------------------------------
def _pair(arch, **overrides):
    """(jax model, jax params, port cfg, port model, port params) on the
    same f32 weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=jnp.float32)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              **overrides)
    return (jmodel, jparams, cfg, get_model(cfg, device="cpu"),
            params_from_reference(_np(jparams), cfg, "cpu"))


def _batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":     # an image of 4 x 5 patches opens each row
        pos = np.zeros((3, B, S), np.int32)
        pos[1, :, :20] = np.arange(20) // 5
        pos[2, :, :20] = np.arange(20) % 5
        pos[:, :, 20:] = 5 + np.arange(S - 20)
        batch["positions"] = pos
    if cfg.family == "encdec":  # the stub frontend's frames, prompt-long
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def _port_batch(batch):
    return {k: _t(v) if v.dtype == np.float32 else _t(v).long()
            for k, v in batch.items()}


TRAINED = ["minitron_4b", "qwen2_vl_2b", "mamba2_1p3b", "zamba2_2p7b",
           "whisper_small", "dbrx_132b", "granite_8b", "mistral_nemo_12b",
           "mistral_large_123b", "arctic_480b"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_every_gradient_match_jax(arch, remat):
    jmodel, jparams, cfg, model, params = _pair(arch, remat=remat)
    batch = _batch(cfg)
    jl, jg = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model, params, _port_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    want = params_from_reference(_np(jg), cfg, "cpu")
    paths, got = T.flatten(grads)
    assert len(got) == len(T.leaves(want)) == len(T.leaves(params))
    for path, g, w in zip(paths, got, T.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=str(path))
    assert all(not p.requires_grad and p.grad is None
               for p in T.leaves(params))


@pytest.mark.parametrize("arch", TRAINED)
def test_grad_step_matches_jax(arch):
    """``make_grad_step`` on a numpy batch: the loss and every gradient
    as the JAX package's ``make_grad_step`` gives them (1e-4)."""
    jmodel, jparams, cfg, model, params = _pair(arch)
    batch = _batch(cfg, seed=3)
    jl, jg = jax_make_grad_step(jmodel)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = make_grad_step(model)(params, batch)
    np.testing.assert_allclose(loss.item(), float(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    want = params_from_reference(_np(jg), cfg, "cpu")
    for path, g, w in zip(T.flatten(grads)[0], T.leaves(grads),
                          T.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=str(path))


# -- the optimizer --------------------------------------------------------------------
@pytest.mark.parametrize("moment,grad_dtype", [
    ("f32", "f32"), ("int8", "f32"), ("f32", "bf16")],
    ids=["f32", "int8", "f32-bf16_grads"])
def test_apply_updates_matches_jax(moment, grad_dtype):
    """Two steps on the minitron smoke weights with seeded gradients
    (scaled so that the clip acts), f32 or int8 moments: parameters and
    moments within 2e-5. The JAX package decays (and clips through the
    op) each layer's norm gain, stacked (L, d), and not the final norm
    (d,); the port reads its per-layer leaves in that layout. bf16
    gradients, as autograd returns them for bf16 weights, go to both as
    the same bf16 values: the JAX package casts them to f32 and clips,
    the port's l2_clip takes them as they are."""
    _, jparams, cfg, _, params = _pair("minitron_4b")
    jcfg = JaxOptConfig(warmup_steps=1, moment_dtype=moment)
    ocfg = OptConfig(warmup_steps=1, moment_dtype=moment)
    jstate = jax_init_opt_state(jparams, jcfg)
    state = init_opt_state(params, ocfg)
    rng = np.random.default_rng(5)
    for step in range(2):
        jg = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32) * 0.05), jparams)
        if grad_dtype == "bf16":
            jg = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jg)
        g = params_from_reference(
            _np(jax.tree.map(lambda a: a.astype(jnp.float32), jg)), cfg,
            "cpu")
        if grad_dtype == "bf16":    # exact: the values are bf16's
            g = T.tree_map(lambda a: a.bfloat16(), g)
            assert all(a.dtype == torch.bfloat16 for a in T.leaves(g))
        jparams, jstate = jax_apply_updates(jparams, jg, jstate, jcfg)
        params, state = apply_updates(params, g, state, ocfg,
                                      ndim=functools.partial(reference_ndim,
                                                             cfg))
        assert int(state["step"]) == step + 1
    want = params_from_reference(_np(jparams), cfg, "cpu")
    for path, p, w in zip(T.flatten(params)[0], T.leaves(params),
                          T.leaves(want)):
        np.testing.assert_allclose(p.numpy(), w.numpy(), atol=TILE_TOL,
                                   rtol=TILE_TOL, err_msg=str(path))
    for key in ("m", "v"):
        jm = params_from_reference(_np(jstate[key]), cfg, "cpu")
        for a, b in zip(T.leaves(state[key]), T.leaves(jm)):
            if moment == "int8" and a.dtype == torch.int8:
                # a rounding tie of x / scale may fall either way
                assert (a.int() - b.int()).abs().max() <= 1
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           atol=TILE_TOL, rtol=TILE_TOL)
    # the stacked layout's rule, visibly: the layer gains moved off 1 by
    # more than their gradient step alone, the final norm's did not decay
    lr_wd = 0.1 * 3e-4
    assert not torch.allclose(params["layers"][0]["ln1"]["g"],
                              params["final_norm"]["g"], atol=lr_wd / 10)


def test_int8_moments_drop_a_small_second_moment_as_the_reference_does():
    """ROADMAP C4, the reference's int8 moments: a second moment below
    1/254 of its row's largest rounds to 0 while its first moment (1/20
    of the row's largest here) keeps 6 of 127 steps, so the next step
    divides that first moment by eps alone. The port's update equals the
    JAX package's there too, ~1e6 times the f32-moment update."""
    g1 = np.array([[1.0, 0.05]], np.float32)
    g2 = np.array([[1.0, 0.0]], np.float32)
    p0 = np.zeros((1, 2), np.float32)
    moved = {}
    for moment in ("f32", "int8"):
        jcfg = JaxOptConfig(warmup_steps=1, moment_dtype=moment,
                            weight_decay=0.0, clip_norm=1e9)
        ocfg = OptConfig(warmup_steps=1, moment_dtype=moment,
                         weight_decay=0.0, clip_norm=1e9)
        jp, jstate = {"w": jnp.asarray(p0)}, None
        jstate = jax_init_opt_state(jp, jcfg)
        tp = {"w": _t(p0)}
        state = init_opt_state(tp, ocfg)
        for g in (g1, g2):
            jp, jstate = jax_apply_updates(jp, {"w": jnp.asarray(g)}, jstate,
                                           jcfg)
            tp, state = apply_updates(tp, {"w": _t(g)}, state, ocfg,
                                      ndim=lambda path, p: p.ndim)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=TILE_TOL)
        moved[moment] = abs(float(tp["w"][0, 1]))
    lr = OptConfig().lr
    assert moved["f32"] < 3 * lr
    assert moved["int8"] > 1e5 * lr


def test_reference_ndim_reads_the_stacked_layout():
    g = torch.ones(8)
    dense = get_smoke_config("minitron_4b")
    assert reference_ndim(dense, ("layers", 3, "ln1", "g"), g) == 2
    assert reference_ndim(dense, ("final_norm", "g"), g) == 1
    assert reference_ndim(get_smoke_config("zamba2_2p7b"),
                          ("shared", "ln1", "g"), g) == 1
    assert reference_ndim(dense, ("embed",), torch.ones(4, 8)) == 2
    whisper = get_smoke_config("whisper_small")
    assert reference_ndim(whisper, ("enc_layers", 0, "ln1", "g"), g) == 2
    assert reference_ndim(whisper, ("dec_layers", 1, "ln1", "g"), g) == 2
    assert reference_ndim(whisper, ("layers", 0, "ln1", "g"), g) == 1


@pytest.mark.parametrize("limit", [8191, 4 * 64 * 128 - 1],
                         ids=["one_row_chunks", "ragged_chunks"])
@pytest.mark.parametrize("moment", ["f32", "bf16", "int8"])
def test_chunked_update_is_the_whole_leafs_bit_for_bit(moment, limit,
                                                        monkeypatch):
    """Two steps on the dbrx smoke weights (bf16, with f32 gradients
    scaled so that the clip acts), every leaf of ndim >= 2 above
    ``limit`` elements (the experts (4, 64, 128) and (4, 128, 64), the
    embedding (512, 64) and unembedding (64, 512)) updated in leading-axis
    chunks of at most ``limit`` elements, against the whole leaves at
    once: every parameter and moment bitwise equal, and l2_clip and adamw
    launched once per chunk."""
    cfg = get_smoke_config("dbrx-132b")
    params = get_model(cfg, device="cpu").init(0)
    ocfg = OptConfig(warmup_steps=1, moment_dtype=moment)
    ndim = functools.partial(reference_ndim, cfg)
    rng = np.random.default_rng(10)
    grads = [T.tree_map(lambda p: torch.from_numpy(rng.normal(
        size=p.shape).astype(np.float32) * 0.05), params) for _ in range(2)]
    calls = {"l2_clip": 0, "adamw_update": 0}

    def counted(name):
        fn = getattr(ops, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    runs = []
    for cap in (adamw.SLICED_UPDATE_ELEMS, limit):
        monkeypatch.setattr(adamw, "SLICED_UPDATE_ELEMS", cap)
        for name in calls:
            monkeypatch.setattr(ops, name, counted(name))
        calls.update(dict.fromkeys(calls, 0))
        p = T.tree_map(torch.clone, params)
        state = init_opt_state(p, ocfg)
        for g in grads:
            p, state = apply_updates(p, g, state, ocfg, ndim=ndim)
        runs.append((T.leaves((p, state)), dict(calls)))
        monkeypatch.undo()
    (whole, whole_calls), (chunked, chunked_calls) = runs
    assert len(whole) == len(chunked)
    for a, b in zip(whole, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaves = T.leaves(params)
    extra = 0
    for p in leaves:
        if p.ndim >= 2 and p.numel() > limit:
            rows = max(1, limit // (p.numel() // p.shape[0]))
            extra += -(-p.shape[0] // rows) - 1
    assert extra >= 3 * cfg.n_layers        # every expert leaf is chunked
    assert whole_calls["adamw_update"] == 2 * len(leaves)
    assert chunked_calls["adamw_update"] == 2 * (len(leaves) + extra)
    assert chunked_calls["l2_clip"] - whole_calls["l2_clip"] == 2 * extra


# -- the trainer ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,lr", [
    pytest.param(a, lr, id=a) for a, lr in (
        ("minitron-4b", 3e-4), ("qwen2-vl-2b", 3e-4), ("mamba2-1.3b", 3e-3),
        ("zamba2-2.7b", 3e-3), ("whisper-small", 3e-4),
        ("dbrx-132b", 3e-4))])
def test_trainer_losses_match_jax(arch, lr, tmp_path, monkeypatch):
    """8 steps of both packages' build_trainer (f32 smoke, the JAX init's
    weights in both, the same pipeline batches), checkpoints every 2
    steps: the losses within 1e-4, and falling. The SSM and hybrid smoke
    models tie their embeddings and start below log(vocab): at the default
    lr their loss moves within its step-to-step spread in 8 steps (in
    both packages alike), so they train at 3e-3. The encdec step's frames
    are the JAX step's (``PRNGKey(0)``, which torch cannot draw)."""
    monkeypatch.setattr(jax_train, "get_smoke_config", lambda a: (
        dataclasses.replace(jax_smoke_config(a), dtype=jnp.float32)))
    monkeypatch.setattr(train, "get_smoke_config", lambda a: (
        dataclasses.replace(get_smoke_config(a), dtype=torch.float32)))
    monkeypatch.setattr(train, "encdec_frames", lambda cfg, B, S, device: (
        _t(jax.random.normal(jax.random.PRNGKey(0), (B, S, cfg.d_model),
                             jnp.float32))))
    kw = dict(smoke=True, steps=8, batch=4, seq=32, lr=lr)
    jt = jax_train.build_trainer(arch, ckpt_dir=str(tmp_path / "jax"), **kw)
    pt = train.build_trainer(arch, ckpt_dir=str(tmp_path / "port"),
                             device="cpu", **kw)
    cfg = get_smoke_config(arch)
    pt.params = params_from_reference(_np(jt.params), dataclasses.replace(
        cfg, dtype=torch.float32), "cpu")
    pt.opt_state = init_opt_state(pt.params, OptConfig())
    want = jt.run()["losses"]
    got = pt.run()["losses"]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("restart", [False, True],
                         ids=["recover", "simulated_host_restart"])
def test_failure_replay_equals_a_clean_run(restart, tmp_path):
    """A host lost at step 5 restores the step-4 checkpoint and replays
    the data from the step counter: the losses equal a clean run's. With
    ``simulate_host_restart`` the recovery also drops every built tile op
    (a replacement host re-saturates)."""
    kw = dict(smoke=True, steps=8, batch=4, seq=32, device="cpu")
    clean = train.build_trainer("minitron-4b", ckpt_dir=str(tmp_path / "a"),
                                **kw).run()
    trainer = train.build_trainer("minitron-4b", ckpt_dir=str(tmp_path / "b"),
                                  inject={5: ("node_loss", 1)}, **kw)
    trainer.cfg.simulate_host_restart = restart
    failed = trainer.run()
    assert clean["recoveries"] == 0 and failed["recoveries"] == 1
    assert failed["elastic_events"][0]["step"] == 5
    assert failed["losses"] == clean["losses"]


def test_grad_accumulation_matches_one_batch():
    """Four microbatches summed in f32 buffers give the one-batch step's
    loss and update (f32, summation order only). No mask: the step
    averages the microbatches' means, as the JAX step, which equals the
    batch's mean where every microbatch counts the same tokens."""
    _, _, cfg, model, params = _pair("minitron_4b")
    batch = _batch(cfg, B=4, seed=1)
    del batch["mask"]
    ocfg = OptConfig(warmup_steps=1)
    outs = []
    for k in (1, 4):
        p = T.tree_map(torch.clone, params)
        p, _, loss = make_train_step(model, ocfg, accum_steps=k)(
            p, init_opt_state(p, ocfg), batch)
        outs.append((loss.item(), T.leaves(p)))
    assert outs[0][0] == pytest.approx(outs[1][0], abs=1e-5)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    """bf16 parameters, f32 and int8 moments and the step, saved async as
    two hosts' shards and restored onto one (N -> M)."""
    model = LM(get_smoke_config("minitron-4b"), device="cpu")
    params = model.init(3)
    state = init_opt_state(params, OptConfig(moment_dtype="int8"))
    state["step"] = torch.tensor(7, dtype=torch.int32)
    tree = (params, state)
    ck = Checkpointer(str(tmp_path))
    for host in range(2):
        ck.save(4, tree, host_id=host, n_hosts=2, extra={"step": 4})
    ck.wait()
    assert ck.latest_step() == 4
    like = T.tree_map(torch.zeros_like, tree)
    restored, extra = ck.restore(like)
    assert extra == {"step": 4}
    for a, b in zip(T.leaves(restored), T.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_build_trainer_takes_every_arch(arch, tmp_path):
    """Every family trains: the smoke config of each of the ten arches
    through build_trainer on the CPU, two steps with finite losses."""
    out = train.build_trainer(arch, smoke=True, steps=2, batch=2, seq=16,
                              ckpt_dir=str(tmp_path), device="cpu").run()
    assert out["final_step"] == 2
    assert all(np.isfinite(out["losses"]))


def test_build_trainer_needs_a_device_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build_trainer("minitron-4b", smoke=True, steps=2, batch=2,
                            seq=8, ckpt_dir=str(tmp_path))


def test_default_opt_config_picks_int8_moments_above_100b():
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import default_opt_config
    assert default_opt_config(get_config("minitron-4b")).moment_dtype == "f32"
    assert default_opt_config(get_config("dbrx-132b"),
                              total_steps=7).moment_dtype == "int8"
