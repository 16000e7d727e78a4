"""The port's gradient compression (repro_torch.parallel.compression)
against the JAX package's (repro.parallel.compression) on the CPU.

The same seeded numpy gradients go through both ``Compressor``s: the
int8 codes and the scales are equal exactly (both round half to even
against the same f32 scale), the decompressed values within f32 2e-5,
``wire_bytes`` equal; the error-feedback state follows the reference's
over 5 steps. Then the training step: the smoke minitron's first
compressed step through both packages' ``build_trainer`` on the JAX
init's weights, and the port's ``int8_ef`` step equal to its ``int8``
step, as the reference's is (its step discards the error-feedback
state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train
from repro.configs import get_smoke_config as jax_smoke_config
from repro.parallel.compression import Compressor as JCompressor
import repro_torch.launch.train as train
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_reference
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.parallel import MODES, Compressor, compressed_grads
from repro_torch.parallel.compression import _dq8, _q8

TOL = dict(atol=2e-5, rtol=2e-5)


def _tree(seed=0, dtype=np.float32):
    """A 2-D leaf, a stacked 3-D leaf (a layer axis first, as the
    reference stacks layers) and a 1-D leaf, with a zero row (scale 1)
    and values of both signs."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(24, 40)).astype(dtype)
    w[3] = 0.0
    return {"w": w, "stack": (rng.normal(size=(3, 8, 16)) * 1e-3).astype(
        dtype), "b": rng.normal(size=(40,)).astype(dtype)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("mode", MODES)
def test_compressor_matches_the_reference(mode):
    g = _tree()
    jc, pc = JCompressor(mode), Compressor(mode)
    jstate, pstate = jc.init_state(_jax(g)), pc.init_state(_torch(g))
    jout, _ = jc.compress(_jax(g), jstate)
    pout, _ = pc.compress(_torch(g), pstate)
    for k in g:
        if mode.startswith("int8"):
            jq, pq = jout[k], pout[k]
            assert pq["q"].dtype == torch.int8
            np.testing.assert_array_equal(pq["q"].numpy(),
                                          np.asarray(jq["q"]))
            np.testing.assert_array_equal(pq["scale"].numpy(),
                                          np.asarray(jq["scale"]))
            assert tuple(pq["shape"].shape) == tuple(jq["shape"].shape)
        else:
            np.testing.assert_allclose(pout[k].float().numpy(),
                                       np.asarray(jout[k], np.float32),
                                       **TOL)
    jd, pd = jc.decompress(jout), pc.decompress(pout)
    for k in g:
        np.testing.assert_allclose(pd[k].float().numpy(),
                                   np.asarray(jd[k], np.float32), **TOL)
    assert pc.wire_bytes(_torch(g)) == jc.wire_bytes(_jax(g))


def test_bf16_gradients_compress_as_the_reference():
    """bf16 leaves (the card's gradients): the codes from their f32
    upcast, equal exactly; ``wire_bytes`` counts bf16's 2 bytes."""
    g = {k: jnp.asarray(v, jnp.bfloat16) for k, v in _tree(seed=2).items()}
    pg = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in g.items()}
    for mode in MODES:
        jc, pc = JCompressor(mode), Compressor(mode)
        assert pc.wire_bytes(pg) == jc.wire_bytes(g)
    jq, _ = JCompressor("int8").compress(g)
    pq, _ = Compressor("int8").compress(pg)
    for k in g:
        np.testing.assert_array_equal(pq[k]["q"].numpy(),
                                      np.asarray(jq[k]["q"]))


def test_error_feedback_state_follows_the_reference_over_5_steps():
    jc, pc = JCompressor("int8_ef"), Compressor("int8_ef")
    g0 = _tree(seed=10)
    jstate, pstate = jc.init_state(_jax(g0)), pc.init_state(_torch(g0))
    for step in range(5):
        g = _tree(seed=11 + step)
        jq, jstate = jc.compress(_jax(g), jstate)
        pq, pstate = pc.compress(_torch(g), pstate)
        for k in g:
            np.testing.assert_array_equal(pq[k]["q"].numpy(),
                                          np.asarray(jq[k]["q"]))
            np.testing.assert_allclose(pstate[k].numpy(),
                                       np.asarray(jstate[k]), **TOL)
    # the residual is carried: it is not zero after a step
    assert any(float(v.abs().max()) > 0 for v in pstate.values())


def test_round_trip_stays_within_half_a_rows_scale():
    g = _torch(_tree(seed=4))
    for k, leaf in g.items():
        q = _q8(leaf)
        back = _dq8(q)
        rows = leaf.reshape(-1, leaf.shape[-1])
        err = (back.reshape(rows.shape) - rows).abs()
        assert bool((err <= q["scale"] / 2 * (1 + 1e-6)).all()), k


def _pin_f32(monkeypatch):
    monkeypatch.setattr(jax_train, "get_smoke_config", lambda a: (
        dataclasses.replace(jax_smoke_config(a), dtype=jnp.float32)))
    monkeypatch.setattr(train, "get_smoke_config", lambda a: (
        dataclasses.replace(get_smoke_config(a), dtype=torch.float32)))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("mode", ["bf16", "int8_ef"])
def test_first_compressed_step_matches_the_jax_trainer(mode, tmp_path,
                                                        monkeypatch):
    """One step of the smoke minitron (f32) through both packages'
    build_trainer with ``compress``, the JAX init's weights in both: the
    loss within 1e-4 (the models' f32 tolerance) and every updated
    parameter within the tile ops' 2e-5."""
    _pin_f32(monkeypatch)
    kw = dict(smoke=True, steps=1, batch=4, seq=32, compress=mode)
    jt = jax_train.build_trainer("minitron-4b",
                                 ckpt_dir=str(tmp_path / "jax"), **kw)
    pt = train.build_trainer("minitron-4b", ckpt_dir=str(tmp_path / "port"),
                             device="cpu", **kw)
    cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                              dtype=torch.float32)
    pt.params = params_from_reference(_np(jt.params), cfg, "cpu")
    pt.opt_state = init_opt_state(pt.params, OptConfig())
    want, got = jt.run(), pt.run()
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4,
                               rtol=1e-4)
    ref = params_from_reference(_np(jt.params), cfg, "cpu")
    for path, a, b in zip(T.flatten(pt.params)[0], T.leaves(pt.params),
                          T.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(path),
                                   **TOL)


def test_int8_ef_step_equals_the_int8_step(tmp_path):
    """The port's ``int8_ef`` training equals its ``int8`` training bit
    for bit, as the reference's does: the JAX step compresses against
    the zeros its jitted step captured and drops the new state
    (``src/repro/launch/train.py:79``), and the port keeps that."""
    kw = dict(smoke=True, steps=3, batch=4, seq=32, device="cpu")
    runs = {m: train.build_trainer("minitron-4b", compress=m,
                                   ckpt_dir=str(tmp_path / m), **kw)
            for m in ("int8", "int8_ef")}
    out = {m: t.run() for m, t in runs.items()}
    assert out["int8"]["losses"] == out["int8_ef"]["losses"]
    for a, b in zip(T.leaves(runs["int8"].params),
                    T.leaves(runs["int8_ef"].params)):
        assert torch.equal(a, b)
    g = _torch(_tree(seed=6))
    ef, ef_read = compressed_grads(Compressor("int8_ef"), g)
    plain, read = compressed_grads(Compressor("int8"), g)
    for k in g:
        assert torch.equal(ef[k]["q"], plain[k]["q"])
        assert torch.equal(ef_read(ef[k], slice(None)),
                           read(plain[k], slice(None)))


def test_jax_int8_ef_step_equals_its_int8_step(tmp_path):
    """The reference's own step, the finding the port keeps: under
    ``int8_ef`` its losses and parameters equal ``int8``'s."""
    kw = dict(smoke=True, steps=3, batch=4, seq=32)
    runs = {m: jax_train.build_trainer("minitron-4b", compress=m,
                                       ckpt_dir=str(tmp_path / m), **kw)
            for m in ("int8", "int8_ef")}
    out = {m: t.run() for m, t in runs.items()}
    assert out["int8"]["losses"] == out["int8_ef"]["losses"]
    for a, b in zip(jax.tree.leaves(runs["int8"].params),
                    jax.tree.leaves(runs["int8_ef"].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_none_is_the_identity_and_bad_modes_raise():
    g = _torch(_tree())
    wire, read = compressed_grads(Compressor("none"), g)
    assert wire is g and read is None
    with pytest.raises(ValueError):
        Compressor("int4")


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_ef"])
def test_the_update_reads_each_chunk_as_the_whole_leaf_decompressed(mode):
    """``compressed_grads``' ``read`` of any leading-axis chunk of a wire
    leaf is bit for bit that chunk of the leaf's ``decompress``, so the
    update that reads chunk by chunk sees the JAX step's f32 gradients."""
    g = _torch(_tree(seed=8))
    comp = Compressor(mode)
    wire, read = compressed_grads(comp, g)
    whole = Compressor("int8" if mode == "int8_ef" else mode).decompress(
        wire)
    for k in g:
        full = read(wire[k], slice(None))
        assert full.dtype == torch.float32
        assert torch.equal(full, whole[k].float())
        if g[k].dim() > 1:
            for c in (slice(0, 1), slice(1, 3)):
                assert torch.equal(read(wire[k], c), whole[k][c].float())


def test_q8_in_row_blocks_equals_the_whole_leaf(monkeypatch):
    """``_q8`` quantizes a leaf's rows in blocks of ``Q8_BLOCK_ELEMS``
    elements; the codes and scales do not depend on the block."""
    from repro_torch.parallel import compression
    g = _torch(_tree(seed=9))
    whole = {k: _q8(v) for k, v in g.items()}
    monkeypatch.setattr(compression, "Q8_BLOCK_ELEMS", 50)
    for k, v in g.items():
        part = _q8(v)
        assert torch.equal(part["q"], whole[k]["q"]), k
        assert torch.equal(part["scale"], whole[k]["scale"]), k
