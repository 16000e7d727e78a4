"""The port's multi-device layer on the CPU: sharded training and decode
on gloo process groups, and the GPipe pipeline.

Each mesh runs once, in a group of spawned processes
(``tests/torch_multidev_worker.py``, a timeout of its own), and its
cases read the results. On the (2, 2) ("data", "model") mesh with FSDP,
each family's f32 smoke model, on the JAX init's weights
(``params_from_reference``), gives the loss of the port's unsharded
model (1e-5 relative) and of the JAX package's ``model.loss``
(``MODEL_TOL``), every gradient (``full_tensor()``) and one
two-microbatch ``make_train_step`` update of the unsharded port, and a
prefill and decode tick their unsharded logits and caches. The
(1, 4) mesh runs mistral-large's smoke model, whose 6 heads pad to 8
(zero heads in the weights) and whose 2 kv heads shard the decode cache
by sequence. The reference's own sharded test cannot run here (ROADMAP
§C: its embedding lookup raises ``DuplicateSpecError``), so the port's
sharded loss is held to the JAX package's unsharded one.

The pipeline runs 4 stages on gloo (the reference's case: L 8, D 16,
M 6, mb 4) against the sequential ``tanh(x @ w)`` stack in jnp.
"""
import dataclasses
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.parallel import pipeline_pp as jpp
from repro_torch.parallel import pipeline_pp as tpp

MODEL_TOL = 1e-4
WORKER = pathlib.Path(__file__).with_name("torch_multidev_worker.py")
MESHES = {"2x2": ["minitron_4b", "dbrx_132b", "mamba2_1p3b", "qwen2_vl_2b",
                  "zamba2_2p7b", "whisper_small"],
          "1x4": ["mistral_large_123b"]}
DECODE = {"minitron_4b", "dbrx_132b", "mamba2_1p3b", "zamba2_2p7b",
          "qwen2_vl_2b", "mistral_large_123b"}
CASES = [(m, a) for m, archs in MESHES.items() for a in archs]
_RESULTS = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(kind, shape, jobs, tmp):
    src, dst = tmp / f"{kind}_{shape}.in", tmp / f"{kind}_{shape}.out"
    with open(src, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(WORKER), kind, shape, str(_free_port()),
         str(src), str(dst)], env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def _batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":     # an image of 4 x 4 patches opens each row
        pos = np.zeros((3, B, S), np.int32)
        pos[1, :, :16] = np.arange(16) // 4
        pos[2, :, :16] = np.arange(16) % 4
        pos[:, :, 16:] = 4 + np.arange(S - 16)
        batch["positions"] = pos
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def _results(mesh, tmp_path_factory):
    if mesh not in _RESULTS:
        jobs, jax_loss = {}, {}
        for arch in MESHES[mesh]:
            jcfg = dataclasses.replace(jax_smoke_config(arch),
                                       dtype=jnp.float32)
            jmodel = jax_get_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            batch = _batch(jcfg)
            jax_loss[arch] = float(jmodel.loss(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
            jobs[arch] = {"params": jax.tree.map(np.asarray, jparams),
                          "batch": batch, "decode": arch in DECODE}
        res = _spawn("sharded", mesh, jobs, tmp_path_factory.mktemp(mesh))
        for arch in res:
            res[arch]["jax_loss"] = jax_loss[arch]
        _RESULTS[mesh] = res
    return _RESULTS[mesh]


@pytest.fixture
def result(request, tmp_path_factory):
    mesh, arch = request.param
    return _results(mesh, tmp_path_factory)[arch]


def _cases(pred=lambda m, a: True):
    return pytest.mark.parametrize(
        "result", [c for c in CASES if pred(*c)], indirect=True,
        ids=[f"{m}-{a}" for m, a in CASES if pred(m, a)])


@_cases()
def test_sharded_loss_matches_the_unsharded_port(result):
    assert abs(result["loss"] - result["loss0"]) <= 1e-5 * abs(
        result["loss0"])


@_cases()
def test_sharded_loss_matches_jax(result):
    np.testing.assert_allclose(result["loss"], result["jax_loss"],
                               atol=MODEL_TOL, rtol=MODEL_TOL)


@_cases()
def test_every_sharded_gradient_matches(result):
    assert len(result["grads"]) == len(result["grads0"])
    for i, (g, w) in enumerate(zip(result["grads"], result["grads0"])):
        np.testing.assert_allclose(g, w, atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=f"leaf {i}")


@_cases()
def test_autograd_leaves_partial_gradient_sums(result):
    # autograd leaves a replicated weight's gradient a Partial sum over
    # the data ranks; the update reduces it (the next test's numbers)
    assert any("Partial" in p for p in result["grad_placements"])


@_cases()
def test_sharded_train_step_update_matches(result):
    """Two microbatches, the update: the parameters (a first Adam step
    moves each by about lr, whatever its gradient's size) and both
    moments (the clipped gradient and its square, which read the
    sharded global norm)."""
    np.testing.assert_allclose(result["step_loss"], result["step_loss0"],
                               atol=1e-5, rtol=1e-5)
    for key in ("update", "m", "v"):
        for i, (p, w) in enumerate(zip(result[key], result[key + "0"])):
            scale = np.abs(w).max() or 1.0
            np.testing.assert_allclose(p, w, atol=MODEL_TOL * scale,
                                       rtol=MODEL_TOL,
                                       err_msg=f"{key} leaf {i}")


@_cases(lambda m, a: a in DECODE)
def test_sharded_prefill_and_decode_tick_match(result):
    """The prefill's last logits, a decode tick's logits, and every cache
    tensor they leave (written where each rank's shard lies: k and v by
    heads or, for mistral-large's 2 kv heads on 4 ranks, by sequence;
    the SSM states and conv histories)."""
    for key in ("prefill", "decode"):
        np.testing.assert_allclose(result[key], result[key + "0"],
                                   atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=key)
    assert len(result["cache"]) == len(result["cache0"])
    for i, (c, w) in enumerate(zip(result["cache"], result["cache0"])):
        np.testing.assert_allclose(c, w, atol=MODEL_TOL, rtol=MODEL_TOL,
                                   err_msg=f"cache leaf {i}")


# -- the pipeline ---------------------------------------------------------------
L_, D_, M_, MB_ = 8, 16, 6, 4


def _pp_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L_, D_, D_)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M_, MB_, D_)).astype(np.float32)
    return ws, x


def test_pipeline_matches_the_sequential_stack(tmp_path):
    ws, x = _pp_inputs()
    out = _spawn("pipeline", "4", {"ws": ws, "x": x}, tmp_path)["out"]
    ref = jnp.asarray(x)
    for w in ws:
        ref = jnp.tanh(ref @ w)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_split_layers_to_stages_matches_the_reference(n_stages):
    ws, _ = _pp_inputs()
    tree = {"w": ws, "b": ws[:, 0]}
    got = tpp.split_layers_to_stages(tree, n_stages)
    want = jpp.split_layers_to_stages(tree, n_stages)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def test_split_layers_to_stages_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="not divisible"):
        tpp.split_layers_to_stages({"w": np.zeros((6, 2))}, 4)
