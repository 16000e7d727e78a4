"""The port's sharding rules (repro_torch.parallel.sharding, ctx) against
the reference's (repro.parallel), leaf by leaf, for the ten configs at
full width on the production meshes (16, 16) and (2, 16, 16) and on
(2, 4) and (1, 1).

Both sides read only a mesh's axis names and sizes before placing
anything, so a stand-in mesh with ``axis_names`` and ``shape`` serves
both, and no device is needed: the JAX side takes ``jax.eval_shape``
trees, the port its ``meta`` ones. The port's layer stacks are lists of
per-layer dicts where the reference stacks each leaf along a leading
axis, so every layer's port spec equals the reference's without its
leading ``None``; the caches are stacked in both and compare as they
are. Also: ``ctx.constrain``'s resolved axes against the reference's
``_expand`` and ``_fits``, ``_padded_H`` against the reference's, and
``placements``/``distribute`` on a one-rank group.
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import ARCHS, SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import steps as JS
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro.optim import OptConfig as JOptConfig
from repro.parallel import ctx as jctx
from repro.parallel import sharding as jsh
from repro_torch import tree as T
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import steps as S
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.optim import OptConfig
from repro_torch.parallel import ctx, sharding as tsh


class StandIn:
    """A mesh as both sharding modules read it: names and sizes."""

    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


MESHES = [(16, 16), (2, 16, 16), (2, 4), (1, 1)]
MESH_IDS = ["16x16", "2x16x16", "2x4", "1x1"]
STACKS = ("layers", "enc_layers", "dec_layers")


def _jname(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                    for p in path)


def _jax_specs(tree):
    """{name: spec tuple} of a tree of the reference's PartitionSpecs."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jname(p): tuple(s) for p, s in leaves}


def _port_specs(tree):
    """{name: set of spec tuples} of a port spec tree, each layer of a
    stack under its stack's name (the index dropped) with a leading
    ``None`` restored."""
    out = {}
    for path, spec in zip(*T.flatten(tree)):
        stacked = path and path[0] in STACKS and isinstance(path[1], int)
        name = "/".join(str(p) for i, p in enumerate(path)
                        if not (stacked and i == 1))
        axes = (None,) + tuple(spec) if stacked else tuple(spec)
        out.setdefault(name, set()).add(axes)
    return out


def _assert_same(port_tree, jax_tree):
    want, got = _jax_specs(jax_tree), _port_specs(port_tree)
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == {spec}, name


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    cfg = jax_config(arch)
    return cfg, jax_model(cfg), JS.params_struct(jax_model(cfg))


@functools.lru_cache(maxsize=None)
def _port_side(arch):
    cfg = get_config(arch)
    model = get_model(cfg, device="meta")
    return cfg, model, S.params_struct(model)


@pytest.mark.parametrize("fsdp", [None, True, False])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh, fsdp):
    jcfg, _, jparams = _jax_side(arch)
    cfg, _, params = _port_side(arch)
    m = StandIn(mesh)
    _assert_same(tsh.param_specs(cfg, params, m, fsdp=fsdp),
                 jsh.param_specs(jcfg, jparams, m, fsdp=fsdp))


@pytest.mark.parametrize("moments", ["f32", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_match_the_reference(arch, mesh, moments):
    jcfg, _, jparams = _jax_side(arch)
    cfg, _, params = _port_side(arch)
    m = StandIn(mesh)
    jps = jsh.param_specs(jcfg, jparams, m)
    jopt = JS.opt_struct(jparams, JOptConfig(moment_dtype=moments))
    ps = tsh.param_specs(cfg, params, m)
    opt = S.opt_struct(params, OptConfig(moment_dtype=moments))
    got = tsh.opt_state_specs(cfg, opt, ps, m)
    want = jsh.opt_state_specs(jcfg, jopt, jps, m)
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    for key in ("m", "v"):
        _assert_same(got[key], want[key])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_the_reference(arch, mesh, shape):
    jcfg, _, _ = _jax_side(arch)
    cfg, _, _ = _port_side(arch)
    m = StandIn(mesh)
    want = jsh.batch_specs(jcfg, JS.batch_spec_struct(jcfg, JSHAPES[shape]),
                           m)
    got = tsh.batch_specs(cfg, S.batch_spec_struct(cfg, SHAPES[shape]), m)
    assert _port_specs(got) == {k: {v} for k, v in _jax_specs(want).items()}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    jcfg, jm, _ = _jax_side(arch)
    cfg, model, _ = _port_side(arch)
    m = StandIn(mesh)
    shape = SHAPES["decode_32k"]
    if cfg.family == "encdec":     # the cross-attention cache: S frames
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 shape.seq_len)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
    jcache = jax.eval_shape(lambda: jm.init_cache(shape.global_batch,
                                                  shape.seq_len))
    got = _port_specs(tsh.cache_specs(cfg, cache, m))
    want = _jax_specs(jsh.cache_specs(jcfg, jcache, m))
    assert got == {k: {v} for k, v in want.items()}


AXES = [("dp", None, None), ("dp", "tp", None, None), (None, "tp"),
        ("dp", None, None, None, "tp"), ("tp", "dp"), ("data", "model"),
        ("pod", None), (None,)]
SHAPES_ = [(256, 4096, 3072), (256, 24, 4096, 128), (3072, 51865),
           (128, 8, 12, 1, 32768), (6, 4), (1, 8), (512, 3), (7,)]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("shape,axes", list(zip(SHAPES_, AXES)))
def test_constrain_resolves_axes_as_the_reference(mesh, shape, axes):
    m = StandIn(mesh)
    want = []
    for dim, ax in zip(shape, axes):
        ax = jctx._expand(m, ax)
        want.append(ax if jctx._fits(m, dim, ax) else None)
    assert ctx.resolve(m, shape, *axes) == tuple(want)


@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_padded_heads_match_the_reference(arch, tp):
    m = StandIn((16, tp))
    with jctx.activate(m):
        want = JL._padded_H(jax_config(arch))
    with ctx.activate(m):
        got = TL._padded_H(get_config(arch))
        assert ctx.tp_size() == tp
    assert got == want
    if arch == "minitron_4b" and tp == 16:
        assert got == 32                  # 24 heads padded to the axis


def test_placements_put_pod_before_data():
    from torch.distributed.tensor import Replicate, Shard
    m = StandIn((2, 16, 16))
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, None), m) == (Replicate(),) * 3


def test_distribute_places_a_tree_on_a_one_rank_group():
    """``distribute`` keeps each rank's shard of the whole tensor and
    leaves non-tensors and 0-d tensors as they are; on one rank the
    local shard is the tensor."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = dataclasses.replace(get_config("minitron_4b"), n_layers=1)
    params = get_model(cfg, device="meta").init(0)
    with fake_group(1):
        mesh = make_debug_mesh(1, 1)
        specs = tsh.param_specs(cfg, params, mesh, fsdp=True)
        placed = tsh.distribute({"p": params, "pos": 3,
                                 "step": torch.zeros((), dtype=torch.int32)},
                                {"p": specs, "pos": tsh.P(),
                                 "step": tsh.P()}, mesh)
        assert placed["pos"] == 3 and not ctx.is_dtensor(placed["step"])
        for p, d, s in zip(T.leaves(params), T.leaves(placed["p"]),
                           T.leaves(specs)):
            assert d.to_local().shape == p.shape
            assert tuple(d.placements) == tsh.placements(s, mesh)
    assert not dist.is_initialized()


def test_meshes_need_enough_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="fake process group of 512"):
        make_production_mesh(multi_pod=True)


def test_specs_read_the_reference_leaf_names():
    """Every leaf name the port's trees hold is one the reference's
    trees hold (so the path rules see the same names)."""
    for arch in ARCHS:
        _, _, jparams = _jax_side(arch)
        _, _, params = _port_side(arch)
        jnames = set(_jax_specs(jax.tree.map(
            lambda x: jax.sharding.PartitionSpec(), jparams)))
        assert set(_port_specs(_map_specs(params))) == jnames, arch


def _map_specs(params):
    return T.tree_map(lambda p: tsh.P(*([None] * p.ndim)), params)



def test_compression_under_a_data_parallel_mesh_raises():
    """No reference path compresses sharded gradients: the port's update
    refuses a compression mode under a mesh with more than one data rank
    (ROADMAP A14.5) and keeps it with one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_update
    model = get_model(get_smoke_config("minitron_4b"), device="cpu")
    with ctx.activate(StandIn((2, 1))):
        with pytest.raises(NotImplementedError, match="A14.5"):
            make_update(model, OptConfig(), "int8")
        make_update(model, OptConfig(), "none")
    with ctx.activate(StandIn((1, 4))):
        make_update(model, OptConfig(), "int8_ef")
