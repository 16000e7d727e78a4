"""Sharding rules: DP / TP (Megatron) / EP (experts) / SP (sequence) /
FSDP. The port of :mod:`repro.parallel.sharding`.

Spec construction is *path-based*: every parameter leaf is matched by its
path in the tree and gets a :class:`P` aligned with the mesh axes
``(pod, data, model)`` (multi-pod) or ``(data, model)`` (single pod).

Rules (with automatic divisibility fallback — a non-dividing axis is
dropped to replication rather than failing):

  embed (V, D)            -> (model, fsdp)         vocab-parallel
  unembed (D, V)          -> (fsdp, model)
  wq/wg/wu/w_z/w_x (D, F) -> (fsdp, model)         column-parallel
  wo/wd/w_out (F, D)      -> (model, fsdp)         row-parallel
  wk/wv (D, KVD)          -> (fsdp, None)          GQA KV replicated
  moe wg/wu (E, D, F)     -> (model, fsdp, None)   expert-parallel
  moe wd (E, F, D)        -> (model, None, fsdp)
  router, norms, scalars  -> replicated
  mamba conv_x (W, di)    -> (None, model); per-head vectors (nh,) -> model

FSDP (sharding the non-TP dim over the data axes) turns on automatically
for configs above ``FSDP_THRESHOLD`` parameters.

Activations: tokens/labels shard batch over (pod, data). Decode caches
shard batch over data, KV heads over model when divisible, else the
sequence axis (SP).

The port keeps its own small :class:`P` (a sequence of None, an axis
name, or a tuple of axis names per dimension). Its layer stacks are
lists of per-layer dicts, where the reference stacks each layer's leaf
along a leading axis, so a port spec of a layer's leaf is the
reference's without its leading ``None``; caches are stacked in both.
Only the mesh's axis names and sizes are read
(:func:`repro_torch.parallel.ctx.axis_sizes`: a ``DeviceMesh`` or a
stand-in) until :func:`placements` turns a spec into DTensor placements
and :func:`distribute` places a tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch import tree as T
from . import ctx

FSDP_THRESHOLD = 30e9


class P:
    """A partition spec: one entry per tensor dimension, each None
    (replicated), an axis name, or a tuple of axis names (sharded over
    their product, the first major)."""
    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.axes == other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]       # data-parallel axes (("pod","data") or ("data",))
    tp: str = "model"

    @property
    def dp_spec(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]


def mesh_axes(mesh) -> MeshAxes:
    dp = tuple(n for n in ctx.axis_sizes(mesh) if n in ("pod", "data"))
    return MeshAxes(dp=dp)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    sizes = ctx.axis_sizes(mesh)
    out = 1
    for n in (name if isinstance(name, tuple) else (name,)):
        out *= sizes[n]
    return out


def _fits(dim: int, mesh, axis) -> bool:
    return axis is None or dim % _axis_size(mesh, axis) == 0


def _spec(mesh, shape, *axes) -> P:
    """Build a P, dropping axes that don't divide."""
    return P(*(ax if (ax is not None and _fits(dim, mesh, ax)) else None
               for dim, ax in zip(shape, axes)))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)



def _map(fn, tree):
    paths, leaves = T.flatten(tree)
    return T.unflatten(tree, [fn(p, x) for p, x in zip(paths, leaves)])


def param_specs(cfg, params_tree, mesh, fsdp: Optional[bool] = None):
    """A tree of :class:`P` matching ``params_tree`` (tensors, ``meta``
    ones included)."""
    ax = mesh_axes(mesh)
    if fsdp is None:
        fsdp = cfg.param_count() > FSDP_THRESHOLD
    fs = ax.dp_spec if fsdp else None
    tp = ax.tp

    def leaf_spec(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        S = lambda *axes: _spec(mesh, shape, *axes)  # noqa: E731
        base = name.rsplit("/", 1)[-1]
        if "embed" == base:
            return S(tp, fs)
        if "unembed" == base:
            return S(fs, tp)
        if "dec_pos" == base:
            return S(None, None)
        if base in ("wq", "wg", "wu", "wi", "w_z", "w_x"):
            if "moe" in name and nd == 3:             # (E, D, F)
                return S(tp, fs, None)
            return S(fs, tp)
        if base in ("wo", "wd", "w_out"):
            if "moe" in name and nd == 3:             # (E, F, D)
                return S(tp, None, fs)
            return S(tp, fs)
        if base in ("wk", "wv"):
            return S(fs, None)
        if base in ("router", "w_B", "w_C", "w_dt", "conv_b", "conv_c"):
            return S(None, None)
        if base == "conv_x":
            return S(None, tp)
        if base in ("a_log", "d_skip", "dt_bias", "norm_g"):
            return S(tp)
        # norms (g, b), scalars
        return P(*([None] * nd))

    return _map(leaf_spec, params_tree)


def opt_state_specs(cfg, opt_state_tree, param_spec_tree, mesh):
    """Optimizer moments inherit the param spec; int8 scale rows follow
    the leading axes; step is replicated."""
    def match(ps, leaf_tree):
        if isinstance(leaf_tree, dict) and "q" in leaf_tree:  # int8 moments
            axes = list(ps) + [None] * (len(leaf_tree["q"].shape) - len(ps))
            scale_spec = P(*(axes[:-1] + [None])) if axes else P()
            return {"q": ps, "scale": scale_spec}
        return ps

    def moments(tree):
        return T.unflatten(param_spec_tree, [
            match(ps, sub) for ps, sub in zip(
                T.leaves(param_spec_tree),
                T.flatten(tree, upto=param_spec_tree)[1])])

    return {"step": P(), "m": moments(opt_state_tree["m"]),
            "v": moments(opt_state_tree["v"])}


def batch_specs(cfg, batch_tree, mesh):
    """Token batches: shard batch dim over all data axes (drop if it does
    not divide, e.g. long_500k batch=1)."""
    ax = mesh_axes(mesh)

    def leaf(path, x):
        shape = tuple(x.shape)
        if _path_str(path) == "positions":        # (3, B, S) for vlm
            return _spec(mesh, shape, None, ax.dp_spec, None)
        if len(shape) >= 1:
            return _spec(mesh, shape, ax.dp_spec,
                         *([None] * (len(shape) - 1)))
        return P()
    return _map(leaf, batch_tree)


def cache_specs(cfg, cache_tree, mesh):
    """Decode caches: batch over data; KV heads over model when
    divisible, else sequence (SP); SSM states shard heads over model."""
    ax = mesh_axes(mesh)
    tp = ax.tp
    tp_n = _axis_size(mesh, tp)

    def leaf(path, x):
        base = _path_str(path).rsplit("/", 1)[-1]
        if base == "pos":                             # a host int
            return P()
        shape = tuple(x.shape)
        if base in ("k", "v", "xk", "xv"):            # (L,B,KH,S,hd)
            KH = shape[2]
            if KH % tp_n == 0:
                return _spec(mesh, shape, None, ax.dp_spec, tp, None, None)
            return _spec(mesh, shape, None, ax.dp_spec, None, tp, None)
        if base == "h":                               # (L,B,nh,N,P)
            return _spec(mesh, shape, None, ax.dp_spec, tp, None, None)
        if base == "conv_x":                          # (L,B,W-1,di)
            return _spec(mesh, shape, None, ax.dp_spec, None, tp)
        if base in ("conv_b", "conv_c"):
            return _spec(mesh, shape, None, ax.dp_spec, None, None)
        return P(*([None] * len(shape)))
    return _map(leaf, cache_tree)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: dimension ``i`` over
    axis ``a`` is ``Shard(i)`` on ``a``'s mesh dimension; a tuple of
    axes shards dimension ``i`` on each, the first major (the layout JAX
    gives ``("pod", "data")``, as DTensor shards mesh dimensions left to
    right); every other mesh dimension is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dm = ctx.device_mesh(mesh)
    out: list = [Replicate()] * (dm.ndim if hasattr(dm, "ndim")
                                 else len(ctx.axis_sizes(mesh)))
    for i, ax in enumerate(spec):
        for n in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            out[ctx.mesh_dim(mesh, n)] = Shard(i)
    return tuple(out)


def to_named(tree_of_specs, mesh):
    """Each spec of the tree as its DTensor placements on ``mesh``."""
    return T.unflatten(tree_of_specs, [placements(s, mesh)
                                       for s in T.leaves(tree_of_specs)])


def distribute(tree, specs, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` by ``specs`` (a tree of
    :class:`P` of the same structure; non-tensor leaves pass through).
    Every rank holds the whole tensor and keeps its own shard of it: no
    data moves (``src_data_rank=None``). A 0-d tensor (the optimizer's
    host step counter) stays as it is."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def place(spec, x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        return distribute_tensor(x, ctx.device_mesh(mesh),
                                 placements(spec, mesh), src_data_rank=None)
    flat_specs = T.leaves(specs)
    flat = T.flatten(tree, upto=specs)[1]
    return T.unflatten(specs, [place(s, x) for s, x in zip(flat_specs,
                                                          flat)])
