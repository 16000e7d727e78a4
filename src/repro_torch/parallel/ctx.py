"""Sharding context: lets model code place activation sharding constraints
without threading the mesh through every call. The port of
:mod:`repro.parallel.ctx`.

``activate(mesh)`` (context manager) is set by the caller that places
the parameters (the dry run, a sharded step); model code calls
``constrain(x, "dp", None, "tp")``-style hints, which are no-ops when no
mesh is active (the one-device paths) and on a plain tensor.

Axis aliases: "dp" expands to all data axes of the active mesh
(("pod", "data") on the multi-pod mesh), "tp" to the model axis. An axis
whose size does not divide the dimension is dropped (replicated), as the
reference drops it.

Where the reference calls ``with_sharding_constraint``, the port
redistributes a DTensor to the resolved placements
(:func:`repro_torch.parallel.sharding.placements`): a ``Partial`` sum
becomes a reduce-scatter or an all-reduce, a missing shard a local
slice, a shard that moves an all-gather, as GSPMD resolves the same
constraint.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

from torch.distributed.tensor import DTensor

_state = threading.local()


def active_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate(mesh):
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a mesh with
    ``axis_names`` and ``shape`` (a mapping, as a JAX mesh's: a
    :class:`repro_torch.launch.mesh.PodMesh`, a test's stand-in)."""
    if hasattr(mesh, "axis_names"):
        return {n: int(mesh.shape[n]) for n in mesh.axis_names}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def device_mesh(mesh):
    """The ``DeviceMesh`` DTensors live on: ``mesh`` itself, or a
    :class:`repro_torch.launch.mesh.PodMesh`'s."""
    return getattr(mesh, "device_mesh", mesh)


def mesh_dim(mesh, axis: str) -> int:
    """The device mesh dimension the mesh axis ``axis`` shards over."""
    if hasattr(mesh, "dim_of"):
        return mesh.dim_of(axis)
    return list(axis_sizes(mesh)).index(axis)


def _expand(mesh, axis):
    names = tuple(axis_sizes(mesh))
    if axis == "dp":
        dp = tuple(n for n in names if n in ("pod", "data"))
        return dp if len(dp) > 1 else (dp[0] if dp else None)
    if axis == "tp":
        return "model" if "model" in names else None
    return axis if axis in (None,) or axis in names else None


def _fits(mesh, dim: int, axis) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    size = 1
    for n in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[n]
    return dim % size == 0


def resolve(mesh, shape: Sequence[int], *axes) -> tuple:
    """The mesh axes ``constrain`` places each dimension of ``shape`` on:
    aliases expanded, an axis that does not divide its dimension
    dropped."""
    out = []
    for dim, ax in zip(shape, axes):
        ax = _expand(mesh, ax)
        out.append(ax if _fits(mesh, dim, ax) else None)
    return tuple(out)


def constrain(x, *axes):
    """``x`` redistributed to the resolved axes when a mesh is active and
    ``x`` is a DTensor; ``x`` itself otherwise."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from .sharding import P, placements
    target = placements(P(*resolve(mesh, x.shape, *axes)), mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def replicated(x, mesh):
    """A plain tensor that every rank holds whole (the same values) as a
    replicated DTensor on ``mesh``; a DTensor as it is."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = device_mesh(mesh)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def like(x, t):
    """``t`` (a plain tensor every rank computes alike, such as a table of
    positions) replicated on ``x``'s mesh where ``x`` is a DTensor; ``t``
    itself otherwise."""
    return replicated(t, x.device_mesh) if is_dtensor(x) else t


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def dp_size() -> int:
    mesh = active_mesh()
    if mesh is None:
        return 1
    out = 1
    for n, s in axis_sizes(mesh).items():
        if n in ("pod", "data"):
            out *= s
    return out


def tp_size() -> int:
    """The model axis's size under the active mesh (1 without one)."""
    mesh = active_mesh()
    return 1 if mesh is None else axis_sizes(mesh).get("model", 1)


__all__ = ["activate", "active_mesh", "axis_sizes", "constrain", "device_mesh",
           "mesh_dim",
           "dp_size", "is_dtensor", "like", "replicated", "resolve", "tp_size"]
