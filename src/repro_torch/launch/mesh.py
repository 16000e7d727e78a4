"""Production mesh construction: the port of :mod:`repro.launch.mesh`.

Single pod: 16×16 = 256 devices, axes (data, model).
Multi-pod:  2×16×16 = 512 devices, axes (pod, data, model) — the `pod`
axis carries only data parallelism (gradient all-reduce over the slower
links between pods), keeping all TP collectives inside a pod.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
current default process group (its first ``prod(shape)`` ranks), made
by a FUNCTION, not a module constant: importing this module touches no
process group. The dry run (:mod:`repro_torch.launch.dryrun`) makes a
``fake`` group of 256 or 512 ranks in one process to count the
production meshes, as the reference forces 512 host devices.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


class PodMesh:
    """A (pod, data, model) mesh: its axes as the sharding rules read
    them (``axis_names``, ``shape``), over a two-dimensional
    ``DeviceMesh`` (``device_mesh``: pod x data, model) that holds the
    DTensors. Every rule shards pod and data together, pod major (the
    reference's ``("pod", "data")``), which is one mesh dimension of
    pod x data ranks: DTensor then never shards one tensor dimension over
    two mesh dimensions, whose redistributions it plans by a search over
    every placement of the three (minutes a step to count)."""

    def __init__(self, device_mesh, shape: Sequence[int]):
        self.device_mesh = device_mesh
        self.axis_names = ("pod", "data", "model")
        self.shape = dict(zip(self.axis_names, shape))

    def dim_of(self, axis: str) -> int:
        """The device mesh dimension ``axis`` shards over."""
        return 1 if axis == "model" else 0


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None):
    """Tiny (data, model) mesh over the current group's ranks, for tests
    (gloo on the CPU) and the card's one-rank mesh."""
    return make_mesh((data, model), ("data", "model"), device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` with axis names ``axes`` over the first
    ``prod(shape)`` ranks of the default process group, on ``device_type``
    (default: cuda under NCCL, else cpu); (pod, data, model) gives a
    :class:`PodMesh`. Raises when the group is smaller than the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks, have {have}; run "
            f"under launch/dryrun.py (a fake process group of {need} "
            f"ranks) or in a process group of {need} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if tuple(axes) == ("pod", "data", "model"):
        pods, data, model = shape
        return PodMesh(DeviceMesh(
            device_type, torch.arange(need).reshape(pods * data, model),
            mesh_dim_names=("pod_data", "model")), shape)
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
