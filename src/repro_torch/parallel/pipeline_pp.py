"""Pipeline parallelism (GPipe-style) over ``torch.distributed``
point-to-point sends: the port of :mod:`repro.parallel.pipeline_pp`.

The layer stack is split into S stages along a ``stage`` mesh axis;
microbatches stream through the stages with send/receive hand-offs. The
schedule is the classic GPipe fill-drain loop: T = M + S - 1 ticks, stage
s works on microbatch t - s at tick t, and an idle tick (t - s outside
[0, M)) runs no stage function and passes its buffer on. Every rank runs
the same loop (SPMD); at each tick every stage sends its output to the
next stage (the last to the first, a ring, as the reference's
``ppermute``) and receives its next input, in one batch of ``isend`` /
``irecv``. The last stage's outputs are broadcast to every rank.

Bubble fraction = (S-1)/(M+S-1) for M microbatches.

The reference's docstring names a ``--pp`` flag of ``launch/train.py``;
nothing there selects it, and the port adds none: the pipeline is a
library call, tested on gloo against the sequential stack.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree as T


def pipeline_apply(mesh, stage_fn: Callable, n_stages: int, n_micro: int,
                   x: torch.Tensor, stage_params: Any, *,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_s, micro_x) -> micro_y`` as a GPipe pipeline.

    x: (n_micro, micro_batch, ...) input microbatches (stage 0's copy is
    read); stage_params: a tree with a leading stage axis
    (:func:`split_layers_to_stages`), of which this rank takes its
    stage's slice, as the reference's ``P(axis)`` shards it. Returns
    (n_micro, micro_batch, ...) outputs (from the last stage, broadcast
    to all)."""
    import torch.distributed as dist
    if x.shape[0] != n_micro:
        raise ValueError(f"x holds {x.shape[0]} microbatches, not {n_micro}")
    names = list(mesh.mesh_dim_names)
    dim = names.index(axis)
    if mesh.size(dim) != n_stages:
        raise ValueError(f"mesh axis {axis!r} has {mesh.size(dim)} ranks "
                         f"for {n_stages} stages")
    group = mesh.get_group(dim)
    stage = mesh.get_local_rank(dim)
    S, M = n_stages, n_micro
    nxt = dist.get_global_rank(group, (stage + 1) % S)
    prv = dist.get_global_rank(group, (stage - 1) % S)
    params_s = T.tree_map(lambda a: a[stage], stage_params)
    buf = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for t in range(M + S - 1):                  # fill-drain ticks
        mb = t - stage
        if 0 <= mb < M:
            out = stage_fn(params_s, x[mb] if stage == 0 else buf)
        else:                                    # an idle tick
            out = buf
        if stage == S - 1 and 0 <= t - (S - 1) < M:
            outs[t - (S - 1)] = out
        # hand off to the next stage, receive from the previous one
        recv = torch.empty_like(buf)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
        for r in reqs:
            r.wait()
        buf = recv
    # broadcast the final outputs from the last stage to all stages
    dist.broadcast(outs, src=dist.get_global_rank(group, S - 1), group=group)
    return outs


def split_layers_to_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major."""
    def re(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages}")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return T.tree_map(re, stacked_params)


def make_stage_fn(layer_fn: Callable):
    """Wrap a single-layer fn into a stage fn looping over its layer
    slice (the leading axis of every leaf), as the port's ``LM`` loops
    its stacks."""
    def stage_fn(stage_params, x):
        n = T.leaves(stage_params)[0].shape[0]
        h = x
        for i in range(n):
            h = layer_fn(T.tree_map(lambda a: a[i], stage_params), h)
        return h
    return stage_fn
