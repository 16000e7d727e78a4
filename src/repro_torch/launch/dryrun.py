"""Dry run: count every (arch × shape) cell's step without running it,
the port of :mod:`repro.launch.dryrun`.

For each cell this
  * builds the model's parameters, moments and batch on the ``meta``
    device (shapes and dtypes, no storage: nothing is allocated),
  * runs the right step (train step / prefill / serve step) on them
    under the op counter (:mod:`repro_torch.roofline.op_analysis`),
    which counts every aten op, each hand-written kernel by its own
    work, and the step's live bytes,
  * derives the memory use and the three-term roofline
    (:mod:`repro_torch.roofline`), writing JSON to
    ``experiments/dryrun_torch/`` (never to ``experiments/dryrun/``,
    the reference's).

A train step's microbatches are identical, so one is run and its counts
scaled by the accumulation count; the gradient buffers, the average and
the update are counted once.

Without a flag the mesh is one card (1 × 1), counted unsharded. The
production meshes (``--single-pod``: 16×16 (data, model);
``--multi-pod``: 2×16×16 (pod, data, model)) are counted per device: a
``fake`` process group of 256 or 512 ranks in this one process
(:func:`fake_group`, the counterpart of the reference's 512 forced host
devices) holds the mesh, the parameters, moments, batch and caches are
``meta`` DTensors placed by :mod:`repro_torch.parallel.sharding` with
the reference's policy (FSDP above 6e9 parameters in training, the
``param_specs`` default otherwise), and the counter counts rank 0's
local work: the ops DTensor runs on its shards, the collectives it
issues, and the live bytes of its local storages.

Usage (on the CPU; nothing is allocated):
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k \
      --single-pod            # or --multi-pod, or both
  python -m repro_torch.launch.dryrun --all [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, ARCHS, SHAPES, applicable, \
    get_config
from repro_torch.launch import steps as S
from repro_torch.models import get_model
from repro_torch.parallel import (batch_specs, cache_specs, ctx, distribute,
                                  opt_state_specs, param_specs)
from repro_torch.roofline.op_analysis import OpCounter, tensors_bytes
from repro_torch.roofline.report import model_flops_for, roofline_from_counts

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
ONE_CARD = (1, 1)
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def mesh_name(mesh: Sequence[int]) -> str:
    return "x".join(map(str, mesh))


def mesh_axes_of(mesh: Sequence[int]) -> tuple:
    """The axis names of a mesh shape: (pod, data, model) for three
    axes, (data, model) for two."""
    return ("pod", "data", "model")[-len(mesh):]


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks in this
    process (this one rank 0): collectives issue and return at once, so
    a mesh of any size can be built and counted on ``meta`` tensors.
    Raises if a default group exists already."""
    import torch.distributed as dist
    # the fake store and backend are torch's own test utility
    # (torch.testing._internal), the one way to hold a 512-rank group in
    # one process; importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the "
                           "dry run's fake group needs a process of its own")
    from torch.distributed.tensor import placement_types
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    # the group's mesh is a "cpu" one, on which DTensor moves a shard
    # from one dimension to another by an all-gather and a local chunk
    # (gloo has no all-to-all); the card's NCCL runs the all-to-all, so
    # that is what is issued (and counted) here
    fallback = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = fallback
        dist.destroy_process_group()


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


def count_train_step(model, params, opt_state, batch, opt_cfg, accum: int,
                     counter: OpCounter, accum_dtype=None):
    """The train step on ``meta`` under ``counter``: with ``accum`` > 1
    the gradient buffers (f32, or ``accum_dtype``, placed as the
    parameters), one microbatch counted ``accum`` times
    (:meth:`OpCounter.repeat`), the average and the update; else
    :func:`repro_torch.launch.steps.make_train_step`'s step. Returns the
    loss."""
    batch = S.batch_to_device(batch, model.device)
    if accum <= 1:
        return S.make_train_step(model, opt_cfg)(params, opt_state, batch)[2]
    update = S.make_update(model, opt_cfg)
    g = S.zero_grads(params, accum_dtype or torch.float32)
    micro = S.split_micro(batch, accum)[0]
    with counter.repeat(accum):
        loss = S.accumulate_grads(model, params, g, micro)
    grads = T.tree_map(lambda a: a.float() / accum, g)
    del g
    update(params, opt_state, grads)
    return loss


def run_cell(arch: str, shape_name: str,
             mesh: Sequence[int] = ONE_CARD, verbose: bool = True,
             overrides: Optional[dict] = None) -> dict:
    """Count one cell on ``mesh`` (data, model) with the reference's
    overrides (``seq_shard`` for train, an f8 KV cache for decode above
    100B parameters) and ``default_accum_steps``: :func:`count_cell`'s
    dict, or a ``skipped`` one where the cell is not applicable."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = tuple(mesh)
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "skipped", "reason": why}
    dp, tp = math.prod(mesh[:-1]), mesh[-1]
    if shape.kind == "train":
        # train cells shard the residual stream along S (Megatron SP)
        cfg = dataclasses.replace(cfg, seq_shard=True)
    if shape.kind == "decode" and cfg.param_count() > 100e9:
        # 100B+ decode carries a TB-scale global KV cache: store it f8
        cfg = dataclasses.replace(cfg, kv_cache_dtype="f8")
    accum = S.default_accum_steps(cfg, shape, dp=dp, tp=tp)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return count_cell(cfg, shape, accum=accum, arch=arch, mesh=mesh,
                      verbose=verbose)


def count_cell(cfg, shape, *, accum: int = 1, arch: Optional[str] = None,
               mesh: Sequence[int] = ONE_CARD, opt_cfg=None,
               verbose: bool = False) -> dict:
    """:func:`count_one` on ``mesh``: unsharded on one card, per device
    in a fake group of the mesh's ranks otherwise."""
    mesh = tuple(mesh)
    if mesh == ONE_CARD:
        return count_one(cfg, shape, accum=accum, arch=arch, opt_cfg=opt_cfg,
                         verbose=verbose)
    from repro_torch.launch.mesh import make_mesh
    with fake_group(math.prod(mesh)):
        dmesh = make_mesh(mesh, mesh_axes_of(mesh), "cpu")
        with ctx.activate(dmesh):
            return count_one(cfg, shape, accum=accum, arch=arch,
                             opt_cfg=opt_cfg, verbose=verbose, mesh=dmesh)


def count_one(cfg, shape, *, accum: int = 1, arch: Optional[str] = None,
              opt_cfg=None, verbose: bool = False, mesh=None) -> dict:
    """Count ``cfg``'s step at ``shape`` on ``meta`` (a train step with
    ``opt_cfg``, by default ``default_opt_config``, over ``accum``
    microbatches; a prefill; a decode step): the reference's dict, with
    ``memory_analysis`` (``argument_bytes``: parameters, moments, batch
    or cache; ``temp_bytes``: the peak of the storages the step made,
    its new outputs included; ``output_bytes`` and ``alias_bytes``, the
    outputs and those that are arguments updated in place) and
    ``roofline`` (``RooflineTerms.to_dict()``, ``fits_hbm`` against the
    card's 80 GB), and the counted kernels and heaviest ops."""
    t0 = time.time()
    arch = arch or cfg.name
    sizes = ctx.axis_sizes(mesh) if mesh is not None else {}
    shape_of_mesh = tuple(sizes.values()) or ONE_CARD
    name = mesh_name(shape_of_mesh)
    n_dev = math.prod(shape_of_mesh)
    model = get_model(cfg, device="meta")
    params = S.params_struct(model)
    groups = {}
    place = lambda tree, specs: tree  # noqa: E731
    if mesh is not None:
        dm = ctx.device_mesh(mesh)
        groups = {dm.get_group(i).group_name: dm.size(i)
                  for i in range(dm.ndim)}
        place = lambda tree, specs: distribute(tree, specs, mesh)  # noqa
        # the reference's FSDP policy: for training shard above 6e9
        # parameters; inference takes param_specs' default (30e9)
        fsdp = (cfg.param_count() > 6e9) if shape.kind == "train" else None
        pspecs = param_specs(cfg, params, mesh, fsdp=fsdp)
        meta_params, params = params, place(params, pspecs)
    counter = OpCounter(n_devices=n_dev, group_sizes=groups)
    if shape.kind == "train":
        opt_cfg = opt_cfg or S.default_opt_config(cfg)
        opt_state = S.opt_struct(params if mesh is None else meta_params,
                                 opt_cfg)
        batch = S.batch_spec_struct(cfg, shape)
        accum_dt = None
        if mesh is not None:
            opt_state = place(opt_state, opt_state_specs(
                cfg, opt_state, pspecs, mesh))
            batch = place(batch, batch_specs(cfg, batch, mesh))
            if cfg.param_count() > 100e9:
                accum_dt = torch.bfloat16
            del meta_params
        args = (params, opt_state, batch)
        with counter:
            out = count_train_step(model, params, opt_state, batch, opt_cfg,
                                   accum, counter, accum_dt)
    elif shape.kind == "prefill":
        batch = S.batch_spec_struct(cfg, shape)
        if mesh is not None:
            batch = place(batch, batch_specs(cfg, batch, mesh))
        args = (params, batch)
        with counter:
            out = S.make_prefill_step(model, cfg)(params, batch)
    else:  # decode
        cache, token = S.decode_input_struct(model, cfg, shape)
        if mesh is not None:
            cache = place(cache, cache_specs(cfg, cache, mesh))
            token = place({"tokens": token}, batch_specs(
                cfg, {"tokens": token}, mesh))["tokens"]
        args = (params, cache, token)
        with counter:
            out = S.make_serve_step(model)(params, cache, token)
    rep = counter.report
    arg_bytes = tensors_bytes(args)
    out_bytes = tensors_bytes(out)
    alias_bytes = out_bytes + arg_bytes - tensors_bytes((args, out))
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": rep.peak_live_bytes, "alias_bytes": alias_bytes}
    terms = roofline_from_counts(
        rep, arch=arch, shape=shape.name, mesh_name=name,
        n_devices=n_dev, model_flops_global=model_flops_for(cfg, shape),
        bytes_per_device=arg_bytes + rep.peak_live_bytes)
    result = {
        "arch": arch, "shape": shape.name, "mesh": name,
        "status": "ok", "compile_s": round(time.time() - t0, 1),
        "accum_steps": accum, "seq_shard": cfg.seq_shard,
        "memory_analysis": mem,
        "roofline": terms.to_dict(),
        "kernels": rep.kernels,
        "vector_ops": rep.vector_ops,
        "top_ops_by_bytes": rep.top_ops(8, "bytes"),
        "collectives": rep.top_collectives(12),
        "other_device_bytes": rep.other_device_bytes,
    }
    if verbose:
        per_dev_gb = terms.bytes_per_device / 1e9
        print(f"[{arch} × {shape.name} × {name}] counted in "
              f"{result['compile_s']}s (accum {accum})")
        print(f"  memory: args={mem['argument_bytes'] / 1e9:.2f}GB "
              f"temp={mem['temp_bytes'] / 1e9:.2f}GB "
              f"out={mem['output_bytes'] / 1e9:.2f}GB "
              f"alias={mem['alias_bytes'] / 1e9:.2f}GB "
              f"-> {per_dev_gb:.2f}GB/device "
              f"({'FITS' if terms.fits_hbm else 'OVER'} 80GB)")
        print(f"  roofline/device: compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"dominant={terms.dominant} "
              f"frac={terms.roofline_frac:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="count on the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="count on the 16x16 (data, model) mesh")
    ap.add_argument("--out", type=str, default=str(OUT_DIR))
    args = ap.parse_args(argv)
    meshes = [m for m, on in ((SINGLE_POD, args.single_pod),
                              (MULTI_POD, args.multi_pod)) if on] \
        or [ONE_CARD]

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else \
        [ARCH_IDS.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                tag = f"{arch}_{shape_name}_{mesh_name(mesh)}"
                path = out_dir / f"{tag}.json"
                if path.exists():
                    print(f"[{tag}] cached -> {path}")
                    continue
                try:
                    res = run_cell(arch, shape_name, mesh)
                except Exception as e:
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name(mesh), "status": "error",
                           "error": str(e)[-2000:]}
                    failures.append(tag)
                path.write_text(json.dumps(res, indent=1))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
