"""Worker of the port's multi-device tests (``tests/test_torch_multidev.py``):
spawns one gloo process group on the CPU and runs one job in it, rank 0
pickling the results. It imports no jax: the test process computes the
JAX package's side and hands the weights over as numpy.

  python tests/torch_multidev_worker.py sharded DATAxMODEL PORT IN OUT
  python tests/torch_multidev_worker.py pipeline STAGES PORT IN OUT

``sharded``: for each arch of IN (f32 smoke weights and batches), the
port's loss, gradients, one two-microbatch ``make_train_step`` update and
(where asked) a prefill and one decode tick with the cache they leave,
unsharded and on the mesh.
``pipeline``: ``pipeline_apply`` of the tanh stack of IN's weights.
"""
import copy
import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _full(t):
    from repro_torch.parallel import ctx
    return t.full_tensor() if ctx.is_dtensor(t) else t


def _arrays(tree):
    from repro_torch import tree as T
    return [_full(x).detach().float().numpy().copy()
            for x in T.leaves(tree) if isinstance(x, torch.Tensor)]


def _sharded_arch(arch, job, mesh):
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import get_model, params_from_reference
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel import (batch_specs, cache_specs, ctx,
                                      distribute, opt_state_specs,
                                      param_specs)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = get_model(cfg, device="cpu")
    params = params_from_reference(job["params"], cfg, "cpu")
    batch = S.batch_to_device(job["batch"], "cpu")
    out = {}
    out["loss0"], g0 = S.value_and_grad(model, params, batch)
    out["grads0"] = _arrays(g0)
    opt_cfg = OptConfig(lr=1e-5, warmup_steps=1)
    step = S.make_train_step(model, opt_cfg, accum_steps=2)
    p0 = copy.deepcopy(params)
    p0, o0, out["step_loss0"] = step(p0, init_opt_state(p0, opt_cfg), batch)
    out["update0"] = _arrays(p0)
    out["m0"], out["v0"] = _arrays(o0["m"]), _arrays(o0["v"])
    with ctx.activate(mesh):
        pspecs = param_specs(cfg, params, mesh, fsdp=True)
        dparams = distribute(params, pspecs, mesh)
        dbatch = distribute(batch, batch_specs(cfg, batch, mesh), mesh)
        loss, grads = S.value_and_grad(model, dparams, dbatch)
        out["loss"] = loss
        out["grads"] = _arrays(grads)
        out["grad_placements"] = [str(tuple(g.placements))
                                  for g in T.leaves(grads)]
        p1 = distribute(copy.deepcopy(params), pspecs, mesh)
        opt = init_opt_state(params, opt_cfg)
        opt = distribute(opt, opt_state_specs(cfg, opt, pspecs, mesh), mesh)
        p1, o1, out["step_loss"] = step(p1, opt, dbatch)
        out["update"] = _arrays(p1)
        out["m"], out["v"] = _arrays(o1["m"]), _arrays(o1["v"])
        if job.get("decode"):
            toks = batch["tokens"]
            with torch.no_grad():
                out["prefill0"], cache = model.prefill(params, toks[:, :-1])
                out["decode0"] = model.decode_step(params, cache,
                                                   toks[:, -1:])[0]
                out["cache0"] = _arrays(cache)
                logits, dcache = model.prefill(dparams,
                                               dbatch["tokens"][:, :-1])
                out["prefill"] = _full(logits)
                tok = distribute({"tokens": toks[:, -1:]}, batch_specs(
                    cfg, {"tokens": toks[:, -1:]}, mesh), mesh)["tokens"]
                out["decode"] = _full(model.decode_step(dparams, dcache,
                                                        tok)[0])
                out["cache"] = _arrays(dcache)
    out["loss0"], out["loss"] = float(out["loss0"]), float(out["loss"])
    out["step_loss0"] = float(out["step_loss0"])
    out["step_loss"] = float(out["step_loss"])
    return out


def _pipeline(job, mesh):
    from repro_torch.parallel.pipeline_pp import (make_stage_fn,
                                                  pipeline_apply,
                                                  split_layers_to_stages)
    ws = torch.from_numpy(job["ws"])
    x = torch.from_numpy(job["x"])
    n = mesh.size(0)
    stage_fn = make_stage_fn(lambda w, h: torch.tanh(h @ w))
    out = pipeline_apply(mesh, stage_fn, n, x.shape[0], x,
                         split_layers_to_stages(ws, n))
    return {"out": out.numpy()}


def _worker(rank, world, kind, shape, port, src, dst):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh, make_debug_mesh
        with open(src, "rb") as f:
            jobs = pickle.load(f)
        if kind == "pipeline":
            mesh = make_mesh(shape, ("stage",), "cpu")
            res = _pipeline(jobs, mesh)
        else:
            mesh = make_debug_mesh(*shape)
            res = {arch: _sharded_arch(arch, job, mesh)
                   for arch, job in jobs.items()}
        if rank == 0:
            with open(dst, "wb") as f:
                pickle.dump(res, f)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(argv):
    kind, shape, port, src, dst = argv
    shape = tuple(int(s) for s in shape.split("x"))
    world = int(np.prod(shape))
    mp.spawn(_worker, args=(world, kind, shape, int(port), src, dst),
             nprocs=world)


if __name__ == "__main__":
    main(sys.argv[1:])
