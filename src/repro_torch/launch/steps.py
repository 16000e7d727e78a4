"""Training's step functions: the port of :mod:`repro.launch.steps`.

``make_train_step`` (with gradient accumulation over microbatches),
``make_grad_step`` and ``default_opt_config``. The JAX module's abstract
``*_struct`` helpers (``ShapeDtypeStruct`` stand-ins for the dry run)
and ``default_accum_steps`` (which reads the dry run's ``ShapeSpec``)
wait for the dry run and the mesh (ROADMAP A14); its prefill and serve
steps wrap ``LM.prefill`` and ``LM.decode_step``, which the port's
server calls directly.

Gradients come from ``torch.autograd.grad`` on detached aliases of the
parameter leaves, functional as ``jax.value_and_grad``: the caller's
tensors gain no ``requires_grad`` and no ``.grad``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models import ModelConfig
from repro_torch.models.common import reference_ndim
from repro_torch.optim import OptConfig, apply_updates


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A pipeline batch (numpy or tensors) as tensors on ``device``:
    integer arrays (tokens, labels, positions) as int64, the rest f32."""
    out = {}
    for k, a in batch.items():
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        dt = torch.int64 if not t.dtype.is_floating_point else torch.float32
        out[k] = t.to(device=device, dtype=dt)
    return out


def value_and_grad(model, params, batch):
    """``(loss, grads)`` of ``model.loss`` at ``params``: a detached
    0-d loss and a tree of gradients shaped as ``params``."""
    flat = T.leaves(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = model.loss(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), T.unflatten(params, list(grads))


def _split_micro(batch, k: int) -> List[Dict[str, Any]]:
    """The batch as ``k`` microbatches along its batch axis (axis 1 of
    the vlm positions (3, B, S), axis 0 of the rest)."""
    def split(key, a):
        axis = 1 if key == "positions" else 0
        if a.shape[axis] % k:
            raise ValueError(f"batch {a.shape[axis]} not divisible by "
                             f"accum {k}")
        return a.chunk(k, dim=axis)
    parts = {key: split(key, a) for key, a in batch.items()}
    return [{key: p[i] for key, p in parts.items()} for i in range(k)]


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1):
    """Train step with optional gradient accumulation: the global batch
    is split into ``accum_steps`` microbatches run one after another, so
    saved activations scale with the microbatch. Their gradients are
    summed in f32 buffers, not in the parameters' dtype, then averaged.
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; the update is in place
    (:func:`repro_torch.optim.apply_updates`, decaying by the JAX
    package's stacked layout of ``model.cfg``)."""
    ndim = functools.partial(reference_ndim, model.cfg)

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        if accum_steps <= 1:
            loss, grads = value_and_grad(model, params, batch)
            params, opt_state = apply_updates(params, grads, opt_state,
                                              opt_cfg, ndim=ndim)
            return params, opt_state, loss
        g = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split_micro(batch, accum_steps):
            li, gi = value_and_grad(model, params, mb)
            for a, b in zip(T.leaves(g), T.leaves(gi)):
                a.add_(b.float())
            del gi
            loss_sum = loss_sum + li
        grads = T.tree_map(lambda a: a / accum_steps, g)
        del g
        params, opt_state = apply_updates(params, grads, opt_state, opt_cfg,
                                          ndim=ndim)
        return params, opt_state, loss_sum / accum_steps
    return train_step


def make_grad_step(model):
    """``grad_step(params, batch) -> (loss, grads)``: the value and
    gradient of ``model.loss``, with no update."""
    def grad_step(params, batch):
        return value_and_grad(model, params, batch_to_device(batch,
                                                             model.device))
    return grad_step


def default_opt_config(cfg: ModelConfig, total_steps: int = 10_000
                       ) -> OptConfig:
    """int8 Adam moments for >= 100B-parameter archs, f32 below."""
    moment = "int8" if cfg.param_count() > 100e9 else "f32"
    return OptConfig(moment_dtype=moment, total_steps=total_steps)
