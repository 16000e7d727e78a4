"""Step functions and abstract input specs shared by train, serve and
the dry run: the port of :mod:`repro.launch.steps`.

``make_train_step`` (with gradient accumulation over microbatches, and
the gradient exchange's compression), ``make_grad_step``,
``make_prefill_step``, ``make_serve_step`` and ``default_opt_config``;
for the dry run (:mod:`repro_torch.launch.dryrun`) ``default_accum_steps``
and the abstract inputs: the JAX package's ``ShapeDtypeStruct``
stand-ins are ``meta`` tensors here (``params_struct``, ``opt_struct``,
``batch_spec_struct``, ``decode_input_struct``), which hold shapes and
dtypes and no storage.

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
from repro_torch.configs import ShapeSpec
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.common import reference_ndim
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.parallel import Compressor, compressed_grads, ctx


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A pipeline batch (numpy or tensors) as tensors on ``device``:
    integer arrays (tokens, labels, positions) as int64, the rest f32;
    DTensors as they are."""
    out = {}
    for k, a in batch.items():
        if ctx.is_dtensor(a):             # placed by the caller
            out[k] = a
            continue
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        dt = torch.int64 if not t.dtype.is_floating_point else torch.float32
        out[k] = t.to(device=device, dtype=dt)
    return out


def value_and_grad(model, params, batch):
    """``(loss, grads)`` of ``model.loss`` at ``params``: a detached
    0-d loss and a tree of gradients shaped as ``params``. With DTensor
    parameters the loss comes back whole on every rank and each
    gradient as autograd leaves it (a ``Partial`` sum over the data axes
    where the parameter is replicated there)."""
    flat = T.leaves(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = model.loss(T.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    if ctx.is_dtensor(loss):
        loss = loss.full_tensor()
    return loss.detach(), T.unflatten(params, list(grads))


def split_micro(batch, k: int) -> List[Dict[str, Any]]:
    """The batch as ``k`` microbatches along its batch axis (axis 1 of
    the vlm positions (3, B, S), axis 0 of the rest)."""
    def split(key, a):
        axis = 1 if key == "positions" else 0
        if a.shape[axis] % k:
            raise ValueError(f"batch {a.shape[axis]} not divisible by "
                             f"accum {k}")
        if ctx.is_dtensor(a):
            return _split_placed(a, k, axis)
        return a.chunk(k, dim=axis)
    parts = {key: split(key, a) for key, a in batch.items()}
    return [{key: p[i] for key, p in parts.items()} for i in range(k)]


def _split_placed(a, k: int, axis: int):
    """A DTensor batch leaf as ``k`` microbatches of contiguous rows, as
    the one-device split (and the reference's) takes them: the leaf is
    gathered whole (a batch of token ids is small beside the step's
    activations), chunked, and each chunk placed as the leaf (a local
    slice)."""
    whole = a.full_tensor()
    return [ctx.replicated(part, a.device_mesh).redistribute(
        a.device_mesh, a.placements) for part in whole.chunk(k, dim=axis)]


def zero_grads(params, dtype=torch.float32):
    """The buffers microbatch gradients are summed in (f32 unless
    ``dtype``), shaped and placed as ``params``."""
    def zero(p):
        if ctx.is_dtensor(p):
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(
                torch.zeros(p.to_local().shape, dtype=dtype,
                            device=p.device), p.device_mesh, p.placements,
                run_check=False)
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    return T.tree_map(zero, params)


def accumulate_grads(model, params, g, mb) -> torch.Tensor:
    """One microbatch: its loss, its gradients added into the buffers
    ``g`` (in place), each first placed as its buffer (a ``Partial`` sum
    reduced to the buffer's shards: ``_pin`` of the reference's step)."""
    li, gi = value_and_grad(model, params, mb)
    for a, b in zip(T.leaves(g), T.leaves(gi)):
        a.add_(_placed_as(b, a).to(a.dtype))
    return li


def _placed_as(g, like):
    """``g`` redistributed to ``like``'s placements where both are
    DTensors and they differ; ``g`` otherwise."""
    if ctx.is_dtensor(g) and tuple(g.placements) != tuple(like.placements):
        return g.redistribute(like.device_mesh, like.placements)
    return g


def make_update(model, opt_cfg: OptConfig, compress: str = "none"):
    """``update(params, opt_state, grads) -> (params, opt_state)``: the
    step's gradient exchange (:func:`repro_torch.parallel.compressed_grads`:
    ``compress`` in {none, bf16, int8, int8_ef}, each leaf compressed, then
    decompressed to f32 as the update reads it, as the JAX step before its
    update), then the in-place AdamW update
    (:func:`repro_torch.optim.apply_updates`, decaying by the JAX
    package's stacked layout of ``model.cfg``)."""
    ndim = functools.partial(reference_ndim, model.cfg)
    comp = Compressor(compress)
    if compress != "none" and ctx.dp_size() > 1:
        raise NotImplementedError(
            f"compress={compress!r} under a mesh with {ctx.dp_size()} data "
            "ranks: the reference runs compression on one device only, and "
            "the port compresses unsharded gradients (ROADMAP A14.5)")

    def update(params, opt_state, grads):
        wire, read = compressed_grads(comp, grads)
        return apply_updates(params, wire, opt_state, opt_cfg, ndim=ndim,
                             read=read)
    return update


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1,
                    compress: str = "none"):
    """Train step with optional gradient accumulation: the global batch
    is split into ``accum_steps`` microbatches run one after another, so
    saved activations scale with the microbatch. Their gradients are
    summed in f32 buffers, not in the parameters' dtype, then averaged.
    With DTensor parameters each microbatch's gradients are pinned to
    the buffers' placements, the parameters' own, as the reference's
    ``_pin`` (:func:`accumulate_grads`). ``train_step(params, opt_state,
    batch) -> (params, opt_state, loss)``; the update
    (:func:`make_update`, with ``compress``) is in place
    (:func:`repro_torch.optim.apply_updates` reduces each gradient to its
    parameter's placements first)."""
    update = make_update(model, opt_cfg, compress)

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        if accum_steps <= 1:
            loss, grads = value_and_grad(model, params, batch)
            params, opt_state = update(params, opt_state, grads)
            return params, opt_state, loss
        g = zero_grads(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in split_micro(batch, accum_steps):
            loss_sum = loss_sum + accumulate_grads(model, params, g, mb)
        grads = T.tree_map(lambda a: a / accum_steps, g)
        del g
        params, opt_state = update(params, opt_state, grads)
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


def default_accum_steps(cfg: ModelConfig, shape: ShapeSpec,
                        dp: int = 16, tp: int = 1,
                        budget_bytes: float = 4e9) -> int:
    """Microbatch count so saved activations (≈ 8·L·tokens_dev·d bytes:
    bf16 carry + attention lse + mlp residual factor) fit the budget.
    With sequence-parallel residuals (seq_shard) the saved carry is
    already sharded tp-ways, so far fewer microbatches are needed —
    keeping FSDP re-gathers per step low."""
    if shape.kind != "train":
        return 1
    tokens_dev = shape.global_batch * shape.seq_len / dp
    layers = cfg.n_layers + cfg.n_enc_layers
    est = 8.0 * layers * tokens_dev * cfg.d_model
    if cfg.seq_shard:
        est /= tp
    k = 1
    max_k = max(shape.global_batch // dp, 1)
    while k < max_k and est / k > budget_bytes:
        k *= 2
    return min(k, max_k)


def make_prefill_step(model, cfg: ModelConfig):
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return model.prefill(params, batch["tokens"], batch["frames"])
    else:
        def prefill_step(params, batch):
            return model.prefill(params, batch["tokens"])
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, token):
        return model.decode_step(params, cache, token)
    return serve_step


def batch_spec_struct(cfg: ModelConfig, shape: ShapeSpec
                      ) -> Dict[str, torch.Tensor]:
    """Abstract train/prefill batch: ``meta`` stand-ins only (token ids
    int64, as the port's model takes them)."""
    B, S = shape.global_batch, shape.seq_len
    i64 = dict(dtype=torch.int64, device="meta")
    batch: Dict[str, Any] = {"tokens": torch.empty((B, S), **i64)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), **i64)
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.float32, device="meta")
    if cfg.family == "vlm":
        batch["positions"] = torch.empty((3, B, S), **i64)
    return batch


def decode_input_struct(model, cfg: ModelConfig, shape: ShapeSpec):
    """(cache, token) stand-ins for a decode step at full cache length
    (``model`` on ``meta``)."""
    B, S = shape.global_batch, shape.seq_len
    # the encdec cross-attention cache holds S positions, as the JAX
    # package's (its encoder output is as long as the decoder's cache)
    cache = model.init_cache(B, S, S) if cfg.family == "encdec" \
        else model.init_cache(B, S)
    token = torch.empty((B, 1), dtype=torch.int64, device="meta")
    return cache, token


def params_struct(model):
    """The model's parameters on ``meta``: shapes and dtypes of its init,
    no storage and no numbers."""
    return get_model(model.cfg, device="meta").init(0)


def opt_struct(params_sds, opt_cfg: OptConfig):
    return init_opt_state(params_sds, opt_cfg)
