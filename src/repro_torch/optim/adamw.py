"""AdamW with the saturator-generated fused update kernel.

The port of :mod:`repro.optim.adamw`. The per-parameter update is the
saturated ``adamw`` tile program, and global-norm clipping the saturated
``l2_clip`` program: on CUDA tensors every leaf's update launches the
generated ``adamw`` Triton kernel, and the clip the generated
``l2_clip`` kernel wherever the JAX package calls that op (neither runs
its plain version there); CPU tensors run their saturated torch code.
Moments are f32, bf16 or int8 (per-row absmax block quantization, as the
JAX package's, rounding half to even as ``jnp.round`` does); the
schedule is linear warmup + cosine decay.

Where the port differs from the JAX module:

* The JAX package casts a gradient to f32 and then clips it. The port's
  ``l2_clip`` kernel reads a bf16 gradient as it is, upcasts it in
  registers and writes f32: the same bits (the cast is exact), without
  the f32 copy that a separate cast writes and the kernel reads again.

* The update is in place: each parameter tensor receives its new value
  (``copy_``) and each moment's entry in ``state`` is replaced leaf by
  leaf, so the old moments are freed as the walk goes (a functional
  update would hold two copies of the moments at once).
* Scalars are host floats: one host read per step, of the global norm
  (``float(global_norm(...))``), feeds the step's clip scale to every
  kernel launch, with the learning rate and the bias corrections.
* The JAX package stacks each layer stack along a leading axis and
  decays (and clips through the op) every leaf with ``ndim >= 2``: each
  layer's norm gain, stacked to (L, d), is decayed, while the final norm
  (d,) is not. The port keeps one dict per layer, so the caller gives
  each leaf's ``ndim`` in the stacked layout (the model's
  :func:`repro_torch.models.common.reference_ndim`: every leaf under a
  layer stack counts one axis more). The same rule picks the leaves the
  ``l2_clip`` op clips. (The JAX package's ``lax.map`` over the leading
  axis of a stacked leaf above 2^31 elements bounds its transients to one
  layer's slice; the port's leaves are one layer each already.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import ops

@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "f32"       # f32 | bf16 | int8


# -- int8 block quantization ----------------------------------------------------
def _quant_i8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-last-axis absmax block quantization (shape-preserving)."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequant_i8(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return s["q"].float() * s["scale"]


def _moment_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _moment_init(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quant_i8(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
    return torch.zeros(p.shape, dtype=_moment_dtype(dtype), device=p.device)


def _moment_get(s, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequant_i8(s)
    return s.float()


def _moment_put(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quant_i8(x)
    return x.to(_moment_dtype(dtype))


# -- public API --------------------------------------------------------------------
def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """``{"step", "m", "v"}``; the step is a host int32 scalar tensor."""
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "m": T.tree_map(lambda p: _moment_init(p, cfg.moment_dtype), params),
        "v": T.tree_map(lambda p: _moment_init(p, cfg.moment_dtype), params),
    }


def lr_at(step: int, cfg: OptConfig) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    device scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in T.leaves(grads)))


def apply_updates(params, grads, state, cfg: OptConfig, *,
                  ndim: Callable[[tuple, torch.Tensor], int],
                  ) -> Tuple[Any, Dict[str, Any]]:
    """One fused AdamW step, in place: returns ``(params, state)``, the
    same trees, updated. ``ndim(path, p)`` is a leaf's ``ndim`` in the
    JAX package's layout; a leaf of two or more decays and clips through
    the ``l2_clip`` op."""
    step = int(state["step"]) + 1
    lr = lr_at(step, cfg)
    # the step's one host read: the clip scale of every leaf needs it
    norm = float(global_norm(grads))
    inv_bc1 = 1.0 / (1.0 - cfg.b1 ** step)
    inv_bc2 = 1.0 / (1.0 - cfg.b2 ** step)
    paths, flat_p = T.flatten(params)
    flat_g = T.flatten(grads, upto=params)[1]
    flat_m = T.flatten(state["m"], upto=params)[1]
    flat_v = T.flatten(state["v"], upto=params)[1]
    with torch.no_grad():
        for i, (path, p, g) in enumerate(zip(paths, flat_p, flat_g)):
            stacked_2d = ndim(path, p) >= 2
            g32 = _clip(g, norm, cfg.clip_norm, stacked_2d)
            m2, v2, p2 = ops.adamw_update(
                p.float(), g32, _moment_get(flat_m[i], cfg.moment_dtype),
                _moment_get(flat_v[i], cfg.moment_dtype), lr=lr, b1=cfg.b1,
                b2=cfg.b2, eps=cfg.eps,
                wd=cfg.weight_decay if stacked_2d else 0.0,
                inv_bc1=inv_bc1, inv_bc2=inv_bc2)
            del g32
            p.copy_(p2)
            # drop this leaf's old moments before the next leaf's update
            flat_m[i] = flat_v[i] = None
            T.set_at(state["m"], path, _moment_put(m2, cfg.moment_dtype))
            T.set_at(state["v"], path, _moment_put(v2, cfg.moment_dtype))
            del m2, v2, p2
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state


def _clip(g, norm: float, max_norm: float, use_op: bool):
    """``g`` in f32 scaled by min(1, c / (norm + eps)): the saturated
    ``l2_clip`` op where the JAX package calls it (a leaf of ``ndim >= 2``
    in its stacked layout), which reads a bf16 gradient as it is and
    writes f32 (on the card one kernel, no separate cast), a plain
    multiply of ``g.float()`` otherwise."""
    if use_op:
        return ops.l2_clip(g, norm=norm, max_norm=max_norm, eps=1e-9)
    return g.float() * min(1.0, max_norm / (norm + 1e-9))
