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

* The update is in place: each parameter tensor and each stored moment
  receives its new value (``copy_``) leaf by leaf (a functional update
  would hold two copies of the moments at once).
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
  ``l2_clip`` op clips.
* The JAX package maps the update over the leading axis of a stacked
  leaf of ``ndim >= 3`` above 2^31 elements (``lax.map``), bounding its
  f32 transients to one layer's slice. The port's leaves are one layer
  each, but one leaf can still be large: dbrx's expert stack (16, 6144,
  10752) holds 1.06 B elements, 4.2 GB for each of the ~7 f32 copies its
  update holds at once, and its embedding and unembedding 0.62 B each.
  So a leaf of ``ndim >= 2`` above ``SLICED_UPDATE_ELEMS`` elements is
  updated in chunks of its leading axis of at most that many elements
  (:func:`update_chunks`; any other leaf is one chunk): bitwise
  the whole leaf's update (it is elementwise, and int8 moments scale per
  last-axis row, which a chunk keeps whole), with one ``l2_clip`` and
  one ``adamw`` launch per chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import ops
from repro_torch.parallel import ctx

# leaves of ndim >= 2 above this many elements update in leading-axis
# chunks of at most this many: 256 MiB for each f32 temporary of a chunk
# (the plain update, generated SSA code, holds each of its ~40 at once)
SLICED_UPDATE_ELEMS = 2 ** 26


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
    device scalar). DTensor leaves (placed as their parameters, no
    ``Partial``) count each element once: the local sums of squares of
    leaves sharded on the same mesh dimensions are added, each such sum
    all-reduced over those dimensions only (a replicated dimension holds
    the same elements on every rank), and the sums added on every
    rank."""
    leaves = T.leaves(grads)
    if not any(ctx.is_dtensor(g) for g in leaves):
        return _norm(leaves)
    return torch.sqrt(_sharded_sumsq(leaves))


def _sharded_sumsq(leaves) -> torch.Tensor:
    """The global sum of squares of DTensor (and replicated plain)
    leaves: one all-reduce per set of sharded mesh dimensions."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    buckets: Dict[tuple, list] = {}
    mesh = None
    for g in leaves:
        key = None
        if ctx.is_dtensor(g):
            mesh = g.device_mesh
            key = tuple(p.is_shard() and mesh.size(i) > 1
                        for i, p in enumerate(g.placements))
            g = g.to_local()
        buckets.setdefault(key, []).append(g)
    total = None
    for key, part in buckets.items():
        part = sum(torch.sum(torch.square(g.float())) for g in part)
        if key is not None and any(key):
            part = DTensor.from_local(
                part, mesh, [Partial() if k else Replicate() for k in key],
                run_check=False).full_tensor()
        total = part if total is None else total + part
    return total


def _norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """:func:`global_norm` of the leaves an iterable yields, one at a
    time (a generator holds one leaf's transients at once)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def apply_updates(params, grads, state, cfg: OptConfig, *,
                  ndim: Callable[[tuple, torch.Tensor], int],
                  read: Optional[Callable[[Any, slice], torch.Tensor]]
                  = None) -> Tuple[Any, Dict[str, Any]]:
    """One fused AdamW step, in place: returns ``(params, state)``, the
    same trees, updated. ``ndim(path, p)`` is a leaf's ``ndim`` in the
    JAX package's layout; a leaf of two or more decays and clips through
    the ``l2_clip`` op. With ``read``, a leaf of ``grads`` is read
    through it, chunk ``c`` as ``read(leaf, c)`` in f32 (compressed
    gradients, :func:`repro_torch.parallel.compressed_grads`), the norm
    from whole leaves ``read(leaf, slice(None))`` one at a time."""
    step = int(state["step"]) + 1
    lr = lr_at(step, cfg)
    paths, flat_p = T.flatten(params)
    flat_g = T.flatten(grads, upto=params)[1]
    if any(ctx.is_dtensor(p) for p in flat_p):
        # every rank updates the shards it holds: each gradient placed as
        # its parameter (a Partial sum reduced), the moments placed so
        # by opt_state_specs; the norm counts each element once
        flat_g = [g.redistribute(p.device_mesh, p.placements)
                  if ctx.is_dtensor(g) and tuple(g.placements)
                  != tuple(p.placements) else g
                  for p, g in zip(flat_p, flat_g)]
    # the step's one host read: the clip scale of every leaf needs it
    if read is None:
        norm = float(global_norm(flat_g))
        read = _chunk
    else:
        norm = float(_norm(read(g, slice(None)) for g in flat_g))
    flat_p, flat_g = _locals(flat_p), _locals(flat_g)
    inv_bc1 = 1.0 / (1.0 - cfg.b1 ** step)
    inv_bc2 = 1.0 / (1.0 - cfg.b2 ** step)
    flat_m = _locals(T.flatten(state["m"], upto=params)[1])
    flat_v = _locals(T.flatten(state["v"], upto=params)[1])
    dtype = cfg.moment_dtype
    with torch.no_grad():
        for i, (path, p, g) in enumerate(zip(paths, flat_p, flat_g)):
            stacked_2d = ndim(path, p) >= 2
            for c in update_chunks(p):
                g32 = _clip(read(g, c), norm, cfg.clip_norm, stacked_2d)
                m2, v2, p2 = ops.adamw_update(
                    p[c].float(), g32,
                    _moment_get(_moment_at(flat_m[i], c), dtype),
                    _moment_get(_moment_at(flat_v[i], c), dtype),
                    lr=lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                    wd=cfg.weight_decay if stacked_2d else 0.0,
                    inv_bc1=inv_bc1, inv_bc2=inv_bc2)
                del g32
                p[c].copy_(p2)
                _moment_copy(flat_m[i], c, m2, dtype)
                _moment_copy(flat_v[i], c, v2, dtype)
                del m2, v2, p2
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state


def _locals(leaves) -> list:
    """Each leaf (a tensor, or an int8 moment's dict) as the tensors this
    rank holds: a DTensor's local shard (a view: updating it updates the
    DTensor), any other tensor as it is."""
    def loc(x):
        if isinstance(x, dict):
            return {k: loc(v) for k, v in x.items()}
        return x.to_local() if ctx.is_dtensor(x) else x
    return [loc(x) for x in leaves]


def _chunk(g: torch.Tensor, c: slice) -> torch.Tensor:
    return g[c]


def update_chunks(p: torch.Tensor) -> list:
    """The leading-axis slices ``apply_updates`` updates ``p`` by: the
    whole leaf, or for a leaf of ``ndim >= 2`` above
    ``SLICED_UPDATE_ELEMS`` elements chunks of at most that many (at
    least one leading index each)."""
    if p.ndim < 2 or p.numel() <= SLICED_UPDATE_ELEMS:
        return [slice(None)]
    rows = max(1, SLICED_UPDATE_ELEMS // (p.numel() // p.shape[0]))
    return [slice(j, j + rows) for j in range(0, p.shape[0], rows)]


def _moment_at(s, c: slice):
    """Chunk ``c`` of a stored moment's leading axis (an int8 moment's
    codes and per-row scales alike): a view."""
    if isinstance(s, dict):
        return {k: t[c] for k, t in s.items()}
    return s[c]


def _moment_copy(s, c: slice, x: torch.Tensor, dtype: str):
    """Write the f32 moment ``x`` into chunk ``c`` of the stored one in
    its dtype (int8: requantized per row)."""
    if dtype == "int8":
        for k, t in _quant_i8(x).items():
            s[k][c].copy_(t)
    else:
        s[c].copy_(x)


def _clip(g, norm: float, max_norm: float, use_op: bool):
    """``g`` in f32 scaled by min(1, c / (norm + eps)): the saturated
    ``l2_clip`` op where the JAX package calls it (a leaf of ``ndim >= 2``
    in its stacked layout), which reads a bf16 gradient as it is and
    writes f32 (on the card one kernel, no separate cast), a plain
    multiply of ``g.float()`` otherwise."""
    if use_op:
        return ops.l2_clip(g, norm=norm, max_norm=max_norm, eps=1e-9)
    return g.float() * min(1.0, max_norm / (norm + 1e-9))
