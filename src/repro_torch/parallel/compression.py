"""Gradient compression for the DP all-reduce, with error feedback: the
port of :mod:`repro.parallel.compression` on the port's parameter trees
(:mod:`repro_torch.tree`).

At multi-pod scale the gradient all-reduce over the pod axis is the
bandwidth bottleneck; compressing that reduction is the standard trick.
Exact-shape-preserving:

  * bf16 compression — halves wire bytes, negligible quality loss;
  * int8 block compression — per-row absmax scale (4x fewer bytes), with
    **error feedback**: the quantization residual is carried into the
    next step's gradient so bias does not accumulate (Seide et al., 1-bit
    SGD lineage).

Usage in the train step:
    comp = Compressor("int8_ef")
    g_c, new_state = comp.compress(grads, state)      # before all-reduce
    grads = comp.decompress(g_c)                      # after
The wire-byte saving shows up in the roofline collective term. Plain
tensor code: the reference has no Pallas kernel here, and the port no
kernel of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as T

MODES = ("none", "bf16", "int8", "int8_ef")
# rows :func:`_q8` quantizes at once: at most this many elements (256 MiB
# for each f32 transient)
Q8_BLOCK_ELEMS = 2 ** 26


@dataclasses.dataclass(frozen=True)
class Compressor:
    mode: str = "none"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"compression mode {self.mode!r} (one of "
                             f"{MODES})")

    def init_state(self, grads):
        if self.mode != "int8_ef":
            return None
        return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)

    def compress(self, grads, state=None) -> Tuple[Any, Any]:
        if self.mode == "none":
            return grads, state
        if self.mode == "bf16":
            return T.tree_map(lambda g: g.to(torch.bfloat16), grads), state
        if self.mode == "int8":
            return T.tree_map(_q8, grads), state

        # int8 with error feedback
        def q_ef(g, e):
            corrected = g.float() + e
            q = _q8(corrected)
            return q, corrected - _dq8(q)
        flat_g = T.leaves(grads)
        flat_e = T.flatten(state, upto=grads)[1]
        pairs = [q_ef(g, e) for g, e in zip(flat_g, flat_e)]
        return (T.unflatten(grads, [p[0] for p in pairs]),
                T.unflatten(grads, [p[1] for p in pairs]))

    def decompress(self, comp):
        if self.mode == "none":
            return comp
        if self.mode == "bf16":
            return T.tree_map(lambda g: g.float(), comp)
        return _map_packed(_dq8, comp)

    def read(self, leaf, c: slice) -> torch.Tensor:
        """Chunk ``c`` (a slice of the leading axis) of one leaf that
        ``bf16`` or ``int8`` compressed, in f32: bitwise that chunk of its
        :meth:`decompress` (codes scale per last-axis row, which a chunk
        keeps whole)."""
        if self.mode == "bf16":
            return leaf[c].float()
        q = leaf["q"]
        scale = leaf["scale"].reshape(*q.shape[:-1], 1) if q.dim() > 1 \
            else leaf["scale"].reshape(1)
        return q[c].float() * scale[c]

    def wire_bytes(self, grads) -> int:
        """Bytes on the wire per all-reduce pass (for roofline
        accounting)."""
        def nbytes(g):
            n = g.numel()
            if self.mode == "none":
                return n * g.element_size()
            if self.mode == "bf16":
                return n * 2
            rows = n // g.shape[-1] if g.dim() else 1
            return n + 4 * rows          # int8 payload + f32 scales
        return sum(nbytes(g) for g in T.leaves(grads))


def _map_packed(fn, tree):
    """``fn`` over a compressed tree's packed leaves (the ``{"q",
    "scale", "shape"}`` dicts of :func:`_q8`), as ``jax.tree.map`` with
    ``is_leaf`` does in the reference."""
    if isinstance(tree, dict):
        if "q" in tree:
            return fn(tree)
        return {k: _map_packed(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_packed(fn, v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree)


def _q8(g) -> Dict[str, torch.Tensor]:
    """Per-row int8 codes: each row of ``g`` (the last axis; a 1-D leaf
    is one row) rounded half to even against its absmax / 127, a zero
    scale taken as 1, clipped to +-127. Rows go in blocks of at most
    ``Q8_BLOCK_ELEMS`` elements, so the f32 transients are one block's
    whatever the leaf (each row's codes depend on that row alone)."""
    flat = g.reshape(-1, g.shape[-1]) if g.dim() > 1 else g.reshape(1, -1)
    q = torch.empty(flat.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty((flat.shape[0], 1), dtype=torch.float32,
                        device=g.device)
    # a 0-d tensor divisor: a true division on every device (CUDA divides
    # by a Python number as a multiply by its reciprocal, an ulp off)
    d127 = torch.tensor(127.0, device=g.device)
    rows = max(1, Q8_BLOCK_ELEMS // max(flat.shape[1], 1))
    for r in range(0, flat.shape[0], rows):
        part = flat[r:r + rows].float()
        s = part.abs().amax(dim=-1, keepdim=True) / d127
        s = torch.where(s == 0, 1.0, s)
        scale[r:r + rows] = s
        q[r:r + rows] = torch.clamp(torch.round(part / s), -127, 127)
    return {"q": q.reshape(g.shape), "scale": scale,
            "shape": torch.zeros((g.dim(),), dtype=torch.int8,
                                 device=g.device)}   # static ndim tag


def _dq8(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    q = c["q"]
    flat = q.reshape(-1, q.shape[-1]) if q.dim() > 1 else q.reshape(1, -1)
    return (flat.float() * c["scale"]).reshape(q.shape)


def compressed_grads(comp: Compressor, grads):
    """The training step's gradient exchange on one process, as the JAX
    step (``src/repro/launch/train.py:54-82``) makes it before its update:
    ``(wire, read)``, the gradients as they cross the wire and
    ``read(leaf, c)``, chunk ``c`` (a leading-axis slice) of a wire leaf
    decompressed to f32, which :func:`repro_torch.optim.apply_updates`
    calls chunk by chunk: one chunk is in f32 at a time, not the tree.
    ``none`` gives the gradients as they are and ``read`` None (the update
    slices them). ``int8_ef`` compresses as ``int8``: the JAX step
    compresses against the zeros its jitted step captured and drops the
    state ``compress`` returns, and adding zeros changes no code, so
    ``int8_ef`` trains as ``int8`` does."""
    if comp.mode == "none":
        return grads, None
    codec = Compressor("int8") if comp.mode == "int8_ef" else comp
    return codec.compress(grads)[0], codec.read
