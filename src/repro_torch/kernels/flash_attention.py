"""Flash attention for Hopper: the hand-written CUDA kernel and its
wrapper, the plain version, and decode attention in torch.

Replaces the TPU kernel ``_attn_kernel`` of
``repro/kernels/flash_attention.py`` (launched by ``flash_attention``
there). The kernel source is ``csrc/flash_attention.cu``; its header says
what bounds it on the H100 and what its design does about that. It is
built by :mod:`repro_torch.kernels.cuda_build` at first use and called
through ``ctypes`` on PyTorch's current stream.

The wrapper picks the kernel by dtype before it launches: bf16 (the
model's path) runs on the bf16 tensor cores (``mma.sync``), f32 on the
CUDA cores, whose full f32 products hold the f32 tolerance that TF32
would miss. Neither is a fallback for the other: a launch that fails
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build
from . import ref as _ref

HEAD_DIMS = (16, 32, 64, 128)
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None):
    """The kernel's plain version: masked f32 softmax attention
    (:func:`repro_torch.kernels.ref.attention_ref`)."""
    return _ref.attention_ref(q, k, v, causal=causal, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q:(B,H,S,D) k/v:(B,KH,S,D) → (B,H,S,D); GQA when KH < H.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise. ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(t.shape)}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: dtype {q.dtype} (float32 or "
                        "bfloat16)")
    B, H, S, D = q.shape
    KH = k.shape[1]
    if tuple(k.shape) != (B, KH, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS or H % KH:
        raise ValueError(f"flash_attention: head_dim {D} (one of "
                         f"{HEAD_DIMS}) and {H} heads over {KH} kv heads")
    scale = (D ** -0.5) if scale is None else float(scale)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _load()
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KH,
        S, D, scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def decode_attention(q, k_cache, v_cache, *, scale: Optional[float] = None):
    """Single-token decode: q:(B,H,1,D) against k/v:(B,KH,S,D), in torch.
    GQA by grouped einsums (the repeated-KV materialization would dominate
    decode memory at long context)."""
    B, H, Q, D = q.shape
    KH = k_cache.shape[1]
    rep = H // KH
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, KH, rep, Q, D)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k_cache.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", probs.to(q.dtype), v_cache)
    return o.reshape(B, H, Q, D)
