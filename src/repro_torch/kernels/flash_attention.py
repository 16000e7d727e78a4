"""Flash attention for Hopper: the hand-written CUDA kernel and its
wrapper, the plain version, and decode attention in torch.

Replaces the TPU kernel ``_attn_kernel`` of
``repro/kernels/flash_attention.py`` (launched by ``flash_attention``
there). The kernel source is ``csrc/flash_attention.cu``; its header says
what bounds it on the H100 and what its design does about that. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, under a build directory that ``.gitignore``
lists, and called through ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from . import ref as _ref

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                     "flash_attention.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "built on a machine with the CUDA toolkit")
    return found


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` (once per source content) and
    return the shared library's path. What ptxas reports (registers,
    shared memory, spills) is kept beside it in ``<library>.log``."""
    with open(_CSRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libflash_attention_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _CSRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i,
                                                ctypes.c_float, i, i, p]
            lib.flash_attention_fwd.restype = i
            lib.flash_attention_error_string.argtypes = [i]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
    if q.dtype not in _DTYPES:
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
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KH,
        S, D, scale, int(causal), _DTYPES[q.dtype],
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
