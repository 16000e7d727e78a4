"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library at first use, under a
build directory that ``.gitignore`` lists, and loaded with ``ctypes``.
A library's file name carries a hash of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
builds anew and an unchanged one is reused. What ptxas
reports (registers, shared memory, spills) is kept beside the library in
``<library>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``), else the one on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _library_path(source: str, csrc: str = CSRC) -> str:
    """Where the library of ``<csrc>/<source>`` is built: its name hashes
    the source, the headers beside it and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(csrc, source)] + sorted(
            glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    digest = digest.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(*sources: str) -> List[str]:
    """Compile each ``csrc/<source>`` not built yet, all ``nvcc``
    processes running at once, and return the libraries' paths in the
    order given. Raises with the compiler's output if one fails."""
    outs = [_library_path(s) for s in sources]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src, out in zip(sources, outs):
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) for "
                          f"{os.path.basename(out)}:\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use (a
    build raced by another thread or process lands by atomic rename)."""
    return ctypes.CDLL(build(source)[0])
