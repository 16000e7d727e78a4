"""Bring-your-own-kernel on the PyTorch/CUDA port: three ways to use the
saturator.

1. The kernel DSL -> saturated torch function + Triton kernel for the
   GPU (bulk load).
2. The fx bridge: saturate an existing elementwise torch function.
3. Inspect the pipeline's phases directly.

The twin of examples/saturate_custom_kernel.py. It runs on the GPU
unless given ``--device cpu`` (there the ops run their plain versions),
and stops with an error when there is no CUDA device and no device is
named.

Run:  PYTHONPATH=src python examples/saturate_custom_kernel_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (KernelProgram, make_tile_op, rmean, rsqrt,
                              saturate_torch_fn, silu)
from repro_torch.models import resolve_device


def fused_norm_gate() -> KernelProgram:
    p = KernelProgram("fused_norm_gate")
    x = p.array_in("x")
    z = p.array_in("z")
    g = p.array_in("g")
    p.array_out("o")
    eps = p.scalar("eps")
    xg = x.load() * silu(z.load())
    p.store("o", xg * rsqrt(rmean(xg * xg) + eps) * g.load())
    return p


def my_fn(a, b):
    t = a * b + a * b          # redundant on purpose
    return t * torch.sigmoid(t) + a * b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. tile program -> Triton kernel ----------------------------------
    op = make_tile_op(fused_norm_gate())
    print("--- Triton kernel (bulk-loaded: every load before the compute) ---")
    print(op.source)
    gen = torch.Generator().manual_seed(0)
    X, Z = (torch.randn(8, 256, generator=gen) for _ in range(2))
    G = torch.randn(256, generator=gen)
    out = op.apply(X.to(device), Z.to(device), G.to(device), eps=1e-6)
    want = op.torch_ref(X, Z, G.expand(X.shape), eps=1e-6)
    assert torch.allclose(out.cpu(), want, atol=1e-5)
    ran = "kernel" if op.launches else "plain version"
    print(f"{ran} on {device} == saturated torch function "
          f"({op.launches} launch)")

    # --- 2. automatic bridging of an existing torch function ---------------
    Xd, Zd = X.to(device), Z.to(device)
    bk = saturate_torch_fn(my_fn, (Xd, Zd), name="my_fn")
    print(f"\nfx bridge: {bk.n_eqns} aten ops -> "
          f"{bk.sk.kernel.stats.n_ops} ops (CSE found the shared a*b)")
    assert torch.allclose(bk(Xd, Zd), my_fn(Xd, Zd), atol=1e-5)
    print("bridged function matches the original")

    # --- 3. phase-by-phase inspection --------------------------------------
    print(f"\npipeline report: {bk.sk.report()}")


if __name__ == "__main__":
    main()
