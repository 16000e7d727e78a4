"""Quickstart for the PyTorch/CUDA port: saturate a kernel under the
paper's five configurations and inspect what each produces, then launch
rmsnorm's Triton kernel under each of them.

The twin of examples/quickstart.py. It runs on the GPU unless given
``--device cpu`` (there each tile op runs its plain version, the
saturated torch function, and no kernel is checked), and stops with an
error when there is no CUDA device and no device is named.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (MODES, KernelProgram, c, run_reference,
                              saturate_all_modes, v)
from repro_torch.kernels.tile_programs import get_tile_op
from repro_torch.models import resolve_device


def matmul_tile() -> KernelProgram:
    """Listing 1 of the paper: the matmul kernel under OpenACC."""
    p = KernelProgram("matmul_tile")
    a = p.array_in("a")
    b = p.array_in("b")
    cm = p.array_in("cmat")
    p.array_out("r")
    for s in ("alpha", "beta", "i", "j", "ax"):
        p.scalar(s)
    p.let("tmp", c(0.0))
    with p.for_("l", 0, v("ax")):
        p.let("tmp", v("tmp") + a[v("i"), v("l")] * b[v("l"), v("j")])
    p.store("r", v("alpha") * v("tmp") + v("beta") * cm[v("i"), v("j")],
            v("i"), v("j"))
    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. saturate Listing 1 under all five configurations ---------------
    p = matmul_tile()
    kernels = saturate_all_modes(p)
    print("mode       cost  ops  loads  fma   (paper Fig. 2 columns)")
    for mode, sk in kernels.items():
        st = sk.kernel.stats
        print(f"{mode:9s} {sk.extraction.dag_cost:6.0f} {st.n_ops:4d} "
              f"{st.n_loads:5d} {st.n_fma:4d}")

    # --- 2. the ACCSAT-generated torch code (temps + bulk load) ------------
    print("\n--- generated code (accsat) ---")
    print(kernels["accsat"].source)

    # --- 3. every mode against the reference interpreter -------------------
    # (a loop with indexed loads: it runs as generated torch source)
    rng = np.random.default_rng(0)
    A, B, C = (rng.normal(size=(4, 5)), rng.normal(size=(5, 6)),
               rng.normal(size=(4, 6)))
    ref = run_reference(p, dict(a=A, b=B, cmat=C, r=np.zeros((4, 6)),
                                alpha=1.5, beta=0.5, i=2, j=3, ax=5))
    for mode, sk in kernels.items():
        out = sk(*(torch.from_numpy(x) for x in (A, B, C)),
                 torch.zeros(4, 6, dtype=torch.float64), 1.5, 0.5, 2, 3, 5)
        assert np.allclose(np.asarray(out[0]), ref["r"]), mode
    print(f"all {len(kernels)} modes match the reference interpreter")

    # --- 4. rmsnorm's Triton kernel under each mode ----------------------
    gen = torch.Generator().manual_seed(0)
    x, g = torch.randn(256, 1024, generator=gen), torch.randn(1024,
                                                              generator=gen)
    on_gpu = device.type != "cpu"
    print(f"\nrmsnorm on {device} (256 x 1024 f32)" + (
        ", each mode's kernel against its plain version:" if on_gpu else
        ": the kernels need a GPU, each mode runs its plain version"))
    print("mode      tl.load  max |err|")
    for mode in MODES:
        op = get_tile_op("rmsnorm", mode=mode)
        got = op.apply(x.to(device), g.to(device), eps=1e-6).cpu()
        err = (got - op.torch_ref(x, g.expand(x.shape), eps=1e-6)).abs().max()
        assert err <= 2e-5 * (1 + got.abs().max()), (mode, err)
        print(f"{mode:9s} {op.source.count('tl.load('):7d}  "
              + (f"{err:.2e}" if on_gpu else "(plain)"))
    print(f"rmsnorm under all {len(MODES)} modes ran on {device}: "
          + ("each kernel within 2e-5 of its plain version" if on_gpu else
             "each mode's plain version"))


if __name__ == "__main__":
    main()
