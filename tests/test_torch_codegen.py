"""The port's torch code generator on the looped, indexed kernels of
benchmarks/kernel_suite.py (for-loops, indexed loads and stores, gathers)
— paths the straight-line tile programs never take. Each kernel is built
with the port's DSL, saturated by the port's pipeline, and its generated
torch function is compared with the JAX package's generated function on
the same inputs, thread by thread."""
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core

sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
from benchmarks import kernel_suite as ks  # noqa: E402

# small deterministic search budgets (bt_like and lbm_like take tens of
# seconds at the defaults); the same on both sides
SEARCH = dict(beam_expansions=500, hillclimb_evals=2000)

# thread indices to run per kernel (inside each kernel's grid)
THREADS = {"bt_like": (0, 5, 31), "sp_like": (1, 7, 32),
           "cg_like": (0, 3), "ep_like": (0, 9, 31), "mg_like": (2, 11, 33),
           "lbm_like": (0, 17, 31), "ft_like": (0, 4, 31)}


def _port_program(name):
    """The suite's builder run against the port's DSL (its globals
    rebound from repro.core to repro_torch.core)."""
    fn = ks.SUITE[name]
    glb = dict(fn.__globals__)
    glb.update({n: getattr(port_core, n) for n in
                ("KernelProgram", "c", "exp", "log", "sqrt", "toint", "v")})
    return types.FunctionType(fn.__code__, glb, fn.__name__)()


@pytest.mark.parametrize("name", sorted(ks.SUITE))
def test_torchgen_matches_jax_codegen_on_suite(name):
    arrays, grid_var, _, extra = ks.inputs_for(name, n=32)
    sk = port_core.saturate_program(_port_program(name), port_core.SaturatorConfig(
        cost_model="tpu_v5e", search_cfg=port_core.SearchConfig(**SEARCH)))
    jsk = jax_core.saturate_program(ks.SUITE[name](), jax_core.SaturatorConfig(
        cost_model="tpu_v5e", search_cfg=jax_core.SearchConfig(**SEARCH)))
    assert isinstance(sk.ssa.prog, port_core.KernelProgram)
    assert sk.kernel.in_arrays == jsk.kernel.in_arrays
    assert sk.kernel.scalars == jsk.kernel.scalars
    for t in THREADS[name]:
        scal = dict(extra, **{grid_var: t})
        targs = [torch.from_numpy(arrays[a].astype(np.float32))
                 for a in sk.kernel.in_arrays]
        jargs = [jnp.asarray(arrays[a], jnp.float32)
                 for a in jsk.kernel.in_arrays]
        got = sk(*targs, *[scal[s] for s in sk.kernel.scalars])
        want = jsk(*jargs, *[scal[s] for s in jsk.kernel.scalars])
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=2e-5, rtol=2e-5,
                                       err_msg=f"{name} thread {t}")
