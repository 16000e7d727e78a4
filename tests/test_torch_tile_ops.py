"""The port's saturated tile ops against the JAX package's.

For every program of ``PROGRAMS``, the port's torchgen function (the
kernel's plain version, the CPU path) is compared with ``repro``'s
saturated jnp function on the same seeded numpy inputs; rmsnorm, rotary
and swiglu are also compared with the Pallas op in interpret mode. The
generated Triton sources are checked for syntax and for the masked
reductions. Tolerances are those of tests/test_kernels.py."""
import ast

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tile_programs import get_tile_op as jax_tile_op
from repro_torch.core import KernelProgram, c, make_tile_op
from repro_torch.core.telemetry import reset_telemetry, telemetry
from repro_torch.core.tritongen import plan_tile_call
from repro_torch.kernels import ops
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=3e-2, rtol=3e-2)}
SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
           "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
           "bias": 0.1, "norm": 3.0, "max_norm": 1.0}


def _inputs(name, rows, d, rng):
    """Seeded numpy inputs of one program: row tiles, and a (d,) vector
    for operands the program declares as a broadcast row."""
    prog = PROGRAMS[name]()
    out = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        shape = (d,) if a.shape == (1, 128) else (rows, d)
        x = rng.normal(size=shape).astype(np.float32)
        if a.name == "v":      # adamw's second moment is non-negative
            x = np.abs(x) * 0.01
        out.append(x)
    return out, {s: SCALARS[s] for s in prog.scalars}


def _to_jax(x, dt):
    return jnp.asarray(x, DTYPES[dt][0])


def _to_torch(x, dt):
    return torch.from_numpy(x).to(DTYPES[dt][1])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _outs(r):
    return r if isinstance(r, (tuple, list)) else (r,)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_torchgen_matches_saturated_jax(name, dt):
    rng = np.random.default_rng(0)
    xs, sc = _inputs(name, 6, 96, rng)
    want = jax_tile_op(name).jax_ref(*[_to_jax(x, dt) for x in xs], **sc)
    got = get_tile_op(name).torch_ref(*[_to_torch(x, dt) for x in xs], **sc)
    for g, w in zip(_outs(got), _outs(want), strict=True):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["rmsnorm", "rmsnorm_gated", "swiglu"])
def test_path_ops_match_pallas_interpret(name, dt):
    rng = np.random.default_rng(1)
    xs, sc = _inputs(name, 12, 192, rng)
    want = jax_tile_op(name).apply(*[_to_jax(x, dt) for x in xs],
                                   interpret=True, **sc)
    got = get_tile_op(name).apply(*[_to_torch(x, dt) for x in xs], **sc)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rotary_matches_pallas_interpret(dt):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    cos = rng.normal(size=(1, 1, 4, 32)).astype(np.float32)
    sin = rng.normal(size=(1, 1, 4, 32)).astype(np.float32)
    # the Pallas body stores in the lead dtype, so it takes cos/sin in it
    qj = _to_jax(q, dt)
    want = jax_tile_op("rotary").apply(
        qj, jnp.broadcast_to(_to_jax(cos, dt), qj.shape),
        jnp.broadcast_to(_to_jax(sin, dt), qj.shape), interpret=True)
    got = ops.rotary(_to_torch(q, dt), _to_torch(cos, dt),
                     _to_torch(sin, dt))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_triton_source_parses(name):
    op = get_tile_op(name)
    assert op.tk is not None and op.sk.ladder_level == "cold"
    tree = ast.parse(op.tk.source)
    fn = tree.body[-1]
    assert isinstance(fn, ast.FunctionDef) and fn.name == f"{name}_kernel"
    assert ast.unparse(fn.decorator_list[0]).startswith(
        "triton.jit(do_not_specialize=['n_rows'")
    # bulk load: every load is issued before the first compute
    assert op.tk.stats.loads_before_compute == op.tk.stats.n_loads


def test_triton_masked_reductions_golden():
    rms = get_tile_op("rmsnorm").tk.source
    # the mean masks the padded lanes to 0 and divides by the true width
    assert "(tl.sum(tl.where(_mask, " in rms and "axis=1)[:, None] / D)" in rms
    soft = get_tile_op("softmax").tk.source
    assert 'tl.max(tl.where(_mask, ' in soft and 'float("-inf"))' in soft
    assert "tl.sum(tl.where(_mask, " in soft
    rot = get_tile_op("rotary").tk
    assert rot.rotated == ("q",)
    assert "_rcols = (_cols + D // 2) % D" in rot.source
    assert "_rsign * tl.load(q_ptr + q_roff" in rot.source
    assert "tl.fma(" in rot.source


def test_plan_tile_call_kinds():
    tk = get_tile_op("rotary").tk
    plan = plan_tile_call(tk, [(4, 24, 512, 128), (1, 1, 512, 128),
                               (1, 1, 512, 128)])
    assert plan.kinds == ("row", "cycle", "cycle")
    assert plan.periods == (4 * 24 * 512, 512, 512)
    assert plan.rows == 4 * 24 * 512 and plan.block_d == 128
    assert plan.block_r * plan.block_d <= 8192
    dec = plan_tile_call(tk, [(4, 24, 1, 128), (1, 1, 1, 128),
                              (1, 1, 1, 128)])
    assert dec.kinds == ("row", "bcast", "bcast")
    rms = plan_tile_call(get_tile_op("rmsnorm").tk, [(2048, 3072), (3072,)])
    assert rms.kinds == ("row", "bcast") and rms.block_d == 4096
    assert rms.grid == (2048 // rms.block_r, 1)
    # no reduction: swiglu also tiles columns
    sw = plan_tile_call(get_tile_op("swiglu").tk, [(2048, 9216)] * 2)
    assert sw.block_d == 1024 and sw.grid[1] == 9
    with pytest.raises(ValueError):
        plan_tile_call(tk, [(4, 6, 128), (5, 128), (5, 128)])


def test_emission_failure_degrades_and_keeps_cpu_path():
    """Ladder contract: a program the Triton emitter cannot take builds a
    degraded op (no kernel, degradation recorded) whose CPU path still
    runs the saturated torch function."""
    reset_telemetry()
    p = KernelProgram("mod_op")
    x = p.array_in("x")
    p.array_out("o")
    p.store("o", x.load() % c(3.0))
    op = make_tile_op(p)
    assert op.tk is None
    assert telemetry().snapshot()["guard"]["degradations"] == {"torch": 1}
    xs = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(op.apply(xs), xs % 3.0)
