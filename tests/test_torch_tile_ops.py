"""The port's saturated tile ops against the JAX package's.

For every program of ``PROGRAMS``, the port's torchgen function (the
kernel's plain version, the CPU path) is compared with ``repro``'s
saturated jnp function on the same seeded numpy inputs; rmsnorm, rotary
and swiglu are also compared with the Pallas op in interpret mode. The
generated Triton sources are checked for syntax and for the masked
reductions, rotary's half tiles and its cycle layout. Tolerances are
those of tests/test_kernels.py."""
import ast

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tile_programs import get_tile_op as jax_tile_op
from repro_torch.core import KernelProgram, c, make_tile_op, toint
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.telemetry import reset_telemetry, telemetry
from repro_torch.core.tritongen import (CYCLE_BLOCK_R, CYCLE_NUM_WARPS,
                                        FLAT_VECTORS, FLAT_WARPS,
                                        plan_tile_call)
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


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rotary_head_dim_80_matches_pallas_interpret(dt):
    """zamba2's head_dim 80: q (B, H, S, 80) against cos/sin of
    (1, 1, S, 80), as the shared attention block calls it."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 4, 6, 80)).astype(np.float32)
    cos = rng.normal(size=(1, 1, 6, 80)).astype(np.float32)
    sin = rng.normal(size=(1, 1, 6, 80)).astype(np.float32)
    qj = _to_jax(q, dt)
    want = jax_tile_op("rotary").apply(
        qj, jnp.broadcast_to(_to_jax(cos, dt), qj.shape),
        jnp.broadcast_to(_to_jax(sin, dt), qj.shape), interpret=True)
    got = ops.rotary(_to_torch(q, dt), _to_torch(cos, dt),
                     _to_torch(sin, dt))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("lead", [(32, 4, 16), (4, 1, 16)])
def test_moe_router_probs_match_pallas_interpret(lead):
    """The router softmax op on f32 (G, TG, E) logits at 16 experts
    against the Pallas op in interpret mode (rows flattened)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=lead) * 3).astype(np.float32)
    want = jax_tile_op("moe_router").apply(
        jnp.asarray(x.reshape(-1, lead[-1])), interpret=True)
    got = ops.moe_router_probs(torch.from_numpy(x))
    assert tuple(got.shape) == lead
    np.testing.assert_allclose(_np(got).reshape(-1, lead[-1]), _np(want),
                               **TOL["f32"])


@pytest.mark.parametrize("shape", [(6, 96), (3, 4, 32), (96,)])
def test_l2_clip_of_a_bf16_gradient_matches_jax_bitwise(shape):
    """``ops.l2_clip`` takes a bf16 gradient as it is and returns f32:
    bitwise the JAX package's saturated op on ``g.astype(f32)`` (its
    optimizer's cast, then the op), and the f32 path of the same values."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                         ).bfloat16()
    sc = {"norm": 3.0, "max_norm": 1.0, "eps": 1e-9}
    got = ops.l2_clip(g, **sc)
    assert got.dtype == torch.float32
    gj = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    want = jax_tile_op("l2_clip").jax_ref(gj.astype(jnp.float32), **sc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ops.l2_clip(g.float(), **sc))


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
    # half tiles: q is loaded once, as two contiguous halves, and
    # rothalf is a register negation — no second load, no modulo
    assert rot.halves and not get_tile_op("rmsnorm").tk.halves
    for src in (rot.source, rot.render(("row", "bcast", "bcast"))):
        assert src.count("tl.load(q_ptr") == 2
        assert "tl.load(q_ptr + q_off, " in src
        assert "tl.load(q_ptr + q_off + D // 2, " in src
        assert "_rcols" not in src and "% D" not in src
        assert "tl.arange(0, BLOCK_D // 2)" in src and "tl.fma(" in src
        assert src.count("tl.store(o_optr") == 2
    # the cycle layout: a program owns a block of positions of one
    # group; cos/sin are read at the position, each input in two half
    # loads, in one pass with no loop
    cyc = rot.render(("row", "cycle", "cycle"))
    for arr in ("cos", "sin", "q"):
        assert cyc.count(f"tl.load({arr}_ptr") == 2
    assert "_rows = tl.program_id(0) * n_pos + _pos" in cyc
    assert "cos_off = (_pos % cos_period) * D + _cols" in cyc
    assert "q_off = _rows * D + _cols" in cyc
    assert "for " not in cyc and "% D" not in cyc


def _plan(tk, shapes, dtype=torch.float32):
    """``plan_tile_call`` with every operand, and the output, in
    ``dtype``."""
    return plan_tile_call(tk, shapes, [dtype] * len(shapes))


def test_plan_tile_call_kinds():
    tk = get_tile_op("rotary").tk
    plan = _plan(tk, [(4, 24, 512, 128), (1, 1, 512, 128),
                               (1, 1, 512, 128)])
    assert plan.kinds == ("row", "cycle", "cycle")
    assert plan.periods == (4 * 24 * 512, 512, 512)
    assert plan.rows == 4 * 24 * 512 and plan.block_d == 128
    assert plan.block_r * plan.block_d <= 8192
    # one program per (group, block of positions)
    assert plan.n_pos == 512 and plan.block_r == CYCLE_BLOCK_R and \
        plan.num_warps == CYCLE_NUM_WARPS
    assert plan.grid == (96, 512 // CYCLE_BLOCK_R, 1)
    k510 = _plan(tk, [(4, 8, 510, 128), (1, 1, 510, 128),
                               (1, 1, 510, 128)])
    assert k510.n_pos == 510 and k510.grid == (32, -(-510 // CYCLE_BLOCK_R), 1)
    # positions past what the grid's second axis holds are refused
    with pytest.raises(ValueError, match="over the grid"):
        _plan(tk, [(2, 2 ** 21, 128), (2 ** 21, 128),
                            (2 ** 21, 128)])
    # row and broadcast layouts keep their plan
    dec = _plan(tk, [(4, 24, 1, 128), (1, 1, 1, 128),
                              (1, 1, 1, 128)])
    assert dec.kinds == ("row", "bcast", "bcast")
    assert (dec.block_r, dec.block_d, dec.grid, dec.num_warps, dec.n_pos) == \
        (64, 128, (2, 1), 8, 96)
    rms = _plan(get_tile_op("rmsnorm").tk, [(2048, 3072), (3072,)])
    assert rms.kinds == ("row", "bcast") and rms.block_d == 3072
    assert rms.pieces == (2048, 1024)
    assert rms.grid == (2048 // rms.block_r, 1)
    # no reduction, every operand the lead's shape: swiglu (bf16, as its
    # path launches it) takes the flat plan, one stream of 2048 * 9216
    # elements in blocks of FLAT_WARPS warps moving FLAT_VECTORS 16-byte
    # vectors of bf16 (8 elements) a thread
    sw = _plan(get_tile_op("swiglu").tk, [(2048, 9216)] * 2, torch.bfloat16)
    block = FLAT_WARPS * 32 * FLAT_VECTORS * 8
    assert sw.flat is not None and sw.block_d == block == 2048
    assert sw.n_blocks == 2048 * 9216 // block and not sw.flat.tail
    # f32 operands take half the elements a block
    sw32 = _plan(get_tile_op("swiglu").tk, [(2048, 9216)] * 2)
    assert sw32.block_d == block // 2
    # with a broadcast operand it tiles columns, as before the flat plan
    swb = _plan(get_tile_op("swiglu").tk, [(2048, 9216), (9216,)])
    assert swb.flat is None and swb.block_d == 1024 and swb.grid[1] == 9
    with pytest.raises(ValueError):
        _plan(tk, [(4, 6, 128), (5, 128), (5, 128)])
    with pytest.raises(ValueError, match="even width"):
        _plan(tk, [(4, 6, 127), (6, 127), (6, 127)])


def test_plan_tile_call_per_batch_tables():
    """M-RoPE's per-batch cos/sin (B, 1, S, d) against q (B, H, S, d): a
    cycle of period S offset by the batch row (span H·S), launched over
    positions as a cycle is, and read in place at
    ``(row // span) * S + position``."""
    tk = get_tile_op("rotary").tk
    plan = _plan(tk, [(4, 12, 512, 128), (4, 1, 512, 128),
                               (4, 1, 512, 128)])
    assert plan.kinds == ("row", "bcycle", "bcycle")
    assert plan.periods[1:] == (512, 512) and plan.spans == (0, 6144, 6144)
    assert plan.n_pos == 512 and plan.grid == (48, 512 // CYCLE_BLOCK_R, 1)
    # one table per batch row at one position (a prefill of one token)
    one = _plan(tk, [(3, 2, 1, 128), (3, 1, 1, 128),
                              (3, 1, 1, 128)])
    assert one.kinds[1:] == ("bcycle", "bcycle") and one.spans[1:] == (2, 2)
    src = tk.render(plan.kinds)
    assert ("cos_off = ((_rows // cos_span) * cos_period + _pos % "
            "cos_period) * D + _cols") in src
    assert "'cos_span', 'sin_span']" in src and "for " not in src
    # a table that varies over the heads but not the batch stays refused
    with pytest.raises(ValueError, match="does not tile"):
        _plan(tk, [(4, 12, 8, 128), (1, 12, 1, 128),
                            (1, 12, 1, 128)])


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_router_plan_covers_the_card(emitter):
    """dbrx's router logits (32, 64, 16): at least two programs per SM of
    the H100, each of one warp over whole rows of 16 (one piece, no
    masked lane), launched as the sync grid in both forms; the decode
    tick one row a program."""
    tk = get_tile_op("moe_router", emitter=emitter).tk
    plan = _plan(tk, [(32, 64, 16)])
    assert plan.grid[0] >= 2 * H100_SXM.sm_count and len(plan.grid) == 2
    assert plan.grid[0] * plan.block_r == 2048 and plan.num_warps == 1
    assert plan.pieces == (16,) and plan.block_d == 16
    assert not plan.persistent
    dec = _plan(tk, [(4, 1, 16)])
    assert (dec.block_r, dec.grid, dec.num_warps) == (1, (4, 1), 1)
    src = tk.render(*plan.layout)
    assert "tl.where" not in src and "_cmask" not in src
    assert "tl.arange(0, BLOCK_D)" not in src and "for " not in src


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_layernorm_pieces_cover_the_row(emitter):
    """whisper's layernorm at (2048, 768): pieces 512 + 256 that cover
    the row exactly, with no overlap; every operand loaded and the output
    stored once per piece, with no column mask on a row operand; the
    reductions sum both pieces' partial sums and divide by the true
    width."""
    tk = get_tile_op("layernorm", emitter=emitter).tk
    plan = _plan(tk, [(2048, 768), (768,), (768,)])
    assert plan.pieces == (512, 256) and plan.block_d == 768
    assert plan.grid[0] * plan.block_r >= 2048 or plan.persistent
    assert plan.n_blocks >= 2 * H100_SXM.sm_count
    src = tk.render(*plan.layout)
    assert "_cols_p0 = tl.arange(0, 512)[None, :]" in src
    assert "_cols_p1 = 512 + tl.arange(0, 256)[None, :]" in src
    assert "x_mask_p0 = _mask" in src and "x_mask_p1 = _mask" in src
    assert "_mask = _rows < n_rows" in src and "_cmask" not in src
    for arr in ("x", "g", "b"):
        assert src.count(f"tl.load({arr}_ptr") == 2
    assert src.count("tl.store(o_optr") == 2 and "tl.where" not in src
    assert ("((tl.sum(_v3_p0, axis=1)[:, None] + tl.sum(_v3_p1, "
            "axis=1)[:, None]) / D)") in src
    # the source without pieces (one masked block) stays what it was
    assert "(tl.sum(tl.where(_mask, _v3, 0.0), axis=1)[:, None] / D)" \
        in tk.source
    with pytest.raises(ValueError, match="column pieces"):
        get_tile_op("swiglu").tk.render(("row", "row"), (512, 256))


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_cycle_plans_unchanged(emitter):
    """Rotary's cycle (cos/sin by position) and bcycle (per batch row)
    plans: blocks of CYCLE_BLOCK_R positions at CYCLE_NUM_WARPS warps,
    one program per (group, block of positions), no pieces, no loop, in
    both forms."""
    tk = get_tile_op("rotary", emitter=emitter).tk
    for lead, tab, kinds in (
            ((4, 24, 512, 128), (1, 1, 512, 128), ("row", "cycle", "cycle")),
            ((4, 12, 512, 128), (4, 1, 512, 128),
             ("row", "bcycle", "bcycle"))):
        plan = _plan(tk, [lead, tab, tab])
        assert plan.kinds == kinds and plan.n_pos == 512
        assert (plan.block_r, plan.block_d, plan.num_warps) == \
            (CYCLE_BLOCK_R, 128, CYCLE_NUM_WARPS)
        assert plan.grid == (lead[0] * lead[1], 512 // CYCLE_BLOCK_R, 1)
        assert plan.pieces == () and not plan.persistent


def test_redesigned_programs_keep_their_terms():
    """The router softmax and layernorm compute what they computed before
    their kernels took column pieces: the same extracted term, op for op,
    in both emitters."""
    mixes = {"moe_router": {"exp": 1, "load": 1, "mul": 1, "recip": 1,
                            "rmax": 1, "rsum": 1, "sub": 1},
             "layernorm": {"add": 1, "fma": 1, "load": 3, "mul": 2,
                           "rmean": 2, "rsqrt": 1, "sub": 1}}
    for name, mix in mixes.items():
        for emitter in (None, "triton_pipelined"):
            op = get_tile_op(name, emitter=emitter)
            assert op.tk.stats.instruction_mix == mix
            assert op.sk.extraction.predicted["n_ops"] == sum(mix.values())


def test_emission_failure_degrades_and_keeps_cpu_path():
    """Ladder contract: a program the Triton emitter cannot take builds a
    degraded op (no kernel, degradation recorded) whose CPU path still
    runs the saturated torch function."""
    reset_telemetry()
    p = KernelProgram("toint_op")
    x = p.array_in("x")
    p.array_out("o")
    p.store("o", toint(x.load() * c(1.5)))
    op = make_tile_op(p)
    assert op.tk is None
    assert telemetry().snapshot()["guard"]["degradations"] == {"torch": 1}
    xs = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(op.apply(xs), (xs * 1.5).to(torch.int64))


# -- the ops residual_scale, softmax and ssd_gate ---------------------------------
def _three_ops(dt):
    """Seeded inputs of the three ops and both packages' calls: a
    non-default alpha and bias, and ssd_gate's a_log a (nh,) row
    against (B, S, nh)."""
    rng = np.random.default_rng(11)
    x, y = (rng.normal(size=(3, 40, 96)).astype(np.float32)
            for _ in range(2))
    s = (rng.normal(size=(2, 12, 72)) * 4).astype(np.float32)
    dt_raw = rng.normal(size=(2, 33, 24)).astype(np.float32)
    a_log = np.log(np.arange(1, 25, dtype=np.float32))
    return {
        "residual_scale": ((x, y), dict(alpha=0.375)),
        "residual_scale_default": ((x, y), {}),
        "softmax": ((s,), {}),
        "ssd_gate": ((dt_raw, a_log), dict(bias=0.25)),
        "ssd_gate_default": ((dt_raw, a_log), {}),
    }


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["residual_scale", "residual_scale_default",
                                  "softmax", "ssd_gate", "ssd_gate_default"])
def test_three_ops_match_jax_ops(case, dt):
    from repro.kernels import ops as jax_ops
    args, kw = _three_ops(dt)[case]
    op = case.replace("_default", "")
    want = getattr(jax_ops, op)(*[_to_jax(a, dt) for a in args], **kw)
    got = getattr(ops, op)(*[_to_torch(a, dt) for a in args], **kw)
    for g, w in zip(_outs(got), _outs(want), strict=True):
        assert g.dtype == DTYPES[dt][1]
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dt])


@pytest.mark.parametrize("impl", ["triton", "ref"])
@pytest.mark.parametrize("case", ["residual_scale", "softmax", "ssd_gate"])
def test_three_ops_gradients_match_jax(case, impl):
    """The ops' gradients: under ``triton`` the autograd Functions (the
    kernel forward, the analytic backward; on CPU tensors the forward is
    the plain version), under ``ref`` autograd of the oracle, against
    ``jax.vjp`` of the JAX op, with a random cotangent per output."""
    import jax
    from repro.kernels import ops as jax_ops
    args, kw = _three_ops("f32")[case]
    rng = np.random.default_rng(2)
    jargs = [jnp.asarray(a) for a in args]
    outs, vjp = jax.vjp(lambda *a: getattr(jax_ops, case)(*a, **kw), *jargs)
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in _outs(outs)]
    want = vjp(tuple(jnp.asarray(c_) for c_ in cot) if len(cot) > 1
               else jnp.asarray(cot[0]))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    ops.set_impl(impl)
    try:
        got = _outs(getattr(ops, case)(*targs, **kw))
    finally:
        ops.set_impl(None)
    torch.autograd.backward(list(got), [torch.from_numpy(c_) for c_ in cot])
    for t, w in zip(targs, want, strict=True):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_ssd_gate_reads_a_log_as_a_broadcast_row():
    """a_log (nh,) against dt_raw (B, S, nh) plans as a ``bcast``
    operand: the kernel reads the row in place, nothing is broadcast."""
    tk = get_tile_op("ssd_gate").tk
    plan = _plan(tk, [(2, 4096, 64), (64,)])
    assert plan.kinds == ("row", "bcast") and plan.d == 64
    assert plan.rows == 2 * 4096


def test_residual_scale_gradient_of_a_broadcast_row():
    """residual_scale's Function sums ``alpha dy`` to a broadcast ``y``'s
    shape, as autograd of the oracle does."""
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.normal(size=(5, 7, 16)).astype(np.float32))
    y0 = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(5, 7, 16)).astype(np.float32))
    grads = []
    for impl in ("triton", "ref"):
        x, y = x0.clone().requires_grad_(), y0.clone().requires_grad_()
        ops.set_impl(impl)
        try:
            out = ops.residual_scale(x, y, alpha=0.25)
        finally:
            ops.set_impl(None)
        out.backward(dy)
        grads.append((x.grad, y.grad))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
