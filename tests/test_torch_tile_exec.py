"""The emitted Triton tile kernels, executed on the CPU.

A small numpy stand-in for the part of ``triton`` / ``triton.language``
that the emitter uses is installed in ``sys.modules``; the source that
``TritonKernel.render`` gives for a layout is then executed over the grid
of ``plan_tile_call``, one program instance after another, with the
arguments ``launch_tile_kernel`` passes on the card. Every masked-in
address must lie inside its tensor, and every output element must be
written exactly once. The results are compared with the kernel's plain
version (``torch_ref``) at the tile tolerances (f32 2e-5, bf16 3e-2), and
rotary also with the JAX package's Pallas op in interpret mode. This
checks the kernels' indexing (half tiles, cycle layouts, ragged edges,
the persistent block walk) without a card; the card checks the same
layouts in tests/test_torch_cuda.py.
"""
import dataclasses
import itertools
import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gelu_ref as jax_gelu_ref
from repro.kernels.tile_programs import get_tile_op as jax_tile_op
from repro_torch.core import (KernelProgram, SaturatorConfig, ScheduleConfig,
                              make_tile_op, rmax, rmean, rothalf, rsqrt,
                              rsum)
from repro_torch.core import tritongen
from repro_torch.core.tritongen import (CYCLE_BLOCK_R, CYCLE_NUM_WARPS,
                                        launch_tile_kernel, plan_tile_call,
                                        prepare_tile_call)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

PIPE = "triton_pipelined"
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
           "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
           "bias": 0.1, "norm": 3.0, "max_norm": 1.0}


# -- the stand-in -------------------------------------------------------------
def _round_bf16(x):
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class _Dtype:
    def __init__(self, name, cast):
        self.name, self.cast = name, cast

    def __repr__(self):
        return f"tl.{self.name}"


_F32 = _Dtype("float32", lambda x: np.asarray(x, dtype=np.float32))
_BF16 = _Dtype("bfloat16", _round_bf16)
_I32 = _Dtype("int32", lambda x: np.asarray(x, dtype=np.int32))
_I64 = _Dtype("int64", lambda x: np.asarray(x, dtype=np.int64))


def _tile(x):
    return np.asarray(x).view(_Tile)


class _Tile(np.ndarray):
    """A block value: a numpy array with Triton's ``.to``."""

    def to(self, dtype):
        if not isinstance(dtype, _Dtype):
            raise TypeError(f"to({dtype!r}): not a tl dtype")
        return _tile(dtype.cast(np.asarray(self)))

    # Triton's % truncates (C's fmod), where numpy's floors
    def __mod__(self, other):
        return _tile(np.fmod(np.asarray(self), np.asarray(other)))

    def __rmod__(self, other):
        return _tile(np.fmod(np.asarray(other), np.asarray(self)))


class _Ptr:
    """A tensor's flat buffer plus a block of element offsets."""

    def __init__(self, buf, element_ty, offs=0, writes=None):
        self.buf, self.offs = buf, offs
        self.dtype = types.SimpleNamespace(element_ty=element_ty)
        self.writes = writes if writes is not None \
            else np.zeros(buf.size, np.int64)

    def __add__(self, off):
        return _Ptr(self.buf, self.dtype.element_ty,
                    np.asarray(self.offs) + np.asarray(off), self.writes)

    __radd__ = __add__

    def _masked(self, mask):
        offs = np.asarray(self.offs)
        mask = np.ones(offs.shape, bool) if mask is None \
            else np.broadcast_to(np.asarray(mask, bool), offs.shape)
        live = offs[mask]
        if live.size and (live.min() < 0 or live.max() >= self.buf.size):
            raise IndexError(f"masked-in offsets {live.min()}..{live.max()} "
                             f"outside a buffer of {self.buf.size}")
        return offs, mask, live


class _Launch:
    grid = (1, 1, 1)
    pid = (0, 0, 0)


def _jit(fn=None, *, do_not_specialize=()):
    if fn is None:
        return lambda f: _Kernel(f, do_not_specialize)
    return _Kernel(fn, do_not_specialize)


class _Kernel:
    def __init__(self, fn, do_not_specialize):
        self.fn = fn
        self.do_not_specialize = list(do_not_specialize)
        self.writes = []

    def __getitem__(self, grid):
        grid = tuple(int(g) for g in grid) + (1,) * (3 - len(grid))

        def launch(*args, num_warps=4, num_stages=None, **consts):
            assert num_warps in (1, 2, 4, 8, 16, 32)
            ptrs, call = [], []
            for a in args:
                if isinstance(a, torch.Tensor):
                    ty = {torch.float32: _F32,
                          torch.bfloat16: _BF16}[a.dtype]
                    ptrs.append((a, _Ptr(a.detach().float().numpy()
                                         .reshape(-1).copy(), ty)))
                    call.append(ptrs[-1][1])
                else:
                    call.append(a)
            _Launch.grid = grid
            # masked-off lanes compute on fill values, as on the card
            with np.errstate(divide="ignore", over="ignore",
                             invalid="ignore"):
                for pid in itertools.product(*(range(g) for g in grid)):
                    _Launch.pid = pid
                    self.fn(*call, **consts)
            for t, p in ptrs:
                if p.writes.any():
                    t.copy_(torch.from_numpy(p.buf).view(t.shape))
            self.writes = [p.writes for _, p in ptrs]
        return launch


def _program_id(axis):
    # an int32 scalar, as Triton's (``.to(tl.int64)`` widens it)
    return _tile(np.asarray(_Launch.pid[axis], np.int32))


def _num_programs(axis):
    return _Launch.grid[axis]


def _arange(start, end):
    n = end - start
    if n <= 0 or n & (n - 1):
        raise ValueError(f"tl.arange({start}, {end}): a power of two only")
    return _tile(np.arange(start, end, dtype=np.int32))


def _range(start, end, step=1, num_stages=None):
    assert num_stages is None or int(num_stages) >= 1
    return (_tile(np.asarray(i, np.int32))
            for i in range(int(start), int(end), int(step)))


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == np.float64 else x


def _load(ptr, mask=None, other=None, eviction_policy=""):
    if eviction_policy not in ("", "evict_first", "evict_last"):
        raise ValueError(f"eviction_policy={eviction_policy!r}")
    if mask is None and other is not None:
        raise ValueError("tl.load: a fill value without a mask")
    offs, mask, live = ptr._masked(mask)
    out = np.full(offs.shape, 0.0 if other is None else other, np.float32)
    out[mask] = ptr.buf[live]
    return _tile(out)


def _store(ptr, value, mask=None):
    offs, mask, live = ptr._masked(mask)
    value = np.broadcast_to(np.asarray(value, np.float32), offs.shape)
    ptr.buf[live] = value[mask]
    np.add.at(ptr.writes, live, 1)


def _unary(f):
    return lambda x: _tile(_f32(f(np.asarray(x, np.float32))))


def _binary(f):
    return lambda x, y: _tile(_f32(f(x, y)))


def _standin_modules():
    tl = types.ModuleType("triton.language")
    fns = dict(
        constexpr=type("constexpr", (), {}), float32=_F32, int32=_I32,
        int64=_I64, program_id=_program_id, num_programs=_num_programs,
        cdiv=lambda a, b: -(-a // b), arange=_arange, range=_range,
        zeros=lambda shape, dtype: _tile(np.zeros(shape, np.float32)),
        full=lambda shape, value, dtype: _tile(
            np.full(shape, value, np.float32)),
        load=_load, store=_store,
        where=lambda c, x, y: _tile(_f32(np.where(c, x, y))),
        fma=lambda a, b, c: _tile(_f32(np.asarray(a) * b + c)),
        sum=lambda x, axis: _tile(np.sum(x, axis=axis, dtype=np.float32)),
        max=lambda x, axis: _tile(np.max(x, axis=axis)),
        minimum=_binary(np.minimum), maximum=_binary(np.maximum),
        exp=_unary(np.exp), log=_unary(np.log), sqrt=_unary(np.sqrt),
        rsqrt=_unary(lambda x: 1.0 / np.sqrt(x)), abs=_unary(np.abs),
        floor=_unary(np.floor),
        sigmoid=_unary(lambda x: 1.0 / (1.0 + np.exp(-x))))
    for k, v in fns.items():
        setattr(tl, k, v)

    def lacks(name):
        raise AttributeError(f"the triton stand-in lacks tl.{name}")
    tl.__getattr__ = lacks
    tl.extra = types.ModuleType("triton.language.extra")
    tl.extra.libdevice = types.SimpleNamespace(pow=_binary(np.power))
    triton = types.ModuleType("triton")
    triton.jit = _jit
    triton.language = tl
    return triton, tl


def _install_standin(monkeypatch):
    triton, tl = _standin_modules()
    monkeypatch.setitem(sys.modules, "triton", triton)
    monkeypatch.setitem(sys.modules, "triton.language", tl)
    monkeypatch.setitem(sys.modules, "triton.language.extra", tl.extra)


@pytest.fixture
def standin(monkeypatch):
    _install_standin(monkeypatch)


# -- running an emitted kernel ------------------------------------------------
def _run(tk, arrays, scalars, out_dtype=None, plan=None):
    """Execute ``tk``'s emitted source for these operands' layout, as
    ``_apply_tile_op`` launches it on the card (or under ``plan``, a
    variant of the call's). Returns the outputs and the plan."""
    call_plan, ins, outs = prepare_tile_call(tk, arrays, tk.name, out_dtype)
    plan = plan or call_plan
    ns = {}
    exec(compile(tk.render(*plan.layout), f"<{tk.kernel_name}>", "exec"), ns)
    kern = ns[tk.kernel_name]
    launch_tile_kernel(kern, plan, ins, outs,
                       [float(scalars[s]) for s in tk.scalars])
    n_in = len(ins)
    for w in kern.writes[:n_in]:
        assert not w.any(), "a kernel wrote to an input"
    for w in kern.writes[n_in:]:
        assert (w == 1).all(), \
            f"outputs written {w.min()}..{w.max()} times, not once"
    return (outs[0] if len(outs) == 1 else tuple(outs)), plan


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def _tile_inputs(name, rows, d, dtype, rng):
    prog = PROGRAMS[name]()
    xs = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        x = rng.normal(size=(d,) if a.shape == (1, 128) else (rows, d))
        xs.append(np.abs(x) * 0.01 if a.name == "v" else x)
    return ([torch.from_numpy(x.astype(np.float32)).to(dtype) for x in xs],
            {s: SCALARS[s] for s in prog.scalars})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_emitted_kernel_matches_plain(name, emitter, dtype, standin):
    """All 13 programs at a ragged (37, 200): rows and columns past a
    block edge, broadcast rows at column offsets only."""
    xs, sc = _tile_inputs(name, 37, 200, dtype, np.random.default_rng(0))
    op = get_tile_op(name, emitter=emitter)
    got, plan = _run(op.tk, xs, sc)
    # one program per block covers the rows, or (flat) the elements
    covered = plan.grid[0] * (plan.block_d if plan.flat else plan.block_r)
    assert covered >= (37 * 200 if plan.flat else 37) or emitter == PIPE
    _close(got, op.torch_ref(*(x.expand(xs[0].shape) for x in xs), **sc),
           TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pipelined_kernel_walks_several_blocks(name, dtype, standin,
                                               monkeypatch):
    """A persistent grid smaller than the block count (one program per
    SM against 135 blocks of a (4300, 200) view): programs walk more than
    one block each, and every block is computed once."""
    monkeypatch.setattr(tritongen, "PROGRAMS_PER_SM", 1)
    xs, sc = _tile_inputs(name, 4300, 200, dtype, np.random.default_rng(1))
    op = get_tile_op(name, emitter=PIPE)
    got, plan = _run(op.tk, xs, sc)
    assert plan.n_blocks > plan.grid[0]
    _close(got, op.torch_ref(*(x.expand(xs[0].shape) for x in xs), **sc),
           TOL[dtype])


def _rope(lead, pos_shape, dtype, seed):
    """q of shape ``lead`` in ``dtype`` and f32 cos/sin of ``pos_shape``
    (the path's dtypes), seeded."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=lead).astype(np.float32)).to(dtype)
    cos, sin = (torch.from_numpy(rng.normal(size=pos_shape)
                                 .astype(np.float32)) for _ in range(2))
    return q, cos, sin


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("d", [32, 96, 200])
@pytest.mark.parametrize("groups", [3, 33])
@pytest.mark.parametrize("period", [5, 510])
def test_rotary_cycle_layout(period, groups, d, emitter, standin):
    """Rotary's prefill layout: cos/sin of (1, 1, S, d) against q of
    (B, H, S, d), with S not a multiple of the position block (5, 510),
    over 3 or 33 (b, h) groups."""
    lead = (1, 3, period, d) if groups == 3 else (3, 11, period, d)
    q, cos, sin = _rope(lead, (1, 1, period, d), torch.float32, period + d)
    op = get_tile_op("rotary", emitter=emitter)
    got, plan = _run(op.tk, (q, cos, sin), {})
    assert plan.kinds == ("row", "cycle", "cycle")
    assert plan.n_pos == period and plan.num_warps == CYCLE_NUM_WARPS
    assert plan.block_r == min(CYCLE_BLOCK_R, 8 if period == 5 else 512)
    assert plan.grid == (groups, math.ceil(period / plan.block_r), 1)
    _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)),
           TOL[torch.float32])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("heads", [24, 8])
def test_rotary_path_dtypes(heads, emitter, standin):
    """bf16 q with f32 cos/sin, as the model calls it: the prefill at a
    ragged 510 positions, and the decode tick's broadcast cos/sin."""
    op = get_tile_op("rotary", emitter=emitter)
    for lead, pos, kinds in (((1, heads, 510, 128), (1, 1, 510, 128),
                              ("row", "cycle", "cycle")),
                             ((4, heads, 1, 128), (1, 1, 1, 128),
                              ("row", "bcast", "bcast"))):
        q, cos, sin = _rope(lead, pos, torch.bfloat16, heads)
        got, plan = _run(op.tk, (q, cos, sin), {})
        assert plan.kinds == kinds
        _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)),
               TOL[torch.bfloat16])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_rotary_head_dim_80(emitter, standin):
    """zamba2's head_dim 80 (the half tiles 40 wide in blocks of 64
    lanes): bf16 q with f32 cos/sin in its 510-token prefill and its
    decode tick, 32 heads."""
    op = get_tile_op("rotary", emitter=emitter)
    for lead, pos, kinds in (((1, 32, 510, 80), (1, 1, 510, 80),
                              ("row", "cycle", "cycle")),
                             ((4, 32, 1, 80), (1, 1, 1, 80),
                              ("row", "bcast", "bcast"))):
        q, cos, sin = _rope(lead, pos, torch.bfloat16, 80)
        got, plan = _run(op.tk, (q, cos, sin), {})
        assert plan.kinds == kinds and plan.block_d == 128
        _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)),
               TOL[torch.bfloat16])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("lead", [(32, 64, 16), (4, 1, 16), (3, 7, 16)])
def test_moe_router_width_16(lead, emitter, standin):
    """The router softmax at dbrx's 16 experts, f32 (G, TG, E) logits: its
    prefill (32 groups of 64 tokens), its decode tick (4 groups of one)
    and a ragged count of rows."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=lead).astype(np.float32) * 3)
    op = get_tile_op("moe_router", emitter=emitter)
    got, plan = _run(op.tk, (x,), {})
    assert plan.kinds == ("row",) and plan.block_d == 16
    _close(got, op.torch_ref(x), TOL[torch.float32])
    _close(got, torch.softmax(x, -1), TOL[torch.float32])


# the row reductions at the paths' shapes (dbrx's router, whisper's
# layernorm, minitron's and zamba2's rmsnorm, zamba2's gated norm; the
# d_model of granite, nemo, arctic and mistral-large, arctic's router in
# prefill and at a tick), and ragged rows and widths
REDUCTION_CASES = [
    ("moe_router", (32, 64, 16)), ("moe_router", (4, 1, 16)),
    ("moe_router", (2048, 128)), ("moe_router", (3, 7, 16)),
    ("moe_router", (32, 64, 128)), ("moe_router", (4, 1, 128)),
    ("layernorm", (2048, 768)), ("layernorm", (4, 768)),
    ("layernorm", (37, 200)), ("layernorm", (37, 768)),
    ("rmsnorm", (5, 3072)), ("rmsnorm", (5, 2560)),
    ("rmsnorm", (5, 4096)), ("rmsnorm", (5, 5120)), ("rmsnorm", (5, 7168)),
    ("rmsnorm", (3, 12288)), ("rmsnorm_gated", (5, 5120))]


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("name,lead", REDUCTION_CASES, ids=[
    f"{n}-{'x'.join(map(str, s))}" for n, s in REDUCTION_CASES])
def test_row_reductions_match_plain_and_pallas(name, lead, emitter,
                                               standin):
    """Each row reduction in the layout its plan picks by shape: column
    pieces of powers of two that cover the row exactly where d allows
    (768 = 512 + 256; 16 and 128 one piece), one masked block of
    next_pow2(d) at 200 and 7168; f32, against the plain version and the JAX
    package's Pallas op in interpret mode (rows flattened)."""
    d = lead[-1]
    rng = np.random.default_rng(math.prod(lead))
    prog = PROGRAMS[name]()
    xs = [rng.normal(size=(d,) if a.shape == (1, 128) else lead)
          .astype(np.float32) * (3.0 if name == "moe_router" else 1.0)
          for a in prog.arrays.values() if a.role != "out"]
    sc = {s: SCALARS[s] for s in prog.scalars}
    op = get_tile_op(name, emitter=emitter)
    got, plan = _run(op.tk, [torch.from_numpy(x) for x in xs], sc)
    if d in (200, 7168):  # 128 + 64 + 8, 4096 + 2048 + 1024: more pieces
        assert plan.pieces == () and plan.block_d == 1 << (d - 1).bit_length()
    else:
        assert sum(plan.pieces) == d and plan.block_d == d
        assert all(p & (p - 1) == 0 for p in plan.pieces)
        assert list(plan.pieces) == sorted(set(plan.pieces), reverse=True)
    assert plan.persistent == (emitter == PIPE and plan.n_blocks > (
        tritongen.PROGRAMS_PER_SM * tritongen.H100_SXM.sm_count))
    tol = TOL[torch.float32]
    _close(got, op.torch_ref(*(torch.from_numpy(x).expand(lead)
                               for x in xs), **sc), tol)
    want = jax_tile_op(name).apply(
        *(jnp.asarray(x.reshape(-1, d) if x.ndim > 1 else x) for x in xs),
        interpret=True, **sc)
    np.testing.assert_allclose(got.numpy().reshape(-1, d), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_rotary_mixed_periods(emitter, standin):
    """Two cycle operands of different periods: the plan's positions are
    their least common multiple."""
    q, _, _ = _rope((2, 2, 5, 32), (1,), torch.float32, 3)
    rng = np.random.default_rng(4)
    cos = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    sin = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    op = get_tile_op("rotary", emitter=emitter)
    got, plan = _run(op.tk, (q, cos, sin), {})
    assert plan.periods[1:] == (10, 5) and plan.n_pos == 10
    _close(got, op.torch_ref(q, cos.expand(q.shape), sin.expand(q.shape)),
           TOL[torch.float32])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_rotary_kernel_matches_pallas_interpret(emitter, dt, standin):
    """The emitted rotary kernel in its cycle layout against the JAX
    package's Pallas op in interpret mode (cos/sin in the lead's dtype:
    the Pallas body stores in it)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 3, 5, 32)).astype(np.float32)
    cos = rng.normal(size=(1, 1, 5, 32)).astype(np.float32)
    sin = rng.normal(size=(1, 1, 5, 32)).astype(np.float32)
    qj = jnp.asarray(q, jdt)
    want = jax_tile_op("rotary").apply(
        qj, jnp.broadcast_to(jnp.asarray(cos, jdt), qj.shape),
        jnp.broadcast_to(jnp.asarray(sin, jdt), qj.shape), interpret=True)
    got, plan = _run(get_tile_op("rotary", emitter=emitter).tk,
                     [torch.from_numpy(x).to(tdt) for x in (q, cos, sin)],
                     {})
    assert plan.kinds == ("row", "cycle", "cycle")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[tdt], rtol=TOL[tdt])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("S", [1, 63, 65])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_rotary_per_batch_tables(B, S, d, emitter, standin):
    """M-RoPE's per-batch cos/sin: one (S, d) table per batch row, passed
    as (B, 1, S, d) against q of (B, H, S, d), read in place (a cycle of
    period S offset by the batch row; a plain cycle at B 1), against the
    plain version and the JAX package's Pallas op in interpret mode on
    the tables broadcast to q's shape (f32). At B 1 the table is a plain
    cycle, or a broadcast row at S 1."""
    H = 3
    lead = (B, H, S, d)
    q, cos, sin = _rope(lead, (B, 1, S, d), torch.float32, 10 * B + S + d)
    op = get_tile_op("rotary", emitter=emitter)
    got, plan = _run(op.tk, (q, cos, sin), {})
    if B > 1:
        assert plan.kinds == ("row", "bcycle", "bcycle")
        assert plan.spans[1:] == (H * S, H * S)
    else:   # one table: a cycle, or one broadcast row at S 1
        assert plan.kinds[1:] == (("cycle",) * 2 if S > 1 else ("bcast",) * 2)
    if plan.kinds[1] != "bcast":
        assert plan.n_pos == S and plan.grid[0] == B * H
    _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)),
           TOL[torch.float32])
    want = jax_tile_op("rotary").apply(
        *(jnp.asarray(t.expand(lead).numpy()) for t in (q, cos, sin)),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_rotary_per_batch_path_dtypes(emitter, standin):
    """qwen2-vl's call: bf16 q and k (12 and 2 heads of 128) against f32
    per-batch cos/sin, a ragged 510 positions, 4 batch rows."""
    op = get_tile_op("rotary", emitter=emitter)
    for heads in (12, 2):
        lead = (4, heads, 510, 128)
        q, cos, sin = _rope(lead, (4, 1, 510, 128), torch.bfloat16, heads)
        got, plan = _run(op.tk, (q, cos, sin), {})
        assert plan.kinds == ("row", "bcycle", "bcycle")
        _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)),
               TOL[torch.bfloat16])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("name,d,dtype", [
    ("rmsnorm", 1536, torch.float32), ("swiglu", 8960, torch.bfloat16)],
    ids=["rmsnorm-1536-f32", "swiglu-8960-bf16"])
def test_qwen2vl_widths(name, d, dtype, emitter, standin):
    """qwen2-vl's rmsnorm (f32, as norm_apply runs it) and swiglu (bf16,
    d_ff 8960: a ragged last column block) at a few prefill rows."""
    xs, sc = _tile_inputs(name, 5, d, dtype, np.random.default_rng(d))
    op = get_tile_op(name, emitter=emitter)
    got, _ = _run(op.tk, xs, sc)
    _close(got, op.torch_ref(*(x.expand(xs[0].shape) for x in xs), **sc),
           TOL[dtype])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("shape", [(37, 200), (4, 3, 9, 32)])
def test_rothalf_with_reductions(shape, emitter, standin):
    """A program with both rothalf and the three reductions: each
    reduction combines the two half tiles of a row."""
    p = KernelProgram("rot_norm")
    x = p.array_in("x")
    g = p.array_in("g")
    p.array_out("o")
    eps = p.scalar("eps")
    xv = x.load()
    p.store("o", rothalf(xv) * rsqrt(rmean(xv * xv) + eps) * g.load()
            + rmax(xv) - rsum(xv))
    op = make_tile_op(p, SaturatorConfig(
        mode="accsat", cost_model="tpu_v5e", tpu_rules=True,
        schedule_cfg=ScheduleConfig(emitter=emitter)))
    assert op.tk.halves and op.tk.has_reduction
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in (shape, shape[-1:])]
    got, plan = _run(op.tk, xs, {"eps": 1e-6})
    assert plan.kinds == ("row", "bcast")
    _close(got, op.torch_ref(xs[0], xs[1].expand(shape), eps=1e-6),
           TOL[torch.float32])


def test_standin_refuses_what_triton_would(standin):
    """The stand-in raises where Triton would: an unknown name, a block
    that is not a power of two, a masked-in address outside its tensor
    (an unmasked access included)."""
    tl = sys.modules["triton.language"]
    with pytest.raises(AttributeError, match="stand-in lacks"):
        tl.flip
    with pytest.raises(ValueError, match="power of two"):
        tl.arange(0, 48)
    ptr = _Ptr(np.zeros(8, np.float32), _F32)
    with pytest.raises(IndexError):
        tl.load(ptr + np.arange(4) + 6, mask=np.ones(4, bool))
    with pytest.raises(IndexError):
        tl.store(ptr + np.arange(4) + 6, np.zeros(4))
    assert tl.load(ptr + np.arange(4) + 6,
                   mask=np.arange(4) + 6 < 8).shape == (4,)


# -- the flat plan ----------------------------------------------------------
# the programs with no reduction and no rothalf: every one takes the flat
# plan where its operands all have the lead's shape
FLAT = sorted(n for n in PROGRAMS if get_tile_op(n).tk.flat_ok)

def _f32_block(emitter):
    """An f32 block: FLAT_WARPS warps (FLAT_PIPELINED_WARPS pipelined) of
    32 threads, FLAT_VECTORS 16-byte vectors of 4 elements a thread."""
    warps = tritongen.FLAT_PIPELINED_WARPS if emitter == PIPE \
        else tritongen.FLAT_WARPS
    return warps * 32 * tritongen.FLAT_VECTORS * 4


def _flat_inputs(name, shape, dtype, seed):
    prog = PROGRAMS[name]()
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32)
          for a in prog.arrays.values() if a.role != "out"]
    xs = [np.abs(x) * 0.01 if a == "v" else x
          for a, x in zip(get_tile_op(name).tk.in_arrays, xs)]
    return ([torch.from_numpy(x).to(dtype) for x in xs],
            {s: SCALARS[s] for s in prog.scalars})


def test_flat_programs():
    assert FLAT == ["adamw", "gelu", "l2_clip", "residual_scale",
                    "sgd_momentum", "ssd_gate", "swiglu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("shape", [(1,), (1, 1023), (3, 344), (2, 3, 1000),
                                   (4, 1024)],
                         ids=["one", "short", "one_over", "ragged", "even"])
@pytest.mark.parametrize("name", FLAT)
def test_flat_plan_matches_plain(name, shape, emitter, dtype, standin):
    """Every elementwise program on the flat plan: one element, a block
    short of the first, a tail of 8 past it, a ragged tail after five
    blocks and a whole number of blocks (only a tail block is masked,
    and none where the block divides the elements). Every masked-in
    address lies inside its tensor and every output element is written
    once (``_run``)."""
    xs, sc = _flat_inputs(name, shape, dtype, math.prod(shape))
    op = get_tile_op(name, emitter=emitter)
    got, plan = _run(op.tk, xs, sc)
    n = math.prod(shape)
    block = _f32_block(emitter) * (2 if dtype == torch.bfloat16 else 1)
    assert plan.flat is not None and plan.block_d == block
    assert plan.flat.tail == (n % block != 0) and not plan.flat.off64
    assert plan.n_blocks == -(-n // block)
    src = op.tk.render(*plan.layout)
    assert ("mask=" in src) == plan.flat.tail and "_rows" not in src
    _close(got, op.torch_ref(*xs, **sc), TOL[dtype])


@pytest.mark.parametrize("name", ["adamw", "gelu", "swiglu"])
@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_flat_plan_persistent_walk_and_tail(name, emitter, standin,
                                            monkeypatch):
    """A persistent walk over more whole blocks than programs, then the
    tail by the last program: the pipelined kernel at one program per
    SM, and the sync kernel launched as such a walk (as
    tools/tile_time.py's variants launch it), over 133 blocks and 7
    elements."""
    monkeypatch.setattr(tritongen, "PROGRAMS_PER_SM", 1)
    shape = (7, (133 * _f32_block(emitter) + 7) // 7)
    xs, sc = _flat_inputs(name, shape, torch.float32, 3)
    op = get_tile_op(name, emitter=emitter)
    plan = tritongen.flat_plan(op.tk, *shape, 4)
    if emitter is None:
        assert not plan.persistent and plan.grid == (plan.n_blocks,)
        plan = dataclasses.replace(
            plan, grid=(tritongen.H100_SXM.sm_count,), persistent=True)
    assert plan.persistent and plan.flat.tail
    assert plan.grid == (tritongen.H100_SXM.sm_count,) < (plan.n_blocks,)
    got, _ = _run(op.tk, xs, sc, plan=plan)
    _close(got, op.torch_ref(*xs, **sc), TOL[torch.float32])


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_flat_int64_offsets(emitter, standin):
    """The int64-offset form, forced on a small operand with a tail,
    addresses the elements as the int32 form does."""
    xs, sc = _flat_inputs("adamw", (3, 1000), torch.float32, 7)
    op = get_tile_op("adamw", emitter=emitter)
    plan = prepare_tile_call(op.tk, xs, "adamw")[0]
    forced = dataclasses.replace(plan, flat=tritongen.FlatLayout(
        tail=True, off64=True))
    src = op.tk.render(*forced.layout)
    assert "_blk.to(tl.int64) * BLOCK" in src
    got, _ = _run(op.tk, xs, sc, plan=forced)
    _close(got, op.torch_ref(*xs, **sc), TOL[torch.float32])


def test_flat_offsets_are_int32_until_they_need_int64():
    """The plan alone, with no allocation: int32 offsets while every
    block's last offset is below 2^31 (minitron's embedding, 786 M
    elements; 2^31 - 1 elements padded to 2^31), int64 past it."""
    tk = get_tile_op("l2_clip").tk

    def flat(*shape, dtype=torch.float32):
        return plan_tile_call(tk, [shape], [dtype]).flat

    assert flat(256000, 3072) == tritongen.FlatLayout(False, False)
    assert not flat(2 ** 31 // 1024, 1024).off64        # 2^31 exactly
    assert flat(2 ** 31 - 1).tail and not flat(2 ** 31 - 1).off64
    assert not flat(2 ** 31 - 1, dtype=torch.bfloat16).off64
    assert flat(2 ** 31 // 1024 + 1, 1024).off64        # 2^31 + 1024
    assert flat(2 ** 31 + 1).off64 and flat(2 ** 31 + 1).tail
    src = tk.render(*plan_tile_call(tk, [(256000, 3072)],
                                    [torch.bfloat16], torch.float32).layout)
    assert ".to(tl.int64)" not in src and "mask=" not in src
    pipe = get_tile_op("l2_clip", emitter=PIPE).tk
    src = pipe.render(*plan_tile_call(pipe, [(2 ** 31 + 1,)],
                                      [torch.float32]).layout)
    assert "_blk.to(tl.int64) * BLOCK" in src
    assert "tl.arange(0, BLOCK).to(tl.int64)" in src


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (5, 1000), (3, 4, 96)])
def test_l2_clip_reads_its_dtype_and_writes_f32(shape, dtype, emitter,
                                                standin):
    """l2_clip of a bf16 or f32 gradient into f32: the kernel loads the
    gradient in its dtype and stores f32 (the block sized by the f32
    output), bitwise the plain version on ``g.float()``."""
    g = _flat_inputs("l2_clip", shape, dtype, 5)[0][0]
    sc = {"norm": 3.0, "max_norm": 1.0, "eps": 1e-9}
    op = get_tile_op("l2_clip", emitter=emitter)
    got, plan = _run(op.tk, [g], sc, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert plan.block_d == _f32_block(emitter)
    assert torch.equal(got, op.torch_ref(g.float(), **sc))
    assert torch.equal(got, op.apply(g, out_dtype=torch.float32, **sc))


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
def test_gelu_tanh_form_matches_gelu_ref(emitter, standin):
    """The emitted gelu (its tanh through tl.exp and "/") against the JAX
    package's gelu_ref over |x| <= 10, where 1 + tanh cancels in the
    negative tail: f32 within 2e-5, bf16 within 3e-2."""
    x = np.concatenate([np.linspace(-10, 10, 4001),
                        np.random.default_rng(6).normal(size=999) * 4])
    want = np.asarray(jax_gelu_ref(jnp.asarray(x, jnp.float32)))
    op = get_tile_op("gelu", emitter=emitter)
    got, _ = _run(op.tk, [torch.from_numpy(x.astype(np.float32))], {})
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    got, _ = _run(op.tk, [xb], {})
    want = np.asarray(jax_gelu_ref(jnp.asarray(xb.float().numpy())))
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


# -- bridged functions: mod and pow --------------------------------------------
BRIDGED = {
    "remainder": lambda a, b: torch.remainder(a, b),
    "remainder_const": lambda a, b: torch.remainder(a, 1.5) + b,
    "pow_int": lambda a, b: a ** 4 + b ** -2 + torch.pow(a, 5.0),
    "pow_libdevice": lambda a, b: a.abs() ** 0.5 + torch.pow(b.abs(), a),
    "mixed": lambda a, b: torch.where(a > b, torch.remainder(a, b),
                                      a ** 3) + b.abs() ** 1.5,
}


@pytest.mark.parametrize("name", sorted(BRIDGED))
def test_bridged_mod_and_pow_kernels(name, monkeypatch):
    """The Triton kernels of bridged functions with ``mod`` and ``pow``,
    on negative operands too: the floored remainder's sign correction
    over Triton's truncating ``%``, integer powers as multiplies, and
    libdevice's ``pow`` (imported by the kernel's module) for others,
    against the eager function and the plain version."""
    from repro_torch.core import saturate_torch_fn
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy((rng.normal(size=(37, 200)) * 3)
                             .astype(np.float32)) for _ in range(2))
    # staged before the stand-in is in place: tracing imports torch's
    # compiler stack, which inspects a triton module it finds
    bk = saturate_torch_fn(BRIDGED[name], (a, b), name=name)
    _install_standin(monkeypatch)
    src = bk.op.tk.render(*plan_tile_call(bk.op.tk, [a.shape] * 2,
                                          [a.dtype] * 2).layout)
    assert ("libdevice" in src) == (name in ("pow_libdevice", "mixed"))
    got, plan = _run(bk.op.tk, [a, b], {})
    assert plan.flat is not None
    want = BRIDGED[name](a, b)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got, bk.op.torch_ref(a, b), atol=2e-5,
                               rtol=2e-5)
