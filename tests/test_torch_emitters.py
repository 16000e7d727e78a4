"""The port's pipelined tile emitter (``"triton_pipelined"``): the
persistent, software-pipelined form of each generated Triton kernel,
checked on the CPU for its source, its schedule, its plain version and
its launch plan. The card checks its results (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ast
import re

import numpy as np
import pytest
import torch

from repro_torch.core import EMITTER_NAMES, SaturatorConfig, ScheduleConfig
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tritongen import (NUM_STAGES, PROGRAMS_PER_SM,
                                        TILE_ELEMS_BUDGET, plan_tile_call)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
           "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
           "bias": 0.1, "norm": 3.0, "max_norm": 1.0}


def _renumbered(body):
    """The body with its temporaries renamed in order of definition, so
    two emissions compare by statement order, not by temp numbering (a
    half-tile temporary's two halves, ``_vN_lo``/``_vN_hi``, are one)."""
    names = {}
    for ln in body:
        m = re.match(r"\s*(_v\d+)(?:_lo|_hi)? = ", ln)
        if m:
            names.setdefault(m.group(1), f"_t{len(names)}")
    return [re.sub(r"_v\d+", lambda m: names[m.group(0)], ln) for ln in body]


def test_config_accepts_the_pipelined_emitter():
    assert "triton_pipelined" in EMITTER_NAMES
    cfg = SaturatorConfig(
        schedule_cfg=ScheduleConfig(emitter="triton_pipelined"))
    assert cfg.emitter == "triton_pipelined"
    with pytest.raises(ValueError, match="emitter must be one of"):
        SaturatorConfig(schedule_cfg=ScheduleConfig(emitter="pallas"))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pipelined_source_and_schedule(name):
    op = get_tile_op(name, emitter="triton_pipelined")
    tk = op.tk
    assert tk is not None and tk.pipelined and op.sk.ladder_level == "cold"
    tree = ast.parse(tk.source)
    fn = tree.body[-1]
    assert isinstance(fn, ast.FunctionDef) and fn.name == f"{name}_kernel"
    # a persistent loop over the blocks, pipelined NUM_STAGES deep
    loops = [n for n in fn.body if isinstance(n, ast.For)]
    assert len(loops) == 1
    assert ast.unparse(loops[0].iter) == (
        "tl.range(tl.program_id(0), _n_blocks, tl.num_programs(0), "
        f"num_stages={NUM_STAGES})")
    assert NUM_STAGES == 2
    # the loop body is the sync twin's body, emitted under the same
    # explicit schedule, and in the shipped sync kernel's statement order
    assert tk.schedule is not None and tk.twin.schedule is tk.schedule
    assert not tk.twin.pipelined
    assert tk.body == tk.twin.body
    assert _renumbered(tk.body) == _renumbered(get_tile_op(name).tk.body)
    assert tk.stats.loads_before_compute == tk.stats.n_loads
    compile(tk.twin.source, "<twin>", "exec")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pipelined_plain_version_is_the_sync_ops(name):
    rng = np.random.default_rng(0)
    prog = PROGRAMS[name]()
    xs = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        shape = (40,) if a.shape == (1, 128) else (9, 40)
        x = rng.normal(size=shape).astype(np.float32)
        xs.append(torch.from_numpy(np.abs(x) * 0.01 if a.name == "v" else x))
    sc = {s: SCALARS[s] for s in prog.scalars}
    got = get_tile_op(name, emitter="triton_pipelined").apply(*xs, **sc)
    want = get_tile_op(name).torch_ref(*xs, **sc)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def _plan(tk, shapes, dtype=torch.float32):
    """``plan_tile_call`` with every operand, and the output, in
    ``dtype``."""
    return plan_tile_call(tk, shapes, [dtype] * len(shapes))


def test_pipelined_plan_is_persistent():
    cap = PROGRAMS_PER_SM * H100_SXM.sm_count
    rms = get_tile_op("rmsnorm", emitter="triton_pipelined").tk
    big = _plan(rms, [(2048, 3072), (3072,)])
    sync = _plan(get_tile_op("rmsnorm").tk, [(2048, 3072), (3072,)])
    assert sync.n_blocks == sync.grid[0] * sync.grid[1]
    assert not sync.persistent
    # a persistent walk's row blocks take the register budget, the sync
    # kernel's the smaller REDUCE_TILE_ELEMS
    assert big.block_d == sync.block_d and big.block_r >= sync.block_r
    assert big.block_r * big.block_d <= TILE_ELEMS_BUDGET
    assert big.persistent and big.n_blocks == 2048 // big.block_r
    assert big.grid == (min(big.n_blocks, cap),) and big.n_blocks > cap
    # blocks that fit in the persistent grid: the sync launch, no loop
    small = _plan(rms, [(37, 200), (200,)])
    assert not small.persistent and small.grid == (small.n_blocks, 1)
    fn = ast.parse(rms.render(*small.layout)).body[-1]
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.For)]
    # no reduction: the flat plan's blocks of the element stream are
    # walked, the tail (none here) by the last program after its walk
    sw = _plan(get_tile_op("swiglu", emitter="triton_pipelined").tk,
               [(2048, 9216)] * 2, torch.bfloat16)
    assert sw.flat is not None and sw.persistent
    assert sw.n_blocks == 2048 * 9216 // sw.block_d and sw.grid == (cap,)
    src = get_tile_op("swiglu", emitter="triton_pipelined").tk.render(
        *sw.layout)
    assert (f"for _blk in tl.range(tl.program_id(0), n_elems // BLOCK, "
            f"tl.num_programs(0), num_stages={NUM_STAGES}):") in src


def test_pipelined_cycle_layout_is_the_sync_launch():
    """A cycle layout's pipelined form launches the sync kernel's grid,
    one program per (group, block of positions), with no block loop."""
    tk = get_tile_op("rotary", emitter="triton_pipelined").tk
    shapes = [(4, 24, 512, 128), (1, 1, 512, 128), (1, 1, 512, 128)]
    plan = _plan(tk, shapes)
    assert plan == _plan(get_tile_op("rotary").tk, shapes)
    assert plan.grid == (96, 512 // plan.block_r, 1)
    src = tk.render(plan.kinds)
    fn = ast.parse(src).body[-1]
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.For)]
    assert src == tk.twin.render(plan.kinds)
