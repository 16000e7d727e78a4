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
                                        plan_tile_call)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op

SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
           "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
           "bias": 0.1, "norm": 3.0, "max_norm": 1.0}


def _renumbered(body):
    """The body with its temporaries renamed in order of definition, so
    two emissions compare by statement order, not by temp numbering."""
    names = {}
    for ln in body:
        m = re.match(r"\s*(_v\d+) = ", ln)
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


def test_pipelined_plan_is_persistent():
    cap = PROGRAMS_PER_SM * H100_SXM.sm_count
    rms = get_tile_op("rmsnorm", emitter="triton_pipelined").tk
    big = plan_tile_call(rms, [(2048, 3072), (3072,)])
    sync = plan_tile_call(get_tile_op("rmsnorm").tk, [(2048, 3072), (3072,)])
    assert big.n_blocks == sync.n_blocks == sync.grid[0] * sync.grid[1]
    assert (big.block_r, big.block_d) == (sync.block_r, sync.block_d)
    assert big.grid == (min(big.n_blocks, cap),) and big.n_blocks > cap
    small = plan_tile_call(rms, [(37, 200), (200,)])
    assert small.grid == (small.n_blocks,)
    # no reduction: column blocks are walked too
    sw = plan_tile_call(get_tile_op("swiglu", emitter="triton_pipelined").tk,
                        [(2048, 9216)] * 2)
    assert sw.n_blocks == (2048 // sw.block_r) * 9 and sw.grid == (cap,)
