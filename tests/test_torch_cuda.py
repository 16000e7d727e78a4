"""The port's kernels on the card, against their plain versions.

Marked ``cuda``: these skip on a host without a CUDA device (decided in
the fixture, never at import). On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import KernelProgram, c, make_tile_op, toint
from repro_torch.kernels.flash_attention import (
    _launch_fwd, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd_plain,
    flash_attention_plain)
from repro_torch.kernels.ssd_scan import (ssd_cb_kernel, ssd_chunks_plain,
                                          ssd_dbdc_plain, ssd_scan,
                                          ssd_scan_bwd, ssd_scan_bwd_plain,
                                          ssd_scan_plain, ssd_scan_with_states,
                                          ssd_state_grads_plain, tf32_unit)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
from repro_torch.launch.serve import Request, Server

pytestmark = pytest.mark.cuda

TILE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCALARS = {"eps": 1e-6, "alpha": 0.5, "lr": 1e-3, "b1": 0.9, "b2": 0.95,
           "wd": 0.1, "inv_bc1": 1.3, "inv_bc2": 1.1, "mu": 0.9,
           "bias": 0.1, "norm": 3.0, "max_norm": 1.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def _tile_inputs(name, rows, d, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    prog = PROGRAMS[name]()
    xs = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        shape = (d,) if a.shape == (1, 128) else (rows, d)
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        xs.append(x.abs() * 0.01 if a.name == "v" else x)
    return xs, {s: SCALARS[s] for s in prog.scalars}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tile_kernel_matches_plain(name, dtype, cuda):
    xs, sc = _tile_inputs(name, 13, 96, dtype, cuda)
    op = get_tile_op(name)
    before = op.launches
    _close(op.apply(*xs, **sc), op.torch_ref(*xs, **sc), TILE_TOL[dtype])
    assert op.launches == before + 1


@pytest.mark.parametrize("rows,d", [(13, 96), (1500, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pipelined_tile_kernel_matches_plain(name, dtype, rows, d, cuda):
    """The persistent kernels, at one block and at more blocks than the
    persistent grid has programs."""
    xs, sc = _tile_inputs(name, rows, d, dtype, cuda)
    op = get_tile_op(name, emitter="triton_pipelined")
    before = op.launches
    _close(op.apply(*xs, **sc), op.torch_ref(*xs, **sc), TILE_TOL[dtype])
    assert op.launches == before + 1


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("mode", ["baseline", "cse", "cse_sat", "cse_bulk",
                                  "accsat"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_mode_kernel_matches_plain(name, mode, emitter, cuda):
    """Each program's kernel under each of the paper's five modes, f32 at
    a ragged (37, 200) and, for a reduction in whole tiles, at (5, 768)
    in two column pieces, against the mode's plain version."""
    op = get_tile_op(name, mode=mode, emitter=emitter)
    assert op.tk is not None
    shapes = [(37, 200)] + ([(5, 768)] if op.tk.has_reduction
                            and not op.tk.halves else [])
    for rows, d in shapes:
        xs, sc = _tile_inputs(name, rows, d, torch.float32, cuda)
        before = op.launches
        got = op.apply(*xs, **sc)
        assert op.launches == before + 1
        _close(got, op.torch_ref(*(x.expand(xs[0].shape) for x in xs),
                                 **sc), 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_three_ops_launch_their_kernels(dtype, cuda):
    """ops.residual_scale, ops.softmax and ops.ssd_gate (a_log a (nh,)
    broadcast row) launch their kernels once a call and match their
    plain versions."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, y = (torch.randn((3, 40, 96), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    dt_raw = torch.randn((2, 33, 24), generator=gen, device=cuda).to(dtype)
    a_log = torch.log(torch.arange(1, 25, device=cuda,
                                   dtype=torch.float32)).to(dtype)
    for name, args, kw in (("residual_scale", (x, y), {"alpha": 0.375}),
                           ("softmax", (x,), {}),
                           ("ssd_gate", (dt_raw, a_log), {"bias": 0.25})):
        op = get_tile_op(name)
        before = op.launches
        got = getattr(ops, name)(*args, **kw)
        assert op.launches == before + 1, name
        _close(got, op.torch_ref(*(a.expand(args[0].shape) for a in args),
                                 **kw), TILE_TOL[dtype])


def test_three_ops_gradients_on_the_card(cuda):
    """The three ops' autograd Functions (kernel forward, analytic
    backward) against autograd of the oracles, f32."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, y = (torch.randn((64, 96), generator=gen, device=cuda)
            for _ in range(2))
    dt_raw = torch.randn((2, 33, 24), generator=gen, device=cuda)
    a_log = torch.randn((24,), generator=gen, device=cuda) * 0.5
    for name, args, kw in (("residual_scale", (x, y), {"alpha": 0.375}),
                           ("softmax", (x,), {}),
                           ("ssd_gate", (dt_raw, a_log), {"bias": 0.25})):
        grads = []
        for impl in (None, "ref"):
            leaves = [a.clone().requires_grad_() for a in args]
            ops.set_impl(impl)
            try:
                outs = getattr(ops, name)(*leaves, **kw)
            finally:
                ops.set_impl(None)
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.autograd.backward(
                list(outs), [torch.ones_like(o) * 0.5 + o.detach()
                             for o in outs])
            grads.append(tuple(a.grad for a in leaves))
        _close(grads[0], grads[1], 2e-5)


# the CPU executor's row-reduction cases (tests/test_torch_tile_exec.py)
REDUCTION_CASES = [
    ("moe_router", (32, 64, 16)), ("moe_router", (4, 1, 16)),
    ("moe_router", (2048, 128)), ("moe_router", (3, 7, 16)),
    ("layernorm", (2048, 768)), ("layernorm", (4, 768)),
    ("layernorm", (37, 200)), ("layernorm", (37, 768)),
    ("rmsnorm", (5, 3072)), ("rmsnorm", (5, 2560)),
    ("rmsnorm_gated", (5, 5120))]


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("name,lead", REDUCTION_CASES, ids=[
    f"{n}-{'x'.join(map(str, s))}" for n, s in REDUCTION_CASES])
def test_row_reductions_on_the_card(name, lead, emitter, cuda):
    """The row reductions in the layouts their plans pick (column pieces,
    or one masked block at 200), f32, against the plain version, and the
    router and layernorm also against torch.softmax and F.layer_norm."""
    import torch.nn.functional as F
    gen = torch.Generator(device=cuda).manual_seed(sum(lead))
    d = lead[-1]
    xs = [torch.randn((d,) if a.shape == (1, 128) else lead, generator=gen,
                      device=cuda) for a in PROGRAMS[name]().arrays.values()
          if a.role != "out"]
    sc = {s: SCALARS[s] for s in PROGRAMS[name]().scalars}
    op = get_tile_op(name, emitter=emitter)
    before = op.launches
    got = op.apply(*xs, **sc)
    assert op.launches == before + 1
    _close(got, op.torch_ref(*(x.expand(lead) for x in xs), **sc), 2e-5)
    if name == "moe_router":
        _close(got, torch.softmax(xs[0], -1), 2e-5)
    elif name == "layernorm":
        _close(got, F.layer_norm(xs[0], (d,), xs[1], xs[2], 1e-6), 2e-5)


def test_rotary_cycle_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 3, 5, 32), generator=gen, device=cuda)
    cos = torch.randn((1, 1, 5, 32), generator=gen, device=cuda)
    sin = torch.randn((1, 1, 5, 32), generator=gen, device=cuda)
    op = get_tile_op("rotary")
    _close(op.apply(q, cos, sin),
           op.torch_ref(q, cos.expand(q.shape), sin.expand(q.shape)), 2e-5)


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("d", [32, 96, 200])
@pytest.mark.parametrize("groups", [3, 33])
@pytest.mark.parametrize("period", [5, 510])
def test_rotary_cycle_layouts(period, groups, d, emitter, cuda):
    """The half-tile rotary kernel in its cycle layout, at the ragged
    layouts of the CPU executor test (tests/test_torch_tile_exec.py)."""
    from repro_torch.core.tritongen import plan_tile_call
    gen = torch.Generator(device=cuda).manual_seed(period + d)
    lead = (1, 3, period, d) if groups == 3 else (3, 11, period, d)
    q = torch.randn(lead, generator=gen, device=cuda)
    cos, sin = (torch.randn((1, 1, period, d), generator=gen, device=cuda)
                for _ in range(2))
    op = get_tile_op("rotary", emitter=emitter)
    plan = plan_tile_call(op.tk, [lead, cos.shape, sin.shape],
                          [q.dtype, cos.dtype, sin.dtype])
    assert (plan.n_pos, plan.grid[0]) == (period, groups)
    before = op.launches
    _close(op.apply(q, cos, sin),
           op.torch_ref(q, cos.expand(lead), sin.expand(lead)), 2e-5)
    assert op.launches == before + 1


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("lead,pos", [
    ((4, 24, 510, 128), (1, 1, 510, 128)), ((4, 8, 512, 128),
                                            (1, 1, 512, 128)),
    ((4, 24, 1, 128), (1, 1, 1, 128)), ((4, 8, 1, 128), (1, 1, 1, 128))])
def test_rotary_path_shapes(lead, pos, emitter, cuda):
    """bf16 q and k with f32 cos/sin at the model's prefill and decode
    shapes, as ``ops.rotary`` is called."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(lead, generator=gen, device=cuda).bfloat16()
    cos, sin = (torch.randn(pos, generator=gen, device=cuda)
                for _ in range(2))
    op = get_tile_op("rotary", emitter=emitter)
    got = op.apply(q, cos, sin)
    assert got.dtype == torch.bfloat16
    _close(got, op.torch_ref(q, cos.expand(lead), sin.expand(lead)), 3e-2)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 4, 2, 128, 16), torch.float32, 2e-3),
    ((1, 6, 2, 100, 64), torch.float32, 2e-3),
    ((2, 8, 8, 192, 32), torch.bfloat16, 5e-2),
    ((1, 3, 1, 70, 128), torch.bfloat16, 5e-2),
    # the bf16 kernel's tile edges: one row, one past a 64-row tile, one
    # past two
    ((1, 4, 4, 1, 64), torch.bfloat16, 5e-2),
    ((1, 4, 4, 65, 64), torch.bfloat16, 5e-2),
    ((1, 4, 4, 129, 64), torch.bfloat16, 5e-2),
    ((2, 4, 2, 96, 16), torch.bfloat16, 5e-2)] + [
    # the wgmma kernel's edges: S around its 128-row items and kv tiles
    # and a long ragged S, GQA 12 at head_dim 128 and 7 at 64
    ((1, h, kh, S, D), torch.bfloat16, 5e-2)
    for S in (127, 128, 255, 257, 4095)
    for h, kh, D in ((12, 1, 128), (14, 2, 64))])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(shape, dtype, tol, causal, cuda):
    B, H, KH, S, D = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, H, S, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, KH, S, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, KH, S, D), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=causal), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-3)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 255, 257, 510,
                               4095])
def test_flash_head_dim_80_matches_plain(S, H, KH, dtype, tol, cuda):
    """zamba2's head_dim 80 (not a multiple of 64) at the tile edges and a
    510-token prompt, MHA as zamba2's shared block and GQA, causal."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, H, S, 80), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, KH, S, 80), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, KH, S, 80), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    _close(got, flash_attention_plain(q, k, v), tol)


def test_flash_bf16_and_f32_both_launch(cuda):
    """The wrapper picks the tensor-core kernel for bf16 and the CUDA-core
    one for f32; each launches and holds its own tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = [torch.randn((2, 8, 130, 64), generator=gen, device=cuda)
           for _ in range(3)]
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-3)):
        q, k, v = (t.to(dtype) for t in qkv)
        before = flash_attention.launches
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1 and got.dtype == dtype
        _close(got, flash_attention_plain(q, k, v), tol)


def test_flash_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 8, 2, 16), device=cuda).transpose(1, 2)
        flash_attention(x, x, x)


FLASH_BWD_CASES = [
    # (B, H, KH, S, D): every head_dim, GQA and MHA, the tile edges (one
    # row, one past a 64-row tile, one past two) and a ragged S
    (2, 4, 2, 128, 16), (1, 4, 4, 65, 32), (2, 8, 2, 100, 64),
    (1, 4, 1, 129, 64), (2, 4, 4, 63, 80), (1, 8, 2, 130, 80),
    (1, 3, 1, 70, 128), (2, 4, 2, 1, 128), (1, 6, 2, 192, 128),
    # long and ragged: far query tiles of each kv tile, late rows
    (1, 6, 2, 1000, 128),
    # the wgmma kernels' edges at head_dim 128: S around their 128-row
    # work items and 64-row steps, a long ragged S with qwen2-vl's group
    # of 6 (GQA 12/2), MHA
    (1, 4, 2, 127, 128), (1, 4, 2, 128, 128), (1, 4, 2, 129, 128),
    (1, 4, 2, 255, 128), (1, 4, 2, 257, 128), (2, 12, 2, 1001, 128),
    (1, 4, 4, 257, 128),
    # whisper's MHA at head_dim 64 (its encoder and cross-attention run the
    # wgmma backward non-causal) at a long ragged S
    (1, 12, 12, 1001, 64)]
# the backward's gradients, norm-relative over the whole tensor and each
# 64-row block (bf16 rounds P and dS for the tensor cores)
FLASH_BWD_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}


def _norm_rel_close(got, want, tol, rows=64):
    """``||got - want|| <= tol ||want||`` for each (..., S, D) gradient,
    over the whole tensor and each 64-row block of each leading index;
    each ``||want||`` at least a thousandth of dv's rms over as many
    elements (dq and dk of a query that sees one key are zero in exact
    arithmetic)."""
    floor = 1e-3 * want[2].float().square().mean().sqrt()
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        S, D = w.shape[-2:]
        d = (g.float() - w.float()).reshape(-1, S, D)
        w = w.float().reshape(-1, S, D)
        assert d.norm() <= tol * torch.maximum(w.norm(),
                                               floor * w.numel() ** 0.5), name
        for r0 in range(0, S, rows):
            db, wb = d[:, r0:r0 + rows], w[:, r0:r0 + rows]
            n = wb[0].numel()
            lim = tol * torch.maximum(wb.norm(dim=(1, 2)), floor * n ** 0.5)
            assert (db.norm(dim=(1, 2)) <= lim).all(), (name, r0)


def _flash_grad_inputs(shape, dtype, device, seed=7):
    B, H, KH, S, D = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*sh):
        return torch.randn(sh, generator=gen, device=device).to(dtype)

    return rn(B, H, S, D), rn(B, KH, S, D), rn(B, KH, S, D), rn(B, H, S, D)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-3)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_BWD_CASES,
                         ids=["x".join(map(str, c)) for c in FLASH_BWD_CASES])
def test_flash_bwd_kernel_matches_plain(shape, causal, dtype, tol, cuda):
    """The backward kernels against their plain version on the same saved
    o and lse (the kernel forward's), over head_dim, GQA, causal and
    ragged S."""
    q, k, v, do = _flash_grad_inputs(shape, dtype, cuda)
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert [g.dtype for g in got] == [dtype] * 3
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _close(got, want, tol)
    _norm_rel_close(got, want, FLASH_BWD_REL[dtype])


# the forward's lse cases: the backward's, and the wgmma forward's edges
# (S around its 128-row items, a long ragged S; GQA 12 and 7, MHA at 80)
FLASH_LSE_CASES = FLASH_BWD_CASES + [
    (1, h, kh, S, D) for S in (127, 255, 257, 4095)
    for h, kh, D in ((12, 1, 128), (14, 2, 64), (2, 2, 80))]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-3)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_LSE_CASES,
                         ids=["x".join(map(str, c)) for c in FLASH_LSE_CASES])
def test_flash_lse_matches_plain_and_leaves_the_forward(shape, causal, dtype,
                                                        tol, cuda):
    """The forward's lse against the plain version's (f32, natural log,
    2e-3 absolute: it is a log), and its output bit for bit the same with
    and without lse."""
    q, k, v, _ = _flash_grad_inputs(shape, dtype, cuda)
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    o_serve, none = _launch_fwd(q, k, v, causal, None, with_lse=False)
    torch.cuda.synchronize()
    assert none is None and lse.dtype == torch.float32
    assert torch.equal(o, o_serve)
    want_o, want_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    _close(o, want_o, tol)
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-3)],
                         ids=["bf16", "f32"])
def test_flash_autograd_on_the_card(dtype, tol, cuda):
    """loss.backward() through the kernel (forward with lse, backward
    kernels) against autograd of the plain attention."""
    q, k, v, do = _flash_grad_inputs((2, 8, 2, 130, 64), dtype, cuda)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (flash_attention.launches, flash_attention_bwd.launches)
        (fn(*leaves) * do).float().sum().backward()
        torch.cuda.synchronize()
        after = (flash_attention.launches, flash_attention_bwd.launches)
        assert after == (tuple(b + 1 for b in before)
                         if fn is flash_attention else before)
        grads.append(tuple(t.grad for t in leaves))
    _close(grads[0], grads[1], tol)
    _norm_rel_close(grads[0], grads[1], FLASH_BWD_REL[dtype])


@pytest.mark.parametrize("shape", [(2, 24, 8, 4096, 128),
                                   (2, 12, 2, 4096, 128)],
                         ids=["minitron_train", "qwen2vl_train"])
def test_flash_bwd_is_deterministic(shape, cuda):
    """Two calls of the bf16 backward at the training paths' shapes give
    the same bits: every gradient element is summed in one fixed order
    (no atomics), which a recovered training run's bitwise replay needs."""
    q, k, v, do = _flash_grad_inputs(shape, torch.bfloat16, cuda)
    o, lse = _launch_fwd(q, k, v, True, None, with_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D,with_lists", [(128, False), (80, False),
                                          (32, True)],
                         ids=["missing_work_list", "missing_work_list_d80",
                              "head_dim_32"])
def test_flash_bwd_wgmma_refuses_a_missing_work_list(D, with_lists, cuda):
    """The library's wgmma entry refuses a call without its work lists,
    and a head_dim it has no instance for (an error, not unwritten
    gradients); the mma.sync entry takes every head_dim."""
    from repro_torch.kernels.flash_attention import (_bwd_work_tensors,
                                                     _load, _raise_on)
    q, k, v, do = _flash_grad_inputs((1, 2, 2, 64, D), torch.bfloat16, cuda)
    o, lse = _launch_fwd(q, k, v, True, None, with_lse=True)
    lib = _load()
    scratch = torch.empty(2 * 2 * 128, device=cuda)
    dq = torch.empty_like(q)
    lists = [None, 0, None, 0]
    if with_lists:
        dkdv_work, n_dkdv, dq_work, n_dq = _bwd_work_tensors(
            1, 2, 2, 64, True, q.device)
        lists = [dkdv_work.data_ptr(), n_dkdv, dq_work.data_ptr(), n_dq]
    err = lib.flash_attention_bwd_bf16_sm90(
        *(t.data_ptr() for t in (q, k, v, o, lse, do, scratch, dq, dq, dq)),
        1, 2, 2, 64, D, 0.25, 1, *lists,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="flash_attention_bwd kernel"):
        _raise_on(lib, err, "flash_attention_bwd")
    assert lib.flash_attention_bwd_bf16(
        *(t.data_ptr() for t in (q, k, v, o, lse, do, scratch, dq, dq, dq)),
        1, 2, 2, 64, D, 0.25, 1, torch.cuda.current_stream().cuda_stream) == 0


@pytest.mark.parametrize("S", [1, 63, 65, 129, 4096])
@pytest.mark.parametrize("KH", [8, 2])
def test_flash_bwd_wgmma_head_dim_80(S, KH, cuda):
    """Head_dim 80 (zamba2's shared block) on the wgmma kernels (two TMA
    boxes a row, the second zero-filled past column 80; m64n80k16 for dV,
    dK, dQ) against the plain version, element-wise and norm-relative,
    at S around the 64- and 128-row tiles and at the train length, MHA
    and GQA; two calls give the same bits."""
    from repro_torch.kernels.flash_attention import bwd_kernel
    assert bwd_kernel(80, torch.bfloat16) == "wgmma"
    q, k, v, do = _flash_grad_inputs((1, 8, KH, S, 80), torch.bfloat16, cuda)
    o, lse = _launch_fwd(q, k, v, True, None, with_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    want = flash_attention_bwd_plain(q, k, v, o, lse, do)
    _close(got, want, 5e-2)
    _norm_rel_close(got, want, FLASH_BWD_REL[torch.bfloat16])
    for name, a, b in zip(("dq", "dk", "dv"), got, again, strict=True):
        assert torch.equal(a, b), name


def _mma_sync_fwd(q, k, v, causal, with_lse):
    """``(o, lse)`` of the bf16 forward on the mma.sync kernel (the
    library's entry at every head_dim), launched by ``chip_smoke.py``'s
    helper, which times it beside the wgmma kernel."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._mma_sync_fwd(torch, q, k, v, causal, with_lse)()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 6, 2, 1000, 128), (1, 14, 2, 257, 64),
                                   (2, 4, 4, 513, 80)],
                         ids=["d128_gqa3", "d64_gqa7", "d80_mha"])
def test_flash_fwd_wgmma_matches_mma_sync(shape, causal, cuda):
    """At head_dim 64, 80 and 128 the wrapper launches the wgmma kernel
    (``fwd_kernel``), and it agrees with the mma.sync kernel it replaced
    on the same operands, output and lse, within the bf16 tolerance (both
    round P to bf16; they sum in other orders)."""
    from repro_torch.kernels.flash_attention import fwd_kernel
    B, H, KH, S, D = shape
    assert fwd_kernel(D, torch.bfloat16) == "wgmma"
    q, k, v, _ = _flash_grad_inputs(shape, torch.bfloat16, cuda)
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    o_mma, lse_mma = _mma_sync_fwd(q, k, v, causal, True)
    torch.cuda.synchronize()
    _close(o, o_mma, 5e-2)
    _norm_rel_close((o, o, o), (o_mma, o_mma, o_mma),
                    FLASH_BWD_REL[torch.bfloat16])
    torch.testing.assert_close(lse, lse_mma, atol=2e-3, rtol=0)


@pytest.mark.parametrize("shape", [(2, 24, 8, 4096, 128),
                                   (2, 32, 32, 4096, 80),
                                   (2, 12, 12, 4096, 64)],
                         ids=["minitron_train", "zamba2_train",
                              "whisper_train"])
def test_flash_fwd_is_deterministic(shape, cuda):
    """Two calls of the bf16 forward at the training paths' shapes give
    the same bits, output and lse (each row is summed by one warpgroup in
    one order), and the output with the lse is the serve path's."""
    q, k, v, _ = _flash_grad_inputs(shape, torch.bfloat16, cuda)
    causal = shape[-1] != 64
    first = _launch_fwd(q, k, v, causal, None, with_lse=True)
    second = _launch_fwd(q, k, v, causal, None, with_lse=True)
    serve, _ = _launch_fwd(q, k, v, causal, None, with_lse=False)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[0], serve)
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("D,H,KH,programs", [
    (32, 4, 2, 132), (16, 4, 2, 132), (128, 6, 4, 132), (128, 4, 2, 0)],
    ids=["head_dim_32", "head_dim_16", "h_not_a_multiple_of_kh",
         "no_programs"])
def test_flash_fwd_sm90_refuses_what_it_cannot_run(D, H, KH, programs,
                                                   cuda):
    """The library's wgmma forward entry refuses a head_dim it has no
    instance for, H % KH != 0 and a grid of no programs (an error, not an
    unwritten output); the mma.sync entry takes head_dims 16 and 32, and
    the wrapper sends them there."""
    from repro_torch.kernels.flash_attention import (_load, _raise_on,
                                                     fwd_kernel)
    q = torch.zeros((1, H, 64, D), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, KH, 64, D), dtype=torch.bfloat16, device=cuda)
    o = torch.empty_like(q)
    lib = _load()
    err = lib.flash_attention_fwd_bf16_sm90(
        q.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(), None, 1, H,
        KH, 64, D, 0.25, 1, programs, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="flash_attention kernel"):
        _raise_on(lib, err, "flash_attention")
    if D in (16, 32):
        assert fwd_kernel(D, torch.bfloat16) == "mma_sync"
        assert lib.flash_attention_fwd_bf16(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(), None,
            1, H, KH, 64, D, 0.25, 1,
            torch.cuda.current_stream().cuda_stream) == 0


def test_flash_bwd_rejects_what_it_cannot_run(cuda):
    """The wrapper refuses operands the kernels do not take, and a launch
    the library refuses (here a head_dim it has no instance for) raises
    with the CUDA error rather than return unwritten gradients."""
    from repro_torch.kernels.flash_attention import _BWD, _load, _raise_on
    q, k, v, do = _flash_grad_inputs((1, 2, 2, 8, 16), torch.float32, cuda)
    o, lse = _launch_fwd(q, k, v, True, None, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :4].contiguous(), do)
    with pytest.raises(TypeError, match="dout"):
        flash_attention_bwd(q, k, v, o, lse, do.bfloat16())
    lib = _load()
    dq = torch.empty_like(q)
    err = getattr(lib, _BWD["cuda_cores"])(
        *(t.data_ptr() for t in (q, k, v, o, lse, do, lse, dq, dq, dq)),
        1, 2, 2, 8, 48, 0.25, 1, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="flash_attention_bwd kernel"):
        _raise_on(lib, err, "flash_attention_bwd")


def _ssd_inputs(B, S, H, P, N, device):
    gen = torch.Generator(device=device).manual_seed(3)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    dt = torch.rand((B, S, H), generator=gen, device=device) * 0.29 + 0.01
    a_log = torch.rand((H,), generator=gen, device=device) * 2 - 1
    return (rn(B, S, H, P), dt, a_log, rn(B, S, N, scale=0.3),
            rn(B, S, N, scale=0.3), rn(H))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 16, 16, 16), (2, 100, 3, 16, 8, 32), (1, 7, 2, 8, 4, 16),
    (2, 1, 2, 8, 4, 16), (1, 300, 4, 64, 128, 128), (1, 7, 2, 6, 4, 16),
    # the tile edges at full width (64 heads of P 64, N 128, chunk 128)
    (1, 1, 64, 64, 128, 128), (1, 128, 64, 64, 128, 128),
    (1, 640, 64, 64, 128, 128)])
def test_ssd_kernel_matches_plain(B, S, H, P, N, chunk, cuda):
    """y and the final state, at a chunk multiple, a ragged S, S < chunk,
    S = 1, a P that is not a multiple of 4 and the serve widths (f32
    2e-4, the SSD tolerance)."""
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    before = ssd_scan.launches
    got = ssd_scan(*xs, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _close(got, ssd_scan_plain(*xs, chunk=chunk, return_state=True), 2e-4)
    _close(ssd_scan(*xs, chunk=chunk), got[0], 0.0)


@pytest.mark.parametrize("B,S,N,chunk", [(2, 300, 128, 128),
                                         (1, 7, 4, 16), (2, 100, 8, 32)])
def test_ssd_cb_matches_plain_decomposition(B, S, N, chunk, cuda):
    """The scan's first launch, C·Bᵀ once per (batch, chunk), equals the
    lower triangle of ssd_chunks_plain's (f32 2e-4: 3xTF32 products)."""
    xs = _ssd_inputs(B, S, 2, 8, N, cuda)
    cb, _, _, _ = ssd_chunks_plain(*xs, chunk=chunk)
    _close(ssd_cb_kernel(xs[3], xs[4], chunk=chunk), cb, 2e-4)


def _norm_rel(got, want):
    """``||got - want|| / ||want||``, the denominator at least the norm of
    an element rms of 1: a gradient that is zero in exact arithmetic (da_log
    of one step, which no decay reaches) is held to the tolerance
    absolutely, as ``tol (1 + |want|)`` holds an element."""
    want = want.float()
    return ((got.float() - want).norm()
            / max(want.norm().item(), want.numel() ** 0.5)).item()


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 2, 16, 16, 16), (2, 100, 3, 16, 8, 32), (1, 7, 2, 8, 4, 16),
    (2, 1, 2, 8, 4, 16), (1, 50, 2, 6, 5, 16), (1, 70, 2, 72, 70, 64),
    # the training widths (mamba2-1.3b: P 64, N 128; zamba2-2.7b: N 64),
    # a chunk multiple and a ragged S; mamba2's 64 heads (eight groups of
    # eight) and zamba2's 80 (ten) at full width, one ragged
    (1, 384, 4, 64, 128, 128), (1, 300, 4, 64, 64, 128),
    (1, 300, 64, 64, 128, 128), (1, 512, 80, 64, 64, 128),
    (1, 333, 80, 64, 64, 128)])
def test_ssd_bwd_kernel_matches_plain(B, S, H, P, N, chunk, cuda):
    """The backward kernels' six gradients against ssd_scan_bwd_plain,
    norm-relative within the SSD's f32 2e-4, from the forward kernel's
    chunk states (themselves against ssd_chunks_plain's), with and
    without a final-state gradient; two calls give the same bits."""
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dy = torch.randn((B, S, H, P), generator=gen, device=cuda)
    dh = torch.randn((B, H, N, P), generator=gen, device=cuda)
    y, h, states = ssd_scan_with_states(*xs, chunk=chunk, return_state=True)
    _, want_states, want_y, want_h = ssd_chunks_plain(*xs, chunk=chunk)
    _close((y, h, states), (want_y, want_h, want_states), 2e-4)
    for dh_final in (None, dh):
        before = ssd_scan_bwd.launches
        got = ssd_scan_bwd(*xs, dy, states, chunk=chunk, dh_final=dh_final)
        assert ssd_scan_bwd.launches == before + 1
        want = ssd_scan_bwd_plain(*xs, dy, chunk=chunk, dh_final=dh_final)
        for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                              want, strict=True):
            assert g.shape == w.shape and bool(g.isfinite().all()), name
            assert _norm_rel(g, w) <= 2e-4, (name, _norm_rel(g, w))
        again = ssd_scan_bwd(*xs, dy, states, chunk=chunk, dh_final=dh_final)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_autograd_on_the_card(cuda):
    """ops.ssd under autograd on the card (the forward kernel with its
    chunk states, the backward kernels), with and without the final
    state, against autograd of the plain scan on the CPU (2e-4)."""
    from repro_torch.kernels import ops
    xs = _ssd_inputs(2, 200, 3, 64, 32, "cpu")
    gen = torch.Generator().manual_seed(6)
    dy = torch.randn(xs[0].shape, generator=gen)
    dh = torch.randn((2, 3, 32, 64), generator=gen)
    for return_state in (False, True):
        grads = []
        for device in ("cpu", cuda):
            leaves = [a.detach().to(device, copy=True).requires_grad_()
                      for a in xs]
            before = ssd_scan_bwd.launches
            out = ops.ssd(*leaves, chunk=64, return_state=return_state)
            if return_state:
                loss = (out[0] * dy.to(device)).sum() \
                    + (out[1] * dh.to(device)).sum()
            else:
                loss = (out * dy.to(device)).sum()
            loss.backward()
            assert ssd_scan_bwd.launches == before + (device != "cpu")
            grads.append([t.grad.cpu() for t in leaves])
        for g, w in zip(grads[1], grads[0], strict=True):
            assert _norm_rel(g, w) <= 2e-4


def test_ssd_bwd_rejects_what_it_cannot_run(cuda):
    xs = _ssd_inputs(1, 16, 2, 8, 4, cuda)
    dy = torch.randn_like(xs[0])
    _, _, states = ssd_scan_with_states(*xs, chunk=16)
    with pytest.raises(ValueError, match="states"):
        ssd_scan_bwd(*xs, dy, states[:, :, :1].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(*xs, dy.double(), states, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        big = _ssd_inputs(1, 256, 1, 128, 256, cuda)
        ssd_scan_bwd(*big, torch.randn_like(big[0]),
                     torch.zeros((1, 1, 1, 256, 128), device=cuda),
                     chunk=256)
    # a chunk over 128 steps: the backward kernels run at 128-step
    # sub-chunks, from the states the forward kernels recompute at 128
    long = _ssd_inputs(1, 129, 2, 8, 4, cuda)
    _, _, long_states = ssd_scan_with_states(*long, chunk=129)
    dy = torch.randn_like(long[0])
    got = ssd_scan_bwd(*long, dy, long_states, chunk=129)
    want = ssd_scan_bwd_plain(*long, dy, chunk=129)
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          want, strict=True):
        assert g.shape == w.shape and bool(g.isfinite().all()), name
        assert _norm_rel(g, w) <= 2e-4, (name, _norm_rel(g, w))


@pytest.mark.parametrize("B,S,H,P,N,chunk,kind", [
    (1, 129, 2, 8, 4, 129, None), (1, 300, 4, 64, 64, 256, None),
    (1, 300, 4, 64, 64, 256, "wgmma"), (2, 333, 4, 64, 128, 192, None),
    (1, 256, 3, 16, 8, 256, "mma_sync")])
def test_ssd_bwd_at_a_long_chunk_matches_plain(B, S, H, P, N, chunk, kind,
                                               cuda):
    """A chunk over 128 steps: one forward call at 128 steps (the
    sub-chunks' states) and one backward call at 128, of the sub-chunk's
    kind (wgmma at P 64, N 64 or 128, also when forced), every gradient
    within 2e-4 of the plain backward at the long chunk, with and without
    a final-state gradient; two calls give the same bits. The wgmma kind
    still refuses the widths it cannot take."""
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    dy = torch.randn((B, S, H, P), generator=gen, device=cuda)
    dh = torch.randn((B, H, N, P), generator=gen, device=cuda)
    _, _, states = ssd_scan_with_states(*xs, chunk=chunk)
    for dh_final in (None, dh):
        fwd, bwd = ssd_scan.launches, ssd_scan_bwd.launches
        got = ssd_scan_bwd(*xs, dy, states, chunk=chunk, dh_final=dh_final,
                           kind=kind)
        assert (ssd_scan.launches, ssd_scan_bwd.launches) == \
            (fwd + 1, bwd + 1)
        want = ssd_scan_bwd_plain(*xs, dy, chunk=chunk, dh_final=dh_final)
        for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc", "dd"),
                              got, want, strict=True):
            assert g.shape == w.shape and bool(g.isfinite().all()), name
            assert _norm_rel(g, w) <= 2e-4, (name, _norm_rel(g, w))
        again = ssd_scan_bwd(*xs, dy, states, chunk=chunk,
                             dh_final=dh_final, kind=kind)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    if P != 64:
        with pytest.raises(ValueError, match="wgmma kind takes"):
            ssd_scan_bwd(*xs, dy, states, chunk=chunk, kind="wgmma")


def test_ssd_rejects_what_it_cannot_run(cuda):
    x, dt, a_log, bm, cm, d = _ssd_inputs(1, 16, 2, 8, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.bfloat16(), dt, a_log, bm, cm, d)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a_log,
                 bm, cm, d)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan(x, dt, a_log, bm, cm[:, :, :3].contiguous(), d)
    with pytest.raises(ValueError, match="shared memory"):
        big = _ssd_inputs(1, 256, 1, 128, 256, cuda)
        ssd_scan(*big, chunk=256)


@pytest.mark.parametrize("L,P,N", [(16, 8, 4), (64, 64, 64), (128, 64, 128),
                                   (100, 80, 40), (256, 128, 256),
                                   (128, 64, 64), (1, 64, 128)])
def test_ssd_size_formulas_are_the_librarys(L, P, N, cuda):
    """The wrapper's shared-memory and scratch sizes (one formula for the
    card and for the dry run on ``meta``) equal what the CUDA source's
    host functions compute, for the forward's and the backward's mma.sync
    kinds and, at the shapes they take, their wgmma kinds (whose smem
    exports are 0 elsewhere; the forward's workspace with and without the
    chunk states)."""
    from repro_torch.kernels import ssd_scan as ssd
    lib = ssd._load()
    assert ssd.cb_pitch(L) == lib.ssd_cb_pitch(L)
    assert ssd.scan_smem_bytes(L, P, N) == lib.ssd_scan_smem_bytes(L, P, N)
    assert ssd.bwd_smem_bytes(L, P, N, "mma_sync") == \
        lib.ssd_scan_bwd_smem_bytes(L, P, N)
    sm90 = ssd.ssd_bwd_kind(L, P, N) == "wgmma"
    assert ssd.ssd_fwd_kind(L, P, N) == ssd.ssd_bwd_kind(L, P, N)
    assert lib.ssd_scan_bwd_sm90_smem_bytes(L, P, N) == \
        (ssd.bwd_smem_bytes(L, P, N, "wgmma") if sm90 else 0)
    assert ssd.fwd_smem_bytes(L, P, N, "mma_sync") == \
        lib.ssd_scan_smem_bytes(L, P, N)
    assert lib.ssd_scan_fwd_sm90_smem_bytes(L, P, N) == \
        (ssd.fwd_smem_bytes(L, P, N, "wgmma") if sm90 else 0)
    for B, S, H in ((1, 4096, 64), (2, 1000, 7), (3, L, 9)):
        assert ssd.bwd_work_floats(B, S, H, P, N, L, "mma_sync") == \
            lib.ssd_scan_bwd_work_floats(B, S, H, P, N, L)
        if sm90:
            assert ssd.bwd_work_floats(B, S, H, P, N, L, "wgmma") == \
                lib.ssd_scan_bwd_sm90_work_floats(B, S, H, P, N, L)
            for states in (False, True):
                assert ssd.fwd_work_floats(B, S, H, P, N, L, "wgmma",
                                           states) == \
                    lib.ssd_scan_fwd_sm90_work_floats(B, S, H, P, N, L,
                                                      int(states))


# the backward's train shapes (mamba2-1.3b, zamba2-2.7b) and a ragged S
SSD_BWD_TRAIN = [(2, 4096, 64, 64, 128), (2, 4096, 80, 64, 64),
                 (2, 4001, 64, 64, 128)]


def _ssd_bwd_case(shape, device):
    B, S, H, P, N = shape
    xs = _ssd_inputs(B, S, H, P, N, device)
    gen = torch.Generator(device=device).manual_seed(8)
    dy = torch.randn((B, S, H, P), generator=gen, device=device)
    states = ssd_scan_with_states(*xs, chunk=128)[2]
    return xs, dy, states


@pytest.mark.parametrize("shape", SSD_BWD_TRAIN)
def test_ssd_bwd_wgmma_launches_match_their_plain_pieces(shape, cuda):
    """The wgmma kind's launches, each against the plain piece it computes
    (f32, 2e-4 norm-relative), through the library's entry with a
    workspace the test holds: the local and passing launches' state
    gradients (the workspace's second region) against
    ssd_state_grads_plain; the chunk and finish launches' dx and ddt, and
    dB/dC's db and dc, against ssd_scan_bwd_plain, db and dc also against
    ssd_dbdc_plain's head-group sums."""
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N = shape
    xs, dy, states = _ssd_bwd_case(shape, cuda)
    assert ssd.ssd_bwd_kind(128, P, N) == "wgmma"
    work = torch.empty((ssd.bwd_work_floats(B, S, H, P, N, 128, "wgmma"),),
                       device=cuda)
    grads = [torch.empty_like(t) for t in xs]
    lib = ssd._load()
    assert lib.ssd_scan_bwd_sm90(
        *(t.data_ptr() for t in xs), dy.data_ptr(), states.data_ptr(), None,
        work.data_ptr(), *(g.data_ptr() for g in grads), B, S, H, P, N, 128,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    nc = -(-S // 128)
    cb = -(-B * nc * 128 * 128 // 32) * 32
    dstates = work[cb:cb + B * nc * H * N * P].view(B, nc, H, N, P)
    _, dt, a_log, _, c_mat, _ = xs
    assert _norm_rel(dstates, ssd_state_grads_plain(dt, a_log, c_mat, dy,
                                                    chunk=128)) <= 2e-4
    want = ssd_scan_bwd_plain(*xs, dy, chunk=128)
    for name, i in (("dx", 0), ("ddt", 1), ("db", 3), ("dc", 4)):
        assert _norm_rel(grads[i], want[i]) <= 2e-4, name
    _, want_states, _, _ = ssd_chunks_plain(*xs, chunk=128)
    db, dc = ssd_dbdc_plain(xs[0], dt, a_log, xs[3], c_mat, dy, want_states,
                            ssd_state_grads_plain(dt, a_log, c_mat, dy,
                                                  chunk=128),
                            chunk=128, group=8)
    assert _norm_rel(grads[3], db) <= 2e-4
    assert _norm_rel(grads[4], dc) <= 2e-4


@pytest.mark.parametrize("shape", SSD_BWD_TRAIN)
def test_ssd_bwd_kinds_agree_and_repeat(shape, cuda):
    """At the train shapes the dispatch takes the wgmma kind; its six
    gradients are within 2e-4 (norm-relative) of the mma.sync kind's on
    the same inputs, and two wgmma calls give the same bits."""
    from repro_torch.kernels import ssd_scan as ssd
    xs, dy, states = _ssd_bwd_case(shape, cuda)
    assert ssd.ssd_bwd_kind(128, shape[3], shape[4]) == "wgmma"
    got = ssd_scan_bwd(*xs, dy, states, chunk=128)
    other = ssd_scan_bwd(*xs, dy, states, chunk=128, kind="mma_sync")
    for name, a, b in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          other, strict=True):
        assert _norm_rel(a, b) <= 2e-4, name
    again = ssd_scan_bwd(*xs, dy, states, chunk=128, kind="wgmma")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tf32_wgmma_unit_product(cuda):
    """One k-tile through the wgmma kind's building blocks (A split in
    registers, B split into hi and lo tiles in shared memory, three
    m64n64k8 TF32 products) against the f64 product: within 1e-6
    norm-relative (3xTF32 keeps ~21 bits of each operand); and one TF32
    product of the unsplit operands, which matches truncation of each f32
    operand to tf32 (the card does not round it) within 1e-6 and not
    rounding."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn((64, 32), generator=gen, device=cuda)
    b = torch.randn((64, 32), generator=gen, device=cuda)
    want = a.double() @ b.double().T

    def rel(x, ref):
        return ((x.double() - ref).norm() / ref.norm()).item()

    def tf32(x, rounding):
        bits = x.view(torch.int32) + (0x1000 if rounding else 0)
        return (bits & -0x2000).view(torch.float32).double()

    assert rel(tf32_unit(a, b), want) <= 1e-6
    raw = tf32_unit(a, b, raw=True)
    assert rel(raw, tf32(a, False) @ tf32(b, False).T) <= 1e-6
    assert rel(raw, tf32(a, True) @ tf32(b, True).T) > 1e-5


def test_ssd_bwd_wgmma_refuses_what_it_cannot_run(cuda):
    """The wgmma kind is asked for only where it runs: the wrapper refuses
    it at a P it does not take, the library's entry refuses such a launch
    (a CUDA error, no launch), and the wrapper raises on a refused launch
    rather than fall back to the mma.sync kind or the plain version."""
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N = 1, 64, 2, 16, 8
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    dy = torch.randn_like(xs[0])
    states = ssd_scan_with_states(*xs, chunk=32)[2]
    with pytest.raises(ValueError, match="wgmma kind takes"):
        ssd_scan_bwd(*xs, dy, states, chunk=32, kind="wgmma")
    lib = ssd._load()
    work = torch.empty((1 << 20,), device=cuda)
    grads = [torch.empty_like(t) for t in xs]
    assert lib.ssd_scan_bwd_sm90(
        *(t.data_ptr() for t in xs), dy.data_ptr(), states.data_ptr(), None,
        work.data_ptr(), *(g.data_ptr() for g in grads), B, S, H, P, N, 32,
        torch.cuda.current_stream().cuda_stream) != 0
    # a refused launch raises (here: an x the TMA boxes cannot take, 4
    # bytes past a 16-byte boundary)
    big = _ssd_inputs(1, 128, 2, 64, 64, cuda)
    xb = torch.empty(big[0].numel() + 1, device=cuda)[1:].view(big[0].shape)
    xb.copy_(big[0])
    states_b = ssd_scan_with_states(*big, chunk=128)[2]
    before = ssd_scan_bwd.launches
    with pytest.raises(RuntimeError, match="ssd_scan_bwd kernel \\(wgmma\\)"):
        ssd_scan_bwd(xb, *big[1:], torch.randn_like(big[0]), states_b,
                     chunk=128)
    assert ssd_scan_bwd.launches == before


# the forward's wgmma kind: mamba2-1.3b's and zamba2-2.7b's widths at a
# chunk multiple, a ragged S, S below a chunk, one step, five chunks, a
# chunk of 64 at zamba2's 80 heads
SSD_FWD_WGMMA = [(1, 384, 4, 64, 128, 128), (2, 300, 3, 64, 64, 128),
                 (1, 100, 9, 64, 128, 128), (2, 1, 8, 64, 64, 128),
                 (1, 640, 16, 64, 128, 128), (1, 256, 80, 64, 64, 64)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_FWD_WGMMA)
def test_ssd_fwd_wgmma_matches_plain(B, S, H, P, N, chunk, cuda):
    """The forward's wgmma kind (the dispatch's at these widths) against
    its plain versions, f32 2e-4: a serve call's y and final state
    (ssd_scan: the chunk states in its workspace), training's y, final
    state and chunk states (ssd_scan_with_states, with and without the
    final state), and the launches' decomposition: the chunk states
    against ssd_passed_states_plain, y against ssd_out_plain of the
    kernel's states. One call counted once."""
    from repro_torch.kernels import ssd_scan as ssd
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    assert ssd.ssd_fwd_kind(min(chunk, S), P, N) == "wgmma"
    before = ssd_scan.launches
    got = ssd_scan(*xs, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _close(got, ssd_scan_plain(*xs, chunk=chunk, return_state=True), 2e-4)
    _, want_states, want_y, want_h = ssd_chunks_plain(*xs, chunk=chunk)
    for return_state in (False, True):
        y, h, states = ssd_scan_with_states(*xs, chunk=chunk,
                                            return_state=return_state)
        assert (h is None) != return_state
        _close((y, states), (want_y, want_states), 2e-4)
        if return_state:
            _close(h, want_h, 2e-4)
    passed, final = ssd.ssd_passed_states_plain(*xs[:4], chunk=chunk)
    _close((states, h), (passed, final), 2e-4)
    _close(y, ssd.ssd_out_plain(*xs, states, chunk=chunk), 2e-4)


@pytest.mark.parametrize("shape", [(2, 4096, 64, 64, 128),
                                   (2, 4096, 80, 64, 64),
                                   (4, 512, 64, 64, 128),
                                   (4, 510, 80, 64, 64)])
def test_ssd_fwd_kinds_agree_and_repeat(shape, cuda):
    """At the train and serve shapes both kinds run: the wgmma kind's y,
    final state and chunk states are within 2e-4 of the mma_sync kind's
    on the same inputs, two calls of each kind give the same bits, and the
    dispatch's kind (wgmma but at mamba2's serve prefill of 4 rows) is
    what a call without one gives."""
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N = shape
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    assert ssd.ssd_fwd_kind(128, P, N) == "wgmma"
    dispatched = ssd.ssd_fwd_kind(128, P, N, B * H)
    assert dispatched == ("mma_sync" if (B, H) == (4, 64) else "wgmma")
    got = {k: ssd_scan_with_states(*xs, chunk=128, return_state=True,
                                   kind=k) for k in ("wgmma", "mma_sync")}
    _close(got["wgmma"], got["mma_sync"], 2e-4)
    for k, want in got.items():
        again = ssd_scan_with_states(*xs, chunk=128, return_state=True,
                                     kind=k)
        assert all(torch.equal(a, b) for a, b in zip(again, want)), k
    default = ssd_scan_with_states(*xs, chunk=128, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(default, got[dispatched]))


def test_ssd_fwd_wgmma_refuses_what_it_cannot_run(cuda):
    """The forward's wgmma kind is asked for only where it runs: the
    wrappers refuse it at a P it does not take, the library's entry
    refuses such a launch (a CUDA error, no launch), and the wrapper
    raises on a refused launch rather than fall back to the mma_sync kind
    or the plain version."""
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N = 1, 64, 2, 16, 8
    xs = _ssd_inputs(B, S, H, P, N, cuda)
    with pytest.raises(ValueError, match="wgmma kind takes"):
        ssd_scan(*xs, chunk=32, kind="wgmma")
    with pytest.raises(ValueError, match="wgmma kind takes"):
        ssd_scan_with_states(*xs, chunk=32, kind="wgmma")
    lib = ssd._load()
    work = torch.empty((1 << 20,), device=cuda)
    y = torch.empty_like(xs[0])
    assert lib.ssd_scan_fwd_sm90(
        *(t.data_ptr() for t in xs), work.data_ptr(), y.data_ptr(), None,
        None, B, S, H, P, N, 32, torch.cuda.current_stream().cuda_stream) != 0
    # a refused launch raises (here: an x the TMA boxes cannot take, 4
    # bytes past a 16-byte boundary)
    big = _ssd_inputs(1, 128, 2, 64, 64, cuda)
    xb = torch.empty(big[0].numel() + 1, device=cuda)[1:].view(big[0].shape)
    xb.copy_(big[0])
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="ssd_scan kernel \\(wgmma\\)"):
        ssd_scan(xb, *big[1:], chunk=128)
    assert ssd_scan.launches == before


def test_ssd_autograd_takes_the_wgmma_kinds(cuda):
    """ops.ssd under autograd at mamba2-1.3b's widths (4 heads of P 64, N
    128, a ragged S) launches the forward's wgmma kernels, then the
    backward's (by the profiler's kernel names and their order), and its
    gradients equal autograd of the plain scan on the CPU (2e-4)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (SSD_BWD_LAUNCHES,
                                              SSD_FWD_LAUNCHES)
    xs = _ssd_inputs(1, 300, 4, 64, 128, "cpu")
    dy = torch.randn(xs[0].shape, generator=torch.Generator().manual_seed(7))
    leaves = [a.detach().requires_grad_() for a in xs]
    (ops.ssd(*leaves, chunk=128) * dy).sum().backward()
    want = [t.grad for t in leaves]
    fwd = set(SSD_FWD_LAUNCHES["wgmma"]) - {"ssd_cb_kernel"}
    bwd = set(SSD_BWD_LAUNCHES["wgmma"]) - {"ssd_cb_kernel"}
    for _ in range(3):   # a profiler session can lose its records
        leaves = [a.detach().to(cuda).requires_grad_() for a in xs]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (ops.ssd(*leaves, chunk=128) * dy.to(cuda)).sum().backward()
            torch.cuda.synchronize()
        starts = {}
        for e in prof.events():
            for name in fwd | bwd:
                if name in e.name:
                    starts.setdefault(name, e.time_range.start)
        if fwd | bwd <= set(starts):
            break
    assert fwd | bwd <= set(starts), sorted(starts)
    assert max(starts[n] for n in fwd) < min(starts[n] for n in bwd)
    for g, w in zip((t.grad.cpu() for t in leaves), want, strict=True):
        assert _norm_rel(g, w) <= 2e-4


def test_degraded_tile_op_raises_on_the_card(cuda):
    p = KernelProgram("toint_op_cuda")
    x = p.array_in("x")
    p.array_out("o")
    p.store("o", toint(x.load() * c(1.5)))
    op = make_tile_op(p)
    assert op.tk is None
    with pytest.raises(RuntimeError, match="no Triton kernel"):
        op.apply(torch.ones((2, 4), device=cuda))


def test_smoke_server_on_the_card_matches_cpu(cuda):
    """The smoke config in f32: greedy tokens on the card (kernels) equal
    those on the CPU (plain versions) with the same weights."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                              dtype=torch.float32)
    cpu = Server("minitron-4b", device="cpu")
    gpu = Server("minitron-4b", device=cuda)
    for srv in (cpu, gpu):
        srv.cfg, srv.model = cfg, LM(cfg, device=srv.device)
        srv._decode = srv.model.decode_step
    cpu.params = cpu.model.init(0)
    gpu.params = _to(cpu.params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=12 - i).astype(np.int32)
               for i in range(3)]
    want = cpu.generate([Request(i, p.copy(), 6)
                         for i, p in enumerate(prompts)])
    got = gpu.generate([Request(i, p.copy(), 6)
                        for i, p in enumerate(prompts)])
    assert got == want


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_mamba_smoke_server_on_the_card_matches_cpu(cuda):
    """The mamba2 smoke config in f32: greedy tokens on the card (the SSD
    and tile kernels) equal those on the CPU (plain versions)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              dtype=torch.float32)
    cpu = Server("mamba2-1.3b", device="cpu")
    gpu = Server("mamba2-1.3b", device=cuda)
    for srv in (cpu, gpu):
        srv.cfg, srv.model = cfg, LM(cfg, device=srv.device)
        srv._decode = srv.model.decode_step
    cpu.params = cpu.model.init(0)
    gpu.params = _to(cpu.params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=40 - i).astype(np.int32)
               for i in range(3)]
    before = ssd_scan.launches
    want = cpu.generate([Request(i, p.copy(), 6)
                         for i, p in enumerate(prompts)])
    got = gpu.generate([Request(i, p.copy(), 6)
                        for i, p in enumerate(prompts)])
    assert got == want
    # one prefill batch (3 requests, max_batch 4): one scan per layer
    assert ssd_scan.launches == before + cfg.n_layers


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_zamba2_and_dbrx_tile_shapes(emitter, cuda):
    """rotary at zamba2's head_dim 80 (bf16 q, f32 cos/sin; prefill and
    decode) and the router softmax at dbrx's 16 experts (f32 logits;
    prefill (32, 64, 16) and decode (4, 1, 16))."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    rot = get_tile_op("rotary", emitter=emitter)
    for lead, pos in (((4, 32, 510, 80), (1, 1, 510, 80)),
                      ((4, 32, 1, 80), (1, 1, 1, 80))):
        q = torch.randn(lead, generator=gen, device=cuda).bfloat16()
        cos, sin = (torch.randn(pos, generator=gen, device=cuda)
                    for _ in range(2))
        _close(rot.apply(q, cos, sin),
               rot.torch_ref(q, cos.expand(lead), sin.expand(lead)), 3e-2)
    router = get_tile_op("moe_router", emitter=emitter)
    for lead in ((32, 64, 16), (4, 1, 16)):
        x = torch.randn(lead, generator=gen, device=cuda) * 3
        before = router.launches
        _close(router.apply(x), router.torch_ref(x), 2e-5)
        assert router.launches == before + 1


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "dbrx-132b"])
def test_family_smoke_server_on_the_card_matches_cpu(arch, cuda):
    """The hybrid and MoE smoke configs in f32: greedy tokens on the card
    (flash, SSD and tile kernels) equal those on the CPU (plain
    versions)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    cpu = Server(arch, device="cpu")
    gpu = Server(arch, device=cuda)
    for srv in (cpu, gpu):
        srv.cfg, srv.model = cfg, LM(cfg, device=srv.device)
        srv._decode = srv.model.decode_step
    cpu.params = cpu.model.init(0)
    gpu.params = _to(cpu.params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=40 - i).astype(np.int32)
               for i in range(3)]
    before = flash_attention.launches
    want = cpu.generate([Request(i, p.copy(), 6)
                         for i, p in enumerate(prompts)])
    got = gpu.generate([Request(i, p.copy(), 6)
                        for i, p in enumerate(prompts)])
    assert got == want
    # one prefill batch: one flash launch per attention layer (zamba2:
    # per application of the shared block)
    n_attn = cfg.n_layers // cfg.shared_attn_every \
        if cfg.family == "hybrid" else cfg.n_layers
    assert flash_attention.launches == before + n_attn


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("S", [1, 63, 65])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_rotary_per_batch_tables(B, S, d, emitter, cuda):
    """M-RoPE's per-batch cos/sin (B, 1, S, d) against q (B, 3, S, d),
    read in place, at the layouts of the CPU executor test
    (tests/test_torch_tile_exec.py)."""
    gen = torch.Generator(device=cuda).manual_seed(10 * B + S + d)
    lead = (B, 3, S, d)
    q = torch.randn(lead, generator=gen, device=cuda)
    cos, sin = (torch.randn((B, 1, S, d), generator=gen, device=cuda)
                for _ in range(2))
    # the plan's kinds: a cycle offset by the batch row; at B 1 a plain
    # cycle, or one broadcast row at S 1
    if B > 1:
        kinds = ("row", "bcycle", "bcycle")
    else:
        kinds = ("row",) + (("cycle",) * 2 if S > 1 else ("bcast",) * 2)
    op = get_tile_op("rotary", emitter=emitter)
    before = op.launches
    by_kinds = op.launches_by_kinds[kinds]
    _close(op.apply(q, cos, sin),
           op.torch_ref(q, cos.expand(lead), sin.expand(lead)), 2e-5)
    assert op.launches == before + 1
    assert op.launches_by_kinds[kinds] == by_kinds + 1


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_qwen2vl_and_whisper_tile_shapes(emitter, cuda):
    """rotary at qwen2-vl's q and k (bf16, 12 and 2 heads of 128) against
    f32 per-batch cos/sin at a ragged 510 positions; layernorm (f32,
    d 768) and gelu (bf16, d 3072) at whisper's prefill and decode rows;
    rmsnorm (f32, d 1536) and swiglu (bf16, d 8960) at qwen2-vl's."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    rot = get_tile_op("rotary", emitter=emitter)
    for heads in (12, 2):
        lead = (4, heads, 510, 128)
        q = torch.randn(lead, generator=gen, device=cuda).bfloat16()
        cos, sin = (torch.randn((4, 1, 510, 128), generator=gen,
                                device=cuda) for _ in range(2))
        _close(rot.apply(q, cos, sin),
               rot.torch_ref(q, cos.expand(lead), sin.expand(lead)), 3e-2)
    ln = get_tile_op("layernorm", emitter=emitter)
    gelu = get_tile_op("gelu", emitter=emitter)
    for rows in (2040, 4):
        x, g, b = (torch.randn(shape, generator=gen, device=cuda)
                   for shape in ((rows, 768), (768,), (768,)))
        _close(ln.apply(x, g, b, eps=1e-6),
               ln.torch_ref(x, g.expand(x.shape), b.expand(x.shape),
                            eps=1e-6), 2e-5)
        a = torch.randn((rows, 3072), generator=gen, device=cuda).bfloat16()
        _close(gelu.apply(a), gelu.torch_ref(a), 3e-2)
    # qwen2-vl's rmsnorm (f32, d 1536) and swiglu (bf16, d_ff 8960)
    rms = get_tile_op("rmsnorm", emitter=emitter)
    swiglu = get_tile_op("swiglu", emitter=emitter)
    for rows in (2040, 4):
        x = torch.randn((rows, 1536), generator=gen, device=cuda)
        g = torch.randn((1536,), generator=gen, device=cuda)
        _close(rms.apply(x, g, eps=1e-6),
               rms.torch_ref(x, g.expand(x.shape), eps=1e-6), 2e-5)
        a, b = (torch.randn((rows, 8960), generator=gen, device=cuda)
                .bfloat16() for _ in range(2))
        _close(swiglu.apply(a, b), swiglu.torch_ref(a, b), 3e-2)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 510])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_whisper_and_qwen2vl_shapes(S, causal, cuda):
    """whisper's MHA 12/12 at head_dim 64, non-causal (the encoder and
    cross-attention) and causal (the decoder), and qwen2-vl's GQA 12/2 at
    head_dim 128, at the bf16 kernel's tile edges and a 510-token
    prompt."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    for kh, d in ((12, 64), (2, 128)):
        q = torch.randn((2, 12, S, d), generator=gen, device=cuda).bfloat16()
        k = torch.randn((2, kh, S, d), generator=gen, device=cuda).bfloat16()
        v = torch.randn((2, kh, S, d), generator=gen, device=cuda).bfloat16()
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        _close(got, flash_attention_plain(q, k, v, causal=causal), 5e-2)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-small"])
def test_new_family_smoke_server_on_the_card_matches_cpu(arch, cuda):
    """The vlm and encdec smoke configs in f32: one short request's greedy
    tokens on the card (flash and tile kernels) equal those on the CPU
    (plain versions)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    cpu = Server(arch, device="cpu")
    gpu = Server(arch, device=cuda)
    for srv in (cpu, gpu):
        srv.cfg, srv.model = cfg, get_model(cfg, device=srv.device)
        srv._decode = srv.model.decode_step
    cpu.params = cpu.model.init(0)
    gpu.params = _to(cpu.params, cuda)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab, size=24)
    before = flash_attention.launches
    want = cpu.generate([Request(0, prompt.astype(np.int32), 6)])
    got = gpu.generate([Request(0, prompt.astype(np.int32), 6)])
    assert got == want
    # one prefill: a flash launch per attention (whisper: the encoder's
    # self-attention, the decoder's self- and cross-attention)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers \
        if cfg.family == "encdec" else cfg.n_layers
    assert flash_attention.launches == before + n_attn


# -- training --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3072,), (5,), (37, 200), (3, 4, 96)],
                         ids=["1d", "1d_small", "2d", "3d"])
def test_optimizer_kernels_match_plain(shape, cuda):
    """The generated adamw and l2_clip kernels (f32, as the optimizer runs
    them) at 1-D and n-D leaves, each launch counted."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(8)
    p, g, m = (torch.randn(shape, generator=gen, device=cuda)
               for _ in range(3))
    v = torch.rand(shape, generator=gen, device=cuda) * 0.01
    sc = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, inv_bc1=1.3,
              inv_bc2=1.1)
    adamw, clip = get_tile_op("adamw"), get_tile_op("l2_clip")
    before = (adamw.launches, clip.launches)
    got = ops.adamw_update(p, g, m, v, **sc)
    clipped = ops.l2_clip(g, norm=3.0, max_norm=1.0)
    torch.cuda.synchronize()
    assert (adamw.launches, clip.launches) == (before[0] + 1, before[1] + 1)
    _close(got, adamw.torch_ref(p, g, m, v, **sc), 2e-5)
    _close(clipped, clip.torch_ref(g, norm=3.0, max_norm=1.0, eps=1e-9),
           2e-5)
    # a bf16 gradient, as autograd returns it for bf16 weights: read as it
    # is, written f32, bitwise the f32 path on g.float() and g.float()
    # times the kernel's own scale (the kernel's result on a one)
    gb = g.bfloat16()
    before = clip.launches
    clipped = ops.l2_clip(gb, norm=3.0, max_norm=1.0)
    scale = ops.l2_clip(torch.ones(1, dtype=torch.bfloat16, device=cuda),
                        norm=3.0, max_norm=1.0)
    torch.cuda.synchronize()
    assert clip.launches == before + 2 and clipped.dtype == torch.float32
    assert torch.equal(clipped, ops.l2_clip(gb.float(), norm=3.0,
                                            max_norm=1.0))
    assert torch.equal(clipped, gb.float() * scale)
    _close(clipped, clip.torch_ref(gb.float(), norm=3.0, max_norm=1.0,
                                   eps=1e-9), 2e-5)


def test_bf16_l2_clip_runs_only_its_kernel_on_the_card(cuda, monkeypatch):
    """A bf16 gradient on the card reaches the l2_clip kernel and never
    a plain version; a kernel that fails to launch raises rather than
    fall back to the cast and the f32 kernel."""
    from repro_torch.kernels import ops, ref
    clip = get_tile_op("l2_clip")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(clip, "torch_ref", plain)
    monkeypatch.setattr(ref, "l2_clip_ref", plain)
    g = torch.randn((37, 200), device=cuda).bfloat16()
    before = clip.launches
    assert ops.l2_clip(g, norm=3.0, max_norm=1.0).dtype == torch.float32
    assert clip.launches == before + 1

    def broken(layout):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(clip.tk, "compiled", broken)
    with pytest.raises(RuntimeError, match="launch refused"):
        ops.l2_clip(g, norm=3.0, max_norm=1.0)
    assert clip.launches == before + 1


@pytest.mark.parametrize("emitter", [None, "triton_pipelined"],
                         ids=["sync", "pipelined"])
def test_gelu_flat_plan_on_the_card(emitter, cuda):
    """gelu on the flat plan at ragged element counts (one element, a
    block short, a tail past one and past many blocks, a persistent
    walk's tail) in f32 and bf16, its tanh through exp and "/": within
    2e-5 (f32) and 3e-2 (bf16) of the plain version over |x| <= 10."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    op = get_tile_op("gelu", emitter=emitter)
    for n in (1, 1023, 2049, 6000, 3 * 4096 + 5, 600 * 2048 + 7):
        x = (torch.rand(n, generator=gen, device=cuda) * 20 - 10)
        x[:min(n, 2001)] = torch.linspace(-10, 10, min(n, 2001),
                                          device=cuda)
        for dtype in (torch.float32, torch.bfloat16):
            a = x.to(dtype)
            before = op.launches
            got = op.apply(a)
            assert op.launches == before + 1 and got.dtype == dtype
            _close(got, op.torch_ref(a), TILE_TOL[dtype])


def _smoke_f32(arch="minitron-4b"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               remat=True)


def test_apply_updates_on_the_card_matches_cpu(cuda):
    """One AdamW step on the f32 smoke weights: the kernels (adamw on
    every leaf, l2_clip on the leaves the JAX package clips through the
    op) against the CPU's plain versions."""
    from repro_torch import tree as T
    from repro_torch.models import LM
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.models.common import reference_ndim
    cfg, ocfg = _smoke_f32(), OptConfig(warmup_steps=1)
    ndim = functools.partial(reference_ndim, cfg)
    cpu = LM(cfg, device="cpu").init(0)
    grads = T.tree_map(lambda p: torch.randn_like(p) * 0.05, cpu)
    gpu = _to(cpu, cuda)
    adamw, clip = get_tile_op("adamw"), get_tile_op("l2_clip")
    before = (adamw.launches, clip.launches)
    apply_updates(gpu, _to(grads, cuda), init_opt_state(gpu, ocfg), ocfg,
                  ndim=ndim)
    torch.cuda.synchronize()
    paths, leaves = T.flatten(cpu)
    n_op = sum(ndim(pa, p) >= 2 for pa, p in zip(paths, leaves))
    assert (adamw.launches - before[0], clip.launches - before[1]) == (
        len(leaves), n_op)
    apply_updates(cpu, grads, init_opt_state(cpu, ocfg), ocfg, ndim=ndim)
    for a, b in zip(T.leaves(gpu), T.leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-vl-2b"])
def test_smoke_train_steps_on_the_card_match_cpu(arch, cuda):
    """Two train steps of the f32 smoke config with remat: the losses and
    parameters on the card (flash forward and backward kernels, tile
    kernels under autograd, adamw and l2_clip) against the CPU's plain
    versions, within the model tests' 1e-4."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import OptConfig, init_opt_state
    cfg, ocfg = _smoke_f32(arch), OptConfig(warmup_steps=1)
    pipe = ShardedTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                           global_batch=2))
    runs = []
    for device in ("cpu", cuda):
        model = LM(cfg, device=device)
        params = _to(LM(cfg, device="cpu").init(0), device)
        state = init_opt_state(params, ocfg)
        step = make_train_step(model, ocfg)
        before = (flash_attention.launches, flash_attention_bwd.launches)
        losses = []
        for i in range(2):
            params, state, loss = step(params, state, pipe.batch_at(i))
            losses.append(loss.item())
        launched = (flash_attention.launches - before[0],
                    flash_attention_bwd.launches - before[1])
        runs.append((losses, [p.cpu() for p in T.leaves(params)], launched))
    (cl, cp, c_launch), (gl, gp, g_launch) = runs
    assert c_launch == (0, 0)
    # per step: a forward and its remat recompute per layer, a backward
    assert g_launch == (2 * 2 * cfg.n_layers, 2 * cfg.n_layers)
    np.testing.assert_allclose(gl, cl, atol=1e-4, rtol=1e-4)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-small", "dbrx-132b"])
def test_smoke_encdec_moe_train_steps_on_the_card_match_cpu(arch, cuda):
    """Two train steps of the f32 smoke config with remat, the encdec and
    MoE families, on the trainer's frames: the losses and parameters on
    the card (layernorm, gelu, the router softmax and swiglu kernels
    under autograd, flash causal and not, the dispatch's torch backward,
    adamw and l2_clip) against the CPU's plain versions within 1e-4;
    flash launches twice a layer's attention a step (forward and remat)
    and its backward once, layernorm and the router twice a layer."""
    from repro_torch import tree as T
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import encdec_frames
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, init_opt_state
    cfg, ocfg = _smoke_f32(arch), OptConfig(warmup_steps=1)
    pipe = ShardedTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                           global_batch=2))
    tile = get_tile_op("layernorm" if cfg.family == "encdec"
                       else "moe_router")
    attn = cfg.n_enc_layers + 2 * cfg.n_layers \
        if cfg.family == "encdec" else cfg.n_layers
    tiles = 2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2 \
        if cfg.family == "encdec" else cfg.n_layers
    runs = []
    for device in ("cpu", cuda):
        model = get_model(cfg, device=device)
        params = _to(get_model(cfg, device="cpu").init(0), device)
        state = init_opt_state(params, ocfg)
        step = make_train_step(model, ocfg)
        before = (flash_attention.launches, flash_attention_bwd.launches,
                  tile.launches)
        losses = []
        for i in range(2):
            batch = pipe.batch_at(i)
            if cfg.family == "encdec":
                batch["frames"] = encdec_frames(cfg, 2, 64, "cpu")
            params, state, loss = step(params, state, batch)
            losses.append(loss.item())
        launched = (flash_attention.launches - before[0],
                    flash_attention_bwd.launches - before[1],
                    tile.launches - before[2])
        runs.append((losses, [p.cpu() for p in T.leaves(params)], launched))
    (cl, cp, c_launch), (gl, gp, g_launch) = runs
    assert c_launch == (0, 0, 0)
    enc_final = 2 if cfg.family == "encdec" else 0
    assert g_launch == (2 * 2 * attn, 2 * attn,
                        2 * (2 * (tiles - enc_final) + enc_final))
    np.testing.assert_allclose(gl, cl, atol=1e-4, rtol=1e-4)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_smoke_ssm_train_steps_on_the_card_match_cpu(arch, cuda):
    """Two train steps of the f32 smoke config with remat, the SSM and
    hybrid families: the losses and parameters on the card (the SSD
    forward with its chunk states and its backward kernels,
    rmsnorm_gated's kernel under autograd, the shared block's flash) against
    the CPU's plain versions within 1e-4; the SSD backward launches once a
    layer a step, the forward twice (the step's forward and the remat)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.data import DataConfig, ShardedTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import OptConfig, init_opt_state
    cfg, ocfg = _smoke_f32(arch), OptConfig(warmup_steps=1)
    if cfg.family == "hybrid":    # two groups, two applications of the block
        cfg = dataclasses.replace(cfg, n_layers=2 * cfg.shared_attn_every)
    pipe = ShardedTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=96,
                                           global_batch=2))
    runs = []
    for device in ("cpu", cuda):
        model = LM(cfg, device=device)
        params = _to(LM(cfg, device="cpu").init(0), device)
        state = init_opt_state(params, ocfg)
        step = make_train_step(model, ocfg)
        before = (ssd_scan.launches, ssd_scan_bwd.launches)
        losses = []
        for i in range(2):
            params, state, loss = step(params, state, pipe.batch_at(i))
            losses.append(loss.item())
        launched = (ssd_scan.launches - before[0],
                    ssd_scan_bwd.launches - before[1])
        runs.append((losses, [p.cpu() for p in T.leaves(params)], launched))
    (cl, cp, c_launch), (gl, gp, g_launch) = runs
    assert c_launch == (0, 0)
    assert g_launch == (2 * 2 * cfg.n_layers, 2 * cfg.n_layers)
    np.testing.assert_allclose(gl, cl, atol=1e-4, rtol=1e-4)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_autograd_tile_ops_on_the_card(cuda):
    """rmsnorm, rmsnorm_gated, swiglu and rotary under autograd on the
    card (the kernels forward; the analytic backwards and rotary's kernel
    with -sin) against autograd of their plain versions on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import rope_cos_sin
    gen = torch.Generator().manual_seed(9)
    x, dy = torch.randn(7, 96, generator=gen), torch.randn(7, 96,
                                                           generator=gen)
    g = torch.randn(96, generator=gen)
    q, dq = torch.randn(2, 3, 10, 32, generator=gen), \
        torch.randn(2, 3, 10, 32, generator=gen)
    cos, sin = (t[None, None] for t in rope_cos_sin(torch.arange(10), 32,
                                                    1e4))
    z = torch.randn(7, 96, generator=gen)
    cases = [(lambda a, b: ops.rmsnorm(a, b), (x, g), dy),
             (lambda a, b, c: ops.rmsnorm_gated(a, b, c), (x, z, g), dy),
             (ops.swiglu, (x, dy), x),
             (lambda a: ops.rotary(a, cos.to(a.device), sin.to(a.device)),
              (q,), dq)]
    for fn, args, out_grad in cases:
        grads = []
        for device in ("cpu", cuda):
            leaves = [a.detach().to(device, copy=True).requires_grad_()
                      for a in args]
            (fn(*leaves) * out_grad.to(device)).sum().backward()
            grads.append([t.grad.cpu() for t in leaves])
        _close(tuple(grads[1]), tuple(grads[0]), 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,shape", [
    ("layernorm", (7, 768)), ("layernorm", (2, 33, 200)),
    ("gelu", (7, 3072)), ("gelu", (2, 33, 200)),
    ("moe_router", (4, 9, 16)), ("moe_router", (2, 1, 128))])
def test_layernorm_gelu_router_train_on_the_card(name, shape, dtype, cuda):
    """layernorm, gelu and the router softmax under autograd on the card:
    one kernel launch forward (``ops._LayernormFn``, ``_GeluFn``,
    ``_MoeRouterFn``), the analytic backward, against autograd of their
    plain versions on the CPU in f32 on the same values (the bf16 ones
    rounded first; f32 2e-5, bf16 3e-2)."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(11)
    d = shape[-1]
    x, dy = (torch.randn(shape, generator=gen).mul(2).to(dtype).float()
             for _ in range(2))
    gb = tuple(torch.randn(d, generator=gen).to(dtype).float()
               for _ in range(2))
    fn, args = {"layernorm": (ops.layernorm, ((x + 3.0).to(dtype).float(),
                                              *gb)),
                "gelu": (ops.gelu, (x,)),
                "moe_router": (ops.moe_router_probs, (x,))}[name]
    op = get_tile_op(name)
    runs = []
    for device, dt in (("cpu", torch.float32), (cuda, dtype)):
        leaves = [a.to(device, dt, copy=True).requires_grad_()
                  for a in args]
        before = op.launches
        y = fn(*leaves)
        assert op.launches - before == (0 if device == "cpu" else 1)
        (y.float() * dy.to(device)).sum().backward()
        runs.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    _close(tuple(runs[1]), tuple(runs[0]), TILE_TOL[dtype])


def test_failure_replay_on_the_card_equals_a_clean_run(cuda, tmp_path):
    """The smoke trainer on the card (bf16) with a host lost at step 5:
    its losses equal a clean run's bit for bit (every kernel on the path
    sums in a fixed order)."""
    from repro_torch.launch.train import build_trainer
    kw = dict(smoke=True, steps=8, batch=4, seq=64, device=cuda)
    clean = build_trainer("minitron-4b", ckpt_dir=str(tmp_path / "a"),
                          **kw).run()
    failed = build_trainer("minitron-4b", ckpt_dir=str(tmp_path / "b"),
                           inject={5: ("node_loss", 1)}, **kw).run()
    assert failed["recoveries"] == 1
    assert failed["losses"] == clean["losses"]


# -- the saturation cache and the verifier on the card --------------------------
# the serve shapes of chip_smoke.py's cache phase: (operand shapes, dtype,
# out dtype)
SERVE_TILES = {
    "rmsnorm": ([(2048, 3072), (3072,)], torch.float32, None),
    "rotary": ([(4, 24, 512, 128), (1, 1, 512, 128), (1, 1, 512, 128)],
               torch.bfloat16, None),
    "swiglu": ([(2048, 9216)] * 2, torch.bfloat16, None),
    "rmsnorm_gated": ([(2048, 4096), (2048, 4096), (4096,)],
                      torch.bfloat16, None),
    "moe_router": ([(32, 64, 16)], torch.float32, None),
    "layernorm": ([(2048, 768), (768,), (768,)], torch.float32, None),
    "gelu": ([(2048, 3072)], torch.bfloat16, None),
    "adamw": ([(3072, 9216)] * 4, torch.float32, None),
    "l2_clip": ([(3072, 9216)], torch.bfloat16, torch.float32),
}


def _serve_tile_inputs(name, device):
    shapes, dtype, out_dtype = SERVE_TILES[name]
    gen = torch.Generator(device=device).manual_seed(7)
    names = [a.name for a in PROGRAMS[name]().arrays.values()
             if a.role != "out"]
    xs = [torch.randn(s, generator=gen, device=device).to(dtype)
          for s in shapes]
    xs = [x.abs() * 0.01 if n == "v" else x for n, x in zip(names, xs)]
    return xs, {s: SCALARS[s] for s in PROGRAMS[name]().scalars}, out_dtype


@pytest.mark.parametrize("emitter", ["triton", "triton_pipelined"])
@pytest.mark.parametrize("name", sorted(SERVE_TILES))
def test_compiled_tile_kernels_fit_the_card(name, emitter, cuda):
    """Every tile kernel compiled at a serve shape passes check_compiled:
    registers, spills and shared memory within the H100's limits."""
    from repro_torch.core.tritongen import (launch_tile_kernel,
                                            prepare_tile_call)
    from repro_torch.verify import check_compiled
    xs, sc, out_dtype = _serve_tile_inputs(name, cuda)
    op = get_tile_op(name, emitter=emitter)
    plan, ins, outs = prepare_tile_call(op.tk, xs, name, out_dtype)
    ck = launch_tile_kernel(op.tk.compiled(plan.layout), plan, ins, outs,
                            [float(sc[s]) for s in op.tk.scalars])
    findings = check_compiled(name, ck.n_regs, ck.n_spills,
                              ck.metadata.shared, plan.num_warps)
    assert not [f for f in findings if f.severity == "error"], \
        [str(f) for f in findings]


@pytest.mark.parametrize("name", ["rmsnorm", "rotary", "adamw", "l2_clip"])
def test_a_warm_build_replays_the_cold_kernel_bitwise(name, tmp_path, cuda):
    """A cache hit rebuilds the same kernel source, and its output on the
    card equals the cold build's bit for bit; both ops certify their
    launch layout and compiled binary with no error."""
    from repro_torch.core.telemetry import reset_telemetry, telemetry
    xs, sc, out_dtype = _serve_tile_inputs(name, cuda)
    reset_telemetry()
    cold = get_tile_op(name, cache_dir=str(tmp_path), verify="cheap")
    assert cold.sk.cache_status == "miss"
    want = cold.apply(*xs, out_dtype=out_dtype, **sc)
    get_tile_op.cache_clear()
    warm = get_tile_op(name, cache_dir=str(tmp_path), verify="cheap")
    assert warm is not cold and warm.sk.cache_status == "hit"
    assert warm.source == cold.source
    got = warm.apply(*xs, out_dtype=out_dtype, **sc)
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    assert warm.certified and warm.binaries
    assert telemetry().snapshot()["verify"]["errors"] == 0


# -- the bridge: user functions as one generated kernel -------------------------
BRIDGED = {
    "my_fn": lambda a, b, s: (a * b + a * b) * torch.sigmoid(a * b + a * b)
    + a * b,
    "mod_pow": lambda a, b, s: torch.where(
        a > b, torch.remainder(a, b), a ** 4) * s + b.abs() ** 1.5
    - torch.pow(a, -2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BRIDGED))
def test_bridged_function_is_one_launch(name, dtype, cuda):
    """A bridged function on CUDA tensors: one Triton launch per call,
    equal to the eager function and to the bridge's plain version on
    negative operands (remainder's sign, pow's integer chains and
    libdevice's pow), at a ragged shape. The kernel computes in f32 and
    rounds once, so in bf16 both are evaluated in f32 on the same bf16
    operands: eager bf16 rounds after every op, and mod_pow's sum
    cancels (2 of 7400 elements past 3e-2 on the H100)."""
    from repro_torch.core import saturate_torch_fn
    gen = torch.Generator(device=cuda).manual_seed(3)
    a, b = (torch.randn((37, 200), generator=gen, device=cuda) * 3
            for _ in range(2))
    s = torch.tensor(0.75, device=cuda)
    bk = saturate_torch_fn(BRIDGED[name], (a, b, s), name=name)
    a, b = a.to(dtype), b.to(dtype)
    before = bk.op.launches
    got = bk(a, b, s)
    assert bk.op.launches == before + 1
    assert got.dtype == dtype and got.shape == a.shape
    _close(got, bk.op.torch_ref(a.float(), b.float(), s2=s),
           TILE_TOL[dtype])
    _close(got, BRIDGED[name](a.float(), b.float(), s), TILE_TOL[dtype])


def test_bridged_remainder_floors_on_the_card(cuda):
    """Triton's float % truncates; the emitted mod corrects the sign
    exactly as torch.remainder does."""
    from repro_torch.core import saturate_torch_fn
    a = torch.tensor([[-7.0, 7.0, -7.0, 7.0, -6.5, 5.25, 0.0, -1e-30]],
                     device=cuda)
    b = torch.tensor([[2.0, 2.0, -2.0, -2.0, 4.0, -1.5, 3.0, 3.0]],
                     device=cuda)
    bk = saturate_torch_fn(torch.remainder, (a, b))
    assert torch.equal(bk(a, b), torch.remainder(a, b))


# -- gradient compression on the card -------------------------------------------
def test_compression_on_the_card_matches_the_cpu(cuda):
    """Each mode on bf16 gradients (as autograd returns them on the
    card): the int8 codes, the scales and the decompressed f32 values
    equal the CPU's bit for bit (round half to even on both), and a
    smoke trainer under ``int8_ef`` trains as under ``int8`` (the
    error-feedback state is discarded, as the JAX step discards it)."""
    from repro_torch.parallel import MODES, Compressor, compressed_grads
    gen = torch.Generator(device=cuda).manual_seed(11)
    g = {"w": torch.randn((300, 257), generator=gen, device=cuda),
         "stack": torch.randn((3, 64, 96), generator=gen, device=cuda) * 1e-4,
         "b": torch.randn((257,), generator=gen, device=cuda)}
    g = {k: v.to(torch.bfloat16) for k, v in g.items()}
    cpu = {k: v.cpu() for k, v in g.items()}
    for mode in MODES:
        comp = Compressor(mode)
        got, read = compressed_grads(comp, g)
        want, _ = compressed_grads(comp, cpu)
        for k in g:
            if read is None:
                assert got[k] is g[k]
                continue
            got_k, want_k = read(got[k], slice(None)), read(want[k],
                                                            slice(None))
            assert got_k.device.type == "cuda"
            assert torch.equal(got_k.cpu(), want_k), (mode, k)
        if mode.startswith("int8"):
            cq, _ = comp.compress(g, comp.init_state(g))
            wq, _ = comp.compress(cpu, comp.init_state(cpu))
            for k in g:
                assert torch.equal(cq[k]["q"].cpu(), wq[k]["q"])
                assert torch.equal(cq[k]["scale"].cpu(), wq[k]["scale"])
        assert comp.wire_bytes(g) == comp.wire_bytes(cpu)


def test_compressed_smoke_training_on_the_card(cuda, tmp_path):
    from repro_torch.launch.train import build_trainer
    kw = dict(smoke=True, steps=8, batch=4, seq=64, device=cuda)
    out = {m: build_trainer("minitron-4b", compress=m,
                            ckpt_dir=str(tmp_path / m), **kw).run()
           for m in ("int8", "int8_ef")}
    assert out["int8"]["losses"] == out["int8_ef"]["losses"]
    assert out["int8_ef"]["losses"][-1] < out["int8_ef"]["losses"][0]


# -- the multi-device layer on the card: a one-rank NCCL mesh -------------------
@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _dense_smoke_step(mesh):
    """The f32 dense smoke model's loss and gradients on the card,
    unsharded and as DTensors on ``mesh`` (its rules with FSDP), and each
    tile and flash kernel's launches in the sharded run."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import get_model
    from repro_torch.parallel import batch_specs, ctx, distribute, param_specs
    cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                              dtype=torch.float32)
    model = get_model(cfg, device="cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device="cuda") for k in ("tokens", "labels")}
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                **{n: get_tile_op(n) for n in ("rmsnorm", "rotary",
                                               "swiglu")}}
    start = {n: c.launches for n, c in counters.items()}
    loss0, g0 = value_and_grad(model, params, batch)
    before = {n: c.launches for n, c in counters.items()}
    plain = {n: before[n] - start[n] for n in counters}
    with ctx.activate(mesh):
        dp = distribute(params, param_specs(cfg, params, mesh, fsdp=True),
                        mesh)
        db = distribute(batch, batch_specs(cfg, batch, mesh), mesh)
        loss, g = value_and_grad(model, dp, db)
        g = [x.full_tensor() for x in T.leaves(g)]
    moved = {n: c.launches - before[n] for n, c in counters.items()}
    return loss0, T.leaves(g0), loss, g, (plain, moved)


def test_one_rank_mesh_loss_and_gradients_are_the_unsharded_ones(nccl_mesh):
    loss0, g0, loss, g, _ = _dense_smoke_step(nccl_mesh)
    assert loss.item() == loss0.item()
    for a, b in zip(g, g0, strict=True):
        assert torch.equal(a, b)


def test_kernels_launch_on_the_shards_under_dtensor(nccl_mesh):
    """No fallback under DTensor: the flash kernels (forward and backward)
    and the tile kernels launch in the sharded step as often as in the
    unsharded one (2 layers: one flash forward and backward each)."""
    *_, (plain, moved) = _dense_smoke_step(nccl_mesh)
    assert moved == plain
    assert moved["flash_attention"] == moved["flash_attention_bwd"] == 2
    assert all(n > 0 for n in moved.values()), moved


# -- f32 on 3xTF32 wgmma ----------------------------------------------------
# the f32 training-parity phases' attention (B 1 x S 512): minitron,
# zamba2, whisper, dbrx, qwen2-vl, mistral-large
FLASH_F32_PARITY = [(1, 24, 8, 512, 128), (1, 32, 32, 512, 80),
                    (1, 12, 12, 512, 64), (1, 48, 8, 512, 128),
                    (1, 12, 2, 512, 128), (1, 96, 8, 512, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_F32_PARITY,
                         ids=["x".join(map(str, c)) for c in FLASH_F32_PARITY])
def test_flash_f32_wgmma_matches_plain_and_repeats(shape, causal, cuda):
    """At head_dim 64, 80 and 128 an f32 call launches the 3xTF32 kind,
    forward and backward (each counted under its kind), within f32
    flash's 2e-3 element-wise and 1e-3 norm-relative of the plain version
    (o, lse, dq, dk, dv), and two calls give the same bits."""
    from repro_torch.kernels.flash_attention import bwd_kernel, fwd_kernel
    D = shape[-1]
    assert fwd_kernel(D, torch.float32) == bwd_kernel(D, torch.float32) \
        == "wgmma_f32"
    q, k, v, do = _flash_grad_inputs(shape, torch.float32, cuda)
    fwd0 = flash_attention.launches_by_kind["wgmma_f32"]
    bwd0 = flash_attention_bwd.launches_by_kind["wgmma_f32"]
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    o2, lse2 = _launch_fwd(q, k, v, causal, None, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_kind["wgmma_f32"] == fwd0 + 2
    assert flash_attention_bwd.launches_by_kind["wgmma_f32"] == bwd0 + 2
    want_o, want_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    _close(o, want_o, 2e-3)
    _norm_rel_close((o, o, o), (want_o, want_o, want_o), 1e-3)
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _close(got, want, 2e-3)
    _norm_rel_close(got, want, FLASH_BWD_REL[torch.float32])
    for name, a, b in zip(("dq", "dk", "dv"), got, again, strict=True):
        assert torch.equal(a, b), name


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 6, 2, 1000, 128), (1, 4, 4, 257, 80),
                                   (1, 6, 2, 129, 64)],
                         ids=["d128_gqa3", "d80_mha", "d64_gqa3"])
def test_flash_f32_wgmma_matches_cuda_cores(shape, causal, cuda):
    """The 3xTF32 kind against the CUDA-core kernels it replaced at these
    head dims (the library's f32 entries, which take every head_dim), on
    the same operands: forward, lse and backward within f32 flash's
    2e-3."""
    smoke = _chip_smoke()
    q, k, v, do = _flash_grad_inputs(shape, torch.float32, cuda)
    o, lse = _launch_fwd(q, k, v, causal, None, with_lse=True)
    o_c, lse_c = smoke._mma_sync_fwd(torch, q, k, v, causal, True,
                                     entry="flash_attention_fwd_f32")()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    cores = smoke._mma_sync_bwd(torch, q, k, v, o, lse, do, causal,
                                entry="flash_attention_bwd_f32")()
    torch.cuda.synchronize()
    _close(o, o_c, 2e-3)
    torch.testing.assert_close(lse, lse_c, atol=2e-3, rtol=0)
    _close(tuple(got), tuple(cores), 2e-3)


@pytest.mark.parametrize("D,H,KH,programs,lists", [
    (32, 4, 2, 132, True), (16, 4, 2, 132, True), (128, 6, 4, 132, True),
    (128, 4, 2, 0, True), (80, 4, 2, 132, False)],
    ids=["head_dim_32", "head_dim_16", "h_not_a_multiple_of_kh",
         "no_programs", "missing_work_list"])
def test_flash_f32_sm90_refuses_what_it_cannot_run(D, H, KH, programs, lists,
                                                   cuda):
    """The f32 wgmma entries refuse a head_dim they have no instance for,
    H % KH != 0, a forward grid of no programs and a backward without its
    work lists (an error, not unwritten outputs); the CUDA-core entries
    take head_dims 16 and 32, and the wrapper sends them there."""
    from repro_torch.kernels.flash_attention import (_bwd_work_tensors,
                                                     _load, _raise_on,
                                                     fwd_kernel)
    q = torch.zeros((1, H, 64, D), device=cuda)
    kv = torch.zeros((1, KH, 64, D), device=cuda)
    o, lse = torch.empty_like(q), torch.zeros((1, H, 64), device=cuda)
    lib = _load()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.flash_attention_fwd_f32_sm90(
        q.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(), None, 1, H,
        KH, 64, D, 0.25, 1, programs, stream)
    work = [None, 0, None, 0]
    if lists and H % KH == 0:
        dkdv_work, n_dkdv, dq_work, n_dq = _bwd_work_tensors(
            1, H, KH, 64, True, q.device, "wgmma_f32")
        work = [dkdv_work.data_ptr(), n_dkdv, dq_work.data_ptr(), n_dq]
    scratch = torch.empty(2 * H * 128, device=cuda)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kv), \
        torch.empty_like(kv)
    bwd_err = lib.flash_attention_bwd_f32_sm90(
        *(t.data_ptr() for t in (q, kv, kv, o, lse, q, scratch, dq, dk, dv)),
        1, H, KH, 64, D, 0.25, 1, *work, stream)
    if programs and lists and D in (64, 80, 128) and H % KH == 0:
        assert err == 0 and bwd_err == 0
        return
    assert err != 0 or bwd_err != 0
    with pytest.raises(RuntimeError, match="flash_attention kernel"):
        _raise_on(lib, err or bwd_err, "flash_attention")
    if D in (16, 32):
        assert err != 0 and bwd_err != 0
        assert fwd_kernel(D, torch.float32) == "cuda_cores"
        assert lib.flash_attention_fwd_f32(
            q.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(), None,
            1, H, KH, 64, D, 0.25, 1, stream) == 0
