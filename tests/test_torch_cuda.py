"""The port's kernels on the card, against their plain versions.

Marked ``cuda``: these skip on a host without a CUDA device (decided in
the fixture, never at import). On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KernelProgram, c, make_tile_op
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tile_kernel_matches_plain(name, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    prog = PROGRAMS[name]()
    xs = []
    for a in prog.arrays.values():
        if a.role == "out":
            continue
        shape = (96,) if a.shape == (1, 128) else (13, 96)
        x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        xs.append(x.abs() * 0.01 if a.name == "v" else x)
    sc = {s: SCALARS[s] for s in prog.scalars}
    op = get_tile_op(name)
    before = op.launches
    _close(op.apply(*xs, **sc), op.torch_ref(*xs, **sc), TILE_TOL[dtype])
    assert op.launches == before + 1


def test_rotary_cycle_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 3, 5, 32), generator=gen, device=cuda)
    cos = torch.randn((1, 1, 5, 32), generator=gen, device=cuda)
    sin = torch.randn((1, 1, 5, 32), generator=gen, device=cuda)
    op = get_tile_op("rotary")
    _close(op.apply(q, cos, sin),
           op.torch_ref(q, cos.expand(q.shape), sin.expand(q.shape)), 2e-5)


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 4, 2, 128, 16), torch.float32, 2e-3),
    ((1, 6, 2, 100, 64), torch.float32, 2e-3),
    ((2, 8, 8, 192, 32), torch.bfloat16, 5e-2),
    ((1, 3, 1, 70, 128), torch.bfloat16, 5e-2)])
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


def test_flash_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 8, 2, 16), device=cuda).transpose(1, 2)
        flash_attention(x, x, x)


def test_degraded_tile_op_raises_on_the_card(cuda):
    p = KernelProgram("mod_op_cuda")
    x = p.array_in("x")
    p.array_out("o")
    p.store("o", x.load() % c(3.0))
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
