"""The port's roofline counting (repro_torch.roofline, the op counter on
``meta`` tensors) against the JAX package's HLO walk
(repro.roofline.hlo_analysis) and its model accounting on the CPU.

A stack of products counts exactly what the reference's trip-count walk
counts of its ``lax.scan`` twin; the collectives' wire math gives the
reference's numbers; ``active_param_count``, ``model_flops_for``,
``cells()`` and ``default_accum_steps`` equal the reference's in every
cell; each hand-written kernel on ``meta`` is counted by its own work
(``roofline.kernel_work``), never by its plain version, and raises
outside a count; the smoke minitron's forward counts the reference's
dot FLOPs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jax_cells
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.steps import default_accum_steps as jax_accum
from repro.models import get_model as jax_get_model
from repro.roofline.hlo_analysis import analyze as hlo_analyze
from repro.roofline.report import model_flops_for as jax_model_flops
from repro_torch.analysis import latency_from_fn, stats_from_fn
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, \
    get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.tile_programs import get_tile_op
from repro_torch.launch.steps import default_accum_steps
from repro_torch.models import get_model
from repro_torch.roofline import OpCounter, count_ops, kernel_work, \
    model_flops_for

C10D = torch.ops._c10d_functional


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_layer_stack_counts_2LMKN_as_the_reference_scan():
    L, M, K = 6, 64, 128

    def jf(x, ws):
        return lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    comp = jax.jit(jf).lower(jax.ShapeDtypeStruct((M, K), jnp.float32),
                             jax.ShapeDtypeStruct((L, K, K), jnp.float32)
                             ).compile()
    want = hlo_analyze(comp.as_text()).dot_flops

    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    rep = count_ops(f, _meta(M, K), [_meta(K, K) for _ in range(L)])
    assert rep.dot_flops == 2 * L * M * K * K == want
    assert rep.ops["mm"]["calls"] == L and rep.ops["tanh"]["calls"] == L
    assert rep.trip_counts == []
    # products read whole operands: L x (x, w in; h out)
    assert rep.ops["mm"]["bytes"] == L * 4 * (M * K + K * K + M * K)
    assert rep.ops["tanh"]["bytes"] == L * 4 * 2 * M * K
    stats = stats_from_fn(f, _meta(M, K), [_meta(K, K) for _ in range(L)])
    assert stats.mxu_flops == rep.dot_flops
    lat = latency_from_fn(f, _meta(M, K), [_meta(K, K) for _ in range(L)])
    assert lat["collective_ns"] == 0.0 and lat["latency_ns"] > 0


# the reference's FAKE module of tests/test_hlo_roofline.py, as collectives
# on meta tensors: an all-gather to bf16[64,2048] over 8, a reduce-scatter
# to f32[8,128] over 4, an all-reduce of f32[1024,1024] over 16
FAKE = """\
ENTRY %main (a: f32[1024,1024]) -> f32[1024,1024] {
  %a = f32[1024,1024]{1,0} parameter(0)
  %ag = bf16[64,2048]{1,0} all-gather(%a), replica_groups=[32,8]<=[256], dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(%a), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %ar = f32[1024,1024]{1,0} all-reduce(%a), replica_groups=[16,16]<=[256], to_apply=%add
}
"""


def _fake_collectives():
    ag = C10D.all_gather_into_tensor(_meta(8, 2048, dtype=torch.bfloat16),
                                     8, "dp8")
    rs = C10D.reduce_scatter_tensor(_meta(32, 128), "sum", 4, "tp4")
    ar = C10D.all_reduce(_meta(1024, 1024), "sum", "dp16")
    return [C10D.wait_tensor(t) for t in (ag, rs, ar)]


def test_collective_wire_math_is_the_references():
    want = hlo_analyze(FAKE)
    with OpCounter(n_devices=256, group_sizes={"dp16": 16}) as c:
        ag, rs, ar = _fake_collectives()
    rep = c.report
    assert (tuple(ag.shape), tuple(rs.shape), tuple(ar.shape)) == \
        ((64, 2048), (8, 128), (1024, 1024))
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        assert rep.collective_breakdown[kind] == pytest.approx(
            want.collective_breakdown[kind])
    assert rep.collective_wire_bytes == pytest.approx(
        want.collective_wire_bytes)
    assert rep.collective_breakdown["all-reduce"] == pytest.approx(
        2 * 1024 * 1024 * 4 * (15 / 16))
    assert [t[0] for t in rep.top_collectives(3)] == \
        [t[0] for t in want.top_collectives(3)]
    assert [t[2] for t in rep.top_collectives(2)] == [16, 8]


def test_an_unknown_collective_raises_on_meta():
    with OpCounter() as c, pytest.raises(NotImplementedError):
        C10D.all_reduce_coalesced([_meta(4)], "sum", "g")
    assert c.report.collective_count == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_accounting_matches_the_reference_in_every_cell(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            JSHAPES[name])
        assert model_flops_for(cfg, shape) == jax_model_flops(
            jcfg, JSHAPES[name])
        for seq_shard in (False, True):
            for tp in (1, 16):
                assert default_accum_steps(
                    dataclasses.replace(cfg, seq_shard=seq_shard), shape,
                    dp=16, tp=tp) == jax_accum(
                    dataclasses.replace(jcfg, seq_shard=seq_shard),
                    JSHAPES[name], dp=16, tp=tp)


def test_cells_are_the_references():
    assert cells() == jax_cells()
    assert sum(ok for *_, ok, _ in cells()) == 32


def test_causal_flash_on_meta_is_counted_by_its_work():
    """Forward and backward of the causal kernel: the causal half of the
    pairs (``kernel_work``), not the plain version's S x S products; no
    product op of torch runs."""
    B, H, KH, S, D = 2, 8, 2, 256, 64
    q = _meta(B, H, S, D, dtype=torch.bfloat16, grad=True)
    k, v = (_meta(B, KH, S, D, dtype=torch.bfloat16, grad=True)
            for _ in range(2))
    launches = flash_attention.launches
    with OpCounter() as c:
        o = flash_attention(q, k, v, causal=True)
        torch.autograd.grad(o.float().sum(), [q, k, v])
    rep = c.report
    fwd, fwd_bytes = kernel_work.flash_fwd_work(B, H, KH, S, D, 2, True,
                                                with_lse=True)
    bwd, bwd_bytes = kernel_work.flash_bwd_work(B, H, KH, S, D, "bfloat16",
                                                True)
    assert fwd == 4 * D * S * (S + 1) // 2 * B * H
    assert rep.kernels["flash_attention"] == {"calls": 1, "flops": fwd,
                                              "bytes": fwd_bytes}
    assert rep.kernels["flash_attention_bwd"] == {"calls": 1, "flops": bwd,
                                                  "bytes": bwd_bytes}
    assert rep.dot_flops == fwd + bwd
    assert not {"bmm", "mm", "baddbmm"} & set(rep.ops)
    assert flash_attention.launches == launches        # nothing launched


def test_ssd_and_tile_ops_on_meta_are_counted_by_their_work():
    B, S, H, P, N = 2, 256, 4, 16, 8
    args = (_meta(B, S, H, P), _meta(B, S, H), _meta(H), _meta(B, S, N),
            _meta(B, S, N), _meta(H))
    x, g = _meta(64, 256), _meta(256)
    with OpCounter() as c:
        y, h = ssd_scan(*args, chunk=64, return_state=True)
        r = ops.rmsnorm(x, g)
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, N, P)
    assert y.device.type == r.device.type == "meta"
    nbytes, flops = kernel_work.ssd_work(B, S, H, P, N, 64)
    assert c.report.kernels["ssd_scan"] == {"calls": 1, "flops": flops,
                                            "bytes": nbytes}
    vops, tbytes = kernel_work.tile_work(get_tile_op("rmsnorm"), [x, g])
    assert c.report.kernels["rmsnorm"] == {"calls": 1, "flops": vops,
                                           "bytes": tbytes}
    assert c.report.vector_ops == vops
    assert c.report.dot_flops == flops


def test_a_kernel_on_meta_outside_a_count_or_without_work_raises():
    q = _meta(1, 2, 16, 16)
    with pytest.raises(RuntimeError, match="OpCounter"):
        flash_attention(q, q, q)
    op = get_tile_op("rmsnorm")
    degraded = dataclasses.replace(op, tk=None)
    with OpCounter(), pytest.raises(RuntimeError, match="no Triton kernel"):
        degraded.apply(_meta(4, 256), _meta(256))
    with OpCounter(), pytest.raises(ValueError, match="head_dim"):
        flash_attention(_meta(1, 2, 16, 24), _meta(1, 2, 16, 24),
                        _meta(1, 2, 16, 24))


def test_live_bytes_peak_and_release():
    """The peak of what a call makes, its arguments apart, and the bytes
    given back when the call's temporaries die."""
    x = _meta(256, 256)

    def f(x):
        a = x @ x                 # 256 KB
        b = a * 2.0               # 256 KB more: the peak
        del a
        return b.sum()            # 4 bytes, after a is gone

    with OpCounter() as c:
        f(x)
    assert c.report.peak_live_bytes == 2 * 256 * 256 * 4
    assert c.live_bytes == 0
    assert c.report.other_device_bytes == 0


def test_a_slice_write_costs_twice_its_bytes():
    cache = _meta(4, 2, 1024, 64)
    new = _meta(4, 2, 1, 64)
    with OpCounter() as c:
        cache[:, :, 7:8] = new
    assert c.report.hbm_bytes == 2 * new.numel() * 4


def test_smoke_forward_counts_the_references_dot_flops():
    """The smoke minitron's loss, f32, B 2 x S 64: the port's counted dot
    FLOPs against the reference's HLO walk of its jitted loss on the CPU,
    within 1 %, with attention taken out of both sides the same way. The
    reference's CPU path is the blocked jnp attention, which computes
    every (q, k) block and masks after: 4 B H S^2 D a layer. The port's
    causal kernel is counted by the pairs it keeps, half of them plus the
    diagonal (asserted on its own record). So each side's attention is
    subtracted by its own count, and the rest (projections, MLP, the
    chunked f32 unembedding over the padded vocab) compared."""
    B, S = 2, 64
    jcfg = dataclasses.replace(jax_smoke_config("minitron_4b"),
                               dtype=jnp.float32)
    jm = jax_get_model(jcfg)
    jbatch = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
    hlo = hlo_analyze(jax.jit(jm.loss).lower(
        jm.init(jax.random.PRNGKey(0)), jbatch).compile().as_text())
    cfg = dataclasses.replace(get_smoke_config("minitron_4b"),
                              dtype=torch.float32)
    model = get_model(cfg, device="meta")
    batch = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    with torch.no_grad():
        rep = count_ops(model.loss, model.init(0), batch)
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.head_dim
    flash = rep.kernels["flash_attention"]["flops"]
    assert flash == L * 4 * D * S * (S + 1) // 2 * B * H
    port = rep.dot_flops - flash
    ref = hlo.dot_flops - L * 4 * B * H * S * S * D
    assert port == pytest.approx(ref, rel=1e-2)
    assert port > 0.5 * rep.dot_flops
