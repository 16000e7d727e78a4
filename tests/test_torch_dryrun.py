"""The port's dry run (repro_torch.launch.dryrun) on the CPU: cells are
counted on ``meta`` tensors at full width, with nothing allocated.

minitron-4b's train_4k cell counts (256 microbatches of B 1 x S 4096,
one traced and scaled) and does not fit the card's 80 GB with its f32
moments and gradient buffers; decode and prefill cells count; a
full-attention arch skips long_500k as the reference does; the
command line writes only under ``--out``. The production meshes (16x16
and 2x16x16, in a ``fake`` process group) count each device's share:
its argument bytes are the local shards the reference's specs give, a
column-parallel product counts its shard's FLOPs and a row-parallel
one's all-reduce its ring wire bytes; on a one-rank mesh the sharded
count is the unsharded one. The kernels' scratch on the
card (the SSD scan's C·Bᵀ and backward workspace, the flash backward's
delta rows) is made on ``meta`` too and counted in the live bytes, and
a chunk the card's shared memory refuses is refused there as well.
"""
import dataclasses
import json
import math

import jax
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import steps as JS
from repro.models import get_model as jax_model
from repro.parallel import sharding as jsh
from repro.roofline.report import model_flops_for as jax_model_flops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import BWD_PAD, bwd_kernel, \
    flash_attention_bwd
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.parallel import ctx, distribute, P
from repro_torch.models import get_model
from repro_torch.optim.adamw import update_chunks
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_analysis import OpCounter, tensors_bytes


def test_minitron_train_cell_counts_and_does_not_fit():
    res = dryrun.run_cell("minitron_4b", "train_4k", verbose=False)
    assert res["status"] == "ok" and res["mesh"] == "1x1"
    assert res["accum_steps"] == 256 and res["seq_shard"]
    rf = res["roofline"]
    assert rf["fits_hbm"] is False
    assert rf["model_flops"] == jax_model_flops(
        jax_config("minitron_4b"), JSHAPES["train_4k"])
    # the forward, its remat recompute and the backward: between the
    # model's 6 N D and 8 N D, attention on top, counted by its kernels
    assert 1.0 < rf["flops"] / rf["model_flops"] < 1.6
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rotary", "swiglu", "adamw", "l2_clip"):
        assert res["kernels"][name]["calls"] > 0, name
    assert res["kernels"]["flash_attention_bwd"]["calls"] == 32 * 256
    mem = res["memory_analysis"]
    cfg = get_config("minitron_4b")
    # the update runs once, not once a microbatch: a launch per chunk
    leaves = torch.utils._pytree.tree_flatten(
        S.params_struct(get_model(cfg, device="meta")))[0]
    assert res["kernels"]["adamw"]["calls"] == sum(
        len(update_chunks(p)) for p in leaves)
    n = cfg.param_count()
    # bf16 weights, two f32 moments, the batch's tokens and labels
    assert mem["argument_bytes"] == 2 * n + 8 * n + 2 * 8 * 256 * 4096 + 4
    # the f32 gradient buffers alone are 4 N bytes of temporaries
    assert mem["temp_bytes"] > 4 * n
    assert rf["bytes_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"]
    assert rf["dominant"] in ("compute", "memory") and rf["step_time_s"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("minitron_4b", "decode_32k"), ("whisper_small", "decode_32k"),
    ("mamba2_1p3b", "long_500k"), ("granite_8b", "prefill_32k")])
def test_decode_and_prefill_cells_count(arch, shape):
    res = dryrun.run_cell(arch, shape, verbose=False)
    assert res["status"] == "ok"
    rf = res["roofline"]
    assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
    assert rf["model_flops"] == jax_model_flops(jax_config(arch),
                                                JSHAPES[shape])
    if shape == "prefill_32k":
        assert res["kernels"]["flash_attention"]["calls"] == \
            get_config(arch).n_layers
        assert res["memory_analysis"]["output_bytes"] > 0


def test_decode_of_a_100b_model_stores_an_f8_cache():
    res = dryrun.run_cell("mistral_large_123b", "decode_32k", verbose=False)
    assert res["status"] == "ok"
    cfg = get_config("mistral_large_123b")
    kv = 2 * cfg.n_layers * 128 * cfg.n_kv_heads * 32768 * cfg.head_dim
    # the cache's bytes are an argument, one byte an element
    assert res["memory_analysis"]["argument_bytes"] >= kv
    assert res["memory_analysis"]["argument_bytes"] < 2 * kv


def test_long_context_is_skipped_for_full_attention():
    res = dryrun.run_cell("minitron_4b", "long_500k", verbose=False)
    assert res["status"] == "skipped"
    assert "full-attention" in res["reason"]


def test_a_full_width_cell_allocates_nothing():
    """Every argument is a ``meta`` tensor, and the counted step makes
    nothing on another device but the optimizer's host step scalar; no
    CUDA context is made."""
    cfg = get_config("mistral_nemo_12b")
    model = get_model(cfg, device="meta")
    params = S.params_struct(model)
    assert all(t.device.type == "meta"
               for t in torch.utils._pytree.tree_flatten(params)[0])
    assert tensors_bytes(params) > 20e9          # 12 B parameters in bf16
    res = dryrun.run_cell("mistral_nemo_12b", "decode_32k", verbose=False)
    assert res["status"] == "ok" and res["other_device_bytes"] == 0
    res = dryrun.run_cell("minitron_4b", "train_4k", verbose=False)
    assert res["other_device_bytes"] <= 16
    assert not torch.cuda.is_initialized()


def test_the_command_line_writes_only_under_out(tmp_path):
    dryrun.main(["--arch", "minitron-4b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["minitron_4b_decode_32k_1x1.json"]
    res = json.loads(files[0].read_text())
    assert res["status"] == "ok" and res["mesh"] == "1x1"
    # a second run finds the cell's file and leaves it
    mtime = files[0].stat().st_mtime_ns
    dryrun.main(["--arch", "minitron-4b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert files[0].stat().st_mtime_ns == mtime


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ssd_args(B, S, H, P, N):
    return (_meta(B, S, H, P), _meta(B, S, H), _meta(H), _meta(B, S, N),
            _meta(B, S, N), _meta(H))


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# mamba2-1.3b's scan (H 64 heads of P 64, N 128, chunk 128) and
# zamba2-2.7b's (N 64) over one 4096-token row, as a train cell's
# microbatch runs them
@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b"])
def test_ssd_scratch_is_counted_in_the_live_bytes(arch):
    ssm = get_config(arch).ssm
    d_inner = ssm.expand * get_config(arch).d_model
    B, S, H, P, N = 1, 4096, d_inner // ssm.head_dim, ssm.head_dim, \
        ssm.state_dim
    L = ssm.chunk
    args = _ssd_args(B, S, H, P, N)
    with OpCounter() as c:
        y, h, states = ssd.ssd_scan_with_states(*args, chunk=L,
                                                return_state=True)
    # the forward's scratch: at these widths the wgmma kind's workspace
    # (C·Bᵀ, the decays and per-head vectors; the chunk states are y's)
    work = 4 * ssd.fwd_work_floats(B, S, H, P, N, L, states=True)
    assert ssd.ssd_fwd_kind(L, P, N) == "wgmma"
    assert c.report.peak_live_bytes == _nbytes((y, h, states)) + work
    dy = _meta(B, S, H, P)
    with OpCounter() as c:
        grads = ssd.ssd_scan_bwd(*args, dy, states, chunk=L)
    work = 4 * ssd.bwd_work_floats(B, S, H, P, N, L)
    assert work > 4 * B * (S // L) * H * N * P     # the state gradients
    assert c.report.peak_live_bytes == _nbytes(grads) + work


@pytest.mark.parametrize("D,KH", [(80, 32), (128, 8)])
def test_flash_bwd_scratch_is_counted_in_the_live_bytes(D, KH):
    """zamba2's shared attention block (32 heads of 80) and minitron's
    (24 of 128 over 8 kv heads): dq, dk, dv and the delta rows."""
    B, H, S = 1, 32 if D == 80 else 24, 4096
    q = _meta(B, H, S, D, dtype=torch.bfloat16)
    k, v = (_meta(B, KH, S, D, dtype=torch.bfloat16) for _ in range(2))
    o, dout = _meta(B, H, S, D, dtype=torch.bfloat16), \
        _meta(B, H, S, D, dtype=torch.bfloat16)
    lse = _meta(B, H, S)
    with OpCounter() as c:
        grads = flash_attention_bwd(q, k, v, o, lse, dout, causal=True)
    wgmma = bwd_kernel(D, torch.bfloat16) == "wgmma"
    rows = B * H * (-(-S // BWD_PAD) * BWD_PAD if wgmma else S)
    scratch = 4 * rows * (2 if wgmma else 1)
    assert c.report.peak_live_bytes == _nbytes(grads) + scratch


def test_ssd_on_meta_refuses_the_chunks_the_card_refuses():
    """A chunk of 256 steps at P 128 and N 256 needs more shared memory
    than a block may have on the card, so the dry run refuses it too; a
    backward at a chunk over 128 steps runs there as on the card: the
    forward kernels at 128 steps for the sub-chunks' states, then the
    backward kernels at 128, each counted with its work."""
    big = _ssd_args(1, 256, 1, 128, 256)
    assert ssd.scan_smem_bytes(256, 128, 256) > \
        ssd.H100_SXM.smem_bytes
    with OpCounter(), pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(*big, chunk=256)
    with OpCounter(), pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan_bwd(*big, _meta(1, 256, 1, 128),
                         _meta(1, 1, 1, 256, 128), chunk=256)
    long = _ssd_args(1, 129, 2, 8, 4)
    with OpCounter() as c:
        grads = ssd.ssd_scan_bwd(*long, _meta(1, 129, 2, 8),
                                 _meta(1, 1, 2, 4, 8), chunk=129)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in long]
    nbytes, flops = kernel_work.ssd_work(1, 129, 2, 8, 4, 128)
    states = 4 * 1 * 2 * 2 * 4 * 8          # two sub-chunks' states
    assert c.report.kernels["ssd_scan"] == {
        "calls": 1, "flops": flops, "bytes": nbytes + states}
    nbytes, flops = kernel_work.ssd_bwd_work(1, 129, 2, 8, 4, 128)
    assert c.report.kernels["ssd_scan_bwd"] == {
        "calls": 1, "flops": flops, "bytes": nbytes}


# -- the production meshes -------------------------------------------------------
class _StandIn:
    def __init__(self, mesh):
        self.axis_names = ("pod", "data", "model")[-len(mesh):]
        self.shape = dict(zip(self.axis_names, mesh))


def _local_bytes(tree, specs, mesh, itemsize=None) -> int:
    """Bytes of each leaf's shard on one device by its reference spec."""
    sizes = _StandIn(mesh).shape
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        parts = 1
        for ax in spec:
            for n in (() if ax is None else ax if isinstance(ax, tuple)
                      else (ax,)):
                parts *= sizes[n]
        total += math.prod(x.shape) * (itemsize or x.dtype.itemsize) \
            // parts
    return total


def _reference_argument_bytes(arch, shape_name, mesh) -> int:
    """A cell's per-device argument bytes from the reference's specs of
    the reference's trees, with the dry run's policy: FSDP above 6e9
    parameters in training (the specs' default otherwise), an f8 cache
    above 100 B for decode. The port's batch holds int64 token ids (8
    bytes) where the reference's holds int32, its decode position is a
    host int, and its optimizer step a 4-byte host scalar."""
    shape = JSHAPES[shape_name]
    cfg = jax_config(arch)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, seq_shard=True)
    if shape.kind == "decode" and cfg.param_count() > 100e9:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="f8")
    m = _StandIn(mesh)
    model = jax_model(cfg)
    params = JS.params_struct(model)
    fsdp = cfg.param_count() > 6e9 if shape.kind == "train" else None
    pspecs = jsh.param_specs(cfg, params, m, fsdp=fsdp)
    total = _local_bytes(params, pspecs, mesh)
    if shape.kind == "train":
        opt = JS.opt_struct(params, JS.default_opt_config(cfg))
        ospecs = jsh.opt_state_specs(cfg, opt, pspecs, m)
        total += _local_bytes(opt["m"], ospecs["m"], mesh)
        total += _local_bytes(opt["v"], ospecs["v"], mesh) + 4
        batch = JS.batch_spec_struct(cfg, shape)
        total += _local_bytes(batch, jsh.batch_specs(cfg, batch, m), mesh, 8)
    elif shape.kind == "prefill":
        batch = JS.batch_spec_struct(cfg, shape)
        total += _local_bytes(batch, jsh.batch_specs(cfg, batch, m), mesh, 8)
    else:
        cache, token = JS.decode_input_struct(model, cfg, shape)
        cache = {k: v for k, v in cache.items() if k != "pos"}
        total += _local_bytes(cache, jsh.cache_specs(cfg, cache, m), mesh)
        total += _local_bytes({"tokens": token}, jsh.batch_specs(
            cfg, {"tokens": token}, m), mesh, 8)
    return total


def test_single_pod_command_line_counts_per_device(tmp_path):
    dryrun.main(["--arch", "minitron-4b", "--shape", "train_4k",
                 "--single-pod", "--out", str(tmp_path)])
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["minitron_4b_train_4k_16x16.json"]
    res = json.loads(files[0].read_text())
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    rf = res["roofline"]
    assert rf["n_devices"] == 256
    assert res["memory_analysis"]["argument_bytes"] == \
        _reference_argument_bytes("minitron_4b", "train_4k", (16, 16))
    # each device computes its share: between 1/256 of the model's
    # FLOPs (6 N D) and 2.2 times it: the remat recompute, attention,
    # the padded heads (32 where the config has 24), and the kv
    # projections, which the reference's rules replicate over the model
    # axis (wk, wv: (fsdp, None)), so each model rank computes them whole
    assert 1.0 < rf["flops"] * 256 / rf["model_flops"] < 2.2
    assert rf["wire_bytes"] > 0 and rf["collective_breakdown"]
    assert res["kernels"]["flash_attention_bwd"]["calls"] == 32
    assert rf["fits_hbm"] and res["other_device_bytes"] <= 16


@pytest.mark.parametrize("arch,shape,mesh", [
    ("minitron_4b", "train_4k", (2, 16, 16)),
    ("mistral_large_123b", "decode_32k", (16, 16)),
    ("mistral_large_123b", "decode_32k", (2, 16, 16)),
    ("granite_8b", "prefill_32k", (16, 16))])
def test_production_mesh_cells_count_per_device(arch, shape, mesh):
    res = dryrun.run_cell(arch, shape, mesh, verbose=False)
    assert res["status"] == "ok"
    assert res["mesh"] == "x".join(map(str, mesh))
    n = math.prod(mesh)
    rf = res["roofline"]
    assert rf["n_devices"] == n and rf["flops"] > 0
    assert rf["wire_bytes"] > 0 and rf["collective_s"] > 0
    assert res["memory_analysis"]["argument_bytes"] == \
        _reference_argument_bytes(arch, shape, mesh)
    if shape == "train_4k":
        assert 1.0 < rf["flops"] * n / rf["model_flops"] < 2.2
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("dp,tp", [(16, 16), (32, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_accum_steps_match_the_reference(arch, dp, tp):
    jcfg = dataclasses.replace(jax_config(arch), seq_shard=True)
    cfg = dataclasses.replace(get_config(arch), seq_shard=True)
    assert S.default_accum_steps(cfg, SHAPES["train_4k"], dp=dp, tp=tp) \
        == JS.default_accum_steps(jcfg, JSHAPES["train_4k"], dp=dp, tp=tp)


@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_1p3b"])
def test_one_rank_mesh_counts_as_the_unsharded_step(arch):
    """On a (1, 1) mesh every DTensor is its local tensor and every
    collective has one rank: the counts are the unsharded step's."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    a = dryrun.count_cell(cfg, SHAPES["train_4k"], accum=4)
    with dryrun.fake_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        with ctx.activate(mesh):
            b = dryrun.count_one(cfg, SHAPES["train_4k"], accum=4,
                                 mesh=mesh)
    assert b["mesh"] == "1x1"
    for key in ("flops", "hbm_bytes", "wire_bytes"):
        assert b["roofline"][key] == a["roofline"][key], key
    assert b["memory_analysis"] == a["memory_analysis"]
    assert {k: v["calls"] for k, v in b["kernels"].items()} == \
        {k: v["calls"] for k, v in a["kernels"].items()}


def test_expanded_kv_gradients_reach_the_projections_unreduced():
    """minitron's 8 kv heads expanded to its 32 padded query heads on a
    16-rank model axis: the gradients of k and v leave the expansion a
    Partial sum and reach the projections as one (no collective on a k
    or v shaped tensor), so what is counted does not hang on DTensor's
    propagation choices; the residual's gradient is reduce-scattered."""
    from repro_torch.parallel import param_specs
    cfg = dataclasses.replace(get_config("minitron_4b"), n_layers=1,
                              seq_shard=True)
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    with dryrun.fake_group(16):
        mesh = make_debug_mesh(1, 16, device_type="cpu")
        model = get_model(cfg, device="meta")
        params = S.params_struct(model)
        params = distribute(params, param_specs(cfg, params, mesh), mesh)
        batch = S.batch_spec_struct(cfg, ShapeSpec("t", 4096, 16, "train"))
        groups = {mesh.get_group(i).group_name: mesh.size(i)
                  for i in range(2)}
        with ctx.activate(mesh), OpCounter(16, groups) as c:
            S.value_and_grad(model, params, batch)
    kinds = {(k, tuple(int(d) for d in sh[sh.index("[") + 1:-1].split(",")))
             for k, sh, *_ in c.report.collectives}
    kv_shaped = [(k, sh) for k, sh in kinds
                 if (len(sh) == 4 and KH in sh and sh[-1] == hd)
                 or (len(sh) == 3 and sh[-1] == KH * hd)]
    assert not kv_shaped, kinds
    assert ("reduce-scatter", (16, 256, cfg.d_model)) in kinds, kinds


def test_products_on_a_four_rank_model_axis_count_their_shards():
    """A column-parallel product counts a quarter of its FLOPs; the
    row-parallel one after it leaves a Partial sum whose all-reduce is
    counted with the ring's wire bytes, 2 (g - 1) / g of the result."""
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_group(4):
        mesh = make_debug_mesh(1, 4, device_type="cpu")
        x = distribute(_meta(8, 16), P(None, None), mesh)
        w1 = distribute(_meta(16, 32), P(None, "model"), mesh)
        w2 = distribute(_meta(32, 16), P("model", None), mesh)
        groups = {mesh.get_group(i).group_name: mesh.size(i)
                  for i in range(2)}
        with ctx.activate(mesh), OpCounter(4, groups) as c:
            h = x @ w1
            col = c.report.dot_flops
            y = ctx.constrain(h @ w2, None, None)
        assert tuple(h.placements) == (Replicate(), Shard(1))
        assert tuple(y.placements) == (Replicate(), Replicate())
    assert col == 2 * 8 * 16 * 32 / 4
    assert c.report.dot_flops == col + 2 * 8 * 32 * 16 / 4
    assert c.report.collectives == [
        ("all-reduce", "float32[8,16]", 4, 1.0, 2 * 8 * 16 * 4 * 3 / 4, "")]
    assert c.report.collective_breakdown == {"all-reduce": 768.0}
