"""The port's dry run (repro_torch.launch.dryrun) on the CPU: cells are
counted on ``meta`` tensors at full width, with nothing allocated.

minitron-4b's train_4k cell counts (256 microbatches of B 1 x S 4096,
one traced and scaled) and does not fit the card's 80 GB with its f32
moments and gradient buffers; decode and prefill cells count; a
full-attention arch skips long_500k as the reference does; the
production meshes wait for the sharding rules (A14.3) and raise; the
command line writes only under ``--out``. The kernels' scratch on the
card (the SSD scan's C·Bᵀ and backward workspace, the flash backward's
delta rows) is made on ``meta`` too and counted in the live bytes, and
a chunk the card's shared memory refuses is refused there as well.
"""
import json

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.roofline.report import model_flops_for as jax_model_flops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import BWD_PAD, bwd_kernel, \
    flash_attention_bwd
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.optim.adamw import update_chunks
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


def test_production_meshes_raise_naming_a14_3():
    for mesh in ((16, 16), (2, 16, 16)):
        with pytest.raises(NotImplementedError, match="A14.3"):
            dryrun.run_cell("minitron_4b", "train_4k", mesh=mesh,
                            verbose=False)
    for flag in ("--single-pod", "--multi-pod"):
        with pytest.raises(NotImplementedError, match="A14.3"):
            dryrun.main(["--arch", "minitron-4b", flag])


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
    cb = 4 * B * (S // L) * L * ssd.cb_pitch(L)
    assert c.report.peak_live_bytes == _nbytes((y, h, states)) + cb
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
    than a block may have on the card, so the dry run refuses it too;
    the backward's 128-step limit holds there as well."""
    big = _ssd_args(1, 256, 1, 128, 256)
    assert ssd.scan_smem_bytes(256, 128, 256) > \
        ssd.H100_SXM.smem_bytes
    with OpCounter(), pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(*big, chunk=256)
    with OpCounter(), pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan_bwd(*big, _meta(1, 256, 1, 128),
                         _meta(1, 1, 1, 256, 128), chunk=256)
    long = _ssd_args(1, 129, 2, 8, 4)
    with OpCounter(), pytest.raises(ValueError, match="at most 128"):
        ssd.ssd_scan_bwd(*long, _meta(1, 129, 2, 8),
                         _meta(1, 1, 2, 4, 8), chunk=129)
