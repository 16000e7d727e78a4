"""The flash kernels' host side on the CPU: the head_dim dispatch
between the wgmma and mma.sync kernels (bf16) and the 3xTF32 wgmma and
CUDA-core kernels (f32), forward and backward, and the work lists that
the wgmma backwards' persistent grids walk (``bwd_work``,
``bwd_schedule``, per kind) and the order in which the wgmma forwards
take their items (``fwd_work``, ``fwd_schedule``). The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    _BWD, _FWD, _lpt, BWD_KV_ITEM, BWD_Q_ITEM, BWD_ROWS, F32_WGMMA_HEAD_DIMS,
    FWD_BLOCK_M, FWD_ITEM, FWD_STEP, HEAD_DIMS, SM90_KINDS, WGMMA_HEAD_DIMS,
    bwd_kernel, bwd_schedule, bwd_work, fwd_kernel, fwd_launch,
    fwd_schedule, fwd_work)

SHAPES = [  # (B, H, KH, S): the train path, qwen2-vl's group of 6, edges
    (2, 24, 8, 4096), (2, 12, 2, 4096), (1, 4, 2, 1), (1, 4, 2, 127),
    (1, 4, 2, 128), (1, 4, 2, 129), (2, 6, 2, 1000), (1, 4, 4, 257),
    (3, 8, 1, 640)]


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_head_dim_dispatch(D):
    """bf16 at head_dim 64, 80 and 128 takes the wgmma kernels, 16 and 32
    the mma.sync ones; f32 the 3xTF32 wgmma kernels at 64, 80 and 128 and
    the CUDA-core kernels at 16 and 32."""
    want = "wgmma" if D in (64, 80, 128) else "mma_sync"
    assert bwd_kernel(D, torch.bfloat16) == want
    assert bwd_kernel(D, torch.float32) == (
        "wgmma_f32" if D in (64, 80, 128) else "cuda_cores")
    assert (D in WGMMA_HEAD_DIMS) == (want == "wgmma")


def test_each_kind_has_a_library_entry():
    """Every kind of kernels ``bwd_kernel`` picks names a library entry,
    the wgmma one apart from the mma.sync one, which takes every head_dim."""
    kinds = {bwd_kernel(D, dt) for D in HEAD_DIMS
             for dt in (torch.bfloat16, torch.float32)}
    assert kinds == set(_BWD)
    assert _BWD["wgmma"] != _BWD["mma_sync"] == "flash_attention_bwd_bf16"


@pytest.mark.parametrize("D,dtype", [(48, torch.bfloat16),
                                     (128, torch.float16)])
def test_head_dim_dispatch_refuses(D, dtype):
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        bwd_kernel(D, dtype)


def _walk_lengths(B, H, KH, S, causal):
    """Steps of 64 rows each item walks, counted from the masks: a dk/dv
    item's kv rows [kv0, kv0 + 128) against each query tile of 64 rows
    (a tile is walked where it holds a query at or past kv0), times the
    group's heads; a dq item's query rows against each kv tile of 64."""
    rep = H // KH
    n_kt, n_qt = -(-S // BWD_KV_ITEM), -(-S // BWD_Q_ITEM)
    dkdv = [rep * sum(1 for q0 in range(0, S, 64)
                      if not causal or q0 + 63 >= t * BWD_KV_ITEM)
            for _ in range(B * KH) for t in range(n_kt)]
    dq = [sum(1 for k0 in range(0, S, 64)
              if not causal or k0 <= min(S, (t + 1) * BWD_Q_ITEM) - 1)
          for _ in range(B * H) for t in range(n_qt)]
    return {"dkdv": dkdv, "dq": dq}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_work_of_each_item(shape, causal):
    """Each item's work is the number of 64-row steps its walk takes."""
    assert bwd_work(*shape, causal) == _walk_lengths(*shape, causal)


@pytest.mark.parametrize("programs", [132, 7, 1])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_schedule_covers_each_item_once_heaviest_first(shape, causal,
                                                       programs):
    """Every (b, kv head, kv tile) of dk/dv and (b, head, query tile) of
    dq exactly once; at most ``programs`` programs, none empty; each
    program's list in non-increasing work; and the deal is balanced: no
    program holds more than the mean plus one item's work (what dealing
    heaviest first to the least loaded guarantees)."""
    B, H, KH, S = shape
    sched = bwd_schedule(B, H, KH, S, causal, programs)
    work = bwd_work(B, H, KH, S, causal)
    assert set(sched) == {"dkdv", "dq"}
    for name, (starts, items) in sched.items():
        w = work[name]
        n = len(starts) - 1
        assert n == min(programs, len(w)) and starts[0] == 0
        assert starts[-1] == len(items)
        assert sorted(items) == list(range(len(w)))
        loads = []
        for p in range(n):
            mine = [w[i] for i in items[starts[p]:starts[p + 1]]]
            assert mine, (name, p)
            assert mine == sorted(mine, reverse=True), (name, p)
            loads.append(sum(mine))
        assert max(loads) <= sum(w) / n + max(w), name


def test_schedule_keeps_a_group_side_by_side():
    """Items of equal work keep their index order: at the train shape the
    dq items dealt first are the heads of one group over the heaviest
    query tile (they read the same K and V at the same time)."""
    B, H, KH, S = 2, 24, 8, 4096
    starts, items = bwd_schedule(B, H, KH, S, True, 132)["dq"]
    n_qt = S // BWD_Q_ITEM
    first = [items[starts[p]] for p in range(H // KH)]
    assert [i // n_qt for i in first] == [0, 1, 2]
    assert {i % n_qt for i in first} == {n_qt - 1}


# -- the forward ---------------------------------------------------------


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_fwd_head_dim_dispatch(D):
    """The bf16 forward at head_dim 64, 80 and 128 takes the wgmma
    kernel, 16 and 32 the mma.sync one; f32 the 3xTF32 wgmma kernel at 64,
    80 and 128 and the CUDA-core one at 16 and 32: the same split as the
    backward's."""
    want = "wgmma" if D in (64, 80, 128) else "mma_sync"
    assert fwd_kernel(D, torch.bfloat16) == want
    assert fwd_kernel(D, torch.float32) == (
        "wgmma_f32" if D in (64, 80, 128) else "cuda_cores")
    for dt in (torch.bfloat16, torch.float32):
        assert fwd_kernel(D, dt) == bwd_kernel(D, dt)


def test_fwd_each_kind_has_a_library_entry():
    """Every kind ``fwd_kernel`` picks names a library entry: the wgmma
    one apart from the mma.sync one, which takes every head_dim."""
    kinds = {fwd_kernel(D, dt) for D in HEAD_DIMS
             for dt in (torch.bfloat16, torch.float32)}
    assert kinds == set(_FWD)
    assert _FWD["wgmma"] == "flash_attention_fwd_bf16_sm90"
    assert _FWD["mma_sync"] == "flash_attention_fwd_bf16"
    assert _FWD["cuda_cores"] == "flash_attention_fwd_f32"
    assert _FWD["wgmma_f32"] == "flash_attention_fwd_f32_sm90"


@pytest.mark.parametrize("D,dtype", [(48, torch.bfloat16),
                                     (128, torch.float16),
                                     (64, torch.float64)])
def test_fwd_head_dim_dispatch_refuses(D, dtype):
    with pytest.raises(ValueError, match="flash_attention"):
        fwd_kernel(D, dtype)


def _fwd_walk_lengths(B, H, S, causal):
    """kv tiles of ``FWD_STEP`` rows each forward item walks, counted
    from the mask: a tile is walked where it holds a key at or before the
    item's last row (any key if not causal)."""
    n_qt = -(-S // FWD_ITEM)
    return [sum(1 for k0 in range(0, S, FWD_STEP)
                if not causal or k0 <= min(S, (t + 1) * FWD_ITEM) - 1)
            for _ in range(B * H) for t in range(n_qt)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_fwd_work_of_each_item(shape, causal):
    B, H, _, S = shape
    assert fwd_work(B, H, S, causal) == _fwd_walk_lengths(B, H, S, causal)


@pytest.mark.parametrize("programs", [132, 7, 1, 1 << 20])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_fwd_schedule_covers_each_item_once_heaviest_first(shape, causal,
                                                           programs):
    """Every (b, head, query tile) exactly once; at most ``programs``
    programs, none empty; each program's list in non-increasing work;
    balanced to within one item's work of the mean. With a program for
    every item, each takes one, heaviest first."""
    B, H, _, S = shape
    starts, items = fwd_schedule(B, H, S, programs)
    w = fwd_work(B, H, S, causal)
    n = len(starts) - 1
    assert n == min(programs, len(w)) and starts[0] == 0
    assert starts[-1] == len(items) and sorted(items) == list(range(len(w)))
    loads = []
    for p in range(n):
        mine = [w[i] for i in items[starts[p]:starts[p + 1]]]
        assert mine and mine == sorted(mine, reverse=True), p
        loads.append(sum(mine))
    assert max(loads) <= sum(w) / n + max(w)
    if n == len(w):
        assert [w[i] for i in items] == sorted(w, reverse=True)


@pytest.mark.parametrize("shape,group", [((2, 24, 8, 4096), 3),
                                         ((4, 96, 8, 512), 12),
                                         ((4, 56, 8, 512), 7)],
                         ids=["minitron_train", "mistral_large", "arctic"])
def test_fwd_schedule_keeps_a_group_side_by_side(shape, group):
    """The items dealt first, one to each of the first programs, are the
    heads of one group over the heaviest query tile (they read the same K
    and V at the same time)."""
    B, H, _, S = shape
    starts, items = fwd_schedule(B, H, S, 132)
    n_qt = -(-S // FWD_ITEM)
    first = [items[starts[p]] for p in range(group)]
    assert [i // n_qt for i in first] == list(range(group))
    assert {i % n_qt for i in first} == {n_qt - 1}


@pytest.mark.parametrize("shape", SHAPES + [(4, 96, 8, 512), (4, 56, 8, 512),
                                            (2, 32, 32, 4096),
                                            (8, 32, 8, 2048)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fwd_schedule_is_as_balanced_as_least_loaded_dealing(shape):
    """The kernel's own order (snake rounds over heaviest first) leaves
    the causal triangle's longest program within one item's work or 4 %
    of dealing each item to the least loaded program (``_lpt``), at the
    card's 132 programs."""
    B, H, _, S = shape
    w = fwd_work(B, H, S, True)

    def longest(starts, items):
        return max(sum(w[i] for i in items[starts[p]:starts[p + 1]])
                   for p in range(len(starts) - 1))
    mine = longest(*fwd_schedule(B, H, S, 132))
    least = longest(*_lpt(w, 132))
    assert mine <= least + max(max(w), 0.04 * least)


# -- the f32 kind ---------------------------------------------------------


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_f32_dispatch_follows_its_head_dims(D):
    """f32 takes the 3xTF32 kind exactly at ``F32_WGMMA_HEAD_DIMS`` (the
    head dims the card timed it at least as fast as the CUDA cores), a
    subset of the head dims its TMA boxes and products take; bf16's
    dispatch does not depend on it."""
    assert set(F32_WGMMA_HEAD_DIMS) <= set(WGMMA_HEAD_DIMS)
    f32 = "wgmma_f32" if D in F32_WGMMA_HEAD_DIMS else "cuda_cores"
    assert fwd_kernel(D, torch.float32) == bwd_kernel(D, torch.float32) == f32
    assert f32 in SM90_KINDS or f32 == "cuda_cores"


def test_f32_kind_has_its_own_entries():
    """The f32 kind names library entries of its own, apart from the bf16
    wgmma ones and the CUDA-core ones it replaced at its head dims."""
    assert _BWD["wgmma_f32"] == "flash_attention_bwd_f32_sm90"
    assert len({_FWD[k] for k in _FWD}) == len(_FWD) == 4
    assert len({_BWD[k] for k in _BWD}) == len(_BWD) == 4
    assert set(SM90_KINDS) == {"wgmma", "wgmma_f32"}


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("shape", [(2, 24, 8, 4096), (4, 32, 32, 510),
                                   (1, 12, 2, 512), (3, 8, 1, 640)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_forward_launch_is_the_wgmma_one(shape, D):
    """The f32 forward's persistent grid takes the bf16 wgmma forward's
    128-row items in the same order (``fwd_schedule``): the same grid and
    the same (b, h, tile, kv head) for every index."""
    B, H, KH, S = shape
    assert FWD_BLOCK_M["wgmma_f32"] == FWD_BLOCK_M["wgmma"] == FWD_ITEM
    g32, item32 = fwd_launch(B, H, KH, S, D, torch.float32, 132)
    g16, item16 = fwd_launch(B, H, KH, S, D, torch.bfloat16, 132)
    assert g32 == g16
    assert [item32(x) for x in range(g32[0])] == \
        [item16(x) for x in range(g16[0])]


def _f32_walk_lengths(B, H, KH, S, causal):
    """Steps of 32 rows each f32 item walks, from the masks: a dk/dv
    item's kv rows [kv0, kv0 + 64) against each 32-query step that holds a
    query at or past kv0 (if causal), times the group's heads; a dq item's
    64 query rows against each 32-row kv step up to its last row."""
    rep = H // KH
    dkdv = [rep * sum(1 for q0 in range(0, S, 32)
                      if not causal or q0 + 31 >= kv0)
            for _ in range(B * KH) for kv0 in range(0, S, 64)]
    dq = [sum(1 for k0 in range(0, S, 32)
              if not causal or k0 <= min(S, q0 + 64) - 1)
          for _ in range(B * H) for q0 in range(0, S, 64)]
    return {"dkdv": dkdv, "dq": dq}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 96, 8, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_work_of_each_item(shape, causal):
    """The f32 kind's 64-row items in 32-row steps (``BWD_ROWS``), as the
    masks count them; the bf16 kind's lists are unchanged by the kind
    argument's default."""
    assert BWD_ROWS["wgmma_f32"] == (64, 32, 64, 32)
    assert bwd_work(*shape, causal, "wgmma_f32") == \
        _f32_walk_lengths(*shape, causal)
    assert bwd_work(*shape, causal) == bwd_work(*shape, causal, "wgmma")


@pytest.mark.parametrize("programs", [132, 7])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 96, 8, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_schedule_covers_each_item_once(shape, causal, programs):
    """Every f32 item of dk/dv and dq once, at most ``programs`` programs,
    none empty, each list heaviest first, within one item of the mean."""
    B, H, KH, S = shape
    sched = bwd_schedule(B, H, KH, S, causal, programs, "wgmma_f32")
    work = bwd_work(B, H, KH, S, causal, "wgmma_f32")
    for name, (starts, items) in sched.items():
        w = work[name]
        n = len(starts) - 1
        assert n == min(programs, len(w)) and starts[-1] == len(items)
        assert sorted(items) == list(range(len(w)))
        loads = [sum(w[i] for i in items[starts[p]:starts[p + 1]])
                 for p in range(n)]
        assert min(loads) > 0 and max(loads) <= sum(w) / n + max(w), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(1, 24, 8, 512), (4, 32, 32, 510),
                                   (1, 12, 2, 512), (1, 4, 2, 129)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_work_lists_certify(shape, causal):
    """The verifier certifies the f32 kind's lists against its own item
    counts, and finds an item dealt twice."""
    from repro_torch.verify import check_flash_bwd_work
    B, H, KH, S = shape
    assert not check_flash_bwd_work(B, H, KH, S, causal, 132,
                                    kind="wgmma_f32")
    sched = {k: (list(st), list(it)) for k, (st, it) in bwd_schedule(
        B, H, KH, S, causal, 132, "wgmma_f32").items()}
    starts, items = sched["dq"]
    items[-1] = items[0]
    codes = {f.code for f in check_flash_bwd_work(
        B, H, KH, S, causal, 132, sched, kind="wgmma_f32")}
    assert "work-dealt-twice" in codes
