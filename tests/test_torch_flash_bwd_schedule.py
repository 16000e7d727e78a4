"""The flash backward's host side on the CPU: the head_dim dispatch
between its wgmma and mma.sync kernels, and the work lists that the
wgmma kernels' persistent grids walk (``bwd_work``, ``bwd_schedule``).
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    _BWD, BWD_KV_ITEM, BWD_Q_ITEM, HEAD_DIMS, WGMMA_BWD_HEAD_DIMS,
    bwd_kernel, bwd_schedule, bwd_work)

SHAPES = [  # (B, H, KH, S): the train path, qwen2-vl's group of 6, edges
    (2, 24, 8, 4096), (2, 12, 2, 4096), (1, 4, 2, 1), (1, 4, 2, 127),
    (1, 4, 2, 128), (1, 4, 2, 129), (2, 6, 2, 1000), (1, 4, 4, 257),
    (3, 8, 1, 640)]


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_head_dim_dispatch(D):
    """bf16 at head_dim 64, 80 and 128 takes the wgmma kernels, 16 and 32
    the mma.sync ones; f32 the CUDA-core kernels at every head_dim."""
    want = "wgmma" if D in (64, 80, 128) else "mma_sync"
    assert bwd_kernel(D, torch.bfloat16) == want
    assert bwd_kernel(D, torch.float32) == "cuda_cores"
    assert (D in WGMMA_BWD_HEAD_DIMS) == (want == "wgmma")


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
