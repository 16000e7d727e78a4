"""The port's static verifier (repro_torch.verify) on the CPU: the rules,
e-graph and schedule passes against the JAX package's on the 13 tile
programs, seeded defects that each pass must flag (after
tests/test_verify_mutation.py), the grid pass over every kind of Triton
launch plan at ragged shapes (after tests/test_grid_check.py), the
flash backward's work lists and the SSD launches at the train shapes,
and EGraph.check_invariants."""
import collections
import copy
import dataclasses
import re

import pytest
import torch

from repro_torch.core import (KernelProgram, SaturatorConfig, rmean, rsqrt,
                              saturate_program)
from repro_torch.core.egraph import EGraph, P, V, add_expr
from repro_torch.core.rules import PAPER_RULES, TPU_RULES, Rule, run_rules
from repro_torch.core.schedule import compute_schedule
from repro_torch.core.ssa import build_ssa
from repro_torch.core.tritongen import (MAX_GRID_YZ, FlatLayout,
                                        plan_tile_call)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
from repro_torch.verify import (check_compiled, check_flash_bwd_work,
                                check_generated, check_grid,
                                check_tile_plan, check_triton_source,
                                flash_attention_model, shapes_of,
                                ssd_scan_models, tile_call_model,
                                verify_persistent_walk, verify_rules,
                                verify_saturated, verify_schedule,
                                verify_tile_layout, verify_tile_op,
                                walk_blocks)

F32, BF16 = torch.float32, torch.bfloat16
A, B = V("a"), V("b")


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def _codes(findings):
    return sorted({f.code for f in _errors(findings)})


# -- rules, e-graph and schedule passes against the reference ---------------
def _by_pass(report, passes=("rules", "egraph", "schedule")):
    return {p: sorted(collections.Counter(
        (f.severity, f.code) for f in report.findings
        if f.pass_name == p).items()) for p in passes}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_full_verify_matches_the_reference(name):
    """At verify="full" (get_tile_op's configuration) a program gives no
    error, and the rules, e-graph and schedule passes report the same
    finding codes, as often, as the JAX package's verifier."""
    import repro.core as jcore
    from repro.kernels.tile_programs import PROGRAMS as JPROGRAMS
    from repro.verify import verify_saturated as jverify

    pcfg = SaturatorConfig(mode="accsat", cost_model="tpu_v5e",
                           tpu_rules=True)
    jcfg = jcore.SaturatorConfig(mode="accsat", cost_model="tpu_v5e",
                                 tpu_rules=True)
    got = verify_saturated(saturate_program(PROGRAMS[name](), pcfg), "full")
    want = jverify(jcore.saturate_program(JPROGRAMS[name](), jcfg), "full")
    assert not got.errors(), [str(f) for f in got.errors()]
    assert _by_pass(got) == _by_pass(want)
    assert got.rules_checked == want.rules_checked > 0
    assert got.schedules_certified == want.schedules_certified > 0


@pytest.mark.parametrize("emitter", ["triton", "triton_pipelined"])
def test_tile_ops_build_clean_under_full_verify(emitter):
    for name in sorted(PROGRAMS):
        op = get_tile_op(name, emitter=emitter, verify="full")
        assert op.verify == "full"
        assert not op.sk.verify_report.errors()
        rep = verify_tile_op(op)
        assert not rep.errors(), [str(f) for f in rep.errors()]
        assert rep.grids_checked == 1 and rep.sources_checked >= 1


# -- seeded defects: rules, order, torch source, e-graph ------------------------
def _rms_prog():
    p = KernelProgram("mut_rms")
    x = p.array_in("x", shape=(8, 128))
    g = p.array_in("g", shape=(1, 128))
    p.array_out("o", shape=(8, 128))
    eps = p.scalar("eps")
    xv = x.load()
    p.store("o", xv * rsqrt(rmean(xv * xv) + eps) * g.load())
    return p


def test_seeded_unsound_rule_is_the_only_finding():
    bad = Rule("BAD-MULDIV", P("mul", A, B), P("div", A, B))
    res = verify_rules(list(PAPER_RULES) + [bad] + list(TPU_RULES))
    assert [f.subject for f in _errors(res.findings)] == ["BAD-MULDIV"]


def test_seeded_illegal_order_and_dropped_unit_caught():
    sk = saturate_program(_rms_prog(), SaturatorConfig(mode="accsat"))
    sched = compute_schedule(sk.ssa, dict(sk.extraction.choice),
                             mode="source", move_budget=0)
    assert verify_schedule(sk.ssa, sk.extraction.choice, sched).ok
    caught = 0
    order = list(sched.regions[()].order)
    for i in range(len(order) - 1):
        mut = copy.deepcopy(sched)
        o = mut.regions[()].order
        o[i], o[i + 1] = o[i + 1], o[i]
        errs = _errors(verify_schedule(sk.ssa, sk.extraction.choice,
                                       mut).findings)
        if errs:
            assert [f.code for f in errs] == ["illegal-order"]
            caught += 1
    assert caught >= 1
    mut = copy.deepcopy(sched)
    mut.regions[()].order = mut.regions[()].order[:-1]
    assert [f.code for f in verify_schedule(
        sk.ssa, sk.extraction.choice, mut).findings] == ["not-a-permutation"]


def test_seeded_oob_index_in_the_torch_source_caught():
    p = KernelProgram("mut_oob")
    x = p.array_in("x", shape=(8, 128))
    p.array_out("o", shape=(8, 128))
    p.store("o", x[999, 0] + x.load())   # row 999 of an 8-row tile
    sk = saturate_program(p, SaturatorConfig(mode="accsat"))
    errs = _errors(check_generated(sk.kernel.source, shapes_of(p)))
    assert [f.code for f in errs] == ["oob-index"]
    assert "999" in errs[0].message and "extent 8" in errs[0].message
    clean = saturate_program(_rms_prog(), SaturatorConfig(mode="accsat"))
    assert not _errors(check_generated(clean.kernel.source,
                                       shapes_of(_rms_prog())))


def test_torch_source_lints_flag_their_defects():
    """use-before-def, an overwritten indexed store and a dead load."""
    src = ("import torch\n\n"
           "def _set(a, idx, val):\n    return a\n\n"
           "def k(x, o):\n"
           "    _v1 = x\n"
           "    _v2 = x[0, 1]\n"
           "    o_v_1 = _set(o, (0, 1), _v2)\n"
           "    o_v_2 = _set(o_v_1, (0, 1), _v2 + _v9)\n"
           "    return (o_v_2,)\n")
    codes = {f.code for f in check_generated(
        src, {"x": (8, 128), "o": (8, 128)})}
    assert {"use-before-def", "overwritten-store", "dead-load"} <= codes


def test_corrupted_union_find_caught():
    eg = EGraph()
    add_expr(eg, ("add", ("var", "a"), ("mul", ("var", "b"), ("var", "c"))))
    assert not _errors(eg.check_invariants())
    eg.uf.parent[0] = 1
    eg.uf.parent[1] = 0
    assert any(f.code == "uf-cycle" for f in eg.check_invariants())
    with pytest.raises(AssertionError):
        eg.check_invariants(strict=True)


def test_invariants_hold_after_run_rules_and_after_a_graft(tmp_path):
    from repro_torch.cache import choice_to_doc, graft_choice
    sk = saturate_program(PROGRAMS["layernorm"](), SaturatorConfig(
        mode="accsat", cost_model="tpu_v5e", tpu_rules=True))
    ssa = build_ssa(PROGRAMS["layernorm"]())
    run_rules(ssa.egraph, sk.config.rules())
    ssa.egraph.check_invariants(strict=True)
    doc, _ = choice_to_doc(sk.ssa.egraph, sk.extraction.choice,
                           sk.extraction.roots)
    fresh = build_ssa(PROGRAMS["layernorm"]())
    graft_choice(fresh.egraph, doc, fresh.roots())
    fresh.egraph.check_invariants(strict=True)


# -- seeded defects: Triton sources --------------------------------------------
def _layout_src(name, shapes, dtypes=None, emitter=None):
    tk = get_tile_op(name, emitter=emitter).tk
    plan = plan_tile_call(tk, shapes, dtypes or [F32] * len(shapes))
    return tk, plan, tk.render(*plan.layout)


def test_a_dropped_mask_is_flagged():
    tk, plan, src = _layout_src("rmsnorm", [(300, 3000), (3000,)])
    assert not _errors(check_triton_source(src, plan.layout))
    mut = src.replace(", mask=x_mask, other=0.0", "", 1)
    assert mut != src
    assert _codes(check_triton_source(mut, plan.layout)) == \
        ["unmasked-access"]
    # the flat plan's tail: a mask dropped outside the whole blocks
    tk, plan, src = _layout_src("swiglu", [(3, 1001), (3, 1001)])
    assert plan.flat is not None and plan.flat.tail
    assert not _errors(check_triton_source(src, plan.layout))
    cut = ", mask=_mask, other=0.0"
    tail = src.rindex(cut)               # a load of the tail block
    mut = src[:tail] + src[tail + len(cut):]
    assert _codes(check_triton_source(mut, plan.layout)) == \
        ["unmasked-access"]


def test_a_reduction_fill_that_is_not_neutral_is_flagged():
    tk, plan, src = _layout_src("softmax", [(64, 1000)])
    assert not plan.pieces
    assert not _errors(check_triton_source(src, plan.layout))
    # the max's masked lanes filled with 0 instead of -inf
    mut = src.replace('float("-inf")', "0.0")
    assert mut != src
    assert _codes(check_triton_source(mut, plan.layout)) == \
        ["reduction-fill"]
    # the where dropped: the max reads the load's other=0.0 directly
    mut = re.sub(r'tl\.max\(tl\.where\(_mask, (\w+), float\("-inf"\)\)',
                 r"tl.max(\1", src)
    assert mut != src
    assert _codes(check_triton_source(mut, plan.layout)) == \
        ["reduction-fill"]
    # ... and a sum over masked lanes with no fill at all
    mut = re.sub(r"tl\.sum\(tl\.where\(_mask, (\w+), 0\.0\)", r"tl.sum(\1",
                 src)
    assert mut != src
    assert _codes(check_triton_source(mut, plan.layout)) == \
        ["unmasked-reduction"]


def test_int32_offsets_past_2_31_are_flagged():
    tk = get_tile_op("adamw").tk
    rows, d = 262_144, 9216          # 2.4e9 elements
    shapes = [(rows, d)] * 4
    plan = plan_tile_call(tk, shapes, [F32] * 4)
    assert plan.flat.off64
    assert not _errors(check_tile_plan(tk, plan, shapes).findings)
    assert not _errors(check_triton_source(tk.render(*plan.layout),
                                           plan.layout))
    bad = dataclasses.replace(plan, flat=FlatLayout(plan.flat.tail, False))
    assert _codes(check_tile_plan(tk, bad, shapes).findings) == \
        ["int32-offset-overflow"]
    # the source of the int32 form, certified as the int64 layout
    assert _codes(check_triton_source(tk.render(*bad.layout),
                                      plan.layout)) == ["int32-offset"]


def test_a_skipped_block_is_flagged():
    tk = get_tile_op("rmsnorm").tk
    shapes = [(1000, 3072), (3072,)]
    plan = plan_tile_call(tk, shapes, [F32, F32])
    assert not _errors(check_tile_plan(tk, plan, shapes).findings)
    bad = dataclasses.replace(plan, grid=(plan.grid[0] - 1, plan.grid[1]))
    assert "grid-coverage-gap" in _codes(
        check_tile_plan(tk, bad, shapes).findings)
    # a persistent walk that skips one block
    walks = walk_blocks(4, 10)
    walks[2].remove(6)
    assert _codes(verify_persistent_walk("k", walks, 10)) == ["walk-gap"]


def test_overlapping_writes_are_flagged():
    tk = get_tile_op("rmsnorm").tk
    plan = plan_tile_call(tk, [(1000, 3072), (3072,)], [F32, F32])
    model = tile_call_model(tk, plan)
    w = model.writes[0]
    racy = dataclasses.replace(model, writes=(dataclasses.replace(
        w, index_map=lambda i, j: (i // 2, j)),))
    assert "grid-write-race" in _codes(check_grid(racy).findings)
    walks = walk_blocks(4, 10)
    walks[1].append(0)
    assert _codes(verify_persistent_walk("k", walks, 10)) == ["walk-revisit"]


def test_a_grid_y_over_the_limit_is_flagged():
    tk = get_tile_op("rotary").tk
    shapes = [(1, 2, 4096, 128), (1, 1, 4096, 128), (1, 1, 4096, 128)]
    plan = plan_tile_call(tk, shapes, [F32] * 3)
    assert not _errors(check_tile_plan(tk, plan, shapes).findings)
    bad = dataclasses.replace(plan, grid=(plan.grid[0], MAX_GRID_YZ + 1,
                                          plan.grid[2]))
    assert "grid-limit" in _codes(check_tile_plan(tk, bad, shapes).findings)


def test_a_flash_work_item_dealt_twice_is_flagged():
    from repro_torch.kernels.flash_attention import bwd_schedule
    sched = {k: (list(s), list(i)) for k, (s, i) in
             bwd_schedule(2, 24, 8, 4096, True, 132).items()}
    assert not check_flash_bwd_work(2, 24, 8, 4096, True, 132, sched)
    starts, items = sched["dq"]
    items[starts[1]] = items[starts[0]]      # program 1 repeats one item
    assert _codes(check_flash_bwd_work(2, 24, 8, 4096, True, 132,
                                       sched)) == ["work-dealt-twice",
                                                   "work-missing"]


def test_a_tile_too_wide_for_the_registers_is_flagged():
    tk = get_tile_op("layernorm", emitter="triton_pipelined").tk
    shapes = [(8192, 768), (768,), (768,)]
    plan = plan_tile_call(tk, shapes, [F32] * 3)
    assert plan.block_r * plan.block_d / (plan.num_warps * 32) == 96
    assert not _errors(check_tile_plan(tk, plan, shapes).findings)
    bad = dataclasses.replace(plan, num_warps=1)
    assert _codes(check_tile_plan(tk, bad, shapes).findings) == \
        ["register-fit"]


def test_compiled_metadata_limits():
    assert not check_compiled("k", 64, 0, 16384, 8)
    assert _codes(check_compiled("k", 256, 0, 0, 1)) == ["register-overflow"]
    assert _codes(check_compiled("k", 128, 0, 0, 32)) == \
        ["register-overflow"]       # 128 x 1024 threads > 65,536
    assert _codes(check_compiled("k", 32, 0, 300_000, 4)) == \
        ["smem-overflow"]
    assert [f.severity for f in check_compiled("k", 32, 3, 0, 4)] == \
        ["warning"]


# -- every plan kind at a ragged shape ----------------------------------------
GRID_CASES = {
    # name: (program, emitter, operand shapes, dtypes, expected kind)
    "row": ("rmsnorm", None, [(1001, 3072), (3072,)], [BF16, BF16],
            ("row", "bcast")),
    "row_masked_columns": ("layernorm", None, [(77, 1000), (1000,), (1000,)],
                           [F32] * 3, ("row", "bcast", "bcast")),
    "pieces_7168": ("rmsnorm", None, [(1001, 7168), (7168,)], [BF16] * 2,
                    ("row", "bcast")),
    "pieces_12288": ("rmsnorm", None, [(1001, 12288), (12288,)], [BF16] * 2,
                     ("row", "bcast")),
    "cycle": ("rotary", None, [(4, 24, 510, 128), (1, 1, 510, 128),
                               (1, 1, 510, 128)], [BF16] * 3,
              ("row", "cycle", "cycle")),
    "bcycle": ("rotary", None, [(4, 12, 512, 128), (4, 1, 512, 128),
                                (4, 1, 512, 128)], [BF16] * 3,
               ("row", "bcycle", "bcycle")),
    "bcast_rows": ("swiglu", None, [(5, 7, 300), (300,)], [F32] * 2,
                   ("row", "bcast")),
    "flat_tail": ("swiglu", None, [(2049, 9215), (2049, 9215)], [BF16] * 2,
                  ("row", "row")),
    "flat_persistent": ("adamw", "triton_pipelined",
                        [(3071, 9217)] * 4, [F32] * 4, ("row",) * 4),
    "row_persistent": ("rmsnorm", "triton_pipelined",
                       [(20001, 3072), (3072,)], [F32] * 2,
                       ("row", "bcast")),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_every_plan_kind_certifies_at_a_ragged_shape(case):
    name, emitter, shapes, dtypes, kinds = GRID_CASES[case]
    op = get_tile_op(name, emitter=emitter)
    plan = plan_tile_call(op.tk, shapes, dtypes)
    assert plan.kinds == kinds
    if case == "pieces_12288":
        assert plan.pieces == (8192, 4096)
    if case == "pieces_7168":
        assert not plan.pieces and plan.block_d == 8192
    if case.endswith("persistent"):
        assert plan.persistent
    if case.startswith("flat"):
        assert plan.flat is not None and plan.flat.tail
    rep = verify_tile_layout(op, plan, shapes)
    assert not rep.errors(), [str(f) for f in rep.errors()]
    assert rep.grids_checked == 1 and rep.sources_checked >= 1


def test_a_bcycle_read_past_its_tables_is_flagged():
    """qwen2-vl's per-batch tables (4, 1, 512, 128): a plan whose span
    were too small would read tables past the fourth."""
    tk = get_tile_op("rotary").tk
    shapes = [(4, 12, 512, 128), (4, 1, 512, 128), (4, 1, 512, 128)]
    plan = plan_tile_call(tk, shapes, [BF16] * 3)
    bad = dataclasses.replace(plan, spans=(0, 512, 512))
    assert "grid-oob-read" in _codes(
        check_tile_plan(tk, bad, shapes).findings)


# -- the CUDA kernels' launches ------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 24, 8, 4096, 128),   # minitron train
                                   (2, 32, 32, 4096, 80),   # zamba2 train
                                   (4, 48, 8, 510, 128)])   # dbrx, ragged
@pytest.mark.parametrize("causal", [True, False])
def test_flash_launches_certify(shape, causal):
    B, H, KH, S, D = shape
    for dtype in (BF16, F32):
        res = check_grid(flash_attention_model(B, H, KH, S, D, dtype,
                                               programs=132))
        assert not res.errors(), [str(f) for f in res.errors()]
    assert not check_flash_bwd_work(B, H, KH, S, causal, 132)


@pytest.mark.parametrize("shape", [(4, 24, 8, 512, 128),    # minitron
                                   (4, 96, 8, 512, 128),    # mistral-large
                                   (4, 56, 8, 510, 128),    # arctic, ragged
                                   (4, 12, 12, 512, 64),    # whisper
                                   (2, 12, 12, 4096, 64),   # whisper train
                                   (4, 32, 32, 512, 80),    # zamba2
                                   (2, 8, 2, 100, 32)])     # mma.sync
@pytest.mark.parametrize("programs", [132, 1 << 20])
def test_flash_fwd_launch_of_each_kind_certifies(shape, programs):
    """The bf16 forward's launch as its kind runs it: the wgmma kernel's
    128-row items as its persistent programs take them (132 programs, or
    a program an item) write each (b, h, query tile) once; the mma.sync
    kernel's (b·h, 64-row tile) grid likewise."""
    from repro_torch.kernels.flash_attention import FWD_BLOCK_M, fwd_kernel
    B, H, KH, S, D = shape
    kind = fwd_kernel(D, BF16)
    model = flash_attention_model(B, H, KH, S, D, BF16, programs=programs)
    assert model.writes[0].block_shape[2] == FWD_BLOCK_M[kind]
    assert len(model.grid) == (1 if kind == "wgmma" else 2)
    res = check_grid(model)
    assert not res.errors(), [str(f) for f in res.errors()]


@pytest.mark.parametrize("fault,code", [("twice", "grid-write-race"),
                                        ("missing", "grid-coverage-gap")])
def test_a_flash_fwd_work_list_fault_is_flagged(fault, code):
    """A forward order that deals one item to two programs is a write
    race; one that deals an item to no program is a coverage gap."""
    from repro_torch.kernels import flash_attention as fa
    starts, items = fa.fwd_schedule(2, 24, 4096, 132)
    bad = (starts, [items[1]] + items[1:]) if fault == "twice" else \
        (starts[:-1] + [starts[-1] - 1], items[:-1])
    orig = fa.fwd_schedule
    try:
        fa.fwd_schedule = lambda *a: bad
        model = flash_attention_model(2, 24, 8, 4096, 128, BF16,
                                      programs=132)
    finally:
        fa.fwd_schedule = orig
    assert code in _codes(check_grid(model).findings)


def test_a_flash_kv_head_out_of_range_is_flagged():
    model = flash_attention_model(1, 8, 2, 256, 64, programs=132)
    k = model.reads[1]
    bad = dataclasses.replace(model, reads=(model.reads[0], dataclasses.replace(
        k, index_map=lambda x, *_: (0, x % 8, 0, 0)), model.reads[2]))
    assert "grid-oob-read" in _codes(check_grid(bad).findings)


@pytest.mark.parametrize("shape", [(2, 4096, 64, 64, 128),   # mamba2 train
                                   (2, 4096, 80, 64, 64),    # zamba2 train
                                   (1, 300, 3, 8, 4)])       # ragged chunk
def test_ssd_launches_certify(shape):
    B, S, H, P, N = shape
    models, walk = ssd_scan_models(B, H, S, P, N, chunk=128)
    assert not walk
    names = {m.name for m in models}
    # the train widths take the wgmma launches both ways, the small shape
    # the mma.sync ones (kernels.ssd_scan.ssd_fwd_kind, ssd_bwd_kind)
    sm90 = "_sm90" if P == 64 else ""
    fwd = {"ssd_fwd_state_sm90_kernel", "ssd_fwd_pass_kernel",
           "ssd_fwd_out_sm90_kernel"} if P == 64 else {"ssd_scan_kernel"}
    assert {"ssd_cb_kernel", f"ssd_bwd_local{sm90}_kernel",
            f"ssd_bwd_dbdc{sm90}_kernel"} | fwd <= names
    for m in models:
        res = check_grid(m)
        assert not res.errors(), [str(f) for f in res.errors()]


@pytest.mark.parametrize("shape", [(2, 4096, 64, 64, 128),
                                   (2, 4096, 80, 64, 64)])
def test_ssd_launches_of_the_mma_sync_kind_certify(shape):
    """The train widths' other kind (what ssd_scan(kind="mma_sync") and
    ssd_scan_bwd(kind="mma_sync") launch, the yardsticks chip_smoke.py
    times in turns) certifies too."""
    B, S, H, P, N = shape
    models, walk = ssd_scan_models(B, H, S, P, N, chunk=128, kind="mma_sync")
    assert not walk
    assert {"ssd_scan_kernel", "ssd_bwd_local_kernel",
            "ssd_bwd_dbdc_kernel"} <= {m.name for m in models}
    for m in models:
        assert not check_grid(m).errors(), m.name


def test_an_ssd_grid_short_of_a_chunk_is_flagged():
    models, _ = ssd_scan_models(1, 3, 300, 8, 4, chunk=128)
    scan = next(m for m in models if m.name == "ssd_scan_kernel")
    bad = dataclasses.replace(scan, grid=(scan.grid[0], scan.grid[1] - 1))
    assert _codes(check_grid(bad).findings) == ["grid-coverage-gap"]
