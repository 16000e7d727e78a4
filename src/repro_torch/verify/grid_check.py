"""Launch-plan certification — the ``grid`` pass.

The port of the JAX package's grid pass, which certifies its Pallas
launch plans (BlockSpec index maps over a grid). Here a launch plan is
a Triton tile kernel's :class:`~repro_torch.core.tritongen.TileCallPlan`
or one launch of the hand-written CUDA kernels, turned into a
:class:`repro_torch.analysis.access.GridModel` (each program's block of
each operand) and certified statically:

* **coverage** — every output block is written by exactly one program
  (``grid-coverage-gap``); **disjointness** — no two programs write one
  block (``grid-write-race``);
* **bounds** — no program indexes a block outside an operand
  (``grid-oob-read`` / ``grid-oob-write``). Buffer shapes are the
  operands' own, unpadded: a ragged last block is masked, not padded,
  and counts as one block;
* **grid limits** — axis x at most 2^31 − 1 programs, y and z at most
  ``MAX_GRID_YZ`` (``grid-limit``);
* **offsets** — a flat plan takes int32 offsets only where every
  block's offsets fit (``int32-offset-overflow``), and its tail flag
  matches its element count (``flat-tail-mismatch``); column pieces
  cover the row exactly (``pieces-cover``);
* **persistent walks** — a persistent plan's programs visit every block
  once (:func:`repro_torch.verify.schedule_check.verify_persistent_walk`);
* **fit** (the counterpart of the VMEM pass) against ``H100_SXM``:
  statically, the elements a thread holds of one tile value at the
  plan's warps against :data:`FIT_ELEMS_PER_THREAD` (``register-fit``);
  on the card, :func:`check_compiled` reads a compiled kernel's
  registers, spills and shared memory.

The flash-attention forward's grid, its backward's work lists and the
SSD scan's launches are certified by :func:`flash_attention_model`,
:func:`check_flash_bwd_work` and :func:`ssd_scan_models`, from the
launch descriptions the kernel wrappers keep beside their sources
(``kernels.flash_attention.fwd_launch`` and ``bwd_schedule``,
``kernels.ssd_scan.launch_grids``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.access import (ENUM_LIMIT, BlockAccess, GridModel,
                                         IndexMapSummary, affine_bounds,
                                         eval_index, summarize_index_map)
from repro_torch.core.hardware import DEFAULT_CHIP
from .findings import PASS_GRID, Finding
from .schedule_check import verify_persistent_walk, walk_blocks

# Coverage lattices larger than this are not materialized even when the
# grid itself is enumerable (a sparse map over a huge buffer): the gap
# check degrades to the unprovable warning instead of an OOM.
_LATTICE_LIMIT = 4 * ENUM_LIMIT
# Corner-sampling cap for the non-enumerable, non-affine fallback.
_CORNER_LIMIT = 1 << 12
# CUDA's grid limits: axis x, and axes y and z
MAX_GRID_X = 2 ** 31 - 1
# The register budget of a tile kernel, stated for the static fit pass:
# a tile value of at most this many f32 elements a thread. More cannot
# stay in registers with a second live tile beside it (255 registers a
# thread); the widest plan on the paths holds 96 (the pipelined
# layernorm's 8 rows of 768 at 2 warps), most 8 to 48.
FIT_ELEMS_PER_THREAD = 128
# Hopper's limits for one thread block, read against a compiled kernel
MAX_REGS_PER_THREAD = 255
REGS_PER_SM = 65536


@dataclasses.dataclass
class GridCheckResult:
    """Findings + coverage facts of one grid certification."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    grids_checked: int = 1
    vmem_bytes: int = 0
    provable: bool = True     # False: fell back to sampling somewhere

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors()


def _f(sev: str, code: str, subject: str, msg: str) -> Finding:
    return Finding(PASS_GRID, sev, code, msg, subject)


def _oob_code(acc: BlockAccess) -> str:
    return "grid-oob-read" if acc.mode == "read" else "grid-oob-write"


def _fmt_env(env: Sequence[int]) -> str:
    return "(" + ", ".join(str(e) for e in env) + ")"


# ---------------------------------------------------------------------------
# Exhaustive certification (grids up to ENUM_LIMIT programs)
# ---------------------------------------------------------------------------
def _certify_enum(model: GridModel, acc: BlockAccess,
                  summ: IndexMapSummary,
                  envs: List[Tuple[int, ...]],
                  findings: List[Finding]) -> None:
    subject = f"{model.name}:{acc.array}"
    nb = acc.n_blocks()
    touch: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
    for env in envs:
        blk = eval_index(summ, env)
        if len(blk) != len(nb):
            findings.append(_f(
                "error", "grid-rank-mismatch", subject,
                f"index map returned rank {len(blk)} for a rank-"
                f"{len(nb)} operand"))
            return
        touch[env] = blk

    oob = [(env, blk) for env, blk in touch.items()
           if any(not (0 <= b < n) for b, n in zip(blk, nb))]
    if oob:
        env, blk = oob[0]
        findings.append(_f(
            "error", _oob_code(acc), subject,
            f"{len(oob)}/{len(envs)} grid instances index outside the "
            f"{nb} block lattice (e.g. instance {_fmt_env(env)} -> block "
            f"{blk}); buffer {acc.array_shape}, block {acc.block_shape}"))
        return   # bounds broke — coverage/race verdicts would only cascade
    if acc.mode == "read":
        return

    # inert axes: varying the axis never moves this write's footprint —
    # a legal revisit, not a race candidate
    n_axes = len(model.grid)
    inert = []
    for k in range(n_axes):
        base = {env: touch[env[:k] + (0,) + env[k + 1:]] for env in envs}
        if all(touch[env] == base[env] for env in envs):
            inert.append(k)
    used = [k for k in range(n_axes) if k not in inert]

    seen: Dict[Tuple[int, ...], Tuple[int, ...]] = {}   # block -> eff env
    races = []
    for env in envs:
        eff = tuple(env[k] for k in used)
        blk = touch[env]
        prev = seen.get(blk)
        if prev is None:
            seen[blk] = eff
        elif prev != eff:
            races.append((prev, eff, blk))
    if races:
        a, b, blk = races[0]
        findings.append(_f(
            "error", "grid-write-race", subject,
            f"{len(races)} write-write collision(s) across grid "
            f"instances (e.g. instances {_fmt_env(a)} and {_fmt_env(b)} "
            f"of the non-inert axes {used} both write block {blk})"))
        return   # the colliding map also double-covers; don't double-report

    lattice = math.prod(nb)
    if lattice > _LATTICE_LIMIT:
        findings.append(_f(
            "warning", "grid-unprovable", subject,
            f"coverage lattice {nb} too large to materialize "
            f"({lattice} blocks > {_LATTICE_LIMIT}); gap check skipped"))
        return
    missing = [blk for blk in itertools.product(*[range(n) for n in nb])
               if blk not in seen]
    if missing:
        findings.append(_f(
            "error", "grid-coverage-gap", subject,
            f"{len(missing)}/{lattice} output block(s) written by no "
            f"grid instance (e.g. block {missing[0]}); grid "
            f"{model.grid}, block {acc.block_shape}, buffer "
            f"{acc.array_shape}"))


# ---------------------------------------------------------------------------
# Affine certification (grids too large to enumerate)
# ---------------------------------------------------------------------------
def _certify_affine(model: GridModel, acc: BlockAccess,
                    summ: IndexMapSummary,
                    findings: List[Finding]) -> bool:
    """True when the access was fully certified without enumeration."""
    if not summ.fully_affine:
        return False
    subject = f"{model.name}:{acc.array}"
    nb = acc.n_blocks()
    dims = summ.dims or []
    if len(dims) != len(nb):
        findings.append(_f(
            "error", "grid-rank-mismatch", subject,
            f"index map returns rank {len(dims)} for a rank-{len(nb)} "
            "operand"))
        return True
    oob_dims = []
    for j, (sym, n) in enumerate(zip(dims, nb)):
        lo, hi = affine_bounds(sym, model.grid)
        if lo < 0 or hi >= n:
            oob_dims.append((j, lo, hi, n))
    if oob_dims:
        j, lo, hi, n = oob_dims[0]
        findings.append(_f(
            "error", _oob_code(acc), subject,
            f"affine block index range [{lo}, {hi}] escapes "
            f"[0, {n}) along dim {j} (block lattice {nb})"))
        return True
    if acc.mode == "read":
        return True

    # bijection proof for the write: each non-inert grid axis must drive
    # exactly one output dim with unit coefficient and zero offset, each
    # output dim at most one axis, and extents must match — then the map
    # is a coordinate embedding: injective (no race) and surjective onto
    # the lattice (no gap)
    used_axes = sorted({k for sym in dims
                        for k, c in enumerate(sym.affine[0]) if c})
    axis_dims: Dict[int, int] = {}
    ok = True
    for j, sym in enumerate(dims):
        coeffs, const = sym.affine
        nz = [(k, c) for k, c in enumerate(coeffs) if c]
        if len(nz) > 1:
            ok = False
            break
        if not nz:
            if const != 0 or nb[j] != 1:
                ok = False
                break
            continue
        k, c = nz[0]
        if c != 1 or const != 0 or k in axis_dims \
                or model.grid[k] != nb[j]:
            ok = False
            break
        axis_dims[k] = j
    if ok and sorted(axis_dims) == used_axes:
        return True
    findings.append(_f(
        "warning", "grid-unprovable", subject,
        f"write map over {model.n_instances} instances is affine but "
        "not a unit coordinate embedding; coverage/disjointness not "
        "proven (bounds were)"))
    return True


def _corner_envs(grid: Sequence[int]) -> List[Tuple[int, ...]]:
    corners = itertools.product(*[(0, g - 1) if g > 1 else (0,)
                                  for g in grid])
    return list(itertools.islice(corners, _CORNER_LIMIT))


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------
def check_grid(model: GridModel, chip=DEFAULT_CHIP) -> GridCheckResult:
    """Certify one launch; see the module docstring for the verdicts.
    Error severities fail a verified build; warnings mark the
    unprovable remainder. ``model.scratch_bytes`` is the launch's shared
    memory a block, held against the chip's."""
    findings: List[Finding] = []
    provable = True
    n_axes = len(model.grid)
    limits = (MAX_GRID_X,) + (_max_grid_yz(),) * 2
    if n_axes > 3 or any(g > lim for g, lim in zip(model.grid, limits)):
        findings.append(_f(
            "error", "grid-limit", model.name,
            f"grid {model.grid} exceeds CUDA's limits (x <= {MAX_GRID_X}, "
            f"y and z <= {limits[1]}, at most 3 axes)"))
    summaries = [(acc, summarize_index_map(acc.index_map, n_axes))
                 for acc in model.reads + model.writes]
    if model.n_instances <= ENUM_LIMIT:
        envs = list(model.instances())
        for acc, summ in summaries:
            _certify_enum(model, acc, summ, envs, findings)
    else:
        for acc, summ in summaries:
            if _certify_affine(model, acc, summ, findings):
                continue
            provable = False
            subject = f"{model.name}:{acc.array}"
            nb = acc.n_blocks()
            bad = []
            for env in _corner_envs(model.grid):
                try:
                    blk = eval_index(summ, env)
                except Exception:
                    continue
                if len(blk) == len(nb) and any(
                        not (0 <= b < n) for b, n in zip(blk, nb)):
                    bad.append((env, blk))
            if bad:
                env, blk = bad[0]
                findings.append(_f(
                    "error", _oob_code(acc), subject,
                    f"corner sample: instance {_fmt_env(env)} indexes "
                    f"block {blk} outside lattice {nb}"))
            findings.append(_f(
                "warning", "grid-unprovable", subject,
                f"non-affine index map over {model.n_instances} "
                f"instances (> {ENUM_LIMIT}): certified at grid-box "
                "corners only"))
    provable = provable and not any(f.code == "grid-unprovable"
                                    for f in findings)
    if model.scratch_bytes > chip.smem_bytes:
        findings.append(_f(
            "error", "grid-smem-overflow", model.name,
            f"shared memory {model.scratch_bytes} B a block exceeds the "
            f"{chip.smem_bytes} B a block may have"))
    return GridCheckResult(findings=findings, grids_checked=1,
                           vmem_bytes=model.vmem_bytes, provable=provable)


def _max_grid_yz() -> int:
    from repro_torch.core.tritongen import MAX_GRID_YZ
    return MAX_GRID_YZ


# ---------------------------------------------------------------------------
# Tile kernels: a TileCallPlan as a GridModel
# ---------------------------------------------------------------------------
def _rows_of(shape: Sequence[int]) -> int:
    return math.prod(shape[:-1]) if len(shape) > 1 else 1


def tile_call_model(tk, plan, in_shapes: Optional[Sequence[Sequence[int]]]
                    = None, name: Optional[str] = None) -> GridModel:
    """One :class:`~repro_torch.core.tritongen.TileCallPlan` as a
    :class:`GridModel` over its work items: one program a block, or, for
    a persistent plan, the blocks its walk takes (linearised as the
    kernel linearises them; :func:`check_tile_plan` certifies the walk).

    ``in_shapes`` are the operands' shapes (by default what the plan
    implies: the lead's rows, a cycle operand's period, a bcycle
    operand's ``rows // span`` tables). Each kind reads its own rows:

    * ``row`` — the block's rows; ``bcast`` — the one row;
    * ``cycle`` — row ``position % period`` (block ``(p * block_r %
      period) // block_r``: the modulo keeps every row of the table in
      range);
    * ``bcycle`` — table ``row // span``, at row ``position % period``;
    * ``flat`` — the operands as one stream of ``rows * d`` elements.

    Outputs are ``(rows, d)``; a cycle layout sees them as
    ``(groups, n_pos, d)``, with the groups the lead's rows allow."""
    name = name or tk.name
    rows, d, br, bd = plan.rows, plan.d, plan.block_r, plan.block_d
    shapes = [tuple(s) for s in in_shapes] if in_shapes is not None \
        else None
    if plan.flat is not None:
        n = rows * d

        def flat(arr, mode, shp=None):
            size = math.prod(shp) if shp is not None else n
            return BlockAccess(arr, mode, (bd,), (size,), lambda i: (i,))
        reads = tuple(flat(a, "read", shapes[k] if shapes else None)
                      for k, a in enumerate(tk.in_arrays))
        writes = tuple(flat(o, "write") for o in tk.out_arrays)
        return GridModel(name, (plan.n_blocks,), reads, writes)

    from repro_torch.core.tritongen import _by_position
    if _by_position(plan.kinds):
        groups = -(-rows // plan.n_pos)
        grid = plan.grid

        def table(k, kind, period):
            if shapes is not None:
                trows = _rows_of(shapes[k])
            elif kind == "bcycle":
                trows = rows // plan.spans[k] * period
            else:
                trows = period
            return trows

        reads = []
        for k, (a, kind, period) in enumerate(zip(tk.in_arrays, plan.kinds,
                                                  plan.periods)):
            if kind == "row":
                reads.append(BlockAccess(
                    a, "read", (1, br, bd), (groups, plan.n_pos, d),
                    lambda g, p, c: (g, p, c)))
            elif kind == "bcast":
                reads.append(BlockAccess(a, "read", (1, bd), (1, d),
                                         lambda g, p, c: (0, c)))
            elif kind == "cycle":
                reads.append(BlockAccess(
                    a, "read", (br, bd), (table(k, kind, period), d),
                    lambda g, p, c, _t=period: ((p * br % _t) // br, c)))
            else:   # bcycle: (tables, period, d)
                span, n_pos = plan.spans[k], plan.n_pos
                reads.append(BlockAccess(
                    a, "read", (1, br, bd),
                    (-(-table(k, kind, period) // period), period, d),
                    lambda g, p, c, _t=period, _s=span: (
                        (g * n_pos + p * br) // _s, (p * br % _t) // br, c)))
        writes = tuple(BlockAccess(o, "write", (1, br, bd),
                                   (groups, plan.n_pos, d),
                                   lambda g, p, c: (g, p, c))
                       for o in tk.out_arrays)
        return GridModel(name, grid, tuple(reads), writes)

    n_cb = -(-d // bd)
    if plan.persistent:
        grid = (plan.n_blocks,)

        def at(b):
            return b // n_cb, b % n_cb
    else:
        grid = plan.grid

        def at(i, j):
            return i, j
    reads = []
    for k, (a, kind) in enumerate(zip(tk.in_arrays, plan.kinds)):
        if kind == "bcast":
            reads.append(BlockAccess(a, "read", (1, bd), (1, d),
                                     lambda *g: (0, at(*g)[1])))
        else:
            trows = _rows_of(shapes[k]) if shapes is not None else rows
            reads.append(BlockAccess(a, "read", (br, bd), (trows, d), at))
    writes = tuple(BlockAccess(o, "write", (br, bd), (rows, d), at)
                   for o in tk.out_arrays)
    return GridModel(name, grid, tuple(reads), writes)


def check_tile_plan(tk, plan, in_shapes: Optional[Sequence[Sequence[int]]]
                    = None, name: Optional[str] = None,
                    chip=DEFAULT_CHIP) -> GridCheckResult:
    """Certify one tile-kernel launch: :func:`check_grid` over
    :func:`tile_call_model`, plus what the model cannot see — the
    launch grid against the work items (a sync plan launches one
    program a block; a persistent plan's walk visits each once), the
    column pieces, the flat plan's tail and offset width, and the
    static register fit."""
    from repro_torch.core.tritongen import _INT32_LIMIT, _by_position
    name = name or tk.name
    res = check_grid(tile_call_model(tk, plan, in_shapes, name), chip)
    out = res.findings
    if plan.flat is not None:
        n = plan.rows * plan.d
        whole = n // plan.block_d
        if plan.flat.tail != (n % plan.block_d != 0):
            out.append(_f("error", "flat-tail-mismatch", name,
                          f"tail={plan.flat.tail} for {n} elements in "
                          f"blocks of {plan.block_d}"))
        if not plan.flat.off64 and plan.n_blocks * plan.block_d \
                > _INT32_LIMIT:
            out.append(_f("error", "int32-offset-overflow", name,
                          f"int32 offsets over {plan.n_blocks} blocks of "
                          f"{plan.block_d}: the last block's offsets pass "
                          f"2^31"))
        if plan.persistent:
            out += _walk(name, plan.grid, whole, plan.flat.tail,
                         plan.n_blocks)
        elif plan.grid != (plan.n_blocks,):
            out.append(_f("error", "grid-coverage-gap", name,
                          f"grid {plan.grid} launches another count of "
                          f"programs than the {plan.n_blocks} blocks"))
    elif plan.persistent:
        out += _walk(name, plan.grid, plan.n_blocks, False, plan.n_blocks)
    elif not _by_position(plan.kinds) and plan.grid != (
            -(-plan.rows // plan.block_r), -(-plan.d // plan.block_d)):
        out.append(_f("error", "grid-coverage-gap", name,
                      f"grid {plan.grid} is not one program a "
                      f"({plan.block_r}, {plan.block_d}) block of "
                      f"({plan.rows}, {plan.d})"))
    if _by_position(plan.kinds) and plan.rows % plan.n_pos:
        out.append(_f("error", "grid-coverage-gap", name,
                      f"{plan.rows} rows are not whole groups of "
                      f"{plan.n_pos} positions"))
    if plan.pieces and (sum(plan.pieces) != plan.d
                        or plan.block_d != plan.d
                        or any(p & (p - 1) for p in plan.pieces)):
        out.append(_f("error", "pieces-cover", name,
                      f"pieces {plan.pieces} do not cover a row of "
                      f"{plan.d} in powers of two"))
    per_thread = plan.block_r * plan.block_d / (plan.num_warps * 32)
    if per_thread > FIT_ELEMS_PER_THREAD:
        out.append(_f("error", "register-fit", name,
                      f"a ({plan.block_r}, {plan.block_d}) tile at "
                      f"{plan.num_warps} warps holds {per_thread:g} "
                      f"elements a thread, over the "
                      f"{FIT_ELEMS_PER_THREAD} budgeted"))
    return res


def _walk(name, grid, n_walked, tail, n_blocks) -> List[Finding]:
    if len(grid) != 1:
        return [_f("error", "grid-limit", name,
                   f"a persistent launch takes one grid axis, got {grid}")]
    return verify_persistent_walk(name, walk_blocks(grid[0], n_walked,
                                                    tail), n_blocks)


def _declared_bcast(spec) -> bool:
    shape = getattr(spec, "shape", None)
    if not shape or any(s is None for s in shape):
        return False
    return math.prod(shape[:-1]) == 1 if len(shape) > 1 else True


def tile_input_shapes(tk, prog, rows: int, d: int) -> List[Tuple[int, ...]]:
    """Synthetic operand shapes for one audit configuration: row-tiled
    arrays get ``(rows, d)``, declared broadcast rows ``(1, d)``."""
    return [(1, d) if prog is not None and _declared_bcast(
        prog.arrays.get(a)) else (rows, d) for a in tk.in_arrays]


def check_tile_op(op, rows: Optional[int] = None, d: Optional[int] = None,
                  chip=DEFAULT_CHIP) -> Tuple[GridCheckResult, object]:
    """Certify one :class:`~repro_torch.core.tritongen.TileOp`'s plan at
    a synthetic ragged geometry, as the JAX package certifies its tile
    ops when they are built: ``d`` the declared feature width (256 when
    none is declared), ``rows`` two and a half row blocks of the plan at
    that width. Returns the result and the plan."""
    import numpy as np

    from repro_torch.core.tritongen import plan_tile_call
    tk = op.tk
    prog = op.sk.ssa.prog if getattr(op, "sk", None) is not None \
        and op.sk.ssa is not None else None
    if d is None:
        dims = [s.shape[-1] for s in (prog.arrays.values() if prog else ())
                if s.shape and s.shape[-1] is not None]
        d = max(dims) if dims else 256
    dt = [np.dtype(np.float32)] * len(tk.in_arrays)
    if rows is None:
        br = plan_tile_call(tk, tile_input_shapes(tk, prog, 4096, d),
                            dt).block_r
        rows = 2 * br + max(1, br // 2)   # a ragged last row block
    shapes = tile_input_shapes(tk, prog, rows, d)
    plan = plan_tile_call(tk, shapes, dt)
    return check_tile_plan(tk, plan, shapes, chip=chip), plan


def check_compiled(name: str, n_regs: Optional[int],
                   n_spills: Optional[int], shared_bytes: Optional[int],
                   num_warps: int, chip=DEFAULT_CHIP) -> List[Finding]:
    """The fit of one compiled kernel on the card, from its metadata
    (Triton's ``n_regs``, ``n_spills`` and ``metadata.shared``):
    registers over 255 a thread, or over the SM's 65,536 for the block's
    threads, and shared memory over the chip's block limit are errors;
    spills are a warning. A field Triton did not report is not judged."""
    out: List[Finding] = []
    threads = num_warps * 32
    if n_regs is not None:
        if n_regs > MAX_REGS_PER_THREAD:
            out.append(_f("error", "register-overflow", name,
                          f"{n_regs} registers a thread, over "
                          f"{MAX_REGS_PER_THREAD}"))
        if n_regs * threads > REGS_PER_SM:
            out.append(_f("error", "register-overflow", name,
                          f"{n_regs} registers x {threads} threads = "
                          f"{n_regs * threads}, over an SM's "
                          f"{REGS_PER_SM}"))
    if shared_bytes is not None and shared_bytes > chip.smem_bytes:
        out.append(_f("error", "smem-overflow", name,
                      f"{shared_bytes} B of shared memory, over the "
                      f"{chip.smem_bytes} B a block may have"))
    if n_spills:
        out.append(_f("warning", "register-spill", name,
                      f"{n_spills} spilled registers"))
    return out


# ---------------------------------------------------------------------------
# The hand-written CUDA kernels
# ---------------------------------------------------------------------------
def flash_attention_model(B: int, H: int, KH: int, S: int, D: int,
                          dtype=None, *, programs: int) -> GridModel:
    """The flash-attention forward launch as a checkable model, from
    :func:`repro_torch.kernels.flash_attention.fwd_launch` for the kernel
    the dtype and head_dim pick: each block (for the wgmma kernel, each
    work item its ``programs`` persistent programs take) reads its query
    tile and its kv head's k and v, and writes its output tile; the kv
    head must lie in ``[0, KH)``. Coverage and disjointness then certify
    that the programs take every (b, h, query tile) exactly once."""
    import torch

    from repro_torch.kernels.flash_attention import (FWD_BLOCK_M,
                                                     fwd_kernel, fwd_launch)
    dtype = dtype or torch.bfloat16
    grid, item = fwd_launch(B, H, KH, S, D, dtype, programs)

    def tile(*c):
        b, h, t, _ = item(*c)
        return b, h, t, 0

    def kv(*c):
        b, _, _, kh = item(*c)
        return b, kh, 0, 0
    q_blk = (1, 1, FWD_BLOCK_M[fwd_kernel(D, dtype)], D)
    reads = (BlockAccess("q", "read", q_blk, (B, H, S, D), tile),
             BlockAccess("k", "read", (1, 1, S, D), (B, KH, S, D), kv),
             BlockAccess("v", "read", (1, 1, S, D), (B, KH, S, D), kv))
    writes = (BlockAccess("o", "write", q_blk, (B, H, S, D), tile),)
    return GridModel("flash_attention", grid, reads, writes)


def check_flash_bwd_work(B: int, H: int, KH: int, S: int, causal: bool,
                         programs: int, schedule=None,
                         kind: str = "wgmma") -> List[Finding]:
    """Certify a wgmma flash backward kind's work lists
    (``bwd_schedule`` of ``kind``: ``"wgmma"``, bf16, or ``"wgmma_f32"``,
    f32; or a given ``schedule`` of the same form): each
    launch's lists are well formed (``starts`` from 0, non-decreasing,
    ending at the item count, at most ``programs`` programs), deal every
    work item exactly once, and each item's heads are in range (a dk/dv
    item's kv head and its group's query heads, a dq item's query head
    and its kv head ``h // group``)."""
    from repro_torch.kernels.flash_attention import BWD_ROWS, bwd_schedule
    sched = schedule if schedule is not None else \
        bwd_schedule(B, H, KH, S, causal, programs, kind)
    group = H // KH
    kv_item, _, q_item, _ = BWD_ROWS[kind]
    n_tiles = {"dkdv": -(-S // kv_item), "dq": -(-S // q_item)}
    heads = {"dkdv": B * KH, "dq": B * H}
    out: List[Finding] = []
    for launch in ("dkdv", "dq"):
        subject = f"flash_attention_bwd:{launch}"
        starts, items = sched[launch]
        n = heads[launch] * n_tiles[launch]
        if (not starts or starts[0] != 0 or starts[-1] != len(items)
                or any(a > b for a, b in zip(starts, starts[1:]))
                or len(starts) - 1 > programs):
            out.append(_f("error", "work-list-malformed", subject,
                          f"starts {starts[:4]}... over {len(items)} items "
                          f"and {programs} programs"))
            continue
        seen: Dict[int, int] = {}
        for p in range(len(starts) - 1):
            for i in items[starts[p]:starts[p + 1]]:
                if not 0 <= i < n:
                    out.append(_f("error", "work-out-of-range", subject,
                                  f"program {p} takes item {i} of {n}"))
                    continue
                if i in seen:
                    out.append(_f("error", "work-dealt-twice", subject,
                                  f"item {i} is dealt to program {seen[i]} "
                                  f"and to program {p}"))
                seen[i] = p
                bh = i // n_tiles[launch]
                if launch == "dkdv":
                    kh = bh % KH
                    hs = [kh * group + j for j in range(group)]
                else:
                    hs = [bh % H]
                    kh = hs[0] // group
                if not (0 <= kh < KH and all(0 <= h < H for h in hs)):
                    out.append(_f("error", "kv-head-out-of-range", subject,
                                  f"item {i}: kv head {kh} of {KH}, query "
                                  f"heads {hs[0]}..{hs[-1]} of {H}"))
        missing = n - len(seen)
        if missing > 0:
            out.append(_f("error", "work-missing", subject,
                          f"{missing} of {n} items dealt to no program"))
    return out


def ssd_scan_models(B: int, H: int, S: int, P: int, N: int,
                    chunk: int = 128, sms: int = 132, kind=None
                    ) -> Tuple[List[GridModel], List[Finding]]:
    """The SSD scan's launches (forward and backward of ``kind``, default
    each direction's: the wrapper's ``ssd_fwd_kind`` at B·H and
    ``ssd_bwd_kind``) as
    checkable models, from :func:`repro_torch.kernels.ssd_scan.launch_grids`:
    each launch's blocks cover its work once, (b·h, chunk) for the
    mma_sync scan, (b, chunk, group of heads) for the wgmma forward's state
    and output launches. The persistent chunk kernel's walk is certified
    directly (the findings returned beside the models)."""
    from repro_torch.kernels.ssd_scan import (SSD_CB_TILE, SSD_DBDC_TILE,
                                              SSD_LOCAL_GROUP, SSD_OUT_GROUP,
                                              SSD_THREADS, launch_grids)
    L = min(chunk, S)
    n_chunks = -(-S // L)
    g = launch_grids(B, S, H, P, N, chunk, sms, kind)
    models = []

    def one(name, out_shape, block, item=None):
        grid, it = g[name]
        models.append(GridModel(name, grid, (), (BlockAccess(
            "out", "write", block, out_shape, item or it),)))

    one("ssd_cb_kernel", (B, n_chunks, L, L), (1, 1) + SSD_CB_TILE)
    if "ssd_scan_kernel" in g:
        one("ssd_scan_kernel", (B, H, n_chunks), (1, 1, 1))
    else:
        # the wgmma forward: a group of heads a block, every chunk; the
        # passing elementwise over (b, h, N x P)
        one("ssd_fwd_state_sm90_kernel", (B, n_chunks, H),
            (1, 1, SSD_LOCAL_GROUP))
        one("ssd_fwd_pass_kernel", (B * H * N * P,), (SSD_THREADS,))
        one("ssd_fwd_out_sm90_kernel", (B, n_chunks, H),
            (1, 1, SSD_OUT_GROUP))
    one("ssd_bwd_pass_kernel", (B * H * N * P,), (SSD_THREADS,))
    one("ssd_bwd_reduce_kernel", (H,), (SSD_THREADS,))
    if "ssd_bwd_dbdc_sm90_kernel" in g:
        # the per-head vectors of every chunk, a group of heads a block
        one("ssd_bwd_local_sm90_kernel", (B, n_chunks, H),
            (1, 1, SSD_LOCAL_GROUP))
        # a warp a (b, chunk, h)
        one("ssd_bwd_finish_kernel", (B * n_chunks * H,),
            (SSD_THREADS // 32,))
        _, dbdc = g["ssd_bwd_dbdc_sm90_kernel"]
        one("ssd_bwd_dbdc_sm90_kernel", (B, n_chunks, 2, L, N),
            (1, 1, 1, L, N), lambda x: dbdc(x) + (0, 0))
        chunk_kernel = "ssd_bwd_chunk_sm90_kernel"
    else:
        one("ssd_bwd_dbdc_kernel", (B, n_chunks, 2, L, N), (1, 1, 1)
            + SSD_DBDC_TILE)
        if "ssd_bwd_local_kernel" in g:
            one("ssd_bwd_local_kernel", (B, n_chunks - 1, H), (1, 1, 1))
        chunk_kernel = "ssd_bwd_chunk_kernel"
    items, programs = g[chunk_kernel]
    walk = verify_persistent_walk(chunk_kernel, walk_blocks(programs, items),
                                  items)
    return models, walk
