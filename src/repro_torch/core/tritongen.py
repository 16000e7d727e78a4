"""Hopper tile kernels for saturated tile programs, emitted as Triton.

Replaces the TPU tile kernel of the JAX package: the Pallas body that
``repro.core.pallasgen.SyncPallasGenerator.generate_pallas`` emits and
``_apply_tile_op`` launches over the row grid of ``plan_tile_call``.

A *tile program* is a straight-line :class:`KernelProgram` over whole
tiles: every load and store is un-indexed. The generator reuses the
scheduler of :class:`repro_torch.core.torchgen.TorchCodeGenerator`
(bulk load included) but emits the body of one ``@triton.jit`` kernel.
One program instance owns ``BLOCK_R`` rows × ``BLOCK_D`` columns of the
``(rows, d)`` view of the operands, masked on both edges:

* whole-tile loads become masked ``tl.load``s converted to f32, in the
  schedule's order — in bulk mode every load precedes the first compute;
* an operand that :func:`plan_tile_call` calls a broadcast row is loaded
  once per program, at column offsets only; a ``cycle`` operand (the
  port's addition: an operand that broadcasts over the lead's leading
  axes, such as RoPE's cos/sin against ``(B, H, S, hd)`` queries) reads
  row ``r % period``, so it is never materialised at the lead's size;
* ``rsum``/``rmean``/``rmax`` mask at the reduction (neutral 0, or −inf
  for the max) and ``rmean`` divides by the true ``d``;
* ``rothalf`` of a loaded input, its only use in the programs, is a
  second load at column ``(c + d/2) % d`` with sign −1 on the first half;
* ``fma`` is ``tl.fma``; all compute is f32 and stores cast to the
  output's dtype (the lead operand's, as in the Pallas call).

What bounds it on the H100: every instance is a streaming pass with at
most a last-axis reduction, so bytes (each input read once, each output
written once over 3.35 TB/s) bound it, not operations. The design keeps
the traffic at that minimum: one pass over each operand, broadcast rows
read once per program, no intermediate in device memory. Programs with a
reduction hold a whole row per program (``BLOCK_D = next_pow2(d)``);
the others also tile columns, so a wide ``d`` (9216 for swiglu) does not
waste masked lanes up to the next power of two.

The ``"triton_pipelined"`` emitter (:class:`TritonPipelinedGenerator`)
replaces the TPU's pipelined tile kernel, ``PipelinedPallasGenerator``
with the scratch-buffer and DMA-semaphore branch of ``_apply_tile_op``:
there every whole-tile input load is an async copy started at its
scheduled slot and waited on at its first consumer, two semaphores
alternating. On Hopper the same overlap is a persistent kernel: a grid
of at most :data:`PROGRAMS_PER_SM` programs per SM, each walking its
blocks in ``tl.range(..., num_stages=2)``, so Triton's software pipeliner
keeps the loads of the next block in flight while this one computes. The
loop body is the sync kernel's, under the same extraction and an
explicit schedule, with loads issued in the schedule's order; the sync
kernel generated under that schedule is kept beside it as its twin.

The source is generated once per program and compiled by Triton at the
first launch for each operand layout; ``triton`` is imported only there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime import chaos

from .dsl import KernelProgram
from .extract import ExtractionResult
from .hardware import H100_SXM
from .pipeline import SaturatorConfig, saturate_program
from .schedule import compute_schedule
from .ssa import LoopRegion, Region, SSAResult, StoreEffect
from .torchgen import GenStats, TorchCodeGenerator

# Where generated kernels are written for Triton to import (it reads a
# jitted function's source back from its file). Listed in .gitignore.
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "triton")

# Register budget of one program instance: at most this many elements in
# a (BLOCK_R, BLOCK_D) tile, so a few live f32 tiles stay in registers
# (the counterpart of the TPU's VMEM-sized row block).
TILE_ELEMS_BUDGET = 8192
# Column tile of programs without a reduction.
MAX_BLOCK_D_NO_REDUCE = 1024
# Persistent (pipelined) kernels: programs launched per SM, and the
# depth of Triton's software pipeline over a program's blocks (a double
# buffer, as the TPU kernel's two alternating DMA semaphores).
PROGRAMS_PER_SM = 4
NUM_STAGES = 2

_REDUCTIONS = ("rsum", "rmean", "rmax")

_UNARY_FMT = {
    "neg": "(-{0})",
    "exp": "tl.exp({0})",
    "log": "tl.log({0})",
    "sqrt": "tl.sqrt({0})",
    "rsqrt": "tl.rsqrt({0})",
    # tanh through exp keeps the kernel off version-dependent libdevice
    # module paths; saturates to ±1 for large |x|
    "tanh": "(1.0 - 2.0 / (tl.exp(2.0 * {0}) + 1.0))",
    "abs": "tl.abs({0})",
    "sigmoid": "tl.sigmoid({0})",
    "recip": "(1.0 / {0})",
    "floor": "tl.floor({0})",
    "square": "({0} * {0})",
    "rsum": "tl.sum(tl.where(_mask, {0}, 0.0), axis=1)[:, None]",
    "rmean": "(tl.sum(tl.where(_mask, {0}, 0.0), axis=1)[:, None] / D)",
    "rmax": "tl.max(tl.where(_mask, {0}, float(\"-inf\")), axis=1)[:, None]",
}
_BIN_FMT = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})",
    "min": "tl.minimum({0}, {1})", "max": "tl.maximum({0}, {1})",
    "lt": "({0} < {1})", "le": "({0} <= {1})", "gt": "({0} > {1})",
    "ge": "({0} >= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})",
}
_TERN_FMT = {
    "fma": "tl.fma({1}, {2}, {0})",          # a + b*c
    "select": "tl.where({0}, {1}, {2})",
    "phi": "tl.where({0}, {1}, {2})",
}
# formats whose arguments must be tensors: a literal is lifted first
_CALL_OPS = {"exp", "log", "sqrt", "rsqrt", "abs", "sigmoid", "floor",
             "tanh", "min", "max", "fma"}


@dataclasses.dataclass
class TritonKernel:
    """One saturated tile program as a Triton kernel source."""
    name: str
    body: List[str]            # the saturated body, kind-independent
    in_arrays: List[str]
    out_arrays: List[str]
    scalars: List[str]
    rotated: Tuple[str, ...]   # inputs read through rothalf
    has_reduction: bool
    stats: GenStats
    bulk: bool
    schedule_mode: str = "bulk"
    schedule: Optional[Any] = None
    # persistent kernel over row blocks (the "triton_pipelined" emitter),
    # with the sync kernel of the same schedule as its twin
    pipelined: bool = False
    twin: Optional["TritonKernel"] = None
    _compiled: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   repr=False)

    @property
    def kernel_name(self) -> str:
        return f"{self.name}_kernel"

    @property
    def source(self) -> str:
        """The kernel source for all-row operands (the common layout)."""
        return self.render(("row",) * len(self.in_arrays))

    def render(self, kinds: Sequence[str]) -> str:
        """Full kernel source for one operand layout: ``kinds[i]`` is
        ``"row"``, ``"cycle"`` or ``"bcast"`` for input ``i``."""
        params = ([f"{a}_ptr" for a in self.in_arrays]
                  + [f"{a}_optr" for a in self.out_arrays] + self.scalars
                  + ["n_rows"] + [f"{a}_period" for a in self.in_arrays]
                  + ["D: tl.constexpr", "BLOCK_R: tl.constexpr",
                     "BLOCK_D: tl.constexpr"])
        ind = "    "
        # row counts and periods vary with the batch and the prompt length:
        # keep them out of Triton's specialisation key so a new length
        # does not recompile the kernel
        dynamic = ["n_rows"] + [f"{a}_period" for a in self.in_arrays]
        lines = [
            "import triton",
            "import triton.language as tl",
            "",
            "",
            f"@triton.jit(do_not_specialize={dynamic!r})",
            f"def {self.kernel_name}({', '.join(params)}):",
        ]
        row_block, col_block = "tl.program_id(0)", "tl.program_id(1)"
        if self.pipelined:
            # persistent: program p takes blocks p, p + n_programs, ...;
            # the loop's next loads are issued while this block computes
            lines += [
                f"{ind}_n_cb = tl.cdiv(D, BLOCK_D)",
                f"{ind}_n_blocks = tl.cdiv(n_rows, BLOCK_R) * _n_cb",
                f"{ind}for _blk in tl.range(tl.program_id(0), _n_blocks, "
                f"tl.num_programs(0), num_stages={NUM_STAGES}):"]
            row_block, col_block = "(_blk // _n_cb)", "(_blk % _n_cb)"
            ind = "        "
        lines += [
            f"{ind}_rows = ({row_block} * BLOCK_R"
            f" + tl.arange(0, BLOCK_R)).to(tl.int64)[:, None]",
            f"{ind}_cols = {col_block} * BLOCK_D"
            f" + tl.arange(0, BLOCK_D)[None, :]",
            f"{ind}_cmask = _cols < D",
            f"{ind}_mask = (_rows < n_rows) & _cmask",
            f"{ind}_zero = tl.zeros((BLOCK_R, BLOCK_D), tl.float32)",
        ]
        if self.rotated:
            lines += [f"{ind}_rcols = (_cols + D // 2) % D",
                      f"{ind}_rsign = tl.where(_cols < D // 2, -1.0, 1.0)"]
        for a, kind in zip(self.in_arrays, kinds):
            if kind == "bcast":
                row, mask = "", "_cmask"
            elif kind == "cycle":
                row, mask = f"(_rows % {a}_period) * D + ", "_mask"
            elif kind == "row":
                row, mask = "_rows * D + ", "_mask"
            else:
                raise ValueError(f"unknown operand kind {kind!r}")
            lines.append(f"{ind}{a}_off = {row}_cols")
            if a in self.rotated:
                lines.append(f"{ind}{a}_roff = {row}_rcols")
            lines.append(f"{ind}{a}_mask = {mask}")
        # the body is emitted at one level of indent
        extra = ind[4:]
        lines += [extra + ln for ln in self.body]
        return "\n".join(lines) + "\n"

    def compiled(self, kinds: Tuple[str, ...]):
        """The ``@triton.jit`` function for one operand layout, built on
        first use. Triton reads a kernel's source from its file, so the
        source is written under :data:`BUILD_DIR` and imported."""
        with self._lock:
            fn = self._compiled.get(kinds)
            if fn is None:
                fn = _import_kernel(self.render(kinds), self.kernel_name)
                self._compiled[kinds] = fn
            return fn


def _import_kernel(src: str, fn_name: str):
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    mod_name = f"repro_torch_tile_{fn_name}_{digest}"
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"{mod_name}.py")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(src)
    os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, fn_name)


class TritonGenerator(TorchCodeGenerator):
    """The ``"triton"`` emitter: the body of a Triton tile kernel."""

    PIPELINED = False

    def __init__(self, ssa: SSAResult, extraction: ExtractionResult, *,
                 bulk: bool = True, fn_name: Optional[str] = None,
                 reuse_temps: bool = True, schedule=None,
                 sched_cost_model=None):
        super().__init__(ssa, extraction, bulk=bulk, fn_name=fn_name,
                         reuse_temps=reuse_temps, schedule=schedule,
                         sched_cost_model=sched_cost_model)
        self._inputs: Dict[str, str] = {}   # bound ref name -> input array
        self._rotated: List[str] = []

    def _check_tilable(self):
        def walk(region: Region):
            for item in region.items:
                if isinstance(item, LoopRegion):
                    raise ValueError(
                        "Triton tile programs must be straight-line; "
                        f"kernel {self.ssa.prog.name!r} has a for-loop")
                if item.index_cids:
                    raise ValueError(
                        "Triton tile programs use whole-tile stores; "
                        f"kernel {self.ssa.prog.name!r} stores with indices")
        walk(self.ssa.region)
        for n in list(self.choice.values()):
            if n.op == "load" and len(n.children) > 1:
                raise ValueError("Triton tile programs use whole-tile loads")
            if n.op == "call":
                raise ValueError("calls not supported in Triton tile programs")

    def _input_of(self, load_cid: int) -> str:
        """The input array a whole-tile load reads; raises for a re-read
        of an output that was never written."""
        n = self.node(load_cid)
        arr = self.node(n.children[0])
        bound = self.scope.get_sym(arr.payload) if arr.op == "array" \
            else None
        if bound not in self._inputs:
            raise ValueError(f"load of {arr.payload!r} before any store")
        return self._inputs[bound]

    def _arg(self, cid: int, lines: List[str], indent: str,
             lift: bool) -> str:
        name = self.emit_value(cid, lines, indent)
        if lift and self.node(cid).op == "const":
            return f"tl.full((), {name}, tl.float32)"
        return name

    def emit_value(self, cid: int, lines: List[str], indent: str) -> str:
        cid = self.eg.find(cid)
        memo_ok = (self.reuse_temps is True
                   or (self.reuse_temps in (False, "lets")
                       and cid in self._let_set))
        bound = self.scope.get(cid, memo=memo_ok)
        if bound is not None:
            return bound
        n = self.node(cid)
        op = n.op
        if op in ("const", "var"):
            return super().emit_value(cid, lines, indent)
        if op == "array":
            raise ValueError("array used as a value in a tile program")
        if op == "load":
            arr = self.node(n.children[0])
            bound_arr = self.scope.get_sym(arr.payload)
            if bound_arr not in self._inputs:
                if bound_arr is None or bound_arr.endswith("_oref"):
                    raise ValueError(f"load of {arr.payload!r} before any "
                                     "store")
                # re-read of an output written earlier: its value
                self.scope.bind(cid, bound_arr)
                return bound_arr
            a = self._inputs[bound_arr]
            name = self._fresh()
            self.stats.n_temps += 1
            self.stats.n_loads += 1
            self.stats.instruction_mix["load"] = \
                self.stats.instruction_mix.get("load", 0) + 1
            lines.append(f"{indent}{name} = tl.load({a}_ptr + {a}_off, "
                         f"mask={a}_mask, other=0.0).to(tl.float32)")
            self.scope.bind(cid, name)
            return name
        name = self._fresh()
        self.stats.n_temps += 1
        self.stats.n_ops += 1
        self.stats.instruction_mix[op] = \
            self.stats.instruction_mix.get(op, 0) + 1
        if op == "rothalf":
            child = self.node(n.children[0])
            if child.op != "load":
                raise ValueError("rothalf is only supported on a loaded "
                                 "input tile")
            a = self._input_of(n.children[0])
            if a not in self._rotated:
                self._rotated.append(a)
            expr = (f"_rsign * tl.load({a}_ptr + {a}_roff, mask={a}_mask, "
                    f"other=0.0).to(tl.float32)")
        elif op in _UNARY_FMT:
            kids = [self._arg(c, lines, indent, op in _CALL_OPS)
                    for c in n.children]
            expr = _UNARY_FMT[op].format(*kids)
        elif op in _BIN_FMT:
            kids = [self._arg(c, lines, indent, op in _CALL_OPS)
                    for c in n.children]
            expr = _BIN_FMT[op].format(*kids)
        elif op in _TERN_FMT:
            kids = [self._arg(c, lines, indent, op in _CALL_OPS)
                    for c in n.children]
            if op == "fma":
                self.stats.n_fma += 1
            expr = _TERN_FMT[op].format(*kids)
        else:
            raise NotImplementedError(f"Triton emission for op {op!r}")
        lines.append(f"{indent}{name} = {expr}")
        self.scope.bind(cid, name)
        return name

    def _emit_store(self, eff: StoreEffect, lines: List[str], indent: str):
        if eff.pred_cid is not None:
            raise ValueError("predicated stores are not supported in "
                             "Triton tile programs")
        val = self.emit_value(eff.value_cid, lines, indent)
        ptr = f"{eff.array}_optr"
        lines.append(f"{indent}tl.store({ptr} + _rows * D + _cols, "
                     f"({val} + _zero).to({ptr}.dtype.element_ty), "
                     f"mask=_mask)")
        # later loads of this array read the value just stored
        self.scope.bind_sym(eff.version_out, val)
        self.stats.n_stores += 1

    def generate_triton(self) -> TritonKernel:
        self._check_tilable()
        prog = self.ssa.prog
        in_arrays = [a.name for a in prog.arrays.values()
                     if a.role in ("in", "inout")]
        out_arrays = [a.name for a in prog.arrays.values()
                      if a.role in ("out", "inout")]
        scalars = list(prog.scalars)
        params = ([f"{n}_ptr" for n in in_arrays]
                  + [f"{n}_optr" for n in out_arrays] + scalars
                  + [f"{n}_period" for n in in_arrays]
                  + ["n_rows", "D", "BLOCK_R", "BLOCK_D"])
        if len(set(params)) != len(params):
            raise ValueError(f"kernel {prog.name!r}: parameter names "
                             f"collide: {params}")
        for a in in_arrays:
            self.scope.bind_sym(f"{a}@0", f"{a}_ref")
            self._inputs[f"{a}_ref"] = a
        for a in out_arrays:
            self.scope.bind_sym(f"{a}@undef", f"{a}_oref")
        lines: List[str] = []
        sched = self._resolve_schedule()
        if sched is None and self.bulk:
            self._collect_load_regions()
        self.emit_region(self.ssa.region, (), lines, "    ")
        chaos.maybe_raise("exec_fail", prog.name, "generated Triton source")
        tk = TritonKernel(
            name=self.fn_name, body=lines, in_arrays=in_arrays,
            out_arrays=out_arrays, scalars=scalars,
            rotated=tuple(self._rotated),
            has_reduction=any(op in self.stats.instruction_mix
                              for op in _REDUCTIONS),
            stats=self.stats, bulk=self.bulk,
            schedule_mode=self.schedule_mode, schedule=sched,
            pipelined=self.PIPELINED)
        # syntax check of the generated source (no triton import needed)
        compile(tk.source, f"<triton:{self.fn_name}>", "exec")
        return tk


class TritonPipelinedGenerator(TritonGenerator):
    """The ``"triton_pipelined"`` emitter: the persistent, software-
    pipelined form of the tile kernel (see the module docstring).

    Emission always follows an explicit schedule: a named order (source
    or bulk) is reconstructed searchlessly when no cost schedule is
    attached, as the TPU's pipelined emitter does, so every load has a
    defined slot. The sync kernel generated under that same schedule is
    attached as :attr:`TritonKernel.twin`."""

    PIPELINED = True

    def __init__(self, ssa: SSAResult, extraction: ExtractionResult, **kw):
        super().__init__(ssa, extraction, **kw)
        self._extraction = extraction
        self._options = kw

    def _resolve_schedule(self):
        sched = super()._resolve_schedule()
        if sched is None:
            cm = self._sched_cm if hasattr(self._sched_cm, "latency") \
                else None
            if cm is not None and hasattr(cm, "bind_egraph"):
                cm.bind_egraph(self.eg)
            self._explicit = compute_schedule(
                self.ssa, self.choice, mode=self.schedule_mode,
                cost_model=cm, move_budget=0)
        return self._explicit

    def generate_triton(self) -> TritonKernel:
        tk = super().generate_triton()
        opts = dict(self._options, schedule=tk.schedule)
        tk.twin = TritonGenerator(self.ssa, self._extraction,
                                  **opts).generate_triton()
        return tk


@dataclasses.dataclass(frozen=True)
class TileCallPlan:
    """Launch geometry of one tile-op call: the ``(rows, d)`` view, the
    operand kinds, block sizes and grid. ``n_blocks`` counts the
    ``(block_r, block_d)`` blocks; a pipelined kernel's grid is persistent
    (one axis, at most :data:`PROGRAMS_PER_SM` programs per SM), any
    other's has one program per block."""
    rows: int
    d: int
    kinds: Tuple[str, ...]       # per input: "row" | "cycle" | "bcast"
    periods: Tuple[int, ...]     # per input: rows a "cycle" operand repeats
    block_r: int
    block_d: int
    n_blocks: int
    grid: Tuple[int, ...]
    num_warps: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def plan_tile_call(tk: TritonKernel, in_shapes: Sequence[Tuple[int, ...]]
                   ) -> TileCallPlan:
    """Plan the launch of ``tk`` over operands of the given shapes.

    As in the Pallas plan, inputs whose leading extents multiply to the
    lead operand's row count tile over rows, and an input of ``d`` (or
    one) elements is a broadcast row. The port adds ``cycle``: an input
    of shape ``T`` where the lead's shape ends with ``T`` (leading ones
    dropped) reads row ``r % prod(T[:-1])``."""
    lead = tuple(in_shapes[0])
    d = lead[-1]
    rows = math.prod(lead[:-1]) if len(lead) > 1 else 1
    kinds, periods = [], []
    for name, shp in zip(tk.in_arrays, in_shapes):
        shp = tuple(shp)
        core = shp
        while len(core) > 1 and core[0] == 1:
            core = core[1:]
        if len(shp) >= 2 and math.prod(shp[:-1]) == rows and shp[-1] == d:
            kinds.append("row")
            periods.append(rows)
        elif math.prod(shp) in (d, 1):
            kinds.append("bcast")
            periods.append(1)
        elif core[-1] == d and lead[len(lead) - len(core):] == core:
            kinds.append("cycle")
            periods.append(math.prod(core[:-1]))
        else:
            raise ValueError(f"{tk.name}: operand {name!r} of shape {shp} "
                             f"does not tile against the lead {lead}")
    bd = _next_pow2(d)
    if not tk.has_reduction:
        bd = min(bd, MAX_BLOCK_D_NO_REDUCE)
    if tk.rotated and d % 2:
        raise ValueError(f"{tk.name}: rothalf needs an even width, got {d}")
    br = max(1, min(TILE_ELEMS_BUDGET // bd, _next_pow2(rows)))
    grid = (-(-rows // br), -(-d // bd))
    n_blocks = grid[0] * grid[1]
    if tk.pipelined:
        grid = (min(n_blocks, PROGRAMS_PER_SM * H100_SXM.sm_count),)
    return TileCallPlan(rows=rows, d=d, kinds=tuple(kinds),
                        periods=tuple(periods), block_r=br, block_d=bd,
                        n_blocks=n_blocks, grid=grid,
                        num_warps=8 if br * bd >= 4096 else 4)


@dataclasses.dataclass
class TileOp:
    """A saturated tile program as an op: the Triton kernel on CUDA
    tensors, its plain version (``torch_ref``, the torchgen function of
    the same saturated program) on CPU tensors.

    ``tk=None`` marks a degraded op (the build fell to the ladder's
    ``ref`` rung, or Triton emission failed). On CPU tensors it still
    runs through ``torch_ref``; on CUDA tensors it raises — the card
    never runs a silent substitute for its kernel. ``launches`` counts
    kernel launches."""
    name: str
    tk: Optional[TritonKernel]
    torch_ref: Callable
    source: str
    sk: Optional[Any] = None
    launches: int = 0

    def __call__(self, *arrays, **scalars):
        return self.apply(*arrays, **scalars)

    def apply(self, *arrays, **scalars):
        devices = {a.device.type for a in arrays}
        if devices == {"cpu"}:
            return self.torch_ref(*arrays, **scalars)
        if devices != {"cuda"}:
            raise ValueError(f"{self.name}: operands on {sorted(devices)}; "
                             "expected all on cpu or all on cuda")
        if self.tk is None:
            raise RuntimeError(
                f"tile op {self.name!r} has no Triton kernel (degraded "
                f"build, ladder level "
                f"{getattr(self.sk, 'ladder_level', '?')!r}); refusing to "
                "run a substitute on the card")
        return _apply_tile_op(self, arrays, scalars)


def _apply_tile_op(op: TileOp, arrays, scalars):
    import torch

    tk = op.tk
    lead = arrays[0]
    if len(arrays) != len(tk.in_arrays):
        raise ValueError(f"{op.name}: expected {len(tk.in_arrays)} inputs "
                         f"{tk.in_arrays}, got {len(arrays)}")
    if not lead.dtype.is_floating_point:
        raise TypeError(f"{op.name}: lead operand dtype {lead.dtype}")
    plan = plan_tile_call(tk, [tuple(a.shape) for a in arrays])
    ins = []
    for kind, a in zip(plan.kinds, arrays):
        if a.device != lead.device:
            raise ValueError(f"{op.name}: operands on {a.device} and "
                             f"{lead.device}")
        if kind == "bcast" and a.numel() == 1:
            a = a.reshape(1).expand(plan.d)
        ins.append(a.contiguous())
    outs = [torch.empty(lead.shape, dtype=lead.dtype, device=lead.device)
            for _ in tk.out_arrays]
    if plan.rows > 0:
        kern = tk.compiled(plan.kinds)
        svals = [float(scalars[s]) for s in tk.scalars]
        kern[plan.grid](*ins, *outs, *svals, plan.rows, *plan.periods,
                        D=plan.d, BLOCK_R=plan.block_r,
                        BLOCK_D=plan.block_d, num_warps=plan.num_warps)
        op.launches += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def make_tile_op(prog: KernelProgram,
                 config: Optional[SaturatorConfig] = None) -> TileOp:
    """Saturate ``prog`` and build both the Triton op and its plain
    version. Keeps the ladder contract of the JAX package's
    ``make_tile_op``: a build that fell to ``ref`` gets no kernel, and a
    failed emission is recorded as a degradation, never raised."""
    cfg = config or SaturatorConfig(mode="accsat", cost_model="tpu_v5e")
    sk = saturate_program(prog, cfg)
    # emission follows the configuration that built sk: a ladder-degraded
    # build carries its cheap config, and re-running the full schedule
    # search here would re-hit whatever failed
    ecfg = sk.config
    if cfg.emitter not in (None, "triton", "triton_pipelined"):
        raise ValueError(f"make_tile_op needs a triton emitter, got "
                         f"{cfg.emitter!r}")
    gen_cls = TritonPipelinedGenerator \
        if cfg.emitter == "triton_pipelined" else TritonGenerator
    tk = None
    if sk.ladder_level != "ref":
        try:
            tk = gen_cls(
                sk.ssa, sk.extraction, bulk=ecfg.use_bulk,
                reuse_temps=ecfg.use_cse,
                schedule=sk.kernel.schedule
                if sk.kernel.schedule is not None else ecfg.schedule,
                sched_cost_model=ecfg.make_schedule_cost_model(prog)
            ).generate_triton()
        except Exception as e:   # ladder contract: emission never fatal
            from repro_torch.runtime.guard import classify_failure
            from .telemetry import telemetry
            telemetry().record_degradation(
                prog.name, "torch", classify_failure(e, "triton_emit"))
            tk = None

    fn = sk.kernel.fn
    in_names = sk.kernel.in_arrays
    scalar_names = sk.kernel.scalars

    def torch_ref(*arrays, **scalars):
        import numpy as np
        import torch

        full_args = []
        ai = iter(arrays)
        for name in in_names:
            if prog.arrays[name].role == "out":
                full_args.append(torch.zeros_like(arrays[0]))
            else:
                full_args.append(next(ai))
        full_args += [scalars[s] for s in scalar_names]
        out = [torch.from_numpy(o) if isinstance(o, np.ndarray) else o
               for o in fn(*full_args)]
        return out[0] if len(out) == 1 else tuple(out)

    return TileOp(name=prog.name, tk=tk, torch_ref=torch_ref,
                  source=tk.source if tk is not None else sk.kernel.source,
                  sk=sk)
