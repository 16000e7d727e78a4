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
  once per program, at column offsets only;
* ``rsum``/``rmean``/``rmax`` mask padded lanes at the reduction
  (neutral 0, or −inf for the max) and ``rmean`` divides by the true
  ``d``;
* a program with a reduction is emitted as a template over column
  *pieces*: every tile value is a tuple of ``(BLOCK_R, w)`` tiles whose
  widths are powers of two (``$p`` in a template line stands for the
  piece, ``$rsum[x]`` for a reduction over all of them). The plan picks
  the pieces by shape: a row of 768 is two pieces, 512 + 256, each
  loaded, computed and stored with no masked column lane, and a
  reduction combines the pieces' partial results; a width that is no
  sum of at most :data:`MAX_PIECES` powers of two is one masked piece of
  ``next_pow2(d)``;
* a program that uses ``rothalf`` is emitted in *half tiles*: every tile
  value is a pair of ``(BLOCK_R, BLOCK_D // 2)`` halves, columns
  ``[0, d/2)`` and ``[d/2, d)``. A load or store is two contiguous half
  accesses, an elementwise op applies to each half, a reduction combines
  both, and ``rothalf(x)`` is the pair ``(−x_hi, x_lo)`` in registers —
  each input element is loaded once, through addresses with no modulo,
  so the loads vectorise to 16 bytes a thread;
* ``mod`` floors, as the DSL's reference and the torch emitter do
  (``torch.remainder``): Triton's float ``%`` truncates (C ``fmod``),
  so a non-zero remainder whose sign differs from the divisor's takes
  the divisor added. ``pow`` by a constant integer of magnitude at most
  :data:`POW_MAX_MULS` is a chain of multiplies (a reciprocal for a
  negative one); any other exponent goes through libdevice's ``pow``,
  imported by the kernel's module only where it is used;
* ``fma`` is ``tl.fma``; all compute is f32 and stores cast to the
  output's dtype (the lead operand's, as in the Pallas call, unless the
  caller names another: l2_clip writes f32 from a bf16 gradient);
* loads and stores stand in the body as ``$load[a]`` and ``$store[o]``
  marks, written out per layout (masked row and column offsets, or the
  flat plan's).

The *flat plan* (:func:`flat_plan`) takes an elementwise program in
whole tiles (no reduction, no ``rothalf``) whose operands all hold the
lead's elements: contiguous buffers of ``rows × d`` elements, so one
stream. A program owns a block of ``BLOCK`` contiguous elements, sized
so that each thread moves whole 16-byte vectors of the widest operand;
there is no row or column index, no per-element mask but in a tail block
(none where ``BLOCK`` divides the elements), and offsets are int32 until
they would pass 2^31. Such a program is bound by its bytes alone; the
row-and-column plan it replaced carried int64 index math and two masks
an element, and at minitron's embedding launched 96,000 programs of
(8, 1024) (tools/tile_time.py compares both on the card).

A ``cycle`` operand (the port's addition: an operand that broadcasts
over the lead's leading axes, such as RoPE's cos/sin of ``(1, 1, S, hd)``
against ``(B, H, S, hd)`` queries) is never materialised at the lead's
size. Its launch sees the lead's rows as groups of ``n_pos`` positions:
program ``(g, p, c)`` owns the ``p``-th block of :data:`CYCLE_BLOCK_R`
positions of group ``g``, reads the cycle operand at those positions and
the rows at ``g * n_pos + position``. The cycle operand's re-reads for
each group come from L2. A ``bcycle`` operand (a per-batch table, such as
M-RoPE's cos/sin of ``(B, 1, S, hd)`` against ``(B, H, S, hd)``) is a
cycle offset by its batch row: lead row ``r`` reads its row
``(r // span) * period + r % period`` (``span`` = H·S lead rows per batch
row, ``period`` = S), in place, in the same launch.

What bounds it on the H100: every instance is a streaming pass with at
most a last-axis reduction, so bytes (each input read once, each output
written once over 3.35 TB/s) bound it, not operations. The design keeps
the traffic at that minimum: one pass over each operand, broadcast rows
read once per program, no intermediate in device memory. Programs with a
reduction hold whole rows, few a program, so that the grid holds at
least :data:`REDUCE_PROGRAMS_PER_SM` programs per SM where the rows
allow: many resident programs overlap one's stores with another's loads,
where a register-sized block left a router softmax 4 programs for 132
SMs. The others take the flat plan where their operands allow, and
otherwise (a broadcast operand) also tile columns, so a wide ``d`` does
not waste masked lanes up to the next power of two.

The ``"triton_pipelined"`` emitter (:class:`TritonPipelinedGenerator`)
replaces the TPU's pipelined tile kernel, ``PipelinedPallasGenerator``
with the scratch-buffer and DMA-semaphore branch of ``_apply_tile_op``:
there every whole-tile input load is an async copy started at its
scheduled slot and waited on at its first consumer, two semaphores
alternating. On Hopper the same overlap is a persistent kernel: a grid
of at most :data:`PROGRAMS_PER_SM` programs per SM, each walking its
blocks in ``tl.range(..., num_stages=2)``, so Triton's software pipeliner
keeps the loads of the next block in flight while this one computes.
Where the blocks fit in that grid, and for a cycle layout, the pipelined
form launches the sync kernel's grid with no loop: a walk of one block
has nothing to pipeline, and a persistent walk over a cycle's small
blocks measured slower on the H100, so nothing there is double-buffered
beyond what the resident programs overlap. The loop body is the sync
kernel's, under the same extraction and an explicit schedule, with loads
issued in the schedule's order; the sync kernel generated under that
schedule is kept beside it as its twin.

The source is generated once per program and compiled by Triton at the
first launch for each layout (operand kinds, pieces, persistent walk,
the flat plan's form); ``triton`` is imported only there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import math
import os
import re
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime import chaos

from .dsl import KernelProgram
from .emit import get_emitter
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
# Cycle layouts: positions per program and warps, chosen on the H100 for
# RoPE's prefill shapes (q (4, 24, 512, 128) and k (4, 8, 512, 128),
# bf16): 16 positions at 4 warps give each thread 8 bf16 (16 bytes) of
# each half of q, and many small programs keep more bytes in flight.
CYCLE_BLOCK_R = 16
CYCLE_NUM_WARPS = 4
# CUDA's limit on a grid's second and third axes
MAX_GRID_YZ = 65535
# Programs with a reduction (outside cycle layouts), chosen on the H100
# (tools/tile_time.py): a row block of at most REDUCE_TILE_ELEMS elements
# (a persistent walk's block TILE_ELEMS_BUDGET), halved until the grid
# holds REDUCE_PROGRAMS_PER_SM programs per SM where the rows allow; a
# warp for each REDUCE_WARP_ELEMS elements of the block where the grid
# fills the card, for half as many where it does not (a decode tick), at
# most REDUCE_MAX_WARPS; widths that are a sum of at most MAX_PIECES
# powers of two are emitted in pieces, with no masked column lane.
REDUCE_TILE_ELEMS = 2048
REDUCE_PROGRAMS_PER_SM = 2
REDUCE_WARP_ELEMS = 768
REDUCE_MAX_WARPS = 8
MAX_PIECES = 2
# The flat plan (elementwise programs whose operands all have the lead's
# shape): blocks of FLAT_WARPS warps (FLAT_PIPELINED_WARPS in the
# pipelined form's persistent walk), each thread moving FLAT_VECTORS
# 16-byte vectors of the widest operand, one program per block in the
# sync form. Chosen on the H100 (tools/tile_time.py --variants): one
# program per block beat every persistent grid of 1-8 programs per SM,
# streaming cache hints did not help when tried (none are emitted), and 1, 2 or
# 4 vectors at 4 or 8 warps stayed within about 1 % of each other; the
# walk of 4 programs per SM is fastest at 8 warps.
FLAT_WARPS = 4
FLAT_PIPELINED_WARPS = 8
FLAT_VECTORS = 2
# offsets past this need int64
_INT32_LIMIT = 2 ** 31

_REDUCTIONS = ("rsum", "rmean", "rmax")
# a template's reduction over all pieces of a tile value: $rsum[x]
_REDUCE_MARK = re.compile(r"\$(rsum|rmean|rmax)\[(.*?)\]")
# a template's whole-tile load of input a ($load[a]) and store of a value
# to output o (a line "$store[o] value"), written out per layout
_LOAD_MARK = re.compile(r"\$load\[(\w+)\]")
_STORE_MARK = re.compile(r"^(\s*)\$store\[(\w+)\] (.*)$")

_UNARY_FMT = {
    "neg": "(-{0})",
    "exp": "tl.exp({0})",
    "log": "tl.log({0})",
    "sqrt": "tl.sqrt({0})",
    "rsqrt": "tl.rsqrt({0})",
    # tanh through exp keeps the kernel off version-dependent libdevice
    # module paths; saturates to ±1 for large |x|. On the H100 Triton
    # lowers the "/" to div.full.f32, and inline PTX of the MUFU's ex2
    # and rcp timed no faster (tools/tile_time.py --tanh)
    "tanh": "(1.0 - 2.0 / (tl.exp(2.0 * {0}) + 1.0))",
    "abs": "tl.abs({0})",
    "sigmoid": "tl.sigmoid({0})",
    "recip": "(1.0 / {0})",
    "floor": "tl.floor({0})",
    "square": "({0} * {0})",
}
_BIN_FMT = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})",
    "min": "tl.minimum({0}, {1})", "max": "tl.maximum({0}, {1})",
    "lt": "({0} < {1})", "le": "({0} <= {1})", "gt": "({0} > {1})",
    "ge": "({0} >= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})",
    # floored: Triton's float % truncates, as torch.fmod does
    "mod": "tl.where((({0} % {1}) != 0) & ((({0} % {1}) < 0) != ({1} < 0)),"
           " ({0} % {1}) + {1}, {0} % {1})",
}
# pow by a constant integer exponent up to this magnitude is multiplies
POW_MAX_MULS = 8
# the kernel module's libdevice import (its path moved between Triton
# releases), only where a kernel calls it
_LIBDEVICE_IMPORT = [
    "try:",
    "    from triton.language.extra import libdevice",
    "except ImportError:",
    "    from triton.language.extra.cuda import libdevice",
]


def _pow_fmt(exponent) -> Tuple[str, bool]:
    """The format of ``pow(x, y)`` for the exponent's node, and whether
    it calls libdevice: multiplies for a small constant integer."""
    y = exponent.payload if exponent.op == "const" else None
    if isinstance(y, (int, float)) and not isinstance(y, bool) \
            and float(y).is_integer() and 1 <= abs(y) <= POW_MAX_MULS:
        chain = " * ".join(["{0}"] * int(abs(y)))
        return (f"({chain})" if y > 0 else f"(1.0 / ({chain}))"), False
    return "libdevice.pow({0}, {1})", True


_TERN_FMT = {
    "fma": "tl.fma({1}, {2}, {0})",          # a + b*c
    "select": "tl.where({0}, {1}, {2})",
    "phi": "tl.where({0}, {1}, {2})",
}
# formats whose arguments must be tensors: a literal is lifted first
_CALL_OPS = {"exp", "log", "sqrt", "rsqrt", "abs", "sigmoid", "floor",
             "tanh", "min", "max", "fma", "mod"}


def _reduce_expr(op: str, parts: Sequence[Tuple[str, str]],
                 masked: bool) -> str:
    """A row reduction over the column pieces of one tile value, ``parts``
    as (value, piece suffix): each piece's partial result, combined.
    ``masked`` pieces hold padded lanes, set to the neutral value (0, or
    −inf for the max) first; ``rmean`` divides by the true width ``D``."""
    neutral = 'float("-inf")' if op == "rmax" else "0.0"
    red = "tl.max" if op == "rmax" else "tl.sum"
    terms = [f"{red}(tl.where(_mask{s}, {x}, {neutral}), axis=1)[:, None]"
             if masked else f"{red}({x}, axis=1)[:, None]"
             for x, s in parts]
    if op == "rmax":
        expr = terms[0]
        for t in terms[1:]:
            expr = f"tl.maximum({expr}, {t})"
        return expr
    expr = terms[0] if len(terms) == 1 else f"({' + '.join(terms)})"
    return f"({expr} / D)" if op == "rmean" else expr


def _suffixes(n_pieces: int) -> List[str]:
    """The names' suffix of each column piece (none for one piece)."""
    return [""] if n_pieces == 1 else [f"_p{i}" for i in range(n_pieces)]


def _expand(template: Sequence[str], n_pieces: int, masked: bool
            ) -> List[str]:
    """A template body for ``n_pieces`` column pieces: a line holding
    ``$p`` is repeated once per piece (suffix ``_p{i}``, none for one
    piece), and ``$rsum[x]`` (``rmean``, ``rmax``) becomes the reduction
    over the pieces of ``x``."""
    sfx = _suffixes(n_pieces)
    out = []
    for ln in template:
        m = _REDUCE_MARK.search(ln)
        if m:
            parts = [(m.group(2).replace("$p", s), s) for s in sfx]
            out.append(ln[:m.start()] + _reduce_expr(m.group(1), parts,
                                                      masked)
                       + ln[m.end():])
        elif "$p" in ln:
            out += [ln.replace("$p", s) for s in sfx]
        else:
            out.append(ln)
    return out


def _access(template: Sequence[str], load: str, store: str) -> List[str]:
    """A template's loads and stores in one layout's addressing: ``load``
    formats input ``{a}``, ``store`` output ``{o}`` and value ``{v}``."""
    out = []
    for ln in template:
        m = _STORE_MARK.match(ln)
        if m:
            ln = m.group(1) + store.format(o=m.group(2), v=m.group(3))
        out.append(_LOAD_MARK.sub(lambda m: load.format(a=m.group(1)), ln))
    return out


# whole-tile loads and stores of the row and column-piece layouts
_ROW_LOAD = "tl.load({a}_ptr + {a}_off$p, mask={a}_mask$p, other=0.0)"
_ROW_STORE = ("tl.store({o}_optr + _rows * D + _cols$p, "
              "{v}.to({o}_optr.dtype.element_ty), mask=_mask$p)")


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The flat plan's form of a kernel: whether a tail block is masked
    (else none is), and whether offsets are int64."""
    tail: bool
    off64: bool


@dataclasses.dataclass
class TritonKernel:
    """One saturated tile program as a Triton kernel source."""
    name: str
    # the saturated body, layout-independent: a template over column
    # pieces (see the module docstring) unless it is in half tiles
    template: List[str]
    in_arrays: List[str]
    out_arrays: List[str]
    scalars: List[str]
    halves: bool               # emitted in half tiles (uses rothalf)
    has_reduction: bool
    stats: GenStats
    bulk: bool
    schedule_mode: str = "bulk"
    schedule: Optional[Any] = None
    # persistent kernel over row blocks (the "triton_pipelined" emitter),
    # with the sync kernel of the same schedule as its twin
    pipelined: bool = False
    twin: Optional["TritonKernel"] = None
    # the body calls libdevice (pow by a non-integer exponent)
    libdevice: bool = False
    _compiled: Dict[Tuple[Any, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock,
                                   repr=False)

    @property
    def kernel_name(self) -> str:
        return f"{self.name}_kernel"

    @property
    def _imports(self) -> List[str]:
        return _LIBDEVICE_IMPORT if self.libdevice else []

    @property
    def body(self) -> List[str]:
        """The body in one masked piece (the layout of ``source``)."""
        return _expand(self._row_template, 1, masked=True)

    @property
    def _row_template(self) -> List[str]:
        if self.halves:     # half tiles write their own accesses
            return self.template
        return _access(self.template, _ROW_LOAD, _ROW_STORE)

    @property
    def flat_ok(self) -> bool:
        """Whether the flat plan can run this program: elementwise, in
        whole tiles."""
        return not (self.halves or self.has_reduction)

    @property
    def source(self) -> str:
        """The kernel source for all-row operands in the row and column
        layout (the flat plan's is ``render(..., flat=...)``)."""
        return self.render(("row",) * len(self.in_arrays))

    def render(self, kinds: Sequence[str], pieces: Sequence[int] = (),
               persistent: Optional[bool] = None,
               flat: Optional[FlatLayout] = None) -> str:
        """Full kernel source for one layout: ``kinds[i]`` is ``"row"``,
        ``"cycle"``, ``"bcycle"`` or ``"bcast"`` for input ``i``;
        ``pieces`` the widths of the column pieces that cover ``D``
        exactly (none: one masked block of ``BLOCK_D``); ``persistent``
        whether programs walk blocks in a loop (by default, a pipelined
        kernel outside a cycle layout); ``flat`` the flat plan's form,
        where the operands are one stream of elements."""
        cycle = _by_position(kinds)
        if persistent is None:
            persistent = self.pipelined and not cycle
        if flat is not None:
            return self._render_flat(flat, persistent)
        if pieces and (self.halves or cycle or not self.has_reduction):
            raise ValueError(f"{self.name}: column pieces are for row "
                             f"reductions in whole tiles")
        pos = (["n_pos"] if cycle else []) + [
            f"{a}_span" for a, k in zip(self.in_arrays, kinds)
            if k == "bcycle"]
        params = ([f"{a}_ptr" for a in self.in_arrays]
                  + [f"{a}_optr" for a in self.out_arrays] + self.scalars
                  + ["n_rows"] + [f"{a}_period" for a in self.in_arrays]
                  + pos + ["D: tl.constexpr", "BLOCK_R: tl.constexpr",
                           "BLOCK_D: tl.constexpr"])
        ind = "    "
        # row counts and periods vary with the batch and the prompt length:
        # keep them out of Triton's specialisation key so a new length
        # does not recompile the kernel
        dynamic = ["n_rows"] + [f"{a}_period" for a in self.in_arrays] + pos
        lines = [
            "import triton",
            "import triton.language as tl",
            *self._imports,
            "",
            "",
            f"@triton.jit(do_not_specialize={dynamic!r})",
            f"def {self.kernel_name}({', '.join(params)}):",
        ]
        # a half-tile program owns columns c and c + D // 2 for each c of
        # its column block
        width, block = ("D // 2", "BLOCK_D // 2") if self.halves \
            else ("D", "BLOCK_D")
        row_block, col_block = "tl.program_id(0)", "tl.program_id(1)"
        rows, in_range = None, "_rows < n_rows"
        if cycle:
            # the rows are groups of n_pos positions; program (g, p, c)
            # owns the p-th block of positions of group g, so a cycle
            # operand is read at its position
            lines.append(f"{ind}_pos = (tl.program_id(1) * BLOCK_R"
                         f" + tl.arange(0, BLOCK_R)).to(tl.int64)[:, None]")
            rows, in_range = "tl.program_id(0) * n_pos + _pos", "_pos < n_pos"
            col_block = "tl.program_id(2)"
        elif persistent:
            # persistent: program p takes blocks p, p + n_programs, ...;
            # the loop's next loads are issued while this block computes
            lines += [
                f"{ind}_n_cb = tl.cdiv(D, BLOCK_D)",
                f"{ind}_n_blocks = tl.cdiv(n_rows, BLOCK_R) * _n_cb",
                f"{ind}for _blk in tl.range(tl.program_id(0), _n_blocks, "
                f"tl.num_programs(0), num_stages={NUM_STAGES}):"]
            row_block, col_block = "(_blk // _n_cb)", "(_blk % _n_cb)"
            ind = "        "
        if rows is None:
            rows = (f"({row_block} * BLOCK_R"
                    f" + tl.arange(0, BLOCK_R)).to(tl.int64)[:, None]")
        lines.append(f"{ind}_rows = {rows}")
        if pieces:
            lines += self._piece_preamble(kinds, pieces, in_range, ind)
        else:
            lines += [
                f"{ind}_cols = {col_block} * {_paren(block)}"
                f" + tl.arange(0, {block})[None, :]",
                f"{ind}_cmask = _cols < {width}",
                f"{ind}_mask = ({in_range}) & _cmask",
                f"{ind}_zero = tl.zeros((BLOCK_R, {block}), tl.float32)",
            ]
            for a, kind in zip(self.in_arrays, kinds):
                row, mask = _operand_row(a, kind)
                lines.append(f"{ind}{a}_off = {row}_cols")
                lines.append(f"{ind}{a}_mask = {mask}")
        # the body is emitted at one level of indent
        extra = ind[4:]
        body = _expand(self._row_template, max(1, len(pieces)),
                       masked=not pieces)
        lines += [extra + ln for ln in body]
        return "\n".join(lines) + "\n"

    def _render_flat(self, flat: FlatLayout, persistent: bool) -> str:
        """The flat plan's kernel: the operands as one stream of
        ``n_elems`` contiguous elements in blocks of ``BLOCK``, with no
        row or column index. A block is loaded and stored unmasked; only
        a tail block, where ``BLOCK`` does not divide ``n_elems``, is
        masked: in a launch of one program per block the last program's,
        in a persistent walk over the whole blocks the last program's
        after its walk."""
        if not self.flat_ok:
            raise ValueError(f"{self.name}: the flat plan is for "
                             f"elementwise programs in whole tiles")
        params = ([f"{a}_ptr" for a in self.in_arrays]
                  + [f"{a}_optr" for a in self.out_arrays] + self.scalars
                  + ["n_elems", "BLOCK: tl.constexpr"])
        lines = ["import triton", "import triton.language as tl",
                 *self._imports, "", "",
                 "@triton.jit(do_not_specialize=['n_elems'])",
                 f"def {self.kernel_name}({', '.join(params)}):"]
        store = "tl.store({o}_optr + _offs, {v}.to({o}_optr.dtype.element_ty)"

        def body(ind, masked):
            mask = ", mask=_mask" if masked else ""
            fill = ", other=0.0" if masked else ""
            out = _access(self.template,
                          f"tl.load({{a}}_ptr + _offs{mask}{fill})",
                          store + mask + ")")
            out = _expand(out, 1, masked=False)
            if any("_zero" in ln for ln in out):
                out.insert(0, "    _zero = tl.zeros((BLOCK,), tl.float32)")
            return [ind + ln for ln in out]

        arange = "tl.arange(0, BLOCK)"
        start = "_blk.to(tl.int64) * BLOCK" if flat.off64 else "_blk * BLOCK"
        full = f"{start} + {arange}"
        if persistent:
            # whole blocks in a pipelined walk; the last program then
            # takes the tail
            lines += [f"    for _blk in tl.range(tl.program_id(0), "
                      f"n_elems // BLOCK, tl.num_programs(0), "
                      f"num_stages={NUM_STAGES}):",
                      f"        _offs = {full}"] + body("    ", False)
            if flat.tail:
                tail = (f"{arange}.to(tl.int64)" if flat.off64 else arange)
                lines += ["    if tl.program_id(0) == tl.num_programs(0) - 1:",
                          f"        _offs = n_elems // BLOCK * BLOCK + {tail}",
                          "        _mask = _offs < n_elems"] \
                    + body("    ", True)
        else:
            lines += ["    _blk = tl.program_id(0)", f"    _offs = {full}"]
            if flat.tail:
                lines += ["    if _blk < n_elems // BLOCK:"] \
                    + body("    ", False) \
                    + ["    else:", "        _mask = _offs < n_elems"] \
                    + body("    ", True)
            else:
                lines += body("", False)
        return "\n".join(lines) + "\n"

    def _piece_preamble(self, kinds, pieces, in_range, ind) -> List[str]:
        """Offsets of each column piece: piece ``i`` covers columns
        ``[start_i, start_i + pieces[i])`` of every row of the block, with
        a row mask only (a broadcast row a column mask that holds
        everywhere: Triton takes a load's fill value only with a mask)."""
        lines = [f"{ind}_mask = {in_range}"]
        start = 0
        for p, w in zip(_suffixes(len(pieces)), pieces):
            at = f"{start} + " if start else ""
            lines += [
                f"{ind}_cols{p} = {at}tl.arange(0, {w})[None, :]",
                f"{ind}_zero{p} = tl.zeros((BLOCK_R, {w}), tl.float32)"]
            if p:
                lines.append(f"{ind}_mask{p} = _mask")
            for a, kind in zip(self.in_arrays, kinds):
                if kind not in ("row", "bcast"):
                    raise ValueError(f"{self.name}: column pieces take row "
                                     f"and broadcast operands, not {kind!r}")
                row, mask = ("_rows * D + ", "_mask") if kind == "row" \
                    else ("", f"_cols{p} < D")
                lines.append(f"{ind}{a}_off{p} = {row}_cols{p}")
                lines.append(f"{ind}{a}_mask{p} = {mask}")
            start += w
        return lines

    def compiled(self, layout: Tuple[Any, ...]):
        """The ``@triton.jit`` function for one layout (a plan's
        :attr:`TileCallPlan.layout`), built on first use. Triton reads a
        kernel's source from its file, so the source is written under
        :data:`BUILD_DIR` and imported."""
        with self._lock:
            fn = self._compiled.get(layout)
            if fn is None:
                fn = _import_kernel(self.render(*layout), self.kernel_name)
                self._compiled[layout] = fn
            return fn


def _operand_row(a: str, kind: str) -> Tuple[str, str]:
    """The row part of input ``a``'s offsets, and its mask, for its kind
    in a layout of one column block."""
    if kind == "bcast":
        return "", "_cmask"
    if kind == "cycle":
        return f"(_pos % {a}_period) * D + ", "_mask"
    if kind == "bcycle":
        # the batch row's table, read at the position
        return (f"((_rows // {a}_span) * {a}_period"
                f" + _pos % {a}_period) * D + "), "_mask"
    if kind == "row":
        return "_rows * D + ", "_mask"
    raise ValueError(f"unknown operand kind {kind!r}")


def _by_position(kinds: Sequence[str]) -> bool:
    """Whether a layout launches over positions (a cycle operand)."""
    return "cycle" in kinds or "bcycle" in kinds


def _paren(expr: str) -> str:
    return expr if expr.isidentifier() else f"({expr})"


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
        self.halves = False
        self._pairs: Dict[str, Tuple[str, str]] = {}   # temp -> (lo, hi)
        # temps that hold a tile value (one per column piece), in a
        # template body; the others are per-row values or scalars
        self._tiles: set = set()
        self._libdevice = False

    def _resolve_schedule(self):
        """Emission always follows an explicit schedule: a named order
        (source or bulk) without one attached is reconstructed
        searchlessly, as the cache stores it, so a cold build and a
        cache replay of the same choice emit the same source."""
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

    def _uses_rothalf(self) -> bool:
        seen, stack = set(), list(self.ssa.roots())
        while stack:
            cid = self.eg.find(stack.pop())
            if cid in seen:
                continue
            seen.add(cid)
            n = self.node(cid)
            if n.op == "rothalf":
                return True
            stack.extend(n.children)
        return False

    def _half(self, name: str) -> Tuple[str, str]:
        """The (lo, hi) halves of a value; a scalar or a per-row value
        (a reduction's result) is the same in both."""
        return self._pairs.get(name, (name, name))

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
            if self.halves:
                for suffix, shift in (("_lo", ""), ("_hi", " + D // 2")):
                    lines.append(f"{indent}{name}{suffix} = tl.load({a}_ptr"
                                 f" + {a}_off{shift}, mask={a}_mask, "
                                 f"other=0.0).to(tl.float32)")
                self._pairs[name] = (f"{name}_lo", f"{name}_hi")
            else:
                # addressed per layout (TritonKernel.render)
                lines.append(f"{indent}{name}$p = $load[{a}]"
                             f".to(tl.float32)")
                self._tiles.add(name)
            self.scope.bind(cid, name)
            return name
        name = self._fresh()
        self.stats.n_temps += 1
        self.stats.n_ops += 1
        self.stats.instruction_mix[op] = \
            self.stats.instruction_mix.get(op, 0) + 1
        if op == "rothalf":
            # half tiles: rothalf(x) = (-x_hi, x_lo), no load, no shuffle
            lo, hi = self._half(self.emit_value(n.children[0], lines,
                                                indent))
            lines.append(f"{indent}{name}_lo = (-{hi})")
            self._pairs[name] = (f"{name}_lo", lo)
            self.scope.bind(cid, name)
            return name
        lift = op in _CALL_OPS
        if op in _REDUCTIONS:
            fmt = None
        elif op == "pow":
            fmt, lift = _pow_fmt(self.node(n.children[1]))
            self._libdevice |= lift
        elif op in _UNARY_FMT:
            fmt = _UNARY_FMT[op]
        elif op in _BIN_FMT:
            fmt = _BIN_FMT[op]
        elif op in _TERN_FMT:
            fmt = _TERN_FMT[op]
            if op == "fma":
                self.stats.n_fma += 1
        else:
            raise NotImplementedError(f"Triton emission for op {op!r}")
        kids = [self._arg(c, lines, indent, lift) for c in n.children]
        if self.halves and op in _REDUCTIONS:
            expr = _reduce_expr(op, [(x, "") for x in self._half(kids[0])],
                                masked=True)
            lines.append(f"{indent}{name} = {expr}")
        elif op in _REDUCTIONS:
            # over every piece of the tile (a per-row value or a scalar
            # is first broadcast to the piece)
            x = kids[0]
            x = f"{x}$p" if x in self._tiles else f"({x} + _zero$p)"
            lines.append(f"{indent}{name} = ${op}[{x}]")
        elif not self.halves and any(k in self._tiles for k in kids):
            args = [f"{k}$p" if k in self._tiles else k for k in kids]
            lines.append(f"{indent}{name}$p = {fmt.format(*args)}")
            self._tiles.add(name)
        elif any(k in self._pairs for k in kids):
            for i, suffix in enumerate(("_lo", "_hi")):
                args = [self._half(k)[i] for k in kids]
                lines.append(f"{indent}{name}{suffix} = {fmt.format(*args)}")
            self._pairs[name] = (f"{name}_lo", f"{name}_hi")
        else:
            lines.append(f"{indent}{name} = {fmt.format(*kids)}")
        self.scope.bind(cid, name)
        return name

    def _emit_store(self, eff: StoreEffect, lines: List[str], indent: str):
        if eff.pred_cid is not None:
            raise ValueError("predicated stores are not supported in "
                             "Triton tile programs")
        val = self.emit_value(eff.value_cid, lines, indent)
        ptr = f"{eff.array}_optr"
        # a value that is not a full tile (a per-row value, a scalar) is
        # first broadcast to one
        if self.halves:
            for part, shift in zip(self._half(val), ("", " + D // 2")):
                if val not in self._pairs:
                    part = f"({part} + _zero)"
                lines.append(f"{indent}tl.store({ptr} + _rows * D + _cols"
                             f"{shift}, {part}.to({ptr}.dtype.element_ty), "
                             f"mask=_mask)")
        else:
            part = f"{val}$p" if val in self._tiles else f"({val} + _zero$p)"
            lines.append(f"{indent}$store[{eff.array}] {part}")
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
                  + [f"{n}_span" for n in in_arrays]
                  + ["n_rows", "n_pos", "D", "BLOCK_R", "BLOCK_D"])
        if len(set(params)) != len(params):
            raise ValueError(f"kernel {prog.name!r}: parameter names "
                             f"collide: {params}")
        for a in in_arrays:
            self.scope.bind_sym(f"{a}@0", f"{a}_ref")
            self._inputs[f"{a}_ref"] = a
        for a in out_arrays:
            self.scope.bind_sym(f"{a}@undef", f"{a}_oref")
        self.halves = self._uses_rothalf()
        lines: List[str] = []
        sched = self._resolve_schedule()
        if sched is None and self.bulk:
            self._collect_load_regions()
        self.emit_region(self.ssa.region, (), lines, "    ")
        chaos.maybe_raise("exec_fail", prog.name, "generated Triton source")
        tk = TritonKernel(
            name=self.fn_name, template=lines, in_arrays=in_arrays,
            out_arrays=out_arrays, scalars=scalars, halves=self.halves,
            has_reduction=any(op in self.stats.instruction_mix
                              for op in _REDUCTIONS),
            stats=self.stats, bulk=self.bulk,
            schedule_mode=self.schedule_mode, schedule=sched,
            pipelined=self.PIPELINED, libdevice=self._libdevice)
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
    ``(block_r, block_d)`` blocks. A pipelined kernel whose blocks
    outnumber :data:`PROGRAMS_PER_SM` programs per SM is ``persistent``:
    one grid axis of that many programs, each walking blocks; any other
    launch has one program per block. With a cycle or bcycle operand the
    rows are groups of ``n_pos`` positions (the periods' least common
    multiple) and the grid is (groups, position blocks, column blocks) in
    both forms; otherwise ``n_pos`` is ``rows``. ``pieces``, where set,
    are the widths of the column pieces that cover ``d`` exactly (then
    ``block_d`` is ``d``). A ``flat`` plan walks the ``rows * d``
    elements as one stream in blocks of ``block_d`` elements
    (``block_r`` 1)."""
    rows: int
    d: int
    kinds: Tuple[str, ...]       # per input: row | cycle | bcycle | bcast
    periods: Tuple[int, ...]     # per input: rows a (b)cycle operand repeats
    block_r: int
    block_d: int
    n_blocks: int
    grid: Tuple[int, ...]
    num_warps: int
    n_pos: int
    # per input: lead rows per batch row of a "bcycle" operand, else 0
    spans: Tuple[int, ...] = ()
    pieces: Tuple[int, ...] = ()
    persistent: bool = False
    flat: Optional[FlatLayout] = None

    @property
    def layout(self) -> Tuple[Tuple[str, ...], Tuple[int, ...], bool,
                              Optional[FlatLayout]]:
        """What the kernel's source depends on: the arguments of
        :meth:`TritonKernel.render` and the key of its compiled form."""
        return self.kinds, self.pieces, self.persistent, self.flat


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _prev_pow2(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _pow2_pieces(d: int) -> Tuple[int, ...]:
    """``d`` as a sum of distinct powers of two, widest first."""
    return tuple(1 << b for b in reversed(range(d.bit_length()))
                 if d >> b & 1)


def _reduction_block(rows: int, width: int, pieces: Sequence[int],
                     elems: int) -> Tuple[int, int]:
    """Rows a program and warps of a program that reduces whole rows of
    ``width`` lanes, in a block of at most ``elems`` elements.

    The block is halved until the grid holds
    :data:`REDUCE_PROGRAMS_PER_SM` programs per SM where the rows allow:
    many resident programs overlap one's stores with another's loads. A
    warp takes about :data:`REDUCE_WARP_ELEMS` elements (24 f32 a
    thread) where the grid fills the card, so the whole grid is resident
    at once, and half that where it does not, so each of few programs
    ends sooner. Warps stay at most a smallest piece's 16-byte f32
    vectors over 32 lanes, so every piece takes the same register layout
    and the pieces' partial reductions combine with no exchange through
    shared memory."""
    br = min(_prev_pow2(elems // width), _next_pow2(rows))
    while br > 1 and -(-rows // br) < (REDUCE_PROGRAMS_PER_SM
                                       * H100_SXM.sm_count):
        br //= 2
    per_warp = REDUCE_WARP_ELEMS
    if -(-rows // br) < H100_SXM.sm_count:
        per_warp //= 2
    warps = 1 << max(0, math.floor(math.log2(br * width / per_warp) + 0.5))
    if pieces:
        warps = min(warps, max(1, min(pieces) // (4 * 32)))
    return br, min(warps, REDUCE_MAX_WARPS)


def flat_plan(tk: TritonKernel, rows: int, d: int, itemsize: int
              ) -> TileCallPlan:
    """The flat plan of ``tk`` over ``rows * d`` elements whose widest
    operand takes ``itemsize`` bytes an element: blocks of
    :data:`FLAT_WARPS` warps (:data:`FLAT_PIPELINED_WARPS` for a
    pipelined kernel) whose threads each move :data:`FLAT_VECTORS`
    16-byte vectors of that operand. The sync kernel launches one program
    per block; the pipelined one walks the blocks persistently where
    they outnumber :data:`PROGRAMS_PER_SM` programs per SM. Offsets are
    int32 where every block's fit, int64 beyond."""
    warps = FLAT_PIPELINED_WARPS if tk.pipelined else FLAT_WARPS
    n = rows * d
    block = warps * 32 * FLAT_VECTORS * max(1, 16 // itemsize)
    n_blocks = -(-n // block)
    cap = PROGRAMS_PER_SM * H100_SXM.sm_count if tk.pipelined else n_blocks
    return TileCallPlan(
        rows=rows, d=d, kinds=("row",) * len(tk.in_arrays),
        periods=(rows,) * len(tk.in_arrays), block_r=1, block_d=block,
        n_blocks=n_blocks, grid=(min(n_blocks, cap),), num_warps=warps,
        n_pos=rows, spans=(0,) * len(tk.in_arrays),
        persistent=n_blocks > cap,
        flat=FlatLayout(tail=n % block != 0,
                        off64=n_blocks * block > _INT32_LIMIT))


def plan_tile_call(tk: TritonKernel, in_shapes: Sequence[Tuple[int, ...]],
                   in_dtypes: Sequence[Any], out_dtype: Any = None
                   ) -> TileCallPlan:
    """Plan the launch of ``tk`` over operands of the given shapes and
    dtypes (torch or numpy: anything with an ``itemsize``), writing
    ``out_dtype`` (by default the lead's dtype).

    An elementwise program in whole tiles whose inputs all hold the
    lead's elements (its rows, or the one row of a 1-D lead) takes the
    :func:`flat_plan`, its block sized by the widest of those dtypes.
    Otherwise:

    As in the Pallas plan, inputs whose leading extents multiply to the
    lead operand's row count tile over rows, and an input of ``d`` (or
    one) elements is a broadcast row. The port adds ``cycle``: an input
    of shape ``T`` where the lead's shape ends with ``T`` (leading ones
    dropped) reads row ``r % prod(T[:-1])``, and ``bcycle``: an input
    that equals the lead on its leading axes, is one on a middle run of
    axes and equals it again after (``(B, 1, S, d)`` against
    ``(B, H, S, d)``) reads row ``(r // span) * period + r % period``
    with ``span`` the lead rows of one leading index and ``period`` the
    rows after the run. Such a launch takes blocks of
    :data:`CYCLE_BLOCK_R` positions at :data:`CYCLE_NUM_WARPS` warps. A
    program with a reduction otherwise takes the block of
    :func:`_reduction_block`, in column pieces (whole tiles only) where
    ``d`` is a sum of at most :data:`MAX_PIECES` powers of two."""
    lead = tuple(in_shapes[0])
    d = lead[-1]
    rows = math.prod(lead[:-1]) if len(lead) > 1 else 1
    if tk.flat_ok and all(math.prod(s) == rows * d and tuple(s)[-1:] == (d,)
                          for s in in_shapes):
        itemsize = max(t.itemsize for t in
                       [*in_dtypes, out_dtype or in_dtypes[0]])
        return flat_plan(tk, rows, d, itemsize)
    kinds, periods, spans = [], [], []
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
        elif (batch := _batch_cycle(lead, shp)) is not None:
            kinds.append("bcycle")
            periods.append(batch[0])
            spans.append(batch[1])
            continue
        else:
            raise ValueError(f"{tk.name}: operand {name!r} of shape {shp} "
                             f"does not tile against the lead {lead}")
        spans.append(0)
    bd = _next_pow2(d)
    if not tk.has_reduction:
        bd = min(bd, MAX_BLOCK_D_NO_REDUCE)
    if tk.halves and d % 2:
        raise ValueError(f"{tk.name}: rothalf needs an even width, got {d}")
    common = dict(rows=rows, d=d, kinds=tuple(kinds), periods=tuple(periods),
                  spans=tuple(spans))
    if _by_position(kinds):
        n_pos = math.lcm(*(p for k, p in zip(kinds, periods)
                           if k in ("cycle", "bcycle")))
        br = max(1, min(CYCLE_BLOCK_R, TILE_ELEMS_BUDGET // bd,
                        _next_pow2(n_pos)))
        grid = (rows // n_pos, -(-n_pos // br), -(-d // bd))
        if grid[1] > MAX_GRID_YZ:
            raise ValueError(f"{tk.name}: {n_pos} positions need "
                             f"{grid[1]} blocks, over the grid's "
                             f"{MAX_GRID_YZ}")
        return TileCallPlan(**common, block_r=br, block_d=bd,
                            n_blocks=math.prod(grid), grid=grid,
                            num_warps=CYCLE_NUM_WARPS, n_pos=n_pos)
    pieces = ()
    if tk.has_reduction:
        if not tk.halves and len(_pow2_pieces(d)) <= MAX_PIECES:
            pieces, bd = _pow2_pieces(d), d
        # a persistent walk's blocks take the register budget: smaller
        # ones measured slower on the H100
        br, warps = _reduction_block(
            rows, bd, pieces,
            TILE_ELEMS_BUDGET if tk.pipelined else REDUCE_TILE_ELEMS)
    else:
        br = max(1, min(TILE_ELEMS_BUDGET // bd, _next_pow2(rows)))
        warps = 8 if br * bd >= 4096 else 4
    grid = (-(-rows // br), -(-d // bd))
    n_blocks = grid[0] * grid[1]
    cap = PROGRAMS_PER_SM * H100_SXM.sm_count
    persistent = tk.pipelined and n_blocks > cap
    if persistent:
        grid = (cap,)
    return TileCallPlan(**common, block_r=br, block_d=bd, n_blocks=n_blocks,
                        grid=grid, num_warps=warps, n_pos=rows,
                        pieces=pieces, persistent=persistent)


def _batch_cycle(lead: Tuple[int, ...], shp: Tuple[int, ...]
                 ) -> Optional[Tuple[int, int]]:
    """``(period, span)`` of an operand that equals ``lead`` on its first
    axes, is one on a middle run of axes where ``lead`` is not, and
    equals ``lead`` on the rest (``(B, 1, S, d)`` against
    ``(B, H, S, d)``: period S, span H·S); None for any other shape."""
    if len(shp) > len(lead):
        return None
    shp = (1,) * (len(lead) - len(shp)) + tuple(shp)
    k = 0
    while k < len(lead) - 1 and shp[k] == lead[k]:
        k += 1
    m = k
    while m < len(lead) - 1 and shp[m] == 1:
        m += 1
    if k == 0 or m == k or shp[m:] != lead[m:]:
        return None
    return math.prod(shp[m:-1]), math.prod(lead[k:-1])


@dataclasses.dataclass
class TileOp:
    """A saturated tile program as an op: the Triton kernel on CUDA
    tensors, its plain version (``torch_ref``, the torchgen function of
    the same saturated program) on CPU tensors; on ``meta`` tensors the
    kernel's work, recorded with the op counter.

    ``tk=None`` marks a degraded op (the build fell to the ladder's
    ``ref`` rung, or Triton emission failed). On CPU tensors it still
    runs through ``torch_ref``; on CUDA tensors it raises — the card
    never runs a silent substitute for its kernel. ``launches`` counts
    kernel launches, and ``launches_by_kinds`` the same launches by their
    plan's operand kinds (``TileCallPlan.kinds``).

    ``verify`` (a :mod:`repro_torch.verify` level) other than ``"off"``
    certifies each launch layout the first time the op plans it, at that
    call's shapes (:func:`repro_torch.verify.verify_tile_layout`), and
    each compiled kernel's registers, spills and shared memory after its
    first launch (:func:`repro_torch.verify.check_compiled`); findings go
    to the process telemetry. A warm launch pays one set lookup."""
    name: str
    tk: Optional[TritonKernel]
    torch_ref: Callable
    source: str
    sk: Optional[Any] = None
    launches: int = 0
    launches_by_kinds: Counter = dataclasses.field(default_factory=Counter)
    verify: str = "off"
    # the launch layouts certified, and the compiled binaries checked
    certified: set = dataclasses.field(default_factory=set, repr=False)
    binaries: set = dataclasses.field(default_factory=set, repr=False)

    def __call__(self, *arrays, **scalars):
        return self.apply(*arrays, **scalars)

    def apply(self, *arrays, out_dtype=None, **scalars):
        """The op on ``arrays``. Outputs take the lead's dtype, or
        ``out_dtype`` where given: the kernel loads each operand in its
        own dtype and stores in that one, and the plain version then
        computes on the operands cast to it."""
        devices = {a.device.type for a in arrays}
        if devices == {"cpu"}:
            if out_dtype is not None:
                arrays = [a.to(out_dtype) for a in arrays]
            return self.torch_ref(*arrays, **scalars)
        if devices not in ({"cuda"}, {"meta"}):
            raise ValueError(f"{self.name}: operands on {sorted(devices)}; "
                             "expected all on cpu, all on cuda or all on "
                             "meta")
        if self.tk is None:
            raise RuntimeError(
                f"tile op {self.name!r} under mode "
                f"{getattr(getattr(self.sk, 'config', None), 'mode', '?')!r}"
                f" has no Triton kernel (degraded build, ladder level "
                f"{getattr(self.sk, 'ladder_level', '?')!r}); refusing to "
                "run a substitute on the card")
        if devices == {"meta"}:
            return _record_tile_op(self, arrays, out_dtype)
        return _apply_tile_op(self, arrays, scalars, out_dtype)


def _apply_tile_op(op: TileOp, arrays, scalars, out_dtype=None):
    tk = op.tk
    plan, ins, outs = prepare_tile_call(tk, arrays, op.name, out_dtype)
    if plan.n_blocks > 0:
        if op.verify != "off" and plan.layout not in op.certified:
            from repro_torch.verify import verify_tile_layout
            verify_tile_layout(op, plan, [tuple(a.shape) for a in arrays])
            op.certified.add(plan.layout)
        ck = launch_tile_kernel(tk.compiled(plan.layout), plan, ins, outs,
                                [float(scalars[s]) for s in tk.scalars])
        op.launches += 1
        op.launches_by_kinds[plan.kinds] += 1
        if op.verify != "off":
            _check_binary(op, plan, ck, ins, outs)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _record_tile_op(op: TileOp, arrays, out_dtype=None):
    """A call on ``meta`` tensors: planned and prepared as on the card
    (a layout the kernel cannot take raises), its work recorded with the
    op counter (:mod:`repro_torch.roofline.kernel_work`) in place of a
    launch, and ``meta`` outputs returned."""
    from repro_torch.roofline import kernel_work
    plan, ins, outs = prepare_tile_call(op.tk, arrays, op.name, out_dtype)
    if plan.n_blocks > 0:
        vector_ops, nbytes = kernel_work.tile_work(op, arrays, out_dtype)
        kernel_work.record(op.name, vector_ops=vector_ops, nbytes=nbytes)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _check_binary(op: TileOp, plan: TileCallPlan, ck, ins, outs):
    """Hold a compiled kernel's metadata against the card's limits, once
    for each binary Triton compiles (layout, block, width, warps and
    operand dtypes)."""
    key = (plan.layout, plan.block_r, plan.block_d, plan.d, plan.num_warps,
           tuple(t.dtype for t in [*ins, *outs]))
    if key in op.binaries:
        return
    op.binaries.add(key)
    from repro_torch.verify import VerifyReport, check_compiled, record
    rep = VerifyReport()
    meta = getattr(ck, "metadata", None)
    rep.extend(check_compiled(
        op.name, getattr(ck, "n_regs", None), getattr(ck, "n_spills", None),
        getattr(meta, "shared", None), plan.num_warps))
    record(rep)


def prepare_tile_call(tk: TritonKernel, arrays, name: str, out_dtype=None):
    """The plan of one call, its inputs as the kernel reads them
    (contiguous; a one-element broadcast widened to ``d``) and its
    outputs, allocated in the lead's shape and in ``out_dtype``, by
    default the lead's dtype."""
    import torch

    lead = arrays[0]
    if len(arrays) != len(tk.in_arrays):
        raise ValueError(f"{name}: expected {len(tk.in_arrays)} inputs "
                         f"{tk.in_arrays}, got {len(arrays)}")
    if not lead.dtype.is_floating_point:
        raise TypeError(f"{name}: lead operand dtype {lead.dtype}")
    out_dtype = out_dtype or lead.dtype
    plan = plan_tile_call(tk, [tuple(a.shape) for a in arrays],
                          [a.dtype for a in arrays], out_dtype)
    ins = []
    for kind, a in zip(plan.kinds, arrays):
        if a.device != lead.device:
            raise ValueError(f"{name}: operands on {a.device} and "
                             f"{lead.device}")
        if kind == "bcast" and a.numel() == 1:
            a = a.reshape(1).expand(plan.d)
        ins.append(a.contiguous())
    outs = [torch.empty(lead.shape, dtype=out_dtype, device=lead.device)
            for _ in tk.out_arrays]
    return plan, ins, outs


def launch_tile_kernel(kern, plan: TileCallPlan, ins, outs, svals):
    """Launch a compiled tile kernel over ``plan``; returns what the
    launch returns (Triton's compiled kernel)."""
    if plan.flat is not None:
        return kern[plan.grid](*ins, *outs, *svals, plan.rows * plan.d,
                               BLOCK=plan.block_d, num_warps=plan.num_warps)
    pos = (plan.n_pos,) if _by_position(plan.kinds) else ()
    spans = tuple(s for k, s in zip(plan.kinds, plan.spans) if k == "bcycle")
    return kern[plan.grid](*ins, *outs, *svals, plan.rows, *plan.periods,
                           *pos, *spans, D=plan.d, BLOCK_R=plan.block_r,
                           BLOCK_D=plan.block_d, num_warps=plan.num_warps)


def make_tile_op(prog: KernelProgram,
                 config: Optional[SaturatorConfig] = None) -> TileOp:
    """Saturate ``prog`` and build both the Triton op and its plain
    version. The Triton emitter is picked by ``config.emitter`` through
    the registry (:mod:`repro_torch.core.emit`): None or ``"triton"``,
    or ``"triton_pipelined"``; the ``torch`` emitter is refused. Keeps
    the ladder contract of the JAX package's ``make_tile_op``: a build
    that fell to ``ref`` gets no kernel, and a failed emission is
    recorded as a degradation, never raised."""
    cfg = config or SaturatorConfig(mode="accsat", cost_model="tpu_v5e")
    emitter = get_emitter(cfg.emitter or "triton")
    if emitter.info.target != "triton":
        raise ValueError(f"make_tile_op needs a triton emitter, got "
                         f"{emitter.info.name!r}")
    sk = saturate_program(prog, cfg)
    # emission follows the configuration that built sk: a ladder-degraded
    # build carries its cheap config, and re-running the full schedule
    # search here would re-hit whatever failed
    ecfg = sk.config
    tk = None
    if sk.ladder_level != "ref":
        try:
            tk = emitter.emit(
                sk.ssa, sk.extraction, bulk=ecfg.use_bulk,
                reuse_temps=ecfg.use_cse,
                schedule=sk.kernel.schedule
                if sk.kernel.schedule is not None else ecfg.schedule,
                sched_cost_model=ecfg.make_schedule_cost_model(prog))
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

    op = TileOp(name=prog.name, tk=tk, torch_ref=torch_ref,
                source=tk.source if tk is not None else sk.kernel.source,
                sk=sk, verify=cfg.verify)
    if cfg.verify != "off" and tk is not None:
        # the grid pass: certify the launch plan at a ragged synthetic
        # geometry, and the source in its layout, before anything runs
        from repro_torch.verify import verify_tile_op
        verify_tile_op(op)
    return op
