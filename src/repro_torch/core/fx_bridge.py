"""Automatic saturation of plain elementwise torch functions.

The port's counterpart of :mod:`repro.core.jaxpr_bridge`. The paper wraps
the compiler invocation and rewrites kernels with no user intervention;
here a user's function is staged to an aten-level FX graph
(``torch.fx.experimental.proxy_tensor.make_fx``), the supported
elementwise subset is turned into a tile program, the program is
saturated, and a drop-in replacement comes back. The replacement runs
through a :class:`~repro_torch.core.tritongen.TileOp`: on CPU tensors the
saturated torch function (what the JAX package's bridge runs), on CUDA
tensors the generated Triton kernel, one launch per call. A degraded
build raises on the card, as every tile op does.

Unsupported aten ops raise :class:`BridgeUnsupported`; callers fall back
to the original function, and :func:`maybe_saturate` counts each such
fallback (never a silent behavior change).

One deliberate difference from the reference: ``aten.remainder`` (which
floors, like the DSL's ``mod``) maps to ``mod``, while ``aten.fmod``
(truncated, with the dividend's sign) raises, since the DSL has no
truncated remainder. The JAX package maps ``lax.rem``, which truncates,
to ``mod`` and so returns floored remainders for mixed signs.

A second one: a dtype cast (``aten._to_copy``) that can lose a value
(f32 to bf16, a float to an integer) raises, since the tile program
computes in one dtype and would never round; a widening cast, or one to
the same dtype, is exact and passes through. The JAX package passes
every ``convert_element_type`` through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .dsl import Expr, KernelProgram
from .pipeline import SaturatedKernel, SaturatorConfig
from .telemetry import telemetry

# aten op (overload packet name) -> DSL op
_UNARY = {
    "neg": "neg", "exp": "exp", "log": "log", "tanh": "tanh",
    "sigmoid": "sigmoid", "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs",
    "floor": "floor", "reciprocal": "recip",
}
_BINARY = {
    "mul": "mul", "div": "div", "maximum": "max", "minimum": "min",
    "remainder": "mod",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
}
_PASSTHROUGH = ("_to_copy", "clone", "detach", "alias", "expand",
                "lift_fresh_copy")


class BridgeUnsupported(ValueError):
    """Raised when a function's graph cannot be bridged. ``primitive``
    names the offending aten op (``"aten.sort"``) or a pseudo-op like
    ``"closure constant"``, so fallbacks are counted per coverage gap."""

    def __init__(self, msg: str, primitive: str = ""):
        super().__init__(msg)
        self.primitive = primitive or msg


@dataclasses.dataclass
class BridgedKernel:
    fn: Callable
    sk: SaturatedKernel
    n_eqns: int
    n_consts: int
    op: Any = None          # the TileOp that runs it (its launch counter)

    def __call__(self, *args):
        return self.fn(*args)


def _aten_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return f"aten.{packet.__name__}"
    return getattr(target, "__name__", str(target))


def _narrows(src, dst) -> bool:
    """Whether a cast from ``src`` to ``dst`` can change a value: to a
    float without every value of ``src`` (fewer bits, or bf16 and f16
    either way; an integer wider than ``dst``'s significand), or to an
    integer from a float or a wider integer."""
    import torch
    if dst is None or dst == src or src == torch.bool:
        return False
    if dst.is_floating_point:
        fd = torch.finfo(dst)
        if src.is_floating_point:
            fs = torch.finfo(src)
            return not (fd.bits > fs.bits and fd.max >= fs.max
                        and fd.eps <= fs.eps)
        return torch.iinfo(src).bits > fd.nmant + 1
    if dst == torch.bool or src.is_floating_point:
        return True
    return torch.iinfo(dst).bits < torch.iinfo(src).bits


def _const(value) -> tuple:
    return ("const", float(value))


def _scaled(term: tuple, alpha) -> tuple:
    """``term * alpha``: add/sub/rsub's ``alpha`` is never dropped."""
    return term if alpha == 1 else ("mul", term, _const(alpha))


def _to_term(node, args: List[Any]) -> tuple:
    op = _aten_name(node.target).split(".", 1)[-1]
    overload = getattr(node.target, "_overloadname", "default")
    alpha = node.kwargs.get("alpha", 1)
    if op in _UNARY:
        return (_UNARY[op], args[0])
    if op in ("add", "sub"):
        return (op, args[0], _scaled(args[1], alpha))
    if op == "rsub":            # other - alpha * self
        return ("sub", args[1], _scaled(args[0], alpha))
    if op == "div" and overload not in ("Tensor", "Scalar"):
        raise BridgeUnsupported(f"aten.div.{overload} (rounding mode)",
                                primitive="aten.div")
    if op in _BINARY:
        return (_BINARY[op], args[0], args[1])
    if op == "pow":
        if overload == "Tensor_Scalar":
            y = node.args[1]
            if y == 2:
                return ("square", args[0])
            if y == -1:
                return ("recip", args[0])
            if y == 3:
                return ("mul", args[0], ("square", args[0]))
        return ("pow", args[0], args[1])
    if op == "where" and overload == "self":
        return ("select", args[0], args[1], args[2])
    if op == "_to_copy" and _narrows(node.args[0].meta["val"].dtype,
                                     node.kwargs.get("dtype")):
        raise BridgeUnsupported(
            f"aten._to_copy from {node.args[0].meta['val'].dtype} to "
            f"{node.kwargs['dtype']} rounds (the kernel computes in one "
            "dtype)", primitive="aten._to_copy")
    if op in _PASSTHROUGH:
        return args[0]
    raise BridgeUnsupported(f"{_aten_name(node.target)} not bridgeable",
                            primitive=_aten_name(node.target))


def saturate_torch_fn(fn: Callable, example_args: Sequence[Any],
                      config: Optional[SaturatorConfig] = None,
                      name: str = "bridged") -> BridgedKernel:
    """Stage ``fn`` and return a saturated drop-in replacement.

    ``fn`` must be elementwise over same-shaped tensors of any rank >= 1
    (0-d tensors are runtime scalars; Python numbers in its body are
    constants) with one tensor (or a tuple of them) out.
    """
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from .tritongen import make_tile_op

    cfg = config or SaturatorConfig()
    gm = make_fx(fn)(*example_args)
    prog = KernelProgram(name)
    terms: Dict[Any, tuple] = {}
    is_array: List[bool] = []
    n_eqns = n_consts = 0
    outputs = None

    def term_of(a):
        """A tensor's or a number's term; any other argument (a size list)
        passes through for the op's own handling."""
        if isinstance(a, torch.fx.Node):
            return terms[a]
        if isinstance(a, (bool, int, float)):
            return _const(a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            k = len(is_array)
            val = node.meta.get("val")
            is_array.append(val.dim() > 0)
            terms[node] = (prog.array_in(f"a{k}").load().t if is_array[-1]
                           else prog.scalar(f"s{k}").t)
        elif node.op == "get_attr":
            n_consts += 1
            value = getattr(gm, node.target)
            if value.dim() != 0:
                raise BridgeUnsupported("non-scalar closure constants",
                                        primitive="closure constant")
            terms[node] = _const(value.item())
        elif node.op == "call_function":
            n_eqns += 1
            if isinstance(node.meta.get("val"), (tuple, list)):
                raise BridgeUnsupported(
                    f"multi-output op {_aten_name(node.target)}",
                    primitive=_aten_name(node.target))
            if _aten_name(node.target) == "aten.scalar_tensor":
                terms[node] = _const(node.args[0])
                continue
            terms[node] = _to_term(node, [term_of(a) for a in node.args])
        elif node.op == "output":
            outputs = node.args[0]
        else:
            raise BridgeUnsupported(f"graph node {node.op}",
                                    primitive=node.op)
    if not any(is_array):
        raise BridgeUnsupported("no tensor argument of rank >= 1",
                                primitive="argument")
    single = not isinstance(outputs, (tuple, list))
    outputs = [outputs] if single else list(outputs)
    for k, out in enumerate(outputs):
        prog.array_out(f"o{k}")
        prog.store(f"o{k}", Expr(term_of(out)))

    # a float result of another dtype than the lead's (a widening cast
    # in the function) is stored in that dtype, as eager torch returns it
    lead = next(a for a, arr in zip(example_args, is_array) if arr)
    out_dtypes = {o.meta["val"].dtype for o in outputs
                  if isinstance(o, torch.fx.Node)}
    out_dtype = None
    if len(out_dtypes) == 1:
        dt = out_dtypes.pop()
        if dt.is_floating_point and dt != lead.dtype:
            out_dtype = dt
    elif len(out_dtypes) > 1:
        raise BridgeUnsupported(
            f"outputs of dtypes {sorted(map(str, out_dtypes))}",
            primitive="output dtypes")

    op = make_tile_op(prog, cfg)
    scalar_names = {k: f"s{k}" for k, arr in enumerate(is_array) if not arr}

    def wrapped(*args):
        if len(args) != len(is_array):
            raise TypeError(f"{name}: expected {len(is_array)} args, got "
                            f"{len(args)}")
        arrays = [a for a, arr in zip(args, is_array) if arr]
        shape = tuple(arrays[0].shape)
        if any(tuple(a.shape) != shape for a in arrays):
            raise ValueError(f"{name}: the bridged kernel takes same-shaped "
                             f"tensors, got {[tuple(a.shape) for a in arrays]}")
        # the tile op's (rows, D) view; a 1-D tensor is one row
        views = [a.reshape(-1, shape[-1]) for a in arrays]
        out = op.apply(*views, out_dtype=out_dtype,
                       **{scalar_names[k]: args[k] for k in scalar_names})
        outs = [o.reshape(shape) for o in (out if isinstance(out, tuple)
                                           else (out,))]
        return outs[0] if single else tuple(outs)

    return BridgedKernel(fn=wrapped, sk=op.sk, n_eqns=n_eqns,
                         n_consts=n_consts, op=op)


def maybe_saturate(fn: Callable, example_args: Sequence[Any],
                   config: Optional[SaturatorConfig] = None,
                   name: str = "bridged"
                   ) -> Tuple[Callable, Optional[BridgedKernel]]:
    """Best-effort bridge: returns (replacement_or_original, info).

    A fallback is never silent: the unsupported aten op is counted in
    :mod:`repro_torch.core.telemetry` so bridge coverage gaps stay
    visible."""
    try:
        bk = saturate_torch_fn(fn, example_args, config, name)
        return bk.fn, bk
    except BridgeUnsupported as e:
        telemetry().record_bridge_fallback(e.primitive, name)
        return fn, None
