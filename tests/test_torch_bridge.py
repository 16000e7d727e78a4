"""The port's bridge (repro_torch.core.fx_bridge) against the JAX
package's (repro.core.jaxpr_bridge) on the CPU.

For each pair of functions, one in jnp and its twin in torch, both
bridges stage the function on the same seeded numpy inputs: the port's
tile program stores the same terms as the reference's, its saturated
kernel has the same number of operations, and its output matches both
the reference's bridged output and the torch function (2e-5, f32). Then
what the port does differently on purpose: ``alpha`` of add/sub/rsub is
a multiply, ``torch.remainder`` floors as the DSL's ``mod`` does while
the reference maps ``lax.rem`` (which truncates) to it, ``torch.fmod``
raises, a narrowing dtype cast raises (the reference passes it through
and never rounds), and what the bridge refuses is counted as a
fallback. The
emitted Triton kernels of ``mod`` and ``pow`` run on the CPU in
tests/test_torch_tile_exec.py and on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import BridgeUnsupported as JBridgeUnsupported
from repro.core import saturate_jax_fn
from repro_torch.core import (BridgeUnsupported, maybe_saturate,
                              reset_telemetry, saturate_torch_fn, telemetry)
from repro_torch.core.fx_bridge import BridgedKernel

TOL = dict(atol=2e-5, rtol=2e-5)


def _my_fn_jax(a, b):
    t = a * b + a * b          # redundant on purpose
    return t * jax.lax.logistic(t) + a * b


def _my_fn_torch(a, b):
    t = a * b + a * b
    return t * torch.sigmoid(t) + a * b


# name -> (jnp function, torch function, argument kinds: "a" a (rows, d)
# array, "s" a 0-d scalar)
PAIRS = {
    "my_fn": (_my_fn_jax, _my_fn_torch, "aa"),
    "scalar": (lambda a, s: a * s + jnp.exp(-a) / s,
               lambda a, s: a * s + torch.exp(-a) / s, "as"),
    "where_cmp": (
        lambda a, b: (lax.select(a > b, a, b * 2.0) + (a <= b) * a
                      + (a < 0.5) * b - (a >= b) + (a == b) + (a != b)),
        lambda a, b: (torch.where(a > b, a, b * 2.0) + (a <= b) * a
                      + (a < 0.5) * b - (a >= b).float() + (a == b)
                      + (a != b)),
        "aa"),
    "pow": (lambda a: a ** 2 + a ** -1 + a ** 3 + jnp.abs(a) ** 0.5,
            lambda a: a ** 2 + a ** -1 + a ** 3 + a.abs() ** 0.5, "a"),
    "unary": (
        lambda a, b: (jnp.tanh(a) + jnp.sqrt(jnp.abs(b))
                      + lax.rsqrt(jnp.abs(a) + 1.0)
                      + jnp.log(jnp.abs(b) + 1.0) + jnp.floor(a)
                      - jnp.maximum(a, b) * jnp.minimum(a, 0.25)
                      + a / (b * b + 1.0)),
        lambda a, b: (torch.tanh(a) + torch.sqrt(b.abs())
                      + torch.rsqrt(a.abs() + 1.0)
                      + torch.log(b.abs() + 1.0) + torch.floor(a)
                      - torch.maximum(a, b)
                      * torch.minimum(a, torch.tensor(0.25))
                      + a / (b * b + 1.0)),
        "aa"),
    "two_outputs": (lambda a, b: (a + b, a * b - 1.0),
                    lambda a, b: (a + b, a * b - 1.0), "aa"),
}


def _args(kinds, shape=(8, 256), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) if k == "a"
            else np.float32(rng.uniform(0.5, 1.5)) for k in kinds]


def _stores(sk):
    return [(s.target.name, s.expr) for s in sk.ssa.prog.body]


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_bridge_matches_the_reference(name):
    jfn, tfn, kinds = PAIRS[name]
    xs = _args(kinds)
    jargs = [jnp.asarray(x) for x in xs]
    targs = [torch.from_numpy(np.asarray(x)) for x in xs]
    jbk = saturate_jax_fn(jfn, jargs, name=name)
    bk = saturate_torch_fn(tfn, targs, name=name)
    assert isinstance(bk, BridgedKernel)
    assert _stores(bk.sk) == _stores(jbk.sk)
    assert bk.sk.kernel.stats.n_ops == jbk.sk.kernel.stats.n_ops
    got = _tuple(bk(*targs))
    for g, j, w in zip(got, _tuple(jbk(*jargs)), _tuple(tfn(*targs)),
                       strict=True):
        torch.testing.assert_close(g, torch.from_numpy(np.array(j)), **TOL)
        torch.testing.assert_close(g, w.float(), **TOL)


def test_example_cse_finds_the_shared_product():
    """The example's redundant ``a * b``: fewer operations after
    saturation than aten ops in the graph, as the reference reports."""
    bk = saturate_torch_fn(_my_fn_torch, [torch.ones(8, 128)] * 2,
                           name="my_fn")
    assert bk.sk.kernel.stats.n_ops < bk.n_eqns
    assert bk.n_consts == 0


@pytest.mark.parametrize("shape", [(1000,), (3, 5, 40), (2, 1, 3, 128)])
def test_any_rank_of_same_shaped_tensors(shape):
    a, b = (torch.from_numpy(x) for x in _args("aa", shape, seed=1))
    bk = saturate_torch_fn(_my_fn_torch, (a, b))
    out = bk(a, b)
    assert out.shape == shape
    torch.testing.assert_close(out, _my_fn_torch(a, b), **TOL)
    with pytest.raises(ValueError, match="same-shaped"):
        bk(a, b.reshape(-1)[:-1] if len(shape) == 1 else b.reshape(-1))


@pytest.mark.parametrize("fn,want", [
    (lambda a, b: torch.add(a, b, alpha=0.5),
     ("add", ("aload", "a0"), ("mul", ("aload", "a1"), ("const", 0.5)))),
    (lambda a, b: torch.sub(a, b, alpha=2),
     ("sub", ("aload", "a0"), ("mul", ("aload", "a1"), ("const", 2.0)))),
    (lambda a, b: torch.rsub(a, b, alpha=3),
     ("sub", ("aload", "a1"), ("mul", ("aload", "a0"), ("const", 3.0)))),
    (lambda a, b: 2.0 - a, ("sub", ("const", 2.0), ("aload", "a0"))),
], ids=["add", "sub", "rsub", "rsub_scalar"])
def test_alpha_is_honoured(fn, want):
    a, b = (torch.from_numpy(x) for x in _args("aa", seed=2))
    bk = saturate_torch_fn(fn, (a, b))
    assert _stores(bk.sk) == [("o0", want)]
    torch.testing.assert_close(bk(a, b), fn(a, b), **TOL)


def test_remainder_floors_and_fmod_raises():
    """The reference's fault (ROADMAP §C): its bridge maps ``lax.rem``,
    which truncates, to the DSL's ``mod``, which floors, so its bridged
    ``lax.rem`` differs from ``lax.rem`` where the signs differ. The
    port maps ``torch.remainder`` (floored) to ``mod`` and refuses
    ``torch.fmod`` (truncated)."""
    a = np.array([[-7.0, 7.0, -7.0, 7.0, -6.5, 5.25, 0.0, -0.0]],
                 np.float32)
    b = np.array([[2.0, 2.0, -2.0, -2.0, 4.0, -1.5, 3.0, -3.0]], np.float32)
    jbk = saturate_jax_fn(lambda x, y: lax.rem(x, y),
                          (jnp.asarray(a), jnp.asarray(b)))
    jgot = np.asarray(jbk(jnp.asarray(a), jnp.asarray(b)))
    jwant = np.asarray(lax.rem(jnp.asarray(a), jnp.asarray(b)))
    assert (jgot[0, :4] == [1.0, 1.0, -1.0, -1.0]).all()
    assert (jwant[0, :4] == [-1.0, 1.0, -1.0, 1.0]).all()
    assert not np.array_equal(jgot, jwant)

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    bk = saturate_torch_fn(torch.remainder, (ta, tb))
    assert _stores(bk.sk) == [("o0", ("mod", ("aload", "a0"),
                                      ("aload", "a1")))]
    assert torch.equal(bk(ta, tb), torch.remainder(ta, tb))
    with pytest.raises(BridgeUnsupported) as e:
        saturate_torch_fn(torch.fmod, (ta, tb))
    assert e.value.primitive == "aten.fmod"


def test_constants_scalar_or_refused():
    """A 0-d tensor constant is a DSL constant; a constant of rank >= 1
    is refused, as the reference refuses a non-scalar closure constant."""
    a = torch.from_numpy(_args("a", seed=3)[0])
    bk = saturate_torch_fn(lambda x: x * torch.tensor(3.0), (a,))
    assert bk.n_consts == 1
    assert _stores(bk.sk) == [("o0", ("mul", ("aload", "a0"),
                                      ("const", 3.0)))]
    torch.testing.assert_close(bk(a), a * 3.0, **TOL)
    bk = saturate_torch_fn(
        lambda x: x.expand(x.shape).clone().detach().float() * 2.0, (a,))
    assert _stores(bk.sk) == [("o0", ("mul", ("aload", "a0"),
                                      ("const", 2.0)))]
    row = torch.arange(256, dtype=torch.float32)
    with pytest.raises(BridgeUnsupported) as e:
        saturate_torch_fn(lambda x: x * row, (a,))
    assert e.value.primitive == "closure constant"
    jrow = jnp.arange(256, dtype=jnp.float32)
    with pytest.raises(JBridgeUnsupported) as je:
        saturate_jax_fn(lambda x: x * jrow, (jnp.asarray(a.numpy()),))
    assert je.value.primitive == "closure constant"


def test_sort_raises_and_falls_back_counted():
    x = torch.ones(8)
    with pytest.raises(BridgeUnsupported) as e:
        saturate_torch_fn(torch.sort, (x,))
    assert e.value.primitive == "aten.sort"
    reset_telemetry()
    fn, info = maybe_saturate(torch.sort, (x,), name="sorty")
    assert fn is torch.sort and info is None
    assert telemetry().snapshot()["bridge_fallbacks"] == {"aten.sort": 1}
    fn, info = maybe_saturate(_my_fn_torch, (x, x), name="ok")
    assert info is not None and fn is info.fn
    assert telemetry().snapshot()["bridge_fallbacks"] == {"aten.sort": 1}


def test_narrowing_cast_raises_and_widening_casts_bridge():
    """A cast that rounds is refused and counted: the tile program
    computes in one dtype, so ``(x.to(bf16) * 3).float()`` would bridge
    to a kernel that never rounds (the reference's bridge passes the
    cast through and is off jnp by the bf16 rounding). f32 -> f32 and
    bf16 -> f32 are exact and still bridge."""
    a = torch.from_numpy(_args("a", seed=5)[0])
    narrow = lambda x: (x.to(torch.bfloat16) * 3).float()  # noqa: E731
    with pytest.raises(BridgeUnsupported) as e:
        saturate_torch_fn(narrow, (a,))
    assert e.value.primitive == "aten._to_copy"
    reset_telemetry()
    fn, info = maybe_saturate(narrow, (a,), name="narrow")
    assert fn is narrow and info is None
    assert telemetry().snapshot()["bridge_fallbacks"] == {"aten._to_copy": 1}
    jb = saturate_jax_fn(lambda x: (x.astype(jnp.bfloat16) * 3)
                         .astype(jnp.float32), (jnp.asarray(a.numpy()),))
    assert np.abs(np.asarray(jb(jnp.asarray(a.numpy()))[0])
                  - narrow(a).numpy()).max() > 1e-3
    widen = lambda x: x.to(torch.float32) * 3  # noqa: E731
    bk = saturate_torch_fn(widen, (a,))
    torch.testing.assert_close(bk(a), a * 3, **TOL)
    ab = a.to(torch.bfloat16)
    bk = saturate_torch_fn(widen, (ab,))
    assert _stores(bk.sk) == [("o0", ("mul", ("aload", "a0"),
                                      ("const", 3.0)))]
    torch.testing.assert_close(bk(ab).float(), ab.float() * 3, **TOL)
    assert telemetry().snapshot()["bridge_fallbacks"] == {"aten._to_copy": 1}


def test_cpu_path_is_the_saturated_torch_function():
    """On CPU tensors the replacement runs the emitted torch function,
    as the reference's runs ``sk.kernel.fn``: no kernel launch counted."""
    a, b = (torch.from_numpy(x) for x in _args("aa", seed=4))
    bk = saturate_torch_fn(_my_fn_torch, (a, b))
    want = bk.sk.kernel.fn(a, b, torch.zeros_like(a))
    torch.testing.assert_close(bk(a, b), _tuple(want)[0], atol=0, rtol=0)
    assert bk.op.launches == 0
    assert bk.op.tk is not None and "sigmoid" in bk.op.source
