"""The paper's five saturation modes on the port, against the JAX package.

``saturate_all_modes`` saturates one program under the configurations the
paper compares (``baseline``, ``cse``, ``cse_sat``, ``cse_bulk``,
``accsat``). For the 13 tile programs, each mode's extraction (ops,
loads, FMAs, DAG cost) under the flat ``tpu_v5e`` model must equal the
JAX package's, and each mode's plain version (the torchgen function) must
match the JAX package's generated function of the same mode. Each mode's
Triton kernel, sync and pipelined, is executed on the CPU through the
numpy stand-in of tests/test_torch_tile_exec.py and held against its
plain version. The paper's Listing 1 (``matmul_tile``, a loop with
indexed loads) runs as generated torch source under every mode against
the reference interpreter."""
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SaturatorConfig as JaxConfig
from repro.core import saturate_all_modes as jax_all_modes
from repro.kernels.tile_programs import PROGRAMS as JAX_PROGRAMS
from repro.kernels.tile_programs import get_tile_op as jax_tile_op
from repro_torch.core import (MODES, KernelProgram, SaturatorConfig, c,
                              run_reference, saturate_all_modes)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
from test_torch_tile_exec import (TOL, _close, _install_standin, _run,
                                  _tile_inputs)
from test_torch_tile_ops import _inputs, _np, _outs

PIPE = "triton_pipelined"


@functools.lru_cache(maxsize=None)
def _both(name):
    """Both packages' five saturations of one program, flat TPU model."""
    return (saturate_all_modes(PROGRAMS[name](),
                               SaturatorConfig(cost_model="tpu_v5e")),
            jax_all_modes(JAX_PROGRAMS[name](),
                          JaxConfig(cost_model="tpu_v5e")))


def _stats(sk):
    st = sk.kernel.stats
    return {"n_ops": st.n_ops, "n_loads": st.n_loads, "n_fma": st.n_fma,
            "dag_cost": sk.extraction.dag_cost}


def test_modes_are_the_references():
    from repro.core import MODES as JAX_MODES
    assert MODES == JAX_MODES
    assert sorted(PROGRAMS) == sorted(JAX_PROGRAMS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_extraction_matches_reference(name, mode):
    port, ref = _both(name)
    assert list(port) == list(MODES)
    assert port[mode].config.mode == mode
    assert _stats(port[mode]) == _stats(ref[mode])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_mode_plain_version_matches_jax_mode(name, mode):
    xs, sc = _inputs(name, 6, 96, np.random.default_rng(3))
    want = jax_tile_op(name, mode=mode).jax_ref(
        *[jnp.asarray(x) for x in xs], **sc)
    got = get_tile_op(name, mode=mode).torch_ref(
        *[torch.from_numpy(x) for x in xs], **sc)
    for g, w in zip(_outs(got), _outs(want), strict=True):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("emitter", [None, PIPE], ids=["sync", "pipelined"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_mode_kernel_matches_plain(name, mode, emitter, monkeypatch):
    """Each mode's emitted kernel, executed through the stand-in at a
    ragged (37, 200) in f32 and bf16, and a reduction's at (5, 768) in
    two column pieces (512 + 256), where the baseline repeats each row
    reduction piece-wise."""
    _install_standin(monkeypatch)
    op = get_tile_op(name, mode=mode, emitter=emitter)
    assert op.tk is not None, f"{name}/{mode}: no Triton kernel"
    shapes = [(37, 200)] + ([(5, 768)] if op.tk.has_reduction
                            and not op.tk.halves else [])
    for rows, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            xs, sc = _tile_inputs(name, rows, d, dtype,
                                  np.random.default_rng(5))
            got, plan = _run(op.tk, xs, sc)
            if d == 768:
                assert plan.pieces == (512, 256)
            _close(got, op.torch_ref(*(x.expand(xs[0].shape) for x in xs),
                                     **sc), TOL[dtype])


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cse_modes_load_each_input_once(name):
    """With CSE every input is loaded once in the kernel (twice in half
    tiles: each half); the baseline recomputes each use of a shared
    value, its loads included, so it never loads fewer."""
    loads = {m: get_tile_op(name, mode=m).source.count("tl.load(")
             for m in MODES}
    tk = get_tile_op(name).tk
    once = len(tk.in_arrays) * (2 if tk.halves else 1)
    assert all(loads[m] == once for m in MODES if m != "baseline"), loads
    assert loads["baseline"] >= once


def test_baseline_repeats_shared_work():
    """rmsnorm's baseline reloads x at every use and reduces the row three
    times (its two uses of the mean and the store's recompute of it)."""
    src = get_tile_op("rmsnorm", mode="baseline").source
    assert src.count("tl.load(") > 10
    assert src.count("tl.sum(") >= 3
    assert get_tile_op("rmsnorm").source.count("tl.sum(") == 1


def _load_example(stem):
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the paper's Listing 1, as the quickstart builds it
matmul_tile = _load_example("quickstart_torch").matmul_tile


@pytest.mark.parametrize("mode", MODES)
def test_matmul_tile_modes_match_reference(mode):
    p = matmul_tile()
    sk = saturate_all_modes(p)[mode]
    rng = np.random.default_rng(0)
    A, B, C = (rng.normal(size=(4, 5)), rng.normal(size=(5, 6)),
               rng.normal(size=(4, 6)))
    ref = run_reference(p, dict(a=A, b=B, cmat=C, r=np.zeros((4, 6)),
                                alpha=1.5, beta=0.5, i=2, j=3, ax=5))
    out = sk(*(torch.from_numpy(x) for x in (A, B, C)),
             torch.zeros(4, 6, dtype=torch.float64), 1.5, 0.5, 2, 3, 5)
    np.testing.assert_allclose(np.asarray(out[0]), ref["r"], atol=1e-12)


def test_matmul_tile_fig2_columns_match_reference():
    """The quickstart's Fig. 2 columns of Listing 1 (ops, loads, FMAs,
    DAG cost) under every mode, equal in both packages under the flat
    ``tpu_v5e`` model."""
    from repro.core import KernelProgram as JaxProgram
    from repro.core import c as jc
    from repro.core import v as jv
    jp = JaxProgram("matmul_tile")
    a, b, cm = jp.array_in("a"), jp.array_in("b"), jp.array_in("cmat")
    jp.array_out("r")
    for s in ("alpha", "beta", "i", "j", "ax"):
        jp.scalar(s)
    jp.let("tmp", jc(0.0))
    with jp.for_("l", 0, jv("ax")):
        jp.let("tmp", jv("tmp") + a[jv("i"), jv("l")] * b[jv("l"), jv("j")])
    jp.store("r", jv("alpha") * jv("tmp") + jv("beta") * cm[jv("i"), jv("j")],
             jv("i"), jv("j"))
    port = saturate_all_modes(matmul_tile(),
                              SaturatorConfig(cost_model="tpu_v5e"))
    ref = jax_all_modes(jp, JaxConfig(cost_model="tpu_v5e"))
    for mode in MODES:
        assert _stats(port[mode]) == _stats(ref[mode]), mode


@pytest.mark.parametrize("mode", MODES)
def test_unemittable_term_raises_off_the_cpu_naming_its_mode(mode):
    """A term the Triton emitter cannot take (a float-to-int cast) builds
    a degraded op under every mode: its CPU path runs the mode's torch
    function, and a call on any other device raises, naming the program
    and the mode, rather than running a substitute."""
    from repro_torch.core import make_tile_op, toint
    p = KernelProgram("toint_op")
    x = p.array_in("x")
    p.array_out("o")
    p.store("o", toint(x.load() * c(1.5)))
    op = make_tile_op(p, SaturatorConfig(mode=mode, cost_model="tpu_v5e"))
    assert op.tk is None
    xs = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(op.apply(xs), (xs * 1.5).to(torch.int64))
    with pytest.raises(RuntimeError,
                       match=f"'toint_op' under mode '{mode}' has no Triton"):
        op.apply(torch.empty(3, 4, device="meta"))
