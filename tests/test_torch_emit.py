"""The port's emitter registry (``repro_torch.core.emit``) against the JAX
package's (``repro.core.emit``): the same metadata, name for name
(torch / jax, triton / pallas, triton_pipelined / pallas_pipelined), the
same versions and cache-key rule, the same refusals; ``emit`` equal to
the generator it fronts; ``make_tile_op`` building through it; the cache
keys pinned as they were before the registry; and ``repro_torch.core``'s
names covering ``repro.core``'s."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

import repro.core as ref_core
import repro.core.emit as ref_emit
import repro_torch.core as port_core
from repro_torch.cache import cache_key_for, config_fingerprint
from repro_torch.core import (EMITTER_NAMES, Emitter, EmitterInfo,
                              SaturatorConfig, ScheduleConfig, get_emitter,
                              make_tile_op, reset_telemetry,
                              saturate_program, telemetry)
from repro_torch.core import tritongen
from repro_torch.core.emit import emitter_cache_id
from repro_torch.core.torchgen import TorchCodeGenerator
from repro_torch.core.tritongen import (TritonGenerator,
                                        TritonPipelinedGenerator)
from repro_torch.kernels.tile_programs import PROGRAMS

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port's emitter for each of the JAX package's
TWINS = {"torch": "jax", "triton": "pallas",
         "triton_pipelined": "pallas_pipelined"}
# the port's targets for the JAX package's
TARGETS = {"torch": "jax", "triton": "pallas"}
# the names of repro.core the port has no twin of under the same name:
# the Pallas generators and their row-block helper (the Triton twins are
# TritonGenerator, TritonPipelinedGenerator and tritongen's plans) and
# the jaxpr bridge (the port's is saturate_torch_fn)
JAX_ONLY = {"PallasGenerator": "TritonGenerator",
            "SyncPallasGenerator": "TritonGenerator",
            "PipelinedPallasGenerator": "TritonPipelinedGenerator",
            "pick_row_block": "plan_tile_call",
            "saturate_jax_fn": "saturate_torch_fn"}


def test_emitter_info_has_the_references_fields():
    assert [f.name for f in dataclasses.fields(EmitterInfo)] == \
        [f.name for f in dataclasses.fields(ref_emit.EmitterInfo)]
    info = get_emitter("triton").info
    with pytest.raises(dataclasses.FrozenInstanceError):
        info.version = 2


@pytest.mark.parametrize("name", EMITTER_NAMES)
def test_registry_name_for_name(name):
    twin = TWINS[name]
    assert EMITTER_NAMES == ("torch", "triton", "triton_pipelined")
    assert tuple(TWINS.values()) == ref_emit.EMITTER_NAMES
    em, ref = get_emitter(name), ref_emit.get_emitter(twin)
    assert isinstance(em, Emitter) and em.info.name == name
    assert em.info.version == ref.info.version
    assert TARGETS[em.info.target] == ref.info.target
    # the default emitters contribute no key; the others name@version
    port_id, ref_id = emitter_cache_id(name), ref_emit.emitter_cache_id(twin)
    assert (port_id is None) == (ref_id is None)
    if port_id is not None:
        assert port_id == f"{name}@v{em.info.version}"
        assert ref_id == f"{twin}@v{ref.info.version}"
    assert emitter_cache_id(None) is None


def test_targets_and_generators():
    assert {n: get_emitter(n).info.target for n in EMITTER_NAMES} == \
        {"torch": "torch", "triton": "triton", "triton_pipelined": "triton"}
    assert get_emitter("torch").generator_cls is TorchCodeGenerator
    assert get_emitter("triton").generator_cls is TritonGenerator
    assert get_emitter("triton_pipelined").generator_cls is \
        TritonPipelinedGenerator


@pytest.mark.parametrize("name", ["cuda", "jax", "pallas",
                                  "pallas_pipelined"])
def test_unknown_emitter_refused(name):
    with pytest.raises(ValueError, match="unknown emitter"):
        get_emitter(name)
    with pytest.raises(ValueError, match="unknown emitter"):
        emitter_cache_id(name)
    with pytest.raises(ValueError, match="emitter"):
        SaturatorConfig(schedule_cfg=ScheduleConfig(emitter=name))


def test_cache_package_keeps_the_function():
    from repro_torch.cache import emitter_cache_id as from_cache
    from repro_torch.cache.keys import emitter_cache_id as from_keys
    assert from_cache is emitter_cache_id and from_keys is emitter_cache_id


def _saturated(name):
    return saturate_program(PROGRAMS[name](),
                            SaturatorConfig(mode="accsat",
                                            cost_model="tpu_v5e",
                                            tpu_rules=True))


# rmsnorm (a row reduction) and swiglu (no reduction)
@pytest.mark.parametrize("prog", ["rmsnorm", "swiglu"])
def test_registry_emit_matches_direct_generator(prog):
    sk = _saturated(prog)
    opts = dict(bulk=True, schedule=sk.kernel.schedule)
    direct = TorchCodeGenerator(sk.ssa, sk.extraction, **opts).generate()
    via = get_emitter("torch").emit(sk.ssa, sk.extraction, **opts)
    assert via.source == direct.source
    for name, cls in (("triton", TritonGenerator),
                      ("triton_pipelined", TritonPipelinedGenerator)):
        tdirect = cls(sk.ssa, sk.extraction, **opts).generate_triton()
        tvia = get_emitter(name).emit(sk.ssa, sk.extraction, **opts)
        assert tvia.source == tdirect.source, name
        assert tvia.template == tdirect.template, name
        assert tvia.pipelined == (name == "triton_pipelined")
        if tvia.twin is not None:
            assert tvia.twin.source == tdirect.twin.source


def test_make_tile_op_builds_through_the_registry(monkeypatch):
    calls = []
    real = tritongen.get_emitter

    def spy(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(tritongen, "get_emitter", spy)
    cfg = SaturatorConfig(mode="accsat", cost_model="tpu_v5e")
    op = make_tile_op(PROGRAMS["swiglu"](), cfg)
    piped = make_tile_op(PROGRAMS["swiglu"](), SaturatorConfig(
        mode="accsat", cost_model="tpu_v5e", emitter="triton_pipelined"))
    assert calls == ["triton", "triton_pipelined"]
    assert op.tk is not None and not op.tk.pipelined
    assert piped.tk is not None and piped.tk.pipelined
    with pytest.raises(ValueError, match="needs a triton emitter"):
        make_tile_op(PROGRAMS["swiglu"](), SaturatorConfig(
            mode="accsat", cost_model="tpu_v5e", emitter="torch"))


def test_make_tile_op_records_a_failed_emission(monkeypatch):
    """The ladder contract: an emission failure is a degradation, never
    raised; the op keeps its plain version."""
    class Failing(Emitter):
        info = EmitterInfo("triton", 1, "triton")

        def emit(self, ssa, extraction, **options):
            raise RuntimeError("emission failed")

    monkeypatch.setattr(tritongen, "get_emitter", lambda name: Failing())
    reset_telemetry()
    op = make_tile_op(PROGRAMS["swiglu"](),
                      SaturatorConfig(mode="accsat", cost_model="tpu_v5e"))
    assert op.tk is None
    assert telemetry().snapshot()["guard"]["degradations"] == {"torch": 1}
    reset_telemetry()


# config_fingerprint, warm key and exact key of rmsnorm's program, as the
# tree before the registry computed them: (mode, emitter) -> digests
PINNED = {
    ("accsat", None): (
        "707dc211eaacc1d04bb1c02501c56b42e3f70bd340a5ec5e49b7a4aee32de6be",
        "594fc8270c0aa2747bed72a142a581d57704a515998b923c2aaffe907f4082f9",
        "c1e7daa2e87400737dd8703e587ba157978442f8dc1c2237bbb00d275974bf2b"),
    ("accsat", "triton_pipelined"): (
        "c8e0934143c8e1a9756d9271c034bd5a3ccd7ee9ec33d68c6bf913beedf5bb74",
        "1f8159b759fc2743223fe52d5507050cba570353d171ee78d6fecc48fd1b06f0",
        "feed60e9962cadfb80507b06ea0419ae9f96aee0e54b241561716c8d133ee84e"),
    ("cse", None): (
        "170676ab0998d7251a6391a6cac1999141bb26b53b0676ef439dc020109b2302",
        "8898fcb11705cd354dc70d2334f0364fd30b5ba28d9b233b2fbfca5eea7ea3c9",
        "73701a8da407557d3369b6470a28411f2c3d3f66209c2f1ed9bd43dea0cd02cd"),
    ("cse", "triton_pipelined"): (
        "a3dfabeeea4351a05beaf14ba05dccacdddd23717a75c339fa9eb7a0eed009b8",
        "855c2694a991fa0821234a859b4e932e2693fc2284772fbf307e9239c5bf83ce",
        "95f31d0f1b86711839350d6f77bb7cb3a6d625fb39cd178b8aadb4c6f72ee4b7"),
}


@pytest.mark.parametrize("mode,emitter", sorted(PINNED, key=str))
def test_cache_keys_are_pinned(mode, emitter):
    for em in ((None, "triton") if emitter is None else (emitter,)):
        cfg = SaturatorConfig(mode=mode, cost_model="tpu_v5e", emitter=em)
        key = cache_key_for(PROGRAMS["rmsnorm"](), cfg)
        assert (config_fingerprint(cfg), key.warm_key, key.exact_key) == \
            PINNED[(mode, emitter)], (mode, em)


def test_core_covers_the_references_names():
    missing = sorted(set(ref_core.__all__) - set(port_core.__all__)
                     - set(JAX_ONLY))
    assert not missing, missing
    for name in port_core.__all__:
        assert hasattr(port_core, name), name
    for ref_name, twin in JAX_ONLY.items():
        assert ref_name in ref_core.__all__ and ref_name not in \
            port_core.__all__
        assert hasattr(port_core, twin) or hasattr(tritongen, twin), twin


def test_registry_imports_without_jax():
    code = ("import builtins; real = builtins.__import__\n"
            "def imp(name, *a, **k):\n"
            "    if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "        raise ImportError(name)\n"
            "    return real(name, *a, **k)\n"
            "builtins.__import__ = imp\n"
            "from repro_torch.core import (get_emitter, Emitter, "
            "EmitterInfo, EMITTER_NAMES)\n"
            "print(get_emitter('triton_pipelined').info)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "triton_pipelined" in proc.stdout
