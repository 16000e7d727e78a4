"""The port's persistent saturation cache (repro_torch.cache) on the CPU:
the JAX package's cache tests (tests/test_saturation_cache.py) run on the
port's pipeline — exact-hit replay, warm starts, robustness against
corrupt and stale entries, concurrent writers, the environment variable,
a cross-process hit under another PYTHONHASHSEED — and the port's keys
and cold documents held against the JAX package's for every tile
program under get_tile_op's configuration, with and without a device
profile (a re-fit under the same name changes the key), and the bridge's
fallback counted in the telemetry."""
import json
import os
import pathlib
import stat
import subprocess
import sys
import threading

import pytest

from repro_torch.cache import (FORMAT_VERSION, SaturationCache,
                               cache_key_for, choice_to_doc,
                               default_cache_dir, entry_digest,
                               schedule_to_doc)
from repro_torch.core import (CacheConfig, KernelProgram, SaturatorConfig,
                              ScheduleConfig, SearchConfig, VerifyConfig,
                              reset_telemetry, rmean, rsqrt,
                              saturate_program, telemetry)
from repro_torch.kernels.tile_programs import PROGRAMS


def _norm_prog(tile=(8, 128)):
    """rmsnorm-shaped program with a parameterized tile: same structure
    (= same warm key) for every tile, different exact key per shape."""
    p = KernelProgram("cache_norm")
    x = p.array_in("x", shape=tile)
    g = p.array_in("g", shape=(1, tile[1]))
    p.array_out("o", shape=tile)
    eps = p.scalar("eps")
    xv = x.load()
    inv = rsqrt(rmean(xv * xv) + eps)
    p.store("o", xv * inv * g.load())
    return p


def _cfg(tmp_path, *, mode="accsat", tpu_rules=True, cost_model="tpu_v5e",
         schedule=None, verify="off", cache_warm_start=True,
         beam_width=None):
    search = (SearchConfig(beam_width=beam_width)
              if beam_width is not None else SearchConfig())
    return SaturatorConfig(
        mode=mode, tpu_rules=tpu_rules, cost_model=cost_model,
        search_cfg=search,
        schedule_cfg=ScheduleConfig(schedule=schedule),
        cache_cfg=CacheConfig(cache_dir=str(tmp_path),
                              cache_warm_start=cache_warm_start),
        verify_cfg=VerifyConfig(verify=verify))


def _entry_files(tmp_path):
    return sorted(pathlib.Path(tmp_path).rglob("*.json"))


# -- exact hits -------------------------------------------------------------
@pytest.mark.parametrize("schedule", [None, "cost"])
def test_exact_hit_bit_identical_and_skips_search(tmp_path, schedule):
    """A second build of the same program+config replays from disk:
    no saturation, no beam search, no schedule search — and the
    generated kernel is bit-for-bit the cold one."""
    cfg = _cfg(tmp_path, schedule=schedule)
    cold = saturate_program(_norm_prog(), cfg)
    assert cold.cache_status == "miss"
    assert _entry_files(tmp_path), "cold run stored no entry"

    hit = saturate_program(_norm_prog(), cfg)
    assert hit.cache_status == "hit"
    assert hit.saturation is None            # run_rules never executed
    assert hit.extraction.search == "cache"  # beam/hillclimb never ran
    assert hit.kernel.source == cold.kernel.source
    assert hit.report()["sat_stop"] == "cached"
    # grafting the cached choice must leave a consistent e-graph
    hit.ssa.egraph.check_invariants(strict=True)


def test_hit_and_miss_telemetry(tmp_path):
    reset_telemetry()
    cfg = _cfg(tmp_path)
    saturate_program(_norm_prog(), cfg)
    saturate_program(_norm_prog(), cfg)
    snap = telemetry().snapshot()
    assert snap["cache_misses"] == 1
    assert snap["cache_hits"] == 1
    assert snap["cache_stores"] == 1
    assert snap["cache_hit_rate"] == 0.5
    assert snap["cold_wall_s"] > snap["hit_wall_s"] > 0


def test_no_cache_reports_off(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_SAT_CACHE", raising=False)
    sk = saturate_program(_norm_prog(), SaturatorConfig(mode="accsat"))
    assert sk.cache_status == "off"
    assert not _entry_files(tmp_path)


# -- warm starts ------------------------------------------------------------
def test_warm_start_on_shape_change(tmp_path):
    """Same kernel structure at a new shape: the entry seeds the beam
    and schedule search (status 'warm'), and the new shape's committed
    result is stored so the third build is an exact hit."""
    cfg = _cfg(tmp_path, schedule="cost")
    k8 = cache_key_for(_norm_prog((8, 128)), cfg)
    k16 = cache_key_for(_norm_prog((16, 128)), cfg)
    assert k8.warm_key == k16.warm_key
    assert k8.exact_key != k16.exact_key

    assert saturate_program(_norm_prog((8, 128)), cfg).cache_status == "miss"
    warm = saturate_program(_norm_prog((16, 128)), cfg)
    assert warm.cache_status == "warm"
    # the warm graft (cached choice unioned into the saturated e-graph)
    # must leave every invariant intact
    warm.ssa.egraph.check_invariants(strict=True)
    hit = saturate_program(_norm_prog((16, 128)), cfg)
    assert hit.cache_status == "hit"
    assert hit.kernel.source == warm.kernel.source


def test_hit_path_verified_when_enabled(tmp_path):
    """verify="cheap" audits the replayed build too (invariants,
    certified cached order, emitted source) — and stays off the key, so
    verified and unverified builds share entries."""
    cfg = _cfg(tmp_path, schedule="cost", verify="cheap")
    cold = saturate_program(_norm_prog(), cfg)
    assert cold.verify_report is not None and cold.verify_report.ok
    hit = saturate_program(_norm_prog(), cfg)
    assert hit.cache_status == "hit"       # verify didn't change the key
    assert hit.verify_report is not None and hit.verify_report.ok
    assert hit.verify_report.schedules_certified >= 1
    off = saturate_program(_norm_prog(), _cfg(tmp_path, schedule="cost"))
    assert off.cache_status == "hit"
    assert off.verify_report is None       # off = no verification work


def test_warm_start_can_be_disabled(tmp_path):
    cfg = _cfg(tmp_path)
    saturate_program(_norm_prog((8, 128)), cfg)
    cfg_nw = _cfg(tmp_path, cache_warm_start=False)
    assert saturate_program(
        _norm_prog((16, 128)), cfg_nw).cache_status == "miss"


# -- key determinism & invalidation -----------------------------------------
def test_keys_deterministic_across_builds(tmp_path):
    cfg = _cfg(tmp_path)
    a = cache_key_for(_norm_prog(), cfg)
    b = cache_key_for(_norm_prog(), cfg)   # a *fresh* program object
    assert (a.warm_key, a.exact_key) == (b.warm_key, b.exact_key)


@pytest.mark.parametrize("change", ["rules", "config", "emitter"])
def test_a_change_of_rules_or_config_invalidates(tmp_path, change):
    """Dropping the TPU rule set changes the rules fingerprint, a
    search budget or the emitter the config fingerprint: the old entry
    must not be served (not even as a warm seed)."""
    saturate_program(_norm_prog(), _cfg(tmp_path))
    other = {"rules": _cfg(tmp_path, tpu_rules=False),
             "config": _cfg(tmp_path, beam_width=4),
             "emitter": SaturatorConfig(
                 mode="accsat", tpu_rules=True, cost_model="tpu_v5e",
                 schedule_cfg=ScheduleConfig(emitter="triton_pipelined"),
                 cache_cfg=CacheConfig(cache_dir=str(tmp_path)))}[change]
    assert saturate_program(_norm_prog(), other).cache_status == "miss"


def test_default_emitters_add_no_key_component(tmp_path):
    """None, "torch" and "triton" key alike (the JAX package's default
    emitters' keys); "triton_pipelined" adds its versioned id."""
    keys = {em: cache_key_for(_norm_prog(), SaturatorConfig(
        mode="accsat", schedule_cfg=ScheduleConfig(emitter=em)))
        for em in (None, "torch", "triton", "triton_pipelined")}
    assert keys[None] == keys["torch"] == keys["triton"]
    assert keys["triton_pipelined"].warm_key != keys[None].warm_key
    from repro_torch.cache import emitter_cache_id
    assert emitter_cache_id("triton_pipelined") == "triton_pipelined@v1"
    assert emitter_cache_id("triton") is None


# -- robustness -------------------------------------------------------------
def _truncate(doc_text):
    return doc_text[: len(doc_text) // 2]


def _garbage(doc):
    doc["choice"]["nodes"] = doc["choice"]["nodes"][:1]  # valid JSON, bogus
    return doc


def _bitflip(doc):
    doc["dag_cost"] = float(doc["dag_cost"]) + 1.0   # digest left stale
    return doc


@pytest.mark.parametrize("damage", ["truncated", "garbage", "bitflip",
                                    "format", "extractor_version"])
def test_damaged_entry_falls_back_cold(tmp_path, damage):
    """A truncated file, valid JSON with a bogus payload, a mutated
    sealed field (stale digest) or a version mismatch is a counted
    miss: rebuilt cold, with the cold source, and the rebuild repairs
    the entry."""
    cfg = _cfg(tmp_path)
    cold = saturate_program(_norm_prog(), cfg)
    [f] = _entry_files(tmp_path)
    if damage == "truncated":
        f.write_text(_truncate(f.read_text()))
    else:
        doc = json.loads(f.read_text())
        if damage == "garbage":
            doc = _garbage(doc)
        elif damage == "bitflip":
            doc = _bitflip(doc)
        else:
            doc[damage] = doc.get(damage, FORMAT_VERSION) + 1
        f.write_text(json.dumps(doc))
    reset_telemetry()
    again = saturate_program(_norm_prog(), cfg)
    assert again.cache_status == "miss"
    assert again.kernel.source == cold.kernel.source
    assert telemetry().snapshot()["cache_invalid"] >= 1
    if damage == "bitflip":
        assert any("digest" in e.get("reason", "")
                   for e in telemetry().events)
    assert saturate_program(_norm_prog(), cfg).cache_status == "hit"


def test_concurrent_writers_do_not_clobber(tmp_path):
    """Many threads racing put() on the same key: atomic tmp+rename
    means the entry file is always one complete JSON document."""
    cfg = _cfg(tmp_path)
    saturate_program(_norm_prog(), cfg)
    cache = SaturationCache(tmp_path)
    key = cache_key_for(_norm_prog(), cfg)
    entry, status = cache.lookup(key)
    assert status == "hit"

    errors = []

    def writer():
        try:
            for _ in range(25):
                assert cache.put(key, entry)
                got, st = cache.lookup(key)
                assert st == "hit" and got["choice"] == entry["choice"]
        except Exception as e:   # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    # no half-written temp files left behind
    assert not list(pathlib.Path(tmp_path).rglob("*.tmp"))
    assert saturate_program(_norm_prog(), cfg).cache_status == "hit"


def test_var_payload_injection_rejected(tmp_path):
    """codegen emits 'var' payloads verbatim into exec'd source, so a
    crafted entry (with a *valid* digest — the digest is integrity, not
    authentication) must be refused at graft time when its var payload
    is not a variable of the kernel."""
    cfg = _cfg(tmp_path)
    cold = saturate_program(_norm_prog(), cfg)
    [f] = _entry_files(tmp_path)
    doc = json.loads(f.read_text())
    planted = False
    for node in doc["choice"]["nodes"]:
        if node[0] == "var":
            node[2] = ["str", "__import__('os').getpid()"]
            planted = True
            break
    assert planted, "expected a var node (eps) in the cached choice"
    doc["digest"] = entry_digest(doc)
    f.write_text(json.dumps(doc))
    reset_telemetry()
    again = saturate_program(_norm_prog(), cfg)
    assert again.cache_status == "miss"
    assert again.kernel.source == cold.kernel.source
    assert "__import__" not in again.kernel.source
    assert any("not a variable" in e.get("reason", "")
               for e in telemetry().events)


def test_world_writable_root_disables_cache(tmp_path):
    """A pre-existing group/other-writable cache root (another local
    user could have planted entries) is refused: the cache silently
    stays off — no reads, no writes, build still works."""
    shared = tmp_path / "shared"
    shared.mkdir()
    os.chmod(shared, 0o777)
    reset_telemetry()
    cfg = _cfg(shared)
    assert saturate_program(_norm_prog(), cfg).cache_status == "miss"
    assert saturate_program(_norm_prog(), cfg).cache_status == "miss"
    assert not _entry_files(shared)
    assert telemetry().snapshot()["cache_invalid"] >= 1


def test_fresh_root_is_created_private(tmp_path):
    root = tmp_path / "newdir"
    saturate_program(_norm_prog(), _cfg(root))
    assert stat.S_IMODE(os.stat(root).st_mode) == 0o700
    assert saturate_program(_norm_prog(), _cfg(root)).cache_status == "hit"


def test_default_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert default_cache_dir() == tmp_path / "repro_torch" / "sat_cache"


def test_warm_graft_failure_falls_back_clean(tmp_path):
    """A digest-valid entry whose schedule cannot graft must not poison
    the warm path: the pipeline rebuilds + re-saturates and produces
    exactly what a cache-less cold build produces."""
    cfg = _cfg(tmp_path, schedule="cost")
    saturate_program(_norm_prog((8, 128)), cfg)
    [f] = _entry_files(tmp_path)
    doc = json.loads(f.read_text())
    path_key = next(iter(doc["schedule"]["orders"]))
    doc["schedule"]["orders"][path_key][0] = ["bogus", 0]
    doc["digest"] = entry_digest(doc)
    f.write_text(json.dumps(doc))
    reset_telemetry()
    poisoned = saturate_program(_norm_prog((16, 128)), cfg)
    assert poisoned.cache_status == "miss"
    assert telemetry().snapshot()["cache_invalid"] >= 1
    nocache = saturate_program(
        _norm_prog((16, 128)),
        SaturatorConfig(mode="accsat", tpu_rules=True,
                        cost_model="tpu_v5e",
                        schedule_cfg=ScheduleConfig(schedule="cost"),
                        cache_cfg=CacheConfig(cache_dir=False)))
    assert poisoned.kernel.source == nocache.kernel.source


def test_bridge_fallback_is_counted():
    """A function the bridge cannot take comes back unchanged, and the
    fallback is counted once under its aten op."""
    import torch

    from repro_torch.core.fx_bridge import maybe_saturate
    reset_telemetry()

    def f(x):
        return torch.sort(x)

    fn, info = maybe_saturate(f, (torch.ones(8),), name="sorty")
    assert info is None and fn is f
    snap = telemetry().snapshot()
    assert snap["bridge_fallbacks"] == {"aten.sort": 1}
    assert any(e.get("fn") == "sorty" for e in telemetry().events)


def test_unwritable_cache_dir_is_nonfatal(tmp_path):
    """A cache that cannot store (read-only dir) must never break the
    build — it just stays cold."""
    ro = tmp_path / "ro"
    ro.mkdir()
    os.chmod(ro, 0o555)
    try:
        sk = saturate_program(_norm_prog(), _cfg(ro))
        assert sk.cache_status == "miss"
        assert sk.kernel.source
    finally:
        os.chmod(ro, 0o755)


# -- cross-process ----------------------------------------------------------
_SUB = """
import hashlib, sys
from repro_torch.core import (CacheConfig, SaturatorConfig, ScheduleConfig,
                              saturate_program)
from repro_torch.kernels.tile_programs import PROGRAMS, get_tile_op
cfg = SaturatorConfig(mode="accsat", tpu_rules=True, cost_model="tpu_v5e",
                      schedule_cfg=ScheduleConfig(schedule="cost"),
                      cache_cfg=CacheConfig(cache_dir=sys.argv[1]))
sk = saturate_program(PROGRAMS["rmsnorm_gated"](), cfg)
op = get_tile_op("rotary", cache_dir=sys.argv[1])
print("CACHE", sk.cache_status, op.sk.cache_status,
      hashlib.sha256(sk.kernel.source.encode()).hexdigest(),
      hashlib.sha256(op.source.encode()).hexdigest())
"""


def _run_sub(code, cache_dir, hashseed):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["PYTHONHASHSEED"] = hashseed
    env.pop("REPRO_SAT_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code, str(cache_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cross_process_hit_different_hashseed(tmp_path):
    """An entry written by one process is an exact, bit-identical hit
    in another process with a different PYTHONHASHSEED (e-class ids and
    set-iteration orders differ — nothing id-dependent may leak into
    the entry); the tile op's Triton source replays too."""
    first = _run_sub(_SUB, tmp_path, hashseed="3").split()
    second = _run_sub(_SUB, tmp_path, hashseed="19").split()
    assert first[1:3] == ["miss", "miss"]
    assert second[1:3] == ["hit", "hit"]
    assert first[3:] == second[3:]


def test_env_var_enables_cache(tmp_path, monkeypatch):
    from repro_torch.core.pipeline import CACHE_ENV_VAR
    monkeypatch.setenv(CACHE_ENV_VAR, str(tmp_path))
    cfg = SaturatorConfig(mode="accsat", tpu_rules=True)
    assert saturate_program(_norm_prog(), cfg).cache_status == "miss"
    assert saturate_program(_norm_prog(), cfg).cache_status == "hit"
    # --no-cache resolves to cache_dir=False, which beats the variable
    off = SaturatorConfig.from_env(flags={"no_cache": True},
                                   mode="accsat", tpu_rules=True)
    assert off.cache_dir is False
    assert saturate_program(_norm_prog(), off).cache_status == "off"


def test_from_env_precedence(tmp_path):
    env = {"REPRO_SAT_CACHE": str(tmp_path / "env"), "REPRO_VERIFY": "full"}
    cfg = SaturatorConfig.from_env(env=env)
    assert (cfg.cache_dir, cfg.verify) == (str(tmp_path / "env"), "full")
    cfg = SaturatorConfig.from_env(env=env, flags={
        "cache_dir": str(tmp_path / "flag"), "verify": "cheap"})
    assert (cfg.cache_dir, cfg.verify) == (str(tmp_path / "flag"), "cheap")
    cfg = SaturatorConfig.from_env(env=env, verify="off",
                                   cache_dir=str(tmp_path / "arg"))
    assert (cfg.cache_dir, cfg.verify) == (str(tmp_path / "arg"), "off")
    assert SaturatorConfig.from_env(env={}).verify == "off"


# -- the tile ops' process-wide settings ---------------------------------------
def test_tile_ops_build_through_the_process_wide_cache(tmp_path):
    """``ops.set_saturation_cache``/``set_saturation_verify`` reach every
    tile op built after them (one op per configuration), a replay is an
    exact hit with the cold sources, and a host restart re-applies both
    settings."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tile_programs import get_tile_op
    try:
        ops.set_saturation_cache(tmp_path)
        ops.set_saturation_verify("cheap")
        cold = get_tile_op("rmsnorm")
        assert cold is get_tile_op("rmsnorm", cache_dir=str(tmp_path),
                                   verify="cheap")
        assert cold.sk.cache_status == "miss"
        assert cold.verify == "cheap" and cold.sk.verify_report.ok
        get_tile_op.cache_clear()
        hit = get_tile_op("rmsnorm")
        assert hit.sk.cache_status == "hit"
        assert (hit.source, hit.sk.kernel.source) == \
            (cold.source, cold.sk.kernel.source)
    finally:
        ops.set_saturation_cache(None)
        ops.set_saturation_verify(None)
    assert get_tile_op("rmsnorm").verify == "off"
    with pytest.raises(ValueError):
        ops.set_saturation_verify("strict")


def test_recovery_reapplies_the_saturation_settings(tmp_path):
    from repro_torch.kernels import ops
    from repro_torch.runtime.ft import (ElasticTrainer, FailureEvent,
                                        TrainLoopConfig)
    try:
        ops.set_saturation_cache(tmp_path)
        ops.set_saturation_verify("cheap")
        tr = ElasticTrainer(TrainLoopConfig(total_steps=1,
                                            ckpt_dir=str(tmp_path / "ck"),
                                            simulate_host_restart=True),
                            lambda n: (None, None), {}, {}, num_shards=1)
        ops.set_saturation_cache(None)
        ops.set_saturation_verify(None)
        tr._recover(FailureEvent(step=0, kind="node_loss", lost_hosts=1))
        assert ops.current_saturation_cache() == str(tmp_path)
        assert ops.current_saturation_verify() == "cheap"
    finally:
        ops.set_saturation_cache(None)
        ops.set_saturation_verify(None)


# -- against the JAX package ----------------------------------------------------
def _jax_tile_cfg():
    import repro.core as jcore
    return jcore.SaturatorConfig(mode="accsat", cost_model="tpu_v5e",
                                 tpu_rules=True)


def _port_tile_cfg():
    return SaturatorConfig(mode="accsat", cost_model="tpu_v5e",
                           tpu_rules=True)


def test_device_profile_key_equals_the_reference(tmp_path):
    """The same profile file gives the same ``device_profile_id`` and the
    same cache key in both packages (``<name>@<digest of the fitted
    params>``), and a re-fit under the same name changes both."""
    import dataclasses

    import repro.cache as jcache
    import repro.core as jcore
    from repro.cache.keys import device_profile_id as j_profile_id
    from repro.kernels.tile_programs import PROGRAMS as JPROGRAMS

    from repro_torch.analysis import CalibrationParams, DeviceProfile
    from repro_torch.cache.keys import device_profile_id

    prof = DeviceProfile(
        name="h100_fit", chip="NVIDIA H100 80GB HBM3",
        measured_kind="triton_compiled",
        params=CalibrationParams(hbm_efficiency=0.8, base_ns=2.0,
                                 vpu_pass_coeffs={"simple": 0.5},
                                 overlap_efficiency=0.3))
    path = str(prof.save(tmp_path / "h100_fit.json"))

    def keys():
        jcfg = jcore.SaturatorConfig(
            mode="accsat", cost_model="tpu_v5e", tpu_rules=True,
            schedule_cfg=jcore.ScheduleConfig(schedule="cost",
                                              device_profile=path))
        pcfg = SaturatorConfig(
            mode="accsat", cost_model="tpu_v5e", tpu_rules=True,
            schedule_cfg=ScheduleConfig(schedule="cost",
                                        device_profile=path))
        pid = device_profile_id(pcfg)
        assert pid == j_profile_id(jcfg) and pid.startswith(f"{path}@")
        pk = cache_key_for(PROGRAMS["rmsnorm"](), pcfg)
        jk = jcache.cache_key_for(JPROGRAMS["rmsnorm"](), jcfg)
        assert (pk.warm_key, pk.exact_key) == (jk.warm_key, jk.exact_key)
        assert pk.components == jk.components
        return pid, pk.exact_key

    first = keys()
    prof.params = dataclasses.replace(prof.params, hbm_efficiency=0.9)
    prof.save(path)
    second = keys()
    assert first[0] != second[0] and first[1] != second[1]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_keys_and_cold_documents_equal_the_reference(name):
    """Under get_tile_op's configuration (default emitter) the port's
    warm and exact keys equal the JAX package's, and so do the cold
    build's choice and schedule documents (same process, same seed):
    the statement orders, not the schedule's predicted times, which each
    package prices for its own chip."""
    import repro.cache as jcache
    from repro.core import saturate_program as jsaturate
    from repro.core.pipeline import _schedule_cm as j_schedule_cm
    from repro.core.schedule import compute_schedule as jcompute
    from repro.kernels.tile_programs import PROGRAMS as JPROGRAMS

    from repro_torch.core.pipeline import _schedule_cm
    from repro_torch.core.schedule import compute_schedule

    jcfg, pcfg = _jax_tile_cfg(), _port_tile_cfg()
    jk = jcache.cache_key_for(JPROGRAMS[name](), jcfg)
    pk = cache_key_for(PROGRAMS[name](), pcfg)
    assert (pk.warm_key, pk.exact_key) == (jk.warm_key, jk.exact_key)
    assert pk.components == jk.components

    def docs(sk, to_choice, to_sched, compute, cm):
        eg = sk.ssa.egraph
        cdoc, index_of = to_choice(eg, sk.extraction.choice,
                                   sk.extraction.roots)
        sr = sk.kernel.schedule or compute(
            sk.ssa, dict(sk.extraction.choice), mode=sk.config.schedule_mode,
            cost_model=cm(sk.config, sk.ssa.prog, eg), move_budget=0)
        sdoc = to_sched(sr, eg, index_of)
        return cdoc, {k: sdoc[k] for k in ("mode", "orders")}

    jsk = jsaturate(JPROGRAMS[name](), jcfg)
    psk = saturate_program(PROGRAMS[name](), pcfg)
    assert docs(psk, choice_to_doc, schedule_to_doc, compute_schedule,
                _schedule_cm) == docs(jsk, jcache.choice_to_doc,
                                      jcache.schedule_to_doc, jcompute,
                                      j_schedule_cm)
