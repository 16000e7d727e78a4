"""The port's calibration (repro_torch.analysis.calibrate) on the CPU.

The JAX package's calibration tests (tests/test_calibration.py) that
apply run on the port: synthetic ground truth, bad input, Spearman and
MAPE, round trip, schema drift, an unknown profile, degradation, the
loaded LatencyModel in lock-step with predict_ns, model_chip and
tile_elems honoured, pass coefficients, a profile changing the beam's
choice and threading through the pipeline. Then the port against the
reference on the same inputs: the fit on the reference's stored evidence
(experiments/device_profiles/cpu_pallas_interpret_sched.json, read as
JSON data, with a port ChipSpec that carries tpu_v5e's numbers) equal to
the last bit, and the calibration features of every tile program under
every schedule equal to the reference's. Last, the committed H100
profile re-scores from its stored evidence, and a profile fitted on a
chip the port does not model fails to load."""
import dataclasses
import json
import pathlib

import pytest

from repro.analysis import calibrate as ref_cal
from repro.core import compute_schedule as ref_compute_schedule
from repro.core.hardware import TPU_V5E
from repro.kernels.tile_programs import get_tile_op as ref_tile_op
from repro_torch.analysis import (DEFAULT_PARAMS, ArrayInfo,
                                  CalibrationError, CalibrationParams,
                                  DeviceProfile, KernelFeatures,
                                  LatencyModel, OpStats, RooflineCostModel,
                                  check_profile, evaluate_params, fit_params,
                                  fit_profile, kernel_features, load_profile,
                                  mape_pct, predict_ns, spearman)
from repro_torch.analysis.calibrate import SCHEMA_VERSION, profile_dir
from repro_torch.cache.keys import device_profile_id
from repro_torch.core.egraph import EGraph, add_expr
from repro_torch.core.extract import extract_dag
from repro_torch.core.hardware import H100_SXM, ChipSpec
from repro_torch.core.schedule import compute_schedule
from repro_torch.core.pipeline import (SaturatorConfig, ScheduleConfig,
                                       predict_choice, saturate_program)
from repro_torch.kernels.tile_programs import (PROGRAMS, get_tile_op,
                                               rmsnorm_program,
                                               swiglu_program)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_PROFILE = (ROOT / "experiments" / "device_profiles"
               / "cpu_pallas_interpret_sched.json")
H100_PROFILE = "h100_triton_sched"
SCHEDULES = ("source", "bulk", "cost")

# tpu_v5e's constants in the port's ChipSpec: VMEM is the on-chip budget
# that the port's formula reads as smem_bytes
V5E_AS_PORT = ChipSpec(
    name=TPU_V5E.name, peak_flops_bf16=TPU_V5E.peak_flops_bf16,
    hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
    smem_bytes=TPU_V5E.vmem_bytes, sm_count=1,
    vpu_lanes=TPU_V5E.vpu_lanes, clock_hz=TPU_V5E.clock_hz)

# ---------------------------------------------------------------------------
# Ground truth the fitter must recover: the reference's identifiable set,
# its bytes scaled so that each kernel sits on the same side of the H100's
# roofline as on tpu_v5e's (a vector pass is ~8.7x cheaper against a byte)
# ---------------------------------------------------------------------------
_PASS_NS_PER_BYTE_NS = {
    chip.name: (1.0 / chip.vpu_elems_per_s) / (1.0 / chip.hbm_bw)
    for chip in (TPU_V5E, H100_SXM)}
_BYTES = _PASS_NS_PER_BYTE_NS["h100_sxm"] / _PASS_NS_PER_BYTE_NS["tpu_v5e"]
TRUE = CalibrationParams(
    overlap_slack_compute=0.30, overlap_slack_memory=0.15,
    hbm_efficiency=0.5, base_ns=0.0,
    vpu_pass_coeffs={"simple": 3.0, "transcendental": 0.5})

SYN_FEATS = [
    KernelFeatures(name, passes, hbm_bytes=nbytes * _BYTES)
    for name, passes, nbytes in (
        ("c_simple_small", {"simple": 10.0}, 16.0),
        ("c_simple_big", {"simple": 40.0}, 16.0),
        ("c_trans_small", {"transcendental": 16.0}, 16.0),
        ("c_trans_big", {"transcendental": 48.0}, 16.0),
        ("m_small", {}, 100_000.0),
        ("m_big", {}, 400_000.0),
        ("mixed_mem", {"simple": 20.0}, 200_000.0),
        ("mixed_cmp", {"simple": 100.0}, 50_000.0),
        ("mixed_both", {"simple": 30.0, "transcendental": 24.0}, 80_000.0))
]
SYN_MEASURED = [predict_ns(f, TRUE) for f in SYN_FEATS]


def test_fitter_recovers_synthetic_ground_truth():
    params, loss, _ = fit_params(SYN_FEATS, SYN_MEASURED)
    assert loss < 1e-4
    ev = evaluate_params(SYN_FEATS, SYN_MEASURED, params)
    assert ev["mape_pct"] < 1.0
    assert ev["spearman"] == pytest.approx(1.0)
    assert params.hbm_efficiency == pytest.approx(TRUE.hbm_efficiency,
                                                  rel=0.15)
    for kls, want in TRUE.vpu_pass_coeffs.items():
        assert params.coeff(kls) == pytest.approx(want, rel=0.15), kls
    assert params.overlap_slack_compute == pytest.approx(
        TRUE.overlap_slack_compute, abs=0.1)
    assert params.overlap_slack_memory == pytest.approx(
        TRUE.overlap_slack_memory, abs=0.1)


def test_fitter_rejects_bad_input():
    with pytest.raises(CalibrationError):
        fit_params([], [])
    with pytest.raises(CalibrationError):
        fit_params(SYN_FEATS, SYN_MEASURED[:-1])
    with pytest.raises(CalibrationError):
        fit_params(SYN_FEATS[:2], [1.0, -5.0])


def test_spearman_and_mape():
    assert spearman([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert spearman([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert spearman([1.0, 1.0], [1.0, 2.0]) == 0.0
    assert mape_pct([110.0], [100.0]) == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# Profile persistence
# ---------------------------------------------------------------------------
def _syn_profile(name="syn") -> DeviceProfile:
    return fit_profile(SYN_FEATS, SYN_MEASURED, name=name, chip="test",
                       measured_kind="synthetic")


def test_profile_roundtrip(tmp_path):
    prof = _syn_profile()
    assert prof.model_chip == H100_SXM.name
    back = load_profile(prof.save(tmp_path / "syn.json"))
    assert back.params == prof.params
    assert back.fit == prof.fit
    assert back.measured_kind == "synthetic"
    assert back.stored_measurements() == SYN_MEASURED
    assert [f.kernel for f in back.stored_features()] \
        == [f.kernel for f in SYN_FEATS]
    assert prof.fit["mape_pct"] < prof.fit["uncalibrated_mape_pct"]
    assert prof.fit["spearman"] >= 0.99


def test_profile_schema_version_mismatch_fails_loudly(tmp_path):
    doc = json.loads(_syn_profile().to_json())
    doc["schema_version"] = SCHEMA_VERSION + 1
    p = tmp_path / "future.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(CalibrationError, match="schema_version"):
        load_profile(p)
    with pytest.raises(CalibrationError, match="not valid JSON"):
        DeviceProfile.from_json("{nope")


def test_load_profile_unknown_name_is_actionable(tmp_path, monkeypatch):
    with pytest.raises(CalibrationError, match="tools/calibrate.py"):
        load_profile(tmp_path / "missing.json")
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    assert profile_dir() == tmp_path
    with pytest.raises(CalibrationError, match="known profiles: none"):
        load_profile("missing")


def test_profile_dir_is_the_ports_own(monkeypatch):
    """The port's profiles live apart from the JAX package's, whose tests
    hold every profile in experiments/device_profiles/ to its chips."""
    monkeypatch.delenv("REPRO_PROFILE_DIR", raising=False)
    assert profile_dir() == ROOT / "experiments" / "device_profiles_torch"


def test_check_profile_detects_degradation():
    prof = _syn_profile()
    assert check_profile(prof) == []
    bad = dataclasses.replace(prof)
    bad.params = CalibrationParams(vpu_pass_coeffs={"simple": 1e9})
    fails = check_profile(bad)
    assert fails and any("degraded" in f or "floor" in f for f in fails)


def test_tpu_profile_fails_to_load():
    """A profile fitted against the JAX package's chip constants names the
    chip it does not know, on load and when re-pricing."""
    with pytest.raises(CalibrationError, match="tpu_v5e"):
        load_profile(REF_PROFILE)
    doc = json.loads(REF_PROFILE.read_text())
    del doc["model_chip"]          # the reference's default is tpu_v5e
    with pytest.raises(CalibrationError, match="tpu_v5e"):
        DeviceProfile.from_json(json.dumps(doc))
    prof = dataclasses.replace(_syn_profile(), model_chip="tpu_v5e")
    with pytest.raises(CalibrationError, match="tpu_v5e"):
        LatencyModel.from_profile(prof)


# ---------------------------------------------------------------------------
# Calibrated LatencyModel semantics
# ---------------------------------------------------------------------------
def test_latency_model_defaults_unchanged():
    lm = LatencyModel()
    st = OpStats(vpu_passes=4.0, bytes_read=8192.0)
    legacy = max(lm.compute_ns(st), lm.memory_ns(st)) \
        + 0.05 * min(lm.compute_ns(st), lm.memory_ns(st))
    assert lm.latency_ns(st) == pytest.approx(legacy)
    assert lm.slack_compute == lm.slack_memory == 0.05


def test_latency_model_from_profile_matches_predict_ns():
    """from_profile + coefficient-scaled passes compute predict_ns's
    number, the pressure term's shared-memory budget included."""
    params = CalibrationParams(
        overlap_slack_compute=0.2, overlap_slack_memory=0.4,
        hbm_efficiency=0.25, base_ns=100.0,
        vpu_pass_coeffs={"simple": 2.0, "transcendental": 0.5,
                         "memory_dispatch": 3.0})
    prof = DeviceProfile(name="t", chip="test", measured_kind="synthetic",
                         params=params)
    lm = LatencyModel.from_profile(prof)
    assert lm.chip is H100_SXM
    feat = KernelFeatures("k", {"simple": 6.0, "transcendental": 16.0,
                                "memory_dispatch": 2.0},
                          hbm_bytes=30_000.0)
    scaled = sum(p * params.coeff(k) for k, p in feat.class_passes.items())
    st = OpStats(vpu_passes=scaled, bytes_read=30_000.0)
    assert lm.latency_ns(st) == pytest.approx(predict_ns(feat, params))
    st_c = OpStats(vpu_passes=1e6, bytes_read=8.0)
    c, m = lm.compute_ns(st_c), lm.memory_ns(st_c)
    assert lm.latency_ns(st_c) == pytest.approx(100.0 + c + 0.2 * m)
    st_m = OpStats(vpu_passes=0.001, bytes_read=1e9)
    c, m = lm.compute_ns(st_m), lm.memory_ns(st_m)
    assert lm.latency_ns(st_m) == pytest.approx(100.0 + m + 0.4 * c)
    # the spill budget: a quarter of a block's shared memory in both
    press = dataclasses.replace(params, vmem_pressure_coeff=2.0)
    over = dataclasses.replace(feat, peak_live_bytes=H100_SXM.smem_bytes)
    spill = H100_SXM.smem_bytes - H100_SXM.smem_bytes / 4
    bw = H100_SXM.hbm_bw * params.hbm_efficiency
    assert predict_ns(over, press) == pytest.approx(
        predict_ns(feat, params) + 2.0 * spill / bw * 1e9)
    assert LatencyModel.from_profile(dataclasses.replace(
        prof, params=press)).vmem_budget_bytes() \
        == H100_SXM.smem_bytes // 4


def test_profile_model_chip_and_tile_elems_are_honored():
    prof = fit_profile(SYN_FEATS, SYN_MEASURED, name="h100", chip="gpu",
                       measured_kind="synthetic", model_chip=H100_SXM,
                       tile_elems=512)
    assert prof.model_chip == "h100_sxm"
    lm = LatencyModel.from_profile(prof)
    assert lm.chip is H100_SXM and lm.tile_elems == 512
    assert check_profile(prof) == []
    cm = RooflineCostModel(profile=prof)
    assert cm.tile_elems == 512 and cm.chip is H100_SXM
    bad = dataclasses.replace(prof)
    bad.model_chip = "no_such_chip"
    with pytest.raises(CalibrationError, match="model_chip"):
        LatencyModel.from_profile(bad)


def test_cost_model_applies_pass_coeffs_and_dispatch():
    from repro_torch.core.ir import ENode
    params = CalibrationParams(vpu_pass_coeffs={"simple": 10.0,
                                                "memory_dispatch": 7.0})
    prof = DeviceProfile(name="t", chip="test", measured_kind="synthetic",
                         params=params)
    cal = RooflineCostModel(profile=prof)
    plain = RooflineCostModel()
    add = ENode("add", (1, 2))
    assert plain.node_stats(add).vpu_passes == 1.0
    assert cal.node_stats(add).vpu_passes == 10.0
    load = ENode("load", (3,))
    assert plain.node_stats(load).vpu_passes == 0.0
    assert cal.node_stats(load).vpu_passes == 7.0
    assert cal.node_stats(load).bytes_read \
        == plain.node_stats(load).bytes_read


# ---------------------------------------------------------------------------
# A loaded profile changes what the search picks
# ---------------------------------------------------------------------------
def _tradeoff_graph():
    """A root class with two equal implementations: a divide (compute,
    no traffic) and a tile load (no compute, 4 KiB of traffic)."""
    eg = EGraph()
    a = add_expr(eg, ("div", ("var", "x"), ("var", "y")))
    b = add_expr(eg, ("load", ("array", "t@0")))
    eg.set_array_info("t", ArrayInfo(shape=(8, 128), dtype="f32"))
    return eg, eg.union(a, b)


@pytest.mark.parametrize("hbm_efficiency,want", [(1e-3, "div"),
                                                 (1e3, "load")])
def test_device_profile_changes_beam_choice(hbm_efficiency, want):
    """On the H100's constants the analytic model prices the divide
    below the 4 KiB load; a profile that measures memory as slow keeps
    the divide, one that measures it as fast flips the choice to the
    load."""
    eg, root = _tradeoff_graph()
    analytic = extract_dag(eg, root, cost_model=RooflineCostModel(),
                           search="beam")
    assert analytic.choice[eg.find(root)].op == "div"
    prof = DeviceProfile(name="hbm", chip="test", measured_kind="synthetic",
                         params=CalibrationParams(
                             hbm_efficiency=hbm_efficiency))
    eg2, root2 = _tradeoff_graph()
    calibrated = extract_dag(eg2, root2,
                             cost_model=RooflineCostModel(profile=prof),
                             search="beam")
    assert calibrated.choice[eg2.find(root2)].op == want


def test_device_profile_threads_through_pipeline():
    prof = DeviceProfile(
        name="synthetic_slow", chip="test", measured_kind="synthetic",
        params=CalibrationParams(hbm_efficiency=1e-6, base_ns=123.0))
    sk = saturate_program(swiglu_program(),
                          SaturatorConfig(schedule_cfg=ScheduleConfig(
                              device_profile=prof)))
    rep = sk.report()
    assert rep["device_profile"] == "synthetic_slow"
    base = saturate_program(swiglu_program(), SaturatorConfig())
    assert base.report()["device_profile"] is None
    assert rep["predicted_latency_ns"] > \
        1e4 * base.report()["predicted_latency_ns"]


def test_get_tile_op_takes_a_profile(tmp_path):
    """get_tile_op(device_profile=...) builds its own op (the profile is
    part of its key) whose cost schedule the profile prices, on the same
    extracted term: extraction stays on the flat model."""
    prof = DeviceProfile(
        name="slow_dispatch", chip="test", measured_kind="synthetic",
        params=CalibrationParams(vpu_pass_coeffs={"memory_dispatch": 50.0},
                                 overlap_efficiency=0.5))
    path = prof.save(tmp_path / "slow_dispatch.json")
    plain = get_tile_op("rmsnorm", schedule="cost")
    cal = get_tile_op("rmsnorm", schedule="cost", device_profile=path)
    assert cal is not plain
    assert cal is get_tile_op("rmsnorm", schedule="cost",
                              device_profile=str(path))
    assert cal.sk.config.device_profile == str(path)
    assert plain.sk.config.device_profile is None
    assert cal.sk.extraction.choice == plain.sk.extraction.choice
    assert cal.tk.schedule.mode == "cost"


def test_kernel_features_counts_match_generated_kernel():
    sk = saturate_program(rmsnorm_program(), SaturatorConfig())
    feat = kernel_features(sk)
    assert feat.kernel == "rmsnorm"
    assert feat.class_passes.get("memory_dispatch") \
        == float(sk.kernel.stats.n_loads)
    pred = predict_choice(sk.ssa, sk.extraction.choice, sk.extraction.roots,
                          sk.kernel.stats.n_stores)
    assert feat.hbm_bytes == pytest.approx(pred["bytes_read"]
                                           + pred["bytes_written"])
    assert predict_ns(feat, DEFAULT_PARAMS) \
        == pytest.approx(pred["latency_ns"])


# ---------------------------------------------------------------------------
# The port against the reference on the same inputs
# ---------------------------------------------------------------------------
def test_fit_matches_reference_on_stored_evidence():
    """fit_params, evaluate_params and predict_ns on the reference
    profile's stored measurements, with the same chip constants: the
    fitted parameters equal to the last bit."""
    doc = json.loads(REF_PROFILE.read_text())
    rows = doc["fit"]["kernels"]
    meas = [float(r["measured_ns"]) for r in rows]
    tile = int(doc["tile_elems"])
    ref_feats = [ref_cal.KernelFeatures.from_dict(r["features"])
                 for r in rows]
    feats = [KernelFeatures.from_dict(r["features"]) for r in rows]
    ref_p, ref_loss, ref_rounds = ref_cal.fit_params(
        ref_feats, meas, chip=TPU_V5E, tile_elems=tile)
    p, loss, rounds = fit_params(feats, meas, chip=V5E_AS_PORT,
                                 tile_elems=tile)
    assert p.to_dict() == ref_p.to_dict()
    assert (loss, rounds) == (ref_loss, ref_rounds)
    stored = CalibrationParams.from_dict(doc["params"])
    ref_stored = ref_cal.CalibrationParams.from_dict(doc["params"])
    for params, ref_params in ((stored, ref_stored),
                               (DEFAULT_PARAMS, ref_cal.DEFAULT_PARAMS)):
        got = evaluate_params(feats, meas, params, chip=V5E_AS_PORT,
                              tile_elems=tile)
        want = ref_cal.evaluate_params(ref_feats, meas, ref_params,
                                       chip=TPU_V5E, tile_elems=tile)
        assert got == want
    assert [predict_ns(f, stored, chip=V5E_AS_PORT, tile_elems=tile)
            for f in feats] == [
        ref_cal.predict_ns(f, ref_stored, chip=TPU_V5E, tile_elems=tile)
        for f in ref_feats]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_features_match_reference(name):
    """The calibration features of the term each schedule emits, under
    get_tile_op's configuration: the reference's from its Pallas op's
    schedule (a named order recomputed as its measurement does), the
    port's from the order its Triton kernel was emitted from. The
    analytic cost order prices the H100's constants in the port and
    tpu_v5e's in the reference, and those can order loads differently
    (adamw's do): there the order-free features match, and the port's
    search priced on tpu_v5e's constants finds the reference's order."""
    order_free = ("kernel", "class_passes", "mxu_flops", "hbm_bytes",
                  "flops", "loop_trips")
    for sched in SCHEDULES:
        ref = ref_tile_op(name, schedule=sched)
        sr = ref.pk.schedule or ref_compute_schedule(
            ref.sk.ssa, dict(ref.sk.extraction.choice), mode=sched)
        want = ref_cal.kernel_features(ref.sk, schedule=sr).to_dict()
        op = get_tile_op(name, schedule=sched)
        got = kernel_features(op.sk, schedule=op.tk.schedule).to_dict()
        if sched != "cost":
            assert got == want, (name, sched)
            continue
        assert {k: got[k] for k in order_free} \
            == {k: want[k] for k in order_free}
        cm = RooflineCostModel(chip=V5E_AS_PORT, dtype=op.sk.ssa.prog.dtype)
        cm.bind_egraph(op.sk.ssa.egraph)
        v5e = compute_schedule(op.sk.ssa, dict(op.sk.extraction.choice),
                               mode="cost", cost_model=cm)
        assert kernel_features(op.sk, schedule=v5e).to_dict() == want, name


# ---------------------------------------------------------------------------
# The committed H100 profile
# ---------------------------------------------------------------------------
def test_committed_h100_profile_meets_acceptance(monkeypatch):
    """tools/calibrate.py's promoted fit re-scores from its stored
    evidence (no card needed), and loads through every front door."""
    monkeypatch.delenv("REPRO_PROFILE_DIR", raising=False)
    prof = load_profile(H100_PROFILE)
    assert prof.model_chip == "h100_sxm"
    assert prof.measured_kind == "triton_compiled"
    assert "H100" in prof.chip
    assert len(prof.stored_features()) == len(PROGRAMS)
    assert set(prof.fit["schedule_medians"]) == set(PROGRAMS)
    assert check_profile(prof) == []
    lm = LatencyModel.from_profile(H100_PROFILE)
    assert lm.profile_name == H100_PROFILE and lm.chip is H100_SXM
    assert device_profile_id(SaturatorConfig(schedule_cfg=ScheduleConfig(
        device_profile=H100_PROFILE))).startswith(f"{H100_PROFILE}@")
