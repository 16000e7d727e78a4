"""The port's examples (``examples/*_torch.py``), each run as a user runs
it, in a subprocess on the CPU (``--device cpu``; train_lm_torch also
``--tiny``) under a timeout of its own: each must exit 0 and print what
it checked. Without a device named they run on the GPU, and with no
CUDA device they stop with an error."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# by name: (the arguments on the card, those added to --device cpu, the
# lines each must print), the table chip_smoke.py's examples phase reads
EXAMPLES = _chip_smoke().EXAMPLES


def _run(name, args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_every_port_example_is_covered():
    assert sorted(p.stem for p in (ROOT / "examples").glob("*_torch.py")) \
        == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    _, args, said = EXAMPLES[name]
    proc = _run(name, ["--device", "cpu", *args], timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    for line in said:
        line = line.format(device="cpu")
        assert line in proc.stdout, (line, proc.stdout[-2000:])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_device_refuses_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    proc = _run(name, EXAMPLES[name][1], timeout=240)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_quickstart_prints_the_five_modes():
    """Fig. 2's columns of Listing 1 under the five modes, then rmsnorm's
    tile kernel under each: its baseline reloads x at every use, every
    other mode loads x and g once each."""
    proc = _run("quickstart_torch", ["--device", "cpu"], timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [ln.split() for ln in proc.stdout.splitlines()]
    fig2 = [r[0] for r in rows if len(r) == 5 and r[0] in (
        "baseline", "cse", "cse_sat", "cse_bulk", "accsat")]
    assert fig2 == ["baseline", "cse", "cse_sat", "cse_bulk", "accsat"]
    loads = {r[0]: int(r[1]) for r in rows if len(r) == 3
             and r[0] in fig2}
    assert loads == {"baseline": loads["baseline"], "cse": 2, "cse_sat": 2,
                     "cse_bulk": 2, "accsat": 2}
    assert loads["baseline"] > loads["accsat"]
