"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py``, the
scripts under ``tools/`` and the port's examples (``examples/*_torch.py``)
import neither ``jax`` nor the JAX package
``repro`` (lazy imports included), and the entry points refuse to fall
back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*.py")
                    if "_build" not in p.parts) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("*.py")) \
    + sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or mod.startswith("repro.")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from repro.core import dsl\n"
                 "    import jax.numpy\n    import repro_torch.core\n")
    assert sorted(m for m in _imported_modules(f) if _forbidden(m)) == \
        ["jax.numpy", "repro.core"]


def test_serving_stack_leaves_jax_unloaded():
    code = ("import sys; import repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.core.tritongen; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_server_without_device_raises_on_a_cpu_host():
    from repro_torch.launch.serve import Server
    from repro_torch.models import LM
    from repro_torch.configs import get_smoke_config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server("minitron-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_smoke_config("minitron-4b"))
