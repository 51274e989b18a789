"""The port stands alone: it imports with JAX blocked, and no file of it
(nor chip_smoke.py, nor the port's drivers ``scripts/torch_*.py`` and
``examples/torch_*.py``) imports the JAX package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


DRIVERS = ("scripts/torch_batched_smoke.py", "scripts/torch_reconfig_smoke.py",
           "scripts/torch_open_loop_smoke.py", "scripts/torch_trace_report.py",
           "scripts/chip_phases.py",
           "examples/torch_quickstart.py", "examples/torch_serve_kvstore.py",
           "examples/torch_train_fault_tolerant.py")


def _port_files():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + [ROOT / rel for rel in DRIVERS])


def test_every_module_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            f"for name in {list(_modules())!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_repro_or_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported_names(tree):
        top = name.split(".")[0]
        assert top not in ("repro", "jax", "jaxlib"), \
            f"{path.relative_to(ROOT)} imports {name}"
