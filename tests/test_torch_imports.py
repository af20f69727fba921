"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and the whole package
imports in a process where ``jax`` cannot be imported."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, names in os.walk(PORT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_package_imports_without_jax():
    modules = sorted(
        ("repro_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, "."))
        .removesuffix(".__init__") for p in _port_files()[1:])
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = sys.modules['jaxlib'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=subprocess_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
