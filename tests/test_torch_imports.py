"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, or names a module of the
JAX package in a string literal (an ``importlib`` target, such as ``wire``'s
error sources, would import it at run time), and the whole package
imports in a process where ``jax`` cannot be imported; the fabric's two
modules import no torch either, at any scope.  And no module of
the package hands a kernel's work to a library call or to ``torch.compile``
(``chip_smoke.py`` may time such a call beside a kernel)."""
import ast
import os
import re
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


# the shard server's boot path: spawned shard processes import these (and
# what they import) and nothing else, so torch stays out of every one
FABRIC = [os.path.join(PORT, "serve", "fabric.py"),
          os.path.join(PORT, "launch", "fabric.py")]


@pytest.mark.parametrize("path", FABRIC,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_fabric_imports_no_torch(path):
    """At module scope or inside a function: ``_imported_roots`` walks the
    whole tree."""
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN | {"torch", "triton"}]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# a string literal that is a module of the JAX package: "repro" or
# "repro.<name>..."
REFERENCE_MODULE = re.compile(r"^repro(\.[A-Za-z_]\w*)*$")


def _reference_module_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and REFERENCE_MODULE.match(node.value)]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_reference_module_named_in_a_string(path):
    bad = _reference_module_names(path)
    assert not bad, f"{os.path.relpath(path, REPO)} names {bad}"


def test_string_scan_finds_the_reference_error_sources():
    """The scan sees what it must refuse: the JAX package's own ``wire``
    names its error sources as strings for ``importlib``."""
    found = {name for _, name in _reference_module_names(
        os.path.join(REPO, "src", "repro", "api", "wire.py"))}
    assert {"repro.core.query_types", "repro.api.types",
            "repro.serve.scheduler", "repro.serve.fabric"} <= found


# the library call a kernel of the port stands beside, and the compiler
LIBRARY_CALLS = re.compile(r"\b(F|functional)\.embedding_bag\b|"
                           r"\bnn\.EmbeddingBag\b|torch\.compile\b|"
                           r"\bsparse\.mm\b|\bto_sparse_csr\b|"
                           r"\bsegment_reduce\b")


def test_scans_cover_the_gnn_slice():
    """The scans above walk the whole package: GraphSAGE's modules and its
    kernel's wrapper are among the files they read."""
    scanned = {os.path.relpath(p, PORT) for p in _port_files()[1:]}
    assert {os.path.join(*p.split("/")) for p in (
        "models/gnn.py", "data/graph_sampler.py", "data/synthetic.py",
        "kernels/segment_sum.py", "configs/graphsage_reddit.py")} <= scanned
    assert LIBRARY_CALLS.search("torch.sparse.mm(adj, h)")


@pytest.mark.parametrize("path", _port_files()[1:],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_library_stand_in_for_a_kernel(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    bad = [m.group(0) for m in LIBRARY_CALLS.finditer(src)]
    assert not bad, f"{os.path.relpath(path, REPO)} calls {bad}"


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
