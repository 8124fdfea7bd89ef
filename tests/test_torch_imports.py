"""The PyTorch port stands alone: no JAX, flax, optax, ml_dtypes or
reference-package import anywhere in it or in ``chip_smoke.py``, and
importing it neither imports ``triton`` nor builds a kernel."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mgat_graphsage_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
             "mgat_graphsage_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_nothing_of_jax_or_reference(path):
    assert os.path.exists(path)
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_builds_nothing_and_skips_triton(tmp_path):
    """Import every module of the port in a fresh interpreter whose
    ``subprocess`` refuses to start processes: no nvcc may run, no build
    directory may appear, and neither triton nor jax may be imported."""
    build = tmp_path / "build"
    code = f"""
import subprocess, sys, pkgutil, importlib
def _refuse(*a, **k):
    raise AssertionError("a process was started at import: %r" % (a,))
subprocess.Popen = _refuse
import mgat_graphsage_torch
for m in pkgutil.walk_packages(mgat_graphsage_torch.__path__,
                               "mgat_graphsage_torch."):
    importlib.import_module(m.name)
bad = [m for m in ("triton", "jax", "flax", "optax", "mgat_graphsage_tpu")
       if m in sys.modules]
assert not bad, bad
"""
    env = dict(os.environ, MGAT_TORCH_BUILD_DIR=str(build),
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert not build.exists()


def test_walk_covers_interchange_and_tooling():
    """The checkpoint interchange (``compat.py``, ``compare/``), the
    tooling (``utils/``), the multi-GPU path (``parallel/``) and the
    classical-ML and statistics harnesses are in the walk above, as every
    module is."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for f in ("compat.py", "compare/__init__.py", "compare/torch_ref.py",
              "compare/torch_ref_gnn.py", "utils/__init__.py",
              "utils/logging.py", "utils/profiling.py", "utils/backend.py",
              "train/checkpoint.py", "parallel/__init__.py",
              "parallel/mesh.py", "parallel/distributed.py",
              "compare/classical.py", "compare/stats.py"):
        assert f in rel, f
