"""The port stands alone: no module of ``tinynerf_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package (``tinynerf``), and
importing the package builds no kernel and needs no card; the host ray
store is built from the port's own source."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "tinynerf_torch", "**", "*.py"), recursive=True)
               + [os.path.join(REPO, "chip_smoke.py")])


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_imports_neither_jax_nor_tinynerf(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "tinynerf", "flax", "optax"}, roots


def test_the_parallel_modules_are_held_to_it():
    """``tinynerf_torch/parallel/`` (the rank processes of a job import it
    without the JAX package) is among the files checked above."""
    names = {os.path.relpath(p, REPO) for p in FILES}
    for module in ("distributed", "mesh", "sample_shard"):
        assert os.path.join("tinynerf_torch", "parallel", f"{module}.py") in names


def test_package_imports_without_jax_or_a_build():
    """In a fresh interpreter with JAX blocked, every module imports, and no
    kernel library is built or loaded."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tinynerf'] = None\n"
        "import tinynerf_torch\n"
        "for m in pkgutil.walk_packages(tinynerf_torch.__path__, 'tinynerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tinynerf_torch.kernels import build\n"
        "assert not build._libs and not build.build_log\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _string_constants(path):
    """The string literals of ``path`` that are not docstrings."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body
            and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_ray_store_is_built_from_the_port_s_own_source(tmp_path, monkeypatch):
    """``data/native.py`` compiles ``tinynerf_torch/csrc/raystore.cpp`` into
    ``build/tinynerf_torch/``: no path of the JAX package (``native/``,
    ``tinynerf/``) is named in its code, and the one ``g++`` call a fresh build
    makes takes the port's source."""
    path = os.path.join(REPO, "tinynerf_torch", "data", "native.py")
    for text in _string_constants(path):
        assert "native/" not in text and "tinynerf/" not in text and text != "native", text
    from tinynerf_torch.data import native
    assert native.SOURCE == os.path.join(REPO, "tinynerf_torch", "csrc", "raystore.cpp")
    assert native.BUILD_DIR == os.path.join(REPO, "build", "tinynerf_torch")
    calls = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native, "_libs", {})
    native.load_library()
    (cmd,) = calls
    assert cmd[0] == "g++" and native.SOURCE in cmd
    assert not any(os.path.join(REPO, d) in arg for arg in cmd for d in ("native", "tinynerf/"))
    assert os.listdir(tmp_path) == [os.path.basename(native._lib_path(native.SOURCE))]


NEW_MODULES = ("tinynerf_torch/core/legacy.py", "tinynerf_torch/tools/__init__.py",
               "tinynerf_torch/tools/render_shipped_ckpt.py",
               "tinynerf_torch/tools/serve_render.py")


@pytest.mark.parametrize("tool", ["serve_render", "render_shipped_ckpt"])
def test_the_tools_run_without_jax(tool):
    """The legacy field and the tools are among the files the import test
    reads, and each tool's ``python -m`` entry point starts (``--help``) in
    an interpreter where JAX and the JAX package cannot be imported."""
    assert all(os.path.join(REPO, m) in FILES for m in NEW_MODULES)
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tinynerf'] = None\n"
            "sys.argv = ['tool', '--help']\n"
            f"runpy.run_module('tinynerf_torch.tools.{tool}', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout
