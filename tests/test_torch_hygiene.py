"""The port stands alone: no module of ``tinynerf_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package (``tinynerf``), and
importing the package builds no kernel and needs no card; the host ray
store is built from the port's own source."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
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


def test_the_png_unfilter_is_built_from_the_port_s_own_source(tmp_path, monkeypatch):
    """``imagefile.read_png``'s unfilter is ``tinynerf_torch/csrc/png_unfilter.cpp``,
    compiled by one ``g++`` call into the build directory at first use, and
    the file it decodes is the one it was given."""
    from tinynerf_torch.data import imagefile, native
    assert native.PNG_SOURCE == os.path.join(REPO, "tinynerf_torch", "csrc", "png_unfilter.cpp")
    calls = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    path = str(tmp_path / "x.png")
    pixels = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    imagefile.write_png(path, pixels)
    build = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native, "_libs", {})
    np.testing.assert_array_equal(imagefile.read_png(path), pixels)
    (cmd,) = [c for c in calls if c[0] == "g++"]
    assert native.PNG_SOURCE in cmd
    assert os.listdir(build) == [os.path.basename(native._lib_path(native.PNG_SOURCE))]


NEW_MODULES = ("tinynerf_torch/core/legacy.py", "tinynerf_torch/tools/__init__.py",
               "tinynerf_torch/tools/render_shipped_ckpt.py",
               "tinynerf_torch/tools/serve_render.py", "tinynerf_torch/data/imagefile.py",
               "tinynerf_torch/tools/make_synthetic_scene.py",
               "tinynerf_torch/tools/validate.py", "tinynerf_torch/tools/profile_step.py")


@pytest.mark.parametrize("tool", ["serve_render", "render_shipped_ckpt", "make_synthetic_scene",
                                  "validate", "profile_step"])
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


# the only functions of the port that import Pillow or imageio: the loader's
# path for an image that is not a PNG, and the video's .mp4; and chip_smoke.py's
# yardstick, which times Pillow's decode and JPEG beside the port's
IMAGE_LIB_USERS = {("tinynerf_torch/data/poses.py", "_load_image", "PIL"),
                   ("tinynerf_torch/eval.py", "_write_video", "imageio"),
                   ("chip_smoke.py", "image_file_times", "PIL")}


def _image_lib_imports(path):
    """(enclosing function or None, imported root) of each import of PIL or
    imageio in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            roots = []
            if isinstance(child, ast.Import):
                roots = [a.name.split(".")[0] for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                roots = [child.module.split(".")[0]]
            found.extend((func, r) for r in roots if r in ("PIL", "imageio"))
            visit(child, inner)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_pillow_and_imageio_only_inside_two_functions(path):
    """No module of the port (nor ``chip_smoke.py``) imports Pillow or
    imageio at module level, and only ``data/poses.py::_load_image`` (an
    image that is not a PNG) and ``eval.py::_write_video`` (an ``.mp4``)
    import them at all, beside ``chip_smoke.py``'s timing of Pillow: the
    CLI, the service and the tools run where neither is installed."""
    rel = os.path.relpath(path, REPO)
    for func, root in _image_lib_imports(path):
        assert func is not None, f"{rel} imports {root} at module level"
        assert (rel, func, root) in IMAGE_LIB_USERS, f"{rel}::{func} imports {root}"


def test_the_image_lib_users_are_found():
    """The permitted imports are where the check above looks for them."""
    found = {(os.path.relpath(p, REPO), f, r) for p in FILES for f, r in _image_lib_imports(p)}
    assert found == IMAGE_LIB_USERS
