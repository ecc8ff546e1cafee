"""The port's scene maker (``tinynerf_torch/tools/make_synthetic_scene.py``)
writes what ``tools/make_synthetic_scene.py`` writes, in all four formats:
the same files, the same JSON or ``poses_bounds.npy``, and the same pixels
(Pillow decoding both); it runs where Pillow cannot be imported; and the
port's loader reads its capture as the JAX package's loader reads the JAX
tool's."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tinynerf.data.poses import load_scene as jload_scene
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.tools import make_synthetic_scene as maker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ["sync", "360", "llff", "texture"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_scene", os.path.join(REPO, "tools", "make_synthetic_scene.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _make(tmp_path, fmt):
    """(the JAX tool's capture, the port's) at hw 16 with 3 views."""
    jtool = _jax_tool()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    make = {"sync": "make_scene", "360": "make_360_scene", "llff": "make_llff_scene",
            "texture": "make_texture_scene"}[fmt]
    getattr(jtool, make)(jdir, hw=16, views=3)
    maker.main([pdir, "--hw", "16", "--views", "3", "--format", fmt])
    return jdir, pdir


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("fmt", FORMATS)
def test_scene_maker_matches_the_jax_tool(tmp_path, fmt):
    jdir, pdir = _make(tmp_path, fmt)
    files = _files(jdir)
    assert files == _files(pdir) and files
    for rel in files:
        a, b = os.path.join(jdir, rel), os.path.join(pdir, rel)
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            ia, ib = Image.open(a), Image.open(b)
            assert (ia.mode, ia.size) == (ib.mode, ib.size), rel
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


@pytest.mark.parametrize("fmt", ["sync", "llff"])
def test_the_loaders_read_both_captures_alike(tmp_path, fmt):
    """The port's ``load_scene`` (PNGs through ``imagefile``) on the port's
    capture equals the JAX package's (Pillow) on the JAX tool's, images and
    pose rows, bit for bit."""
    jdir, pdir = _make(tmp_path, fmt)
    for mode in (("train", "test") if fmt == "sync" else ("train",)):
        a, b = jload_scene(jdir, fmt, mode), load_scene(pdir, fmt, mode)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.poses_bounds, b.poses_bounds)
        assert (a.height, a.width, a.focal) == (b.height, b.width, b.focal)


def test_scene_maker_runs_without_pillow(tmp_path):
    """``python -m tinynerf_torch.tools.make_synthetic_scene`` in an
    interpreter where Pillow cannot be imported writes the capture."""
    code = ("import runpy, sys\n"
            "sys.modules['PIL'] = None\n"
            f"sys.argv = ['make_synthetic_scene', {str(tmp_path / 's')!r}, '--hw', '8', "
            "'--views', '2']\n"
            "runpy.run_module('tinynerf_torch.tools.make_synthetic_scene', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 12 views at 8x8" in proc.stdout
    assert len(os.listdir(tmp_path / "s" / "train")) == 2
