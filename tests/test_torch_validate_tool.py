"""The port's validate protocol on the CPU: ``tinynerf_torch.tools.validate``
keeps ``tools/validate.py``'s INI tables and prints its JSON row; the port's
CLI trains and renders the test split where neither Pillow nor imageio can
be imported (as on the card's machine), writing its JPGs and a ``.gif``;
and ``tinynerf_torch.tools.profile_step`` prints its table and leaves a
trace."""

import argparse
import glob
import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

from tinynerf_torch.tools import validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an interpreter in which Pillow and imageio cannot be imported
NO_IMAGE_LIBS = "import sys\nsys.modules['PIL'] = None\nsys.modules['imageio'] = None\n"


def _run_module(module: str, args, timeout: int = 600):
    code = (NO_IMAGE_LIBS + "import runpy\n"
            f"sys.argv = [{module!r}, *{list(args)!r}]\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_base_and_family_equal_the_jax_tool():
    spec = importlib.util.spec_from_file_location("jax_validate",
                                                  os.path.join(REPO, "tools", "validate.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    assert validate.BASE == jtool.BASE
    assert validate.FAMILY == jtool.FAMILY


def test_validate_cpu_row(tmp_path):
    """``--family reference --cpu`` at hw 16, 4 views, 20 iterations, batch
    64 and 8 fine samples prints a row with a finite PSNR and SSIM, the
    capture written by the port's scene maker."""
    r = _run_module("tinynerf_torch.tools.validate", [
        "--family", "reference", "--cpu", "--scene", str(tmp_path / "scene"), "--hw", "16",
        "--views", "4", "--iters", "20", "--batch", "64", "--n-fine", "8",
        "--out", str(tmp_path / "out"), "--extra", "RENDER_CHUNK = 128"])
    assert r.returncode == 0, r.stderr[-3000:]
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(row) == {"family", "iters", "psnr_db", "ssim", "sustained_rays_per_sec",
                        "wall_s", "ini"}
    assert row["family"] == "reference" and row["iters"] == 20
    assert math.isfinite(row["psnr_db"]) and row["psnr_db"] > 0
    assert math.isfinite(row["ssim"]) and 0.0 <= row["ssim"] <= 1.0
    assert row["sustained_rays_per_sec"] > 0
    with open(row["ini"]) as fh:
        ini = fh.read()
    assert "RENDER_CHUNK = 128" in ini and "N_FINE = 8" in ini
    assert len(os.listdir(tmp_path / "scene" / "train")) == 4


def test_cli_runs_without_pillow_or_imageio(tmp_path):
    """``python -m tinynerf_torch --conf <ini> --mode all --device cpu`` on a
    capture of the port's scene maker, with Pillow and imageio unimportable,
    reaches ``Test PSNR`` and writes the preview JPG, the per-view JPGs and
    the ``.gif`` (the validate tool's ``full`` family cut to tiny sizes)."""
    made = _run_module("tinynerf_torch.tools.make_synthetic_scene",
                       [str(tmp_path / "scene"), "--hw", "16", "--views", "4"])
    assert made.returncode == 0, made.stderr
    args = argparse.Namespace(family="full", scene=str(tmp_path / "scene"),
                              out=str(tmp_path / "out"), iters=8, batch=32, n_fine=8,
                              extra=["N_COARSE=8", "OCC_RES=8", "RENDER_CHUNK=128", "STEP=4"])
    ini = validate.write_ini(args)
    r = _run_module("tinynerf_torch", ["--conf", ini, "--mode", "all", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Test PSNR:" in r.stdout
    results = tmp_path / "out" / "results"
    previews = glob.glob(str(results / "*.jpg"))
    views = glob.glob(str(results / "*" / "*.jpg"))
    gifs = glob.glob(str(results / "*.gif"))
    assert len(previews) == 2 and len(views) == 5 and len(gifs) == 1   # STEP 4 of 8; 5 test views
    for path in previews + views:
        with open(path, "rb") as f:
            data = f.read()
        assert data[:3] == b"\xff\xd8\xff" and data[-2:] == b"\xff\xd9"
    with open(gifs[0], "rb") as f:
        assert f.read(6) == b"GIF89a"


def test_profile_step_on_the_cpu(tmp_path):
    """``tinynerf_torch.tools.profile_step --device cpu`` prints a non-empty
    table of the ops' time per step and leaves a Chrome trace at ``--out``."""
    r = _run_module("tinynerf_torch.tools.profile_step", [
        "--device", "cpu", "--batch", "32", "--coarse", "8", "--fine", "8", "--steps", "2",
        "--occ", "--set", "OCC_RES=8", "--out", str(tmp_path / "trace")])
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [ln for ln in r.stdout.splitlines() if "ms/step" in ln]
    assert rows and any("aten::mm" in ln for ln in rows)
    assert "busy share not measured" in r.stdout
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_resolving_the_card_turns_tf32_off(monkeypatch):
    """The CLI's Runner and the tools resolve the card through
    ``device.resolve_device``, which turns TF32 off (PyTorch allows it in
    cuDNN by default, and the plain fields refuse to run with it); the CPU
    leaves the flags alone."""
    import torch
    from tinynerf_torch.device import resolve_device
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
