"""The port's render service (``tinynerf_torch/tools/serve_render.py``) and
its pose helpers (``data/paths.py::orbit_pose``, ``free_pose``) against the
JAX package's, on the CPU: the poses equal JAX's on the Blender, outward-360
and LLFF rigs; each view's frame, before its JPEG encoding, within 1e-4 per
pixel (fp32) of ``tinynerf.eval.make_frame_fn`` at the same pose; and the
HTTP routes over a real socket (``/info``, ``/``, a JPEG ``/frame`` for each
view, the scale refusal, a 404) and the refusal of fresh weights, as
``tests/test_serve.py`` checks the JAX service."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tinynerf import eval as jeval, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data import paths as jpaths
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf_torch import ckpt, optim
from tinynerf_torch.config import Config, load_config
from tinynerf_torch.data import paths
from tinynerf_torch.runner import Runner
from tinynerf_torch.tools import serve_render
from tests.test_torch_unbounded_slice import ring_scene
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_ATOL = 1e-4
# the service's config: the MLP field at fp32, cut to the CPU
SMALL = dict(batch_ray=16, n_coarse=4, n_fine=8, render_chunk=64)


# ---------------------------------------------------------------- poses


def _rig(kind, sync_dir, llff_dir):
    if kind == "outward360":
        return ring_scene(6, 12, 16, 0)[0]
    root = sync_dir if kind == "blender" else llff_dir
    return jload_scene(root, "sync" if kind == "blender" else "llff", "train").poses_bounds


@pytest.mark.parametrize("kind", ["blender", "outward360", "llff"])
@pytest.mark.parametrize("view", [(0.0, None, 1.0, 1.0), (45.0, 20.0, 1.2, 0.5),
                                  (300.0, -75.0, 0.6, 2.0)], ids=["rig", "up", "down"])
def test_poses_match_jax(kind, view, sync_scene_dir, llff_scene_dir):
    rows = _rig(kind, sync_scene_dir, llff_scene_dir)
    theta, elev, radius, scale = view
    kw = dict(elev_deg=elev, radius_scale=radius, res_scale=scale)
    assert paths.is_outward_rig(rows) == (kind == "outward360")
    np.testing.assert_array_equal(paths.free_pose(rows, theta, **kw),
                                  jpaths.free_pose(rows, theta, **kw))
    np.testing.assert_array_equal(paths.orbit_pose(rows, theta, **kw),
                                  jpaths.orbit_pose(rows, theta, **kw))


# ---------------------------------------------------------------- the service


def _write_ini(path, scene_dir, out_dir, data_type):
    with open(path, "w") as fh:
        fh.write(f"""[servescene]
IMG_DIR = {scene_dir}/
RESULTS_PATH = {out_dir}/results/
CKPT_PATH = {out_dir}/ckpt/
LOG_DIR = {out_dir}/runs/
TOTAL_ITER = 4
BATCH_RAY = {SMALL["batch_ray"]}
N_COARSE = {SMALL["n_coarse"]}
N_FINE = {SMALL["n_fine"]}
DATA_TYPE = {data_type}
STEP = 2
DECAY_END = 1000
SCHED = EXP
CONTINUE = True
RENDER_CHUNK = {SMALL["render_chunk"]}
""")


def _served(tmp_path, scene_dir, data_type, iteration=7):
    """A checkpoint of JAX's init with content (the sigma bias +1) at
    ``iteration``, and a Service on a CPU Runner resumed from it: (service,
    JAX params)."""
    ini = str(tmp_path / "serve.ini")
    _write_ini(ini, scene_dir, str(tmp_path / "out"), data_type)
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        JConfig(**SMALL), jax.random.PRNGKey(3)).params)
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    params = ckpt.params_from_numpy(tree)
    ckpt.save_checkpoint(str(tmp_path / "out" / "ckpt"), "serve", iteration, params,
                         optim.adam_init(params))
    cfg = load_config(ini)
    runner = Runner(cfg, device="cpu")
    return serve_render.Service(cfg, runner), jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("data_type", ["sync", "llff"])
def test_frames_match_jax_before_encoding(data_type, sync_scene_dir, llff_scene_dir,
                                          tmp_path):
    """Each view at one viewpoint: the service's pose is ``free_pose`` (the
    spiral's row on LLFF), its frame function's output within 1e-4 of JAX's
    ``make_frame_fn`` at that pose, and ``render_u8`` the uint8 of it."""
    svc, jparams = _served(tmp_path, sync_scene_dir if data_type == "sync" else llff_scene_dir,
                           data_type)
    theta, elev, radius, scale = 45.0, 20.0, 1.2, 0.5
    row = svc.pose(theta, elev, radius, scale)
    rows = svc.pose_rows
    want_row = (jpaths.spiral_path(rows, n_views=120, res_scale=scale)[15]
                if data_type == "llff" else
                jpaths.free_pose(rows, theta, elev_deg=elev, radius_scale=radius,
                                 res_scale=scale))
    np.testing.assert_array_equal(row, want_row)
    h, w, f = row[:15].reshape(3, 5)[:, 4]
    ref = jeval.make_frame_fn(dataclasses.replace(JConfig(**SMALL), data_type=data_type),
                              jmake_k_inv(h, w, f), int(h), int(w), extras=True)(
                                  jparams, jnp.asarray(row))
    rgb, depth, acc = svc.frame_fn((h, w, f), extras=True)(svc.runner.params, row)
    np.testing.assert_allclose(rgb, np.asarray(ref[0]).reshape(rgb.shape), atol=PIXEL_ATOL,
                               rtol=0)
    np.testing.assert_allclose(depth, np.asarray(ref[1]), atol=PIXEL_ATOL, rtol=1e-4)
    np.testing.assert_allclose(acc, np.asarray(ref[2]), atol=PIXEL_ATOL, rtol=0)
    plain = svc.frame_fn((h, w, f))(svc.runner.params, row)
    np.testing.assert_array_equal(plain, rgb)
    view = dict(theta=theta, elev=elev, radius=radius, scale=scale)
    u8 = svc.render_u8(**view)
    assert u8.dtype == np.uint8 and u8.shape == (int(h), int(w), 3)
    np.testing.assert_array_equal(u8, (np.clip(rgb, 0, 1) * 255.0).astype(np.uint8))
    near, far = (0.0, 1.0) if svc.runner.ndc_params is not None else row[15:17]
    np.testing.assert_array_equal(svc.render_u8(**view, view="depth"), (
        (1.0 - np.clip((depth - near) / max(far - near, 1e-6), 0, 1)) * 255.0).astype(np.uint8))
    np.testing.assert_array_equal(svc.render_u8(**view, view="acc"),
                                  (np.clip(acc, 0, 1) * 255.0).astype(np.uint8))
    assert len(svc._frame_fns) == 2   # (h, w, extras) for both kinds, made once


def test_routes_over_http(sync_scene_dir, tmp_path):
    from PIL import Image
    svc, _ = _served(tmp_path, sync_scene_dir, "sync")
    server = serve_render.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    get = lambda route: urllib.request.urlopen(base + route, timeout=120).read()
    try:
        info = json.loads(get("/info"))
        assert info["iteration"] == 7 and info["backend"] == "cpu"
        assert (info["height"], info["width"], info["data_type"]) == (12, 12, "sync")
        page = get("/")
        assert b"tinynerf" in page and b"/frame" in page
        for view, mode in (("rgb", "RGB"), ("depth", "L"), ("acc", "L")):
            img = Image.open(io.BytesIO(get(f"/frame?theta=45&elev=20&radius=1.2&scale=0.5"
                                            f"&view={view}")))
            assert img.format == "JPEG" and img.size == (6, 6) and img.mode == mode
        assert Image.open(io.BytesIO(get("/frame?theta=90&scale=0.5"))).size == (6, 6)
        for route, code in (("/frame?scale=0.125", 400), ("/frame?view=normals", 400),
                            ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                get(route)
            assert err.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    with pytest.raises(ValueError, match="gives a 1px frame; minimum is 4px"):
        svc.render_u8(scale=0.125)


def test_jpeg_encoding_names_pillow_when_it_is_missing(monkeypatch):
    """The service's JPEG encoding needs Pillow no longer (the port's own
    encoder, ``data/imagefile.py``): with Pillow unimportable it still
    answers with a baseline JPEG of the frame's size, in RGB and in gray."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    for u8 in (np.zeros((4, 6, 3), np.uint8), np.full((4, 6), 200, np.uint8)):
        data = serve_render.encode_jpeg(u8)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        sof = data.index(b"\xff\xc0")
        assert data[sof + 5:sof + 9] == bytes([0, 4, 0, 6])   # height, width


def test_serve_refuses_fresh_weights(sync_scene_dir, tmp_path):
    ini = str(tmp_path / "serve.ini")
    _write_ini(ini, sync_scene_dir, str(tmp_path / "out"), "sync")   # no checkpoint
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "tinynerf_torch.tools.serve_render",
                           "--conf", ini, "--cpu", "--port", "0"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no checkpoint" in proc.stderr + proc.stdout
