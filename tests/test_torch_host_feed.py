"""The port's host-fed path (``HOST_FEED``: the native ray store of
``tinynerf_torch/data/native.py`` built from ``csrc/raystore.cpp``, its
plain version ``NumpyRayStore``, ``RayTable.upload``,
``train.make_host_fed_train_step`` and the Runner's feeder) against the JAX
package's, on the CPU at small sizes. Both packages build their own store
here with ``g++``."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data import native as jnative
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayBatch as JRayBatch, RayTable as JRayTable
from tinynerf_torch import ckpt, optim, train
from tinynerf_torch.config import Config
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data import native
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (8, 8)


@pytest.fixture(scope="module")
def tables():
    """{pixel dtype: (pixels, poses)}: 4 views of 8x8, f32 and u8."""
    rng = np.random.default_rng(0)
    pixels = rng.uniform(0, 1, (4 * HW[0] * HW[1], 3)).astype(np.float32)
    poses = rng.normal(size=(4, 17)).astype(np.float32)
    return {"f32": (pixels, poses), "u8": ((pixels * 255).astype(np.uint8), poses)}


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pixel_dtype", ["f32", "u8"])
def test_native_store_matches_jax_and_numpy(tables, pixel_dtype):
    """Batches 0-4 of seed 624: the port's native store, the JAX package's
    native store and the port's ``NumpyRayStore``, bit for bit, through
    ``sample(i)`` and through ``start`` / ``next``; and the batch is the
    table's rows (u8 dequantised)."""
    pixels, poses = tables[pixel_dtype]
    stores = [native.HostRayStore(pixels, poses, *HW, seed=624),
              jnative.HostRayStore(pixels, poses, *HW, seed=624),
              native.NumpyRayStore(pixels, poses, *HW, seed=624)]
    try:
        for i in range(5):
            ref = stores[0].sample(i, 32)
            for other in stores[1:]:
                _equal(ref, other.sample(i, 32))
        rows, cols, rgb, pose, pic = ref
        idx = pic * HW[0] * HW[1] + rows.astype(int) * HW[1] + cols.astype(int)
        want = pixels[idx] if pixel_dtype == "f32" else pixels[idx] / np.float32(255.0)
        np.testing.assert_allclose(rgb, want, rtol=1e-7)
        np.testing.assert_array_equal(pose, poses[pic])
        for s in stores:
            s.start(16, depth=3)
        for i in range(5):
            got = [s.next() for s in stores]
            _equal(got[0], stores[0].sample(i, 16))
            for other in got[1:]:
                _equal(got[0], other)
    finally:
        for s in stores:
            s.close()


def test_mmap_store_matches_the_in_memory_store(tables, tmp_path):
    pixels, poses = tables["u8"]
    path = tmp_path / "pixels.u8"
    pixels.tofile(path)
    mapped = native.HostRayStore.from_pixel_file(str(path), True, pixels.shape[0], poses, *HW,
                                                 seed=3)
    owned = native.HostRayStore(pixels, poses, *HW, seed=3)
    try:
        _equal(mapped.sample(2, 64), owned.sample(2, 64))
    finally:
        mapped.close()
        owned.close()
    with pytest.raises(RuntimeError, match="rs_create_mmap failed"):
        native.HostRayStore.from_pixel_file(str(path), False, pixels.shape[0], poses, *HW)


def test_make_ray_store_raises_where_the_build_fails(tables, monkeypatch):
    """No fallback: with the source pointed at a missing file the store
    raises with g++'s message instead of handing back the numpy store."""
    monkeypatch.setattr(native, "SOURCE", os.path.join(REPO, "no_such_dir", "raystore.cpp"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the host ray store"):
        native.make_ray_store(*tables["f32"], *HW)


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes build the library into one empty directory at once,
    as test workers may: each loads a whole library and draws the same
    batch, and no temporary file is left."""
    code = ("import sys, numpy as np\n"
            "from tinynerf_torch.data import native\n"
            f"native.BUILD_DIR = {str(tmp_path)!r}\n"
            "px = np.arange(192, dtype=np.float32).reshape(64, 3)\n"
            "s = native.HostRayStore(px, np.ones((1, 17), np.float32), 8, 8, seed=5)\n"
            "print(int(s.sample(0, 8)[4].sum()), float(s.sample(1, 8)[2].sum()))\n"
            "s.close()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out)
    assert len(set(outs)) == 1
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].startswith("libraystore-") and names[0].endswith(".so")


def test_upload_on_the_cpu_copies_the_batch(sync_scene_dir, tables):
    table = RayTable(load_scene(sync_scene_dir, "sync", "train"), device_pixels=False)
    host = native.NumpyRayStore(*tables["f32"], *HW, seed=1).sample(0, 16)
    batch = table.upload(host)
    for t, a in zip(batch, host):
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)
    host[0][:] = -1.0   # the batch holds its own copy
    assert bool(torch.all(batch.rows >= 0))


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("proposal", [False, True], ids=["mlp", "proposal-grid"])
def test_host_fed_step_matches_jax(sync_scene_dir, proposal):
    """One host-fed step in each package from the same params (the MLP's
    sigma bias +1) on the same batch of the native store
    (``tests/test_native.py:94-117``'s config): the loss to rel 1e-5, and
    each part's gradient, read from Adam's first moment after the step (0.1
    times it), to cosine >= 0.9999 and norm within 1e-3
    (``tests/test_torch_train.py``'s bounds for one step)."""
    kw = dict(batch_ray=32, n_coarse=8, n_fine=8, use_pallas=False, host_feed=True,
              proposal=proposal)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jtable = JRayTable(jload_scene(sync_scene_dir, "sync", "train"), device_pixels=False)
    table = RayTable(load_scene(sync_scene_dir, "sync", "train"), device_pixels=False)
    tree = jax.tree_util.tree_map(np.asarray, jtrain.init_state(jcfg).params)
    net = tree["net"] if proposal else tree
    net["sigma"]["b"] = net["sigma"]["b"] + np.float32(1.0)
    jstate = jtrain.init_state(jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree))
    state = train.init_state(cfg, torch.device("cpu"), params=ckpt.params_from_numpy(tree))
    store = native.make_ray_store(table.host_pixels, table.poses.numpy(), table.height,
                                  table.width, seed=0)
    try:
        host = store.sample(0, cfg.batch_ray)
    finally:
        store.close()
    jstep = jtrain.make_host_fed_train_step(
        jcfg, jmake_k_inv(jtable.height, jtable.width, jtable.focal))
    step = train.make_host_fed_train_step(cfg, make_k_inv(table.height, table.width,
                                                          table.focal))
    jstate, jm = jstep(jstate, JRayBatch(*(jnp.asarray(a) for a in host)))
    state, m = step(state, table.upload(host))
    assert abs(m["loss"].item() / float(jm["loss"]) - 1) <= 1e-5
    assert state.iteration == int(jstate.iteration) == 1
    parts = ("net", "prop") if proposal else (None,)
    for part in parts:
        get = (lambda t: t[part]) if part else (lambda t: t)
        got = np.concatenate([t.numpy().ravel() for t in optim.leaves(get(state.opt.mu))])
        want = np.concatenate([np.asarray(x).ravel() for x in
                               jax.tree_util.tree_leaves(get(jstate.opt.mu))])
        assert got.size == want.size
        assert _cos(got, want) >= 0.9999, part
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= 1e-3, part


def test_runner_host_feed_trains_and_closes_its_store(sync_scene_dir, tmp_path, monkeypatch):
    """A Runner with ``HOST_FEED`` keeps the pixels on the host, trains 3
    steps on batches of the native store (the first is batch 0 of SEED) and
    closes the store at the loop's end."""
    made = []
    real = Runner._make_feeder

    def spy(self, table):
        made.append(real(self, table))
        return made[-1]

    monkeypatch.setattr(Runner, "_make_feeder", spy)
    cfg = Config(img_dir=f"{sync_scene_dir}/", data_type="sync", n_coarse=8, n_fine=8,
                 batch_ray=32, total_iter=3, step=1000, host_feed=True,
                 ckpt_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"))
    runner = Runner(cfg, device="cpu")
    assert runner.train_table.pixels is None and runner.val_table.pixels is None
    runner.train()
    assert runner.state.iteration == 3
    assert len(made) == 1 and isinstance(made[0], native.HostRayStore)
    assert made[0]._handle is None   # closed
    with open(runner.logger.path) as f:
        assert sum(1 for _ in f) == 3
