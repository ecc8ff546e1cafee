"""The port's render path as a whole (``tinynerf_torch``: config, scene
ingest, checkpoints, frames, Runner, CLI) against the JAX package's, on the
CPU at small sizes."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import ckpt as jckpt, eval as jeval, train as jtrain
from tinynerf.config import Config as JConfig, load_config as jload_config
from tinynerf.core import mlp as jmlp
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data import paths as jpaths
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf_torch import ckpt, eval as evallib, train as trainlib
from tinynerf_torch.__main__ import main as cli_main
from tinynerf_torch.config import Config, load_config
from tinynerf_torch.core import mlp
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data import paths
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.runner import NoCheckpointError, Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "*.ini")))

# Frame tolerance: 1e-4 on every pixel. Float32 sums and exp run in other
# orders and libraries in the two frameworks, and the resampler's slopes
# amplify their last-ulp differences in the fine sample positions.
PIXEL_ATOL = 1e-4


def _as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_defaults_match_jax():
    assert _as_dict(Config()) == _as_dict(JConfig())


@pytest.mark.parametrize("conf", CONFS, ids=os.path.basename)
def test_load_config_matches_jax(conf):
    assert _as_dict(load_config(conf)) == _as_dict(jload_config(conf))


@pytest.mark.parametrize("kind", ["sync", "llff"])
def test_load_scene_matches_jax(kind, sync_scene_dir, llff_scene_dir):
    root = sync_scene_dir if kind == "sync" else llff_scene_dir
    for low_res in (1, 2):
        a = load_scene(root, kind, "test", low_res)
        b = jload_scene(root, kind, "test", low_res)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.poses_bounds, b.poses_bounds)
        assert (a.height, a.width, a.focal) == (b.height, b.width, b.focal)


@pytest.mark.parametrize("kind", ["sync", "llff"])
def test_make_path_matches_jax(kind, sync_scene_dir, llff_scene_dir):
    root = sync_scene_dir if kind == "sync" else llff_scene_dir
    rows = jload_scene(root, kind, "test").poses_bounds
    np.testing.assert_array_equal(paths.make_path(rows, kind, 7, res_scale=2.0),
                                  jpaths.make_path(rows, kind, 7, res_scale=2.0))


def _field_with_content(seed):
    """JAX init with the sigma bias raised by 1 (see
    tests/test_torch_render.py::field_with_content for why): (JAX params,
    numpy tree)."""
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(seed)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _small_cfg(cls, **kw):
    base = dict(n_coarse=8, n_fine=16, render_chunk=24)  # 24 < 64 pixels
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def frame_setup(request):
    """An 8x8 view of the fixture scene (focal scaled with the frame)."""
    scene = jload_scene(request.getfixturevalue("sync_scene_dir"), "sync", "test")
    H = W = 8
    focal = scene.focal * H / scene.height
    return scene.poses_bounds.astype(np.float32), H, W, focal


@pytest.mark.parametrize("view", [0, 1, 2])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_frame_matches_jax(frame_setup, view, white_bkgd):
    poses, H, W, focal = frame_setup
    jparams, tree = _field_with_content(view)
    ref = jeval.make_frame_fn(_small_cfg(JConfig, white_bkgd=white_bkgd),
                              jmake_k_inv(H, W, focal), H, W)(jparams, jnp.asarray(poses[view]))
    got = evallib.make_frame_fn(_small_cfg(Config, white_bkgd=white_bkgd),
                                make_k_inv(H, W, focal), H, W)(
                                    ckpt.params_from_numpy(tree), poses[view])
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=PIXEL_ATOL, rtol=0)


def test_frame_extras_match_jax(frame_setup):
    poses, H, W, focal = frame_setup
    jparams, tree = _field_with_content(5)
    ref = jeval.make_frame_fn(_small_cfg(JConfig), jmake_k_inv(H, W, focal), H, W,
                              extras=True)(jparams, jnp.asarray(poses[0]))
    got = evallib.make_frame_fn(_small_cfg(Config), make_k_inv(H, W, focal), H, W,
                                extras=True)(ckpt.params_from_numpy(tree), poses[0])
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=PIXEL_ATOL)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=PIXEL_ATOL, rtol=1e-4)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), atol=PIXEL_ATOL)


def test_frame_does_not_depend_on_chunking(frame_setup):
    poses, H, W, focal = frame_setup
    _, tree = _field_with_content(6)
    params = ckpt.params_from_numpy(tree)
    frames = [evallib.make_frame_fn(_small_cfg(Config, render_chunk=c),
                                    make_k_inv(H, W, focal), H, W)(params, poses[1])
              for c in (24, 64, 1000)]
    for f in frames[1:]:
        np.testing.assert_array_equal(f, frames[0])


def test_jax_checkpoint_loads_and_renders_the_same_frame(frame_setup, tmp_path):
    """A training checkpoint written by the JAX package (params, Adam
    moments, PRNG key) loads in the port, which reads the params alone."""
    poses, H, W, focal = frame_setup
    jcfg = _small_cfg(JConfig)
    jparams, tree = _field_with_content(7)
    state = jtrain.init_state(jcfg, params=jparams)
    path = jckpt.save_checkpoint(str(tmp_path), "run", 42, jax.device_get(state.params),
                                 jax.device_get(state.opt), key=jax.device_get(state.key))
    iteration, params = ckpt.load_checkpoint_full(path)
    assert iteration == 42
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            np.testing.assert_array_equal(params[name][part].numpy(), tree[name][part])
    ref = jeval.make_frame_fn(jcfg, jmake_k_inv(H, W, focal), H, W)(
        jparams, jnp.asarray(poses[2]))
    got = evallib.make_frame_fn(_small_cfg(Config), make_k_inv(H, W, focal), H, W)(
        params, poses[2])
    np.testing.assert_allclose(got, np.asarray(ref), atol=PIXEL_ATOL)


def test_port_checkpoint_round_trips_and_loads_in_jax(tmp_path):
    params = mlp.init_network(torch.Generator().manual_seed(3))
    path = ckpt.save_checkpoint(str(tmp_path), "a", 7, params)
    iteration, back = ckpt.load_checkpoint_full(path)
    j_iter, j_params, j_opt = jckpt.load_checkpoint(path)
    assert iteration == j_iter == 7 and j_opt is None
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            assert torch.equal(back[name][part], params[name][part])
            np.testing.assert_array_equal(np.asarray(j_params[name][part]),
                                          params[name][part].numpy())


def test_find_latest_picks_highest_iteration(tmp_path):
    assert ckpt.find_latest(str(tmp_path)) is None
    params = mlp.init_network(torch.Generator().manual_seed(0))
    for it in (9, 100, 20):
        ckpt.save_checkpoint(str(tmp_path), "t", it, params)
    assert ckpt.find_latest(str(tmp_path)).endswith("t_100.npz")
    assert ckpt.find_latest(str(tmp_path)) == jckpt.find_latest(str(tmp_path))


def test_params_from_numpy_rejects_other_trees():
    with pytest.raises(ValueError):
        ckpt.params_from_numpy({"net": {}, "prop": {}})


def _write_ini(tmp_path, scene_dir, **extra):
    lines = [f"[{'scene'}]", f"IMG_DIR = {scene_dir}/",
             f"RESULTS_PATH = {tmp_path}/results/", f"CKPT_PATH = {tmp_path}/ckpt/",
             "N_COARSE = 8", "N_FINE = 16", "RENDER_CHUNK = 64", "DATA_TYPE = sync"]
    lines += [f"{k} = {v}" for k, v in extra.items()]
    ini = tmp_path / "scene.ini"
    ini.write_text("\n".join(lines) + "\n")
    return str(ini)


def _place_checkpoint(tmp_path, iteration=300):
    return ckpt.save_checkpoint(str(tmp_path / "ckpt"), "run", iteration,
                                mlp.init_network(torch.Generator().manual_seed(1)))


def test_cli_display_on_cpu_writes_views_and_depth(sync_scene_dir, tmp_path, capsys):
    ini = _write_ini(tmp_path, sync_scene_dir)
    _place_checkpoint(tmp_path)
    cli_main(["--conf", ini, "--mode", "display", "--depth", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Resumed from" in out and "Test PSNR" in out
    (run_dir,) = [p for p in (tmp_path / "results").iterdir() if p.is_dir()]
    names = sorted(os.listdir(run_dir))
    assert names == sorted([f"{i}{s}.jpg" for i in range(3)
                            for s in ("", "_depth", "_acc")])
    assert glob.glob(str(tmp_path / "results" / "*_300.*"))  # the video


def test_python_m_display_runs(sync_scene_dir, tmp_path):
    ini = _write_ini(tmp_path, sync_scene_dir)
    _place_checkpoint(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "tinynerf_torch", "--conf", ini, "--mode", "display",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Test PSNR" in proc.stdout


def test_cli_path_mode_on_cpu(sync_scene_dir, tmp_path):
    ini = _write_ini(tmp_path, sync_scene_dir)
    _place_checkpoint(tmp_path)
    cli_main(["--conf", ini, "--mode", "path", "--path-views", "2", "--device", "cpu"])
    assert glob.glob(str(tmp_path / "results" / "*_path_300.*"))


@pytest.mark.parametrize("mode", ["display", "path"])
def test_cli_refuses_to_render_without_checkpoint(sync_scene_dir, tmp_path, mode):
    ini = _write_ini(tmp_path, sync_scene_dir)
    with pytest.raises(SystemExit, match="refusing to render from fresh weights"):
        cli_main(["--conf", ini, "--mode", mode, "--device", "cpu"])
    assert not (tmp_path / "results").exists()


@pytest.mark.parametrize("mode", ["train", "all"])
def test_cli_training_modes_are_not_ported(sync_scene_dir, tmp_path, mode):
    """Training is ported; what it does not port yet, the host-fed path,
    is refused by name before anything runs."""
    ini = _write_ini(tmp_path, sync_scene_dir, HOST_FEED="True")
    with pytest.raises(NotImplementedError, match="HOST_FEED"):
        cli_main(["--conf", ini, "--mode", mode, "--device", "cpu"])
    assert not (tmp_path / "ckpt").exists()


def test_runner_resumes_latest_and_renders(sync_scene_dir, tmp_path):
    cfg = load_config(_write_ini(tmp_path, sync_scene_dir, CONTINUE="True"))
    _place_checkpoint(tmp_path, 10)
    path = _place_checkpoint(tmp_path, 20)
    runner = Runner(cfg, device="cpu")
    assert runner.last_iter == 20 and runner.k_inv.device.type == "cpu"
    _, params = ckpt.load_checkpoint_full(path)
    assert torch.equal(runner.params["trunk_3"]["w"], params["trunk_3"]["w"])
    frames = evallib.render_test_set(cfg, runner.params, runner.test_table, runner.k_inv,
                                     runner.start_time, runner.last_iter, save=False)
    assert frames.shape == (3, 12, 12, 3)
    assert np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1
    assert not (tmp_path / "results").exists()


def test_runner_with_fresh_weights_refuses_to_render(sync_scene_dir, tmp_path):
    runner = Runner(load_config(_write_ini(tmp_path, sync_scene_dir)), device="cpu")
    assert runner.last_iter < 0
    with pytest.raises(NoCheckpointError):
        runner.display()


def test_cuda_without_a_card_raises(sync_scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        Runner(load_config(_write_ini(tmp_path, sync_scene_dir)), device="cuda")


_GRID = dict(OCC_GRID="True", WHITE_BKGD="True")


@pytest.mark.parametrize("extra,what", [
    # the proposal grid, the proposal MLP and the grid field are ported; the
    # hybrid grids' sigma nets are not
    pytest.param({"PROPOSAL": "True", "PROP_GRID_HYBRID": "True"}, "PROP_GRID_HYBRID",
                 id="PROPOSAL-True"),
    # the fused renderer is ported (tests/test_torch_render_fused.py); the val
    # metrics that would route val batches through it are not
    pytest.param({"FUSED_RENDER": "True", "VAL_METRICS": "True"}, "VAL_METRICS",
                 id="FUSED_RENDER-True"),
    pytest.param({"HOST_FEED": "True"}, "HOST_FEED", id="HOST_FEED-True"),
    pytest.param({"VAL_METRICS": "True"}, "VAL_METRICS", id="VAL_METRICS-True"),
    pytest.param({"PROFILE_STEPS": "5"}, "PROFILE_STEPS=5", id="PROFILE_STEPS-5"),
    pytest.param({"FINE_FIELD": "grid", "GRID_HYBRID": "True"}, "GRID_HYBRID",
                 id="FINE_FIELD-grid")])
def test_unported_config_keys_raise(sync_scene_dir, tmp_path, extra, what):
    cfg = load_config(_write_ini(tmp_path, sync_scene_dir, **extra))
    with pytest.raises(NotImplementedError, match=f"{what} is not ported yet .ROADMAP"):
        Runner(cfg, device="cpu")


@pytest.mark.parametrize("extra", [
    pytest.param(dict(_GRID, OCC_RES="8", CONTRACT="True", LINDISP="True"), id="OCC_GRID-True"),
    pytest.param({"CONTRACT": "True"}, id="CONTRACT-True"),
    pytest.param({"LINDISP": "True"}, id="LINDISP-True"),
    pytest.param(dict(_GRID, OCC_RES="8", PRECISION="bf16", LINDISP="True"),
                 id="PRECISION-bf16")])
def test_slice7_config_keys_train_and_render(sync_scene_dir, tmp_path, extra):
    """The keys slice 7 ports, once refused by name, take a step and render a
    frame through the Runner: the contracted occupancy grid (its extent
    forced to 2), CONTRACT alone, LINDISP alone, and the grid's disparity
    march at bf16. (Their agreement with the JAX package:
    tests/test_torch_unbounded.py, tests/test_torch_occupancy.py.)"""
    cfg = load_config(_write_ini(tmp_path, sync_scene_dir, TOTAL_ITER="1", STEP="1000",
                                 BATCH_RAY="64", LOG_DIR=f"{tmp_path}/runs/", **extra))
    runner = Runner(cfg, device="cpu")
    if cfg.occ_grid and cfg.contract:
        assert cfg.occ_extent == 2.0 and float(runner.state.occ.half_extent) == 2.0
    runner.train()
    frame = evallib.make_frame_fn(cfg, runner.k_inv, runner.test_table.height,
                                  runner.test_table.width, occ_grid=runner.state.occ)(
        runner.params, runner.test_table.poses[0].numpy())
    assert frame.shape == (runner.test_table.height, runner.test_table.width, 3)
    assert np.isfinite(frame).all()


def test_runner_takes_a_step_with_the_proposal_mlp(sync_scene_dir, tmp_path):
    """``PROPOSAL`` with ``PROP_FIELD = mlp`` (and ``PROP_PALLAS``, here
    through the kernels' plain versions) is no longer refused: the Runner
    builds the ``{"net", "prop"}`` state with the proposal MLP at its
    configured width and depth, and its training step takes one step that
    moves the proposal's weights."""
    cfg = load_config(_write_ini(tmp_path, sync_scene_dir, PROPOSAL="True", PROP_FIELD="mlp",
                                 PROP_PALLAS="True", PROPOSAL_WIDTH=32, PROPOSAL_DEPTH=2,
                                 BATCH_RAY=32))
    runner = Runner(cfg, device="cpu")
    prop = runner.params["prop"]
    assert sorted(prop) == ["color", "sigma", "trunk_0", "trunk_1"]
    assert prop["trunk_0"]["w"].shape == (60, 32) and prop["color"]["w"].shape == (56, 3)
    step = trainlib.make_train_step(cfg, runner.train_table, runner.k_inv)
    state, metrics = step(runner.state)
    assert state.iteration == 1 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.params["prop"]["trunk_1"]["w"], prop["trunk_1"]["w"])


def test_psnr_and_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert evallib.psnr(a, b) == jeval.psnr(a, b)
    assert evallib.ssim(a, b) == jeval.ssim(a, b)
    assert evallib.psnr(a, a) == float("inf")
