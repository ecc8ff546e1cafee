"""The Runner's one-device options of this slice against the JAX package's,
on the CPU at small sizes: ``VAL_METRICS`` (the fixed val batch and its
PSNR, with and without ``FUSED_RENDER``), ``PROFILE_STEPS`` (the trace
window) and what ``eval.check_supported`` accepts and still refuses. Inputs are made with
numpy from a seed and handed to both."""

import glob
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf.config import Config as JConfig
from tinynerf.runner import Runner as JRunner
from tinynerf_torch import ckpt, eval as evallib, optim, profiling
from tinynerf_torch.config import Config
from tinynerf_torch.kernels import render_kernel
from tinynerf_torch.logging import MetricLogger
from tinynerf_torch.parallel import mesh as meshlib
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

PSNR_DB = 1e-3               # the val PSNR, port against JAX and fused against unfused


# ---------------------------------------------------------------- VAL_METRICS


def _cfgs(scene_dir, tmp_path, **kw):
    base = dict(img_dir=f"{scene_dir}/", data_type="sync", n_coarse=8, n_fine=16,
                batch_ray=32, total_iter=4, step=2, use_pallas=False, val_metrics=True,
                ckpt_path=str(tmp_path / "ckpt"), results_path=str(tmp_path / "results"),
                log_dir=str(tmp_path / "runs"))
    base.update(kw)
    return JConfig(**base), Config(**base)


def _content(jrunner):
    """The JAX Runner's fresh MLP with the sigma bias raised by 1 (a field
    with content, as the frame tests use): (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.asarray, jrunner.state.params)
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


@pytest.mark.parametrize("pixel_dtype", ["f32", "u8"])
def test_val_batch_and_psnr_match_jax(sync_scene_dir, tmp_path, pixel_dtype):
    """The port's val batch (rows, cols, rgb, pose, pic) equals the JAX
    Runner's bit for bit (the same numpy stream over the host pixels, u8
    dequantised); at the same params the two val PSNRs agree within
    1e-3 dB."""
    jcfg, cfg = _cfgs(sync_scene_dir, tmp_path, pixel_dtype=pixel_dtype)
    jrunner, runner = JRunner(jcfg), Runner(cfg, device="cpu")
    jparams, params = _content(jrunner)
    jrunner.state = jrunner.state._replace(params=jparams)
    runner.state.params = params
    j_db, db = jrunner._val_psnr(), runner.val_psnr()
    for field in ("rows", "cols", "rgb", "pose17", "pic"):
        got = getattr(runner._val_batch, field).numpy()
        want = np.asarray(getattr(jrunner._val_eval[1], field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert np.isfinite(db) and abs(db - j_db) <= PSNR_DB
    assert runner.val_psnr() == db   # the same rays every call


def test_runner_reports_val_psnr_at_each_step_boundary(sync_scene_dir, tmp_path, capsys):
    _, cfg = _cfgs(sync_scene_dir, tmp_path)
    runner = Runner(cfg, device="cpu")
    runner.train()
    out = capsys.readouterr().out
    assert out.count("[VAL PSNR]") == 2 and " dB" in out
    (path,) = glob.glob(str(tmp_path / "runs" / "*" / "metrics.jsonl"))
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows if "psnr/val" in r] == [1, 3]
    assert all(np.isfinite(r["psnr/val"]) for r in rows if "psnr/val" in r)


def test_val_psnr_with_fused_render_goes_through_render_fused(sync_scene_dir, tmp_path,
                                                              monkeypatch):
    """With ``FUSED_RENDER`` the val pass takes the fused branch: one call of
    ``render_fused`` (its plain version on the CPU; on the card one launch
    of kernel 9), and its PSNR agrees with the unfused one within 1e-3 dB."""
    calls = []
    real = render_kernel.render_fused

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(render_kernel, "render_fused", counted)
    jcfg, cfg = _cfgs(sync_scene_dir, tmp_path, use_pallas=True, white_bkgd=True)
    runner = Runner(cfg, device="cpu")
    _, runner.state.params = _content(JRunner(jcfg))
    unfused = runner.val_psnr()
    assert calls == []
    runner.cfg.fused_render = True
    fused = runner.val_psnr()
    assert calls == [1]
    assert np.isfinite(fused) and abs(fused - unfused) <= PSNR_DB


# ---------------------------------------------------------------- PROFILE_STEPS


def test_profile_steps_traces_and_changes_no_param(sync_scene_dir, tmp_path, capsys):
    """``PROFILE_STEPS = 2`` on the CPU: a Chrome trace under
    ``LOG_DIR/trace`` and the ``[PROFILE]`` line; the params after 4 steps
    equal those of the same run without the profiler, bit for bit."""
    runs = {}
    for steps in (0, 2):
        _, cfg = _cfgs(sync_scene_dir, tmp_path / str(steps), profile_steps=steps,
                       val_metrics=False, step=1000)
        runner = Runner(cfg, device="cpu")
        runner.train()
        runs[steps] = runner.params
    out = capsys.readouterr().out
    assert f"[PROFILE] trace of 2 steps -> {tmp_path / '2' / 'runs' / 'trace'}" in out
    (trace,) = glob.glob(str(tmp_path / "2" / "runs" / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert not (tmp_path / "0" / "runs" / "trace").exists()
    for a, b in zip(optim.leaves(runs[0]), optim.leaves(runs[2])):
        assert torch.equal(a, b)


def test_trace_context_writes_a_cpu_trace(tmp_path):
    """``profiling.trace`` on the CPU asks for CPU activity alone and writes
    one Chrome trace of what it brackets under its directory."""
    with profiling.trace(str(tmp_path / "trace"), torch.device("cpu")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as f:
        assert "aten::mm" in f.read()


# ---------------------------------------------------------------- check_supported


@pytest.mark.parametrize("kw", [
    dict(host_feed=True), dict(val_metrics=True), dict(profile_steps=5),
    dict(fine_field="grid", grid_upsample="100:128,200:256")],
    ids=["HOST_FEED", "VAL_METRICS", "PROFILE_STEPS", "GRID_UPSAMPLE"])
def test_check_supported_accepts_the_runner_options(kw):
    evallib.check_supported(Config(**kw))


def test_check_supported_keeps_the_pyramid_error_and_the_refusals(sync_scene_dir, tmp_path):
    """``GRID_UPSAMPLE`` with a pyramid is the JAX package's ``ValueError``;
    the gather lookup, once refused by name, is accepted on the fine grid
    and on the proposal grid, and a Runner trains two steps with each; a
    ``MESH_SHAPE`` other than the job's world size and a ``SAMPLE_SHARD``
    that does not divide it are refused, now that a mesh over several ranks
    is ported (``parallel/``)."""
    with pytest.raises(ValueError, match="GRID_UPSAMPLE is incompatible with GRID_LEVELS>1"):
        evallib.check_supported(Config(fine_field="grid", grid_upsample="100:128",
                                       grid_levels=2))
    small = dict(img_dir=f"{sync_scene_dir}/", data_type="sync", n_coarse=8, n_fine=16,
                 batch_ray=32, total_iter=2, step=1000, grid_res=9, grid_comp_density=2,
                 grid_comp_app=3, grid_decoder_width=8, prop_grid_res=8,
                 prop_grid_comp_density=2, prop_grid_comp_app=2, prop_grid_decoder_width=8)
    for i, kw in enumerate((dict(fine_field="grid", grid_lookup="gather"),
                            dict(proposal=True, prop_field="grid", grid_lookup="gather"))):
        cfg = Config(**small, **kw, ckpt_path=str(tmp_path / f"ckpt{i}"),
                     log_dir=str(tmp_path / f"runs{i}"))
        evallib.check_supported(cfg)
        runner = Runner(cfg, device="cpu")
        runner.logger = MetricLogger(cfg.log_dir, use_tensorboard=False)
        runner.train()
        assert runner.state.iteration == 2
    with pytest.raises(ValueError, match="MESH_SHAPE=4 asks for 4 ranks but this job has 1"):
        evallib.check_supported(Config(mesh_shape=4))
    with pytest.raises(ValueError, match="SAMPLE_SHARD=3 must divide the device count 4"):
        meshlib.check_mesh(Config(mesh_shape=4, sample_shard=3), 4)
