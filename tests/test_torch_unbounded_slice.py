"""Slice 7 as a whole on the CPU at small sizes: unbounded360-mlp
(``conf/unbounded360.ini`` with ``FINE_FIELD = mlp``: CONTRACT, LINDISP, the
proposal grid, DIST_LOSS, PROP_INTERLEVEL, the 8x256 MLP at bf16 with
``USE_PALLAS``, which under CONTRACT runs ``field_flat``: kernels 3 and 4 on
the card, their plain versions here) and the NDC path of
``conf/fern_ndc.ini``, against the JAX package's, whose field runs its
Pallas kernels in interpret mode (``force_pallas``). Inputs and index
streams are made with numpy from a seed.

The fields get content (the MLP's sigma bias +1, the proposal grid's
density columns x3): at random init the coarse weights are near zero, where
the resampler's slope amplifies last-ulp differences (ROADMAP section 3).
Gradients through the resampler are compared by cosine and norm bounds."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf import train as jtrain
from tinynerf.config import load_config as jload_config
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import SceneData as JSceneData
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf_torch import ckpt, eval as evallib, train
from tinynerf_torch.config import load_config
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import SceneData
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.kernels import mlp_kernel as mk
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

# conf/unbounded360.ini with the MLP fine field, cut to CPU size: the
# proposal grid's resolution and widths, the samples and the batch
SMALL = dict(fine_field="mlp", n_coarse=8, n_fine=16, batch_ray=32, prop_grid_res=8,
             prop_grid_comp_density=4, prop_grid_comp_app=4, prop_grid_decoder_width=8,
             total_iter=1000, step=10_000, decay_end=1000)


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _cfgs(conf, **kw):
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "conf", f"{conf}.ini")
    jcfg, cfg = jload_config(path), load_config(path)
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(cfg, **kw)
    return jcfg, cfg


def ring_scene(n_views, height, width, seed, near=0.5, far=100.0):
    """An outward-facing 360 ring, as an LLFF capture of an unbounded scene
    is: cameras on a radius-0.3 circle looking outward, per-image bounds
    near/far, smooth seeded images. (rows (n, 17), images (n, H, W, 3))."""
    rng = np.random.default_rng(seed)
    focal = 0.8 * width
    rows = np.zeros((n_views, 17))
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        out = np.array([np.sin(theta), 0.0, np.cos(theta)])
        back = -out  # the camera looks down -back: outward
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        c2w = np.stack([right, np.cross(back, right), back, 0.3 * out], axis=1)
        rows[i, :15] = np.concatenate([c2w, [[height], [width], [focal]]], axis=1).ravel()
        rows[i, 15:] = (near * rng.uniform(1.0, 1.2), far * rng.uniform(0.9, 1.0))
    base = rng.uniform(0.1, 0.9, (n_views, 4, 4, 3))
    images = np.kron(base, np.ones((1, -(-height // 4), -(-width // 4), 1)))
    return rows, images[:, :height, :width].astype(np.float32)


def _with_content(jcfg, seed):
    """JAX's fresh ``{"net", "prop"}`` params with content: (JAX params, the
    port's)."""
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        jcfg, jax.random.PRNGKey(seed)).params)
    tree["net"]["sigma"]["b"] = tree["net"]["sigma"]["b"] + np.float32(1.0)
    for ax in "xyz":
        tree["prop"]["lines"][ax][:, :jcfg.prop_grid_comp_density] *= np.float32(3.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def tables():
    rows, images = ring_scene(4, 12, 16, 0)
    h, w, f = 12, 16, float(rows[0, 14])
    jtable = JRayTable(JSceneData(images=images, poses_bounds=rows, height=h, width=w, focal=f))
    table = RayTable(SceneData(images=images, poses_bounds=rows, height=h, width=w, focal=f))
    idx = np.random.default_rng(1).integers(0, table.num_pix, (2, 32)).astype(np.int32)
    return jtable, table, idx, jmake_k_inv(h, w, f), make_k_inv(h, w, f)


def _compare_step(tables, jcfg, cfg, jparams, params, row, loss_rtol, cos_min, norm_rtol):
    """One step's loss (relative) and each part's gradient (cosine, norm)
    against JAX's ``make_loss_fn`` with the MLP through its Pallas kernels
    (interpret mode) wrapped by the contraction."""
    jtable, table, idx, jk_inv, k_inv = tables
    loss_fn = jtrain.make_loss_fn(jcfg, jk_inv, jtrain.make_field_fn(jcfg, force_pallas=True))
    (loss_ref, _), g_ref = jax.jit(jax.value_and_grad(
        lambda p, batch: loss_fn(p, batch, jax.random.PRNGKey(0), None), has_aux=True))(
            jparams, jtable.gather(jnp.asarray(idx[row])))
    before = (mk.field_flat.launches, mk.field_flat_bwd.launches)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx[row])))
    assert (mk.field_flat.launches, mk.field_flat_bwd.launches) == before  # plain versions
    assert abs(loss.item() / float(loss_ref) - 1) <= loss_rtol, (loss.item(), float(loss_ref))
    for part in ("net", "prop"):
        a, b = _flat(grads[part]), _flat(g_ref[part])
        assert _cos(a, b) >= cos_min, (part, _cos(a, b))
        assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) <= norm_rtol, part


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_unbounded360_mlp_step_matches_jax(tables, precision):
    """One step of the tiny unbounded360-mlp from the same params and batch
    (CONTRACT, LINDISP, the proposal grid, DIST_LOSS 0.003,
    PROP_INTERLEVEL 0.01; STRATIFIED off, since the two packages' jitter
    streams cannot match: coarse_ts's injected jitter is checked in
    tests/test_torch_unbounded.py), against ``tinynerf.train``'s loss with
    ``force_pallas`` under INTERPRET: the loss to rel 1e-4, each part's
    gradient (the 8x256 net, the proposal grid) to cosine >= 0.9999 at fp32
    and 0.999 at bf16, and its norm within 1%."""
    jcfg, cfg = _cfgs("unbounded360", **SMALL, precision=precision, stratified=False)
    assert cfg.contract and cfg.lindisp and cfg.dist_loss > 0 and cfg.prop_interlevel > 0
    jparams, params = _with_content(jcfg, 2)
    _compare_step(tables, jcfg, cfg, jparams, params, 0, 1e-4,
                  0.9999 if precision == "fp32" else 0.999, 1e-2)


@pytest.mark.parametrize("aux", ["dist_loss", "prop_interlevel"])
def test_aux_loss_terms_match_jax(tables, aux):
    """Each aux loss alone at a weight that makes it a large share of the
    loss (DIST_LOSS 1, PROP_INTERLEVEL 10): the loss and its gradient
    against JAX's at the same params and batch (fp32)."""
    kw = dict(SMALL, stratified=False, precision="fp32", dist_loss=0.0, prop_interlevel=0.0)
    kw[aux] = 1.0 if aux == "dist_loss" else 10.0
    jcfg, cfg = _cfgs("unbounded360", **kw)
    jparams, params = _with_content(jcfg, 3)
    _compare_step(tables, jcfg, cfg, jparams, params, 1, 1e-4, 0.9999, 1e-2)
    # the term is there: without it the loss differs
    plain = dataclasses.replace(cfg, **{aux: 0.0})
    batch = tables[1].gather(torch.from_numpy(tables[2][1]))
    with_aux = train.make_loss_fn(cfg, tables[4])(params, batch)[0]
    without = train.make_loss_fn(plain, tables[4])(params, batch)[0]
    assert float(with_aux) > float(without)


def test_unbounded360_mlp_runner_trains_and_renders(tmp_path):
    """The tiny unbounded360-mlp through ``Runner`` on an in-memory ring:
    the loss falls over 24 steps (jittered coarse samples, both aux losses
    on), and a frame renders finite, in [0, 1]."""
    rows, images = ring_scene(4, 12, 16, 4)
    scene = SceneData(images=images, poses_bounds=rows, height=12, width=16,
                      focal=float(rows[0, 14]))
    _, cfg = _cfgs("unbounded360", **SMALL, learning=5e-3)
    cfg = dataclasses.replace(cfg, total_iter=24, ckpt_path=str(tmp_path / "ckpt"),
                              results_path=str(tmp_path / "results"),
                              log_dir=str(tmp_path / "runs"), render_chunk=64)
    runner = Runner(cfg, device="cpu", scene=scene)
    assert runner.ndc_params is None and cfg.stratified
    runner.train()
    import json
    with open(runner.logger.path) as f:
        losses = [json.loads(line)["loss/train"] for line in f]
    assert len(losses) == 24 and np.all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
    frames = evallib.render_test_set(cfg, runner.params, runner.test_table, runner.k_inv,
                                     "run", 23, save=False, max_views=1)
    assert frames.shape == (1, 12, 16, 3) and np.isfinite(frames).all()


def test_fern_ndc_runner_trains_and_renders(llff_scene_dir, tmp_path):
    """``conf/fern_ndc.ini`` (NDC, bf16, u8 pixels) on a tiny LLFF scene: the
    Runner recentres the train poses and sets ``ndc_params``; it takes
    steps and renders a frame whose depth stays in [0, 1] (NDC units); the
    recentred poses are the JAX Runner's."""
    from tinynerf.data.poses import load_scene as jload_scene, recenter_and_rescale
    _, cfg = _cfgs("fern_ndc", img_dir=llff_scene_dir, low_res=1, n_coarse=8, n_fine=16,
                   batch_ray=32, total_iter=4, step=1000, render_chunk=64,
                   ckpt_path=str(tmp_path / "ckpt"), results_path=str(tmp_path / "results"),
                   log_dir=str(tmp_path / "runs"))
    assert cfg.ndc and cfg.precision == "bf16" and cfg.pixel_dtype == "u8"
    runner = Runner(cfg, device="cpu")
    t = runner.train_table
    assert runner.ndc_params == (float(t.height), float(t.width), float(t.focal))
    want = recenter_and_rescale(jload_scene(llff_scene_dir, "llff", "train", 1).poses_bounds)
    np.testing.assert_allclose(t.poses.numpy(), want.astype(np.float32), rtol=0, atol=0)
    runner.train()
    frame = evallib.make_frame_fn(cfg, runner.k_inv, t.height, t.width, extras=True,
                                  ndc_params=runner.ndc_params)(runner.params,
                                                               t.poses[0].numpy())
    rgb, depth, acc = frame
    assert rgb.shape == (t.height, t.width, 3) and np.isfinite(rgb).all()
    assert np.all((depth >= 0) & (depth <= 1 + 1e-5)) and np.isfinite(acc).all()


def test_fern_ndc_frame_matches_jax(llff_scene_dir):
    """One NDC frame of the tiny fern_ndc config from the same params (a
    field with content), through the MLP's ray kernels' plain versions and
    JAX's Pallas kernels in interpret mode: every pixel within 1e-3 (the
    kernels' bf16 form on both sides), and the fused branch
    (``FUSED_RENDER``, kernel 9's plain version) within 1e-3 of the
    unfused frame."""
    from tinynerf import eval as jeval
    from tinynerf.data.poses import load_scene as jload_scene, recenter_and_rescale
    jcfg, cfg = _cfgs("fern_ndc", img_dir=llff_scene_dir, low_res=1, n_coarse=8, n_fine=16,
                      render_chunk=40)
    scene = jload_scene(llff_scene_dir, "llff", "train", 1)
    rows = recenter_and_rescale(scene.poses_bounds).astype(np.float32)
    h, w, f = scene.height, scene.width, scene.focal
    ndc = (float(h), float(w), float(f))
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(jcfg, jax.random.PRNGKey(5)).params)
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    jparams, params = jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)
    ref = np.asarray(jeval.make_frame_fn(
        jcfg, jmake_k_inv(h, w, f), h, w, field_fn=jtrain.make_field_fn(jcfg, force_pallas=True),
        ndc_params=ndc)(jparams, jnp.asarray(rows[0])))
    k_inv = make_k_inv(h, w, f)
    got = evallib.make_frame_fn(cfg, k_inv, h, w, ndc_params=ndc)(params, rows[0])
    np.testing.assert_allclose(got, ref.reshape(got.shape), atol=1e-3)
    fused_cfg = dataclasses.replace(cfg, fused_render=True)
    fused = evallib.make_frame_fn(fused_cfg, k_inv, h, w, ndc_params=ndc)(params, rows[0])
    np.testing.assert_allclose(fused, got, atol=1e-3)
