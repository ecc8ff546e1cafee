"""The proposal grid and the grid field in the port's renderer and training
step (``tinynerf_torch``: ``render_rays`` with ``prop_params``, the
``{"net", "prop"}`` state, ``GRID_TV``, ``make_lr_scale``, ``GRID_PALLAS``
through ``grid_rays``, the Runner and the CLI on ``conf/lego_grid.ini``'s
keys) against the JAX package's, on the CPU at small sizes. Inputs and index
streams are made with numpy from a seed and handed to both.

The grids get content: every line table's density columns are scaled by 3
(sigma by 27), in both packages' params. A random grid's sigma is about
0.01-0.1, where the coarse weights are near zero and the resampler's slope
``delta / (dense + 1e-7)`` amplifies last-ulp differences into visible
shifts of the fine samples (ROADMAP section 3)."""

import functools
import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf import train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import gridfield as jgf, render as jrender
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf_torch import ckpt, optim, train
from tinynerf_torch.config import Config, load_config
from tinynerf_torch.core import gridfield, render
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.kernels import grid_kernel as gk
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_ATOL = 1e-4   # the frame tolerance (tests/test_torch_slice.py)
DENSITY_SCALE = 3.0

# conf/lego_grid.ini's structure at small widths
SMALL = dict(n_coarse=8, n_fine=16, fine_field="grid", grid_res=16, grid_comp_density=4,
             grid_comp_app=8, grid_decoder_width=16, proposal=True, prop_field="grid",
             prop_grid_res=8, prop_grid_comp_density=4, prop_grid_comp_app=4,
             prop_grid_decoder_width=8, grid_tv=0.1, white_bkgd=True, batch_ray=32,
             learning=5e-4, decay_end=100)


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return JConfig(**base), Config(**base)


def _with_content(jcfg, seed):
    """JAX's fresh ``{"net", "prop"}`` params, each grid's density columns
    scaled by 3 (an MLP net: sigma bias +1): (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        jcfg, jax.random.PRNGKey(seed)).params)
    for part, nd in (("net", jcfg.grid_comp_density), ("prop", jcfg.prop_grid_comp_density)):
        if "lines" in tree[part]:
            for ax in "xyz":
                tree[part]["lines"][ax][:, :nd] *= np.float32(DENSITY_SCALE)
        else:
            tree[part]["sigma"]["b"] = tree[part]["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _parts(params):
    """The trained parts of a pair, by path: the net's lines and decoder (or
    the whole MLP), the proposal grid's lines and decoder."""
    net = ["net.lines", "net.decoder"] if "lines" in params["net"] else ["net"]
    return net + ["prop.lines", "prop.decoder"]


def _part(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


# ---------------------------------------------------------------- render


def _pose_rows(rng, B):
    rows = np.zeros((B, 17), np.float32)
    for i in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.concatenate([q, rng.normal(size=(3, 1)) * 0.5 + q[:, 2:3] * 3.0], axis=1)
        rows[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], axis=1).ravel()
        rows[i, 15:] = (1.5, 4.5)
    return rows


@pytest.mark.parametrize("fields", ["point", "kernels"])
@pytest.mark.parametrize("white_bkgd,extras", [(False, False), (True, True)])
def test_render_rays_with_the_proposal_grid_matches_jax(fields, white_bkgd, extras):
    """The coarse pass on the proposal grid, the resampler fed the detached
    coarse weights, the fine pass composited on its own: both passes'
    pixels, and with extras depth and opacity over the fine samples, within
    the frame tolerance. ``point``: both packages' point fields;
    ``kernels``: JAX's Pallas kernels in interpret mode and the port's
    ``grid_rays``."""
    jcfg, cfg = _cfgs(white_bkgd=white_bkgd)
    jparams, params = _with_content(jcfg, 1)
    rng = np.random.default_rng(2)
    B = 24
    rows, cols = (rng.integers(0, 16, B).astype(np.float32) for _ in range(2))
    pose = _pose_rows(rng, B)
    jnet = jgf.make_field_grid(n_density=4)
    jprop = jgf.make_field_grid(n_density=4)
    net = functools.partial(gridfield.apply_grid_field, n_density=4)
    prop = functools.partial(gridfield.apply_grid_field, n_density=4)
    if fields == "kernels":
        from tinynerf.kernels.grid_kernel import grid_field_pallas_rays
        jnet.eval_rays = functools.partial(grid_field_pallas_rays, n_density=4,
                                           compute_dtype=jnp.float32)
        jprop.eval_rays = jnet.eval_rays
        net.eval_rays = functools.partial(gk.grid_rays, n_density=4)
        prop.eval_rays = net.eval_rays
    ref = jrender.render_rays(jparams["net"], jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(pose), jmake_k_inv(16, 16, 20.0), 8, 16,
                              field_fn=jnet, white_bkgd=white_bkgd, extras=extras,
                              prop_params=jparams["prop"], prop_field_fn=jprop)
    got = render.render_rays(params["net"], torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(pose), make_k_inv(16, 16, 20.0), 8, 16,
                             field_fn=net, white_bkgd=white_bkgd, extras=extras,
                             prop_params=params["prop"], prop_field_fn=prop)
    assert len(got) == len(ref) == (4 if extras else 2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PIXEL_ATOL, rtol=1e-4)
    if extras:   # the grids have content: every ray's fine opacity 0.1-0.4
        assert float(got[3].min()) > 0.05


def test_render_rays_refuses_what_the_proposal_mode_cannot_do():
    _, params = _with_content(_cfgs()[0], 0)
    args = (torch.zeros(2), torch.zeros(2), torch.from_numpy(_pose_rows(np.random.default_rng(0), 2)),
            make_k_inv(16, 16, 20.0), 8)
    field = functools.partial(gridfield.apply_grid_field, n_density=4)
    kw = dict(field_fn=field, prop_params=params["prop"], prop_field_fn=field)
    with pytest.raises(ValueError, match="N_FINE=0"):
        render.render_rays(params["net"], *args, 0, **kw)
    with pytest.raises(ValueError, match="COMPAT_SORT"):
        render.render_rays(params["net"], *args, 16, compat_sort=True, **kw)


def test_render_rays_defaults_to_the_proposal_mlp():
    """``prop_params`` without ``prop_field_fn`` runs the coarse pass on the
    proposal MLP's plain field (``proposal.field_proposal``), as the JAX
    package's renderer does (``tinynerf/core/render.py:320-322``): both
    passes' pixels against JAX's within the frame tolerance."""
    jcfg, _ = _cfgs(prop_field="mlp", proposal_width=32, proposal_depth=2)
    jparams, params = _with_content(jcfg, 6)
    rng = np.random.default_rng(7)
    B = 16
    rows, cols = (rng.integers(0, 16, B).astype(np.float32) for _ in range(2))
    pose = _pose_rows(rng, B)
    ref = jrender.render_rays(jparams["net"], jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(pose), jmake_k_inv(16, 16, 20.0), 8, 16,
                              field_fn=jgf.make_field_grid(n_density=4),
                              prop_params=jparams["prop"])
    got = render.render_rays(params["net"], torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(pose), make_k_inv(16, 16, 20.0), 8, 16,
                             field_fn=functools.partial(gridfield.apply_grid_field, n_density=4),
                             prop_params=params["prop"])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PIXEL_ATOL, rtol=1e-4)


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def step_setup(request):
    scene_dir = request.getfixturevalue("sync_scene_dir")
    jtable = JRayTable(jload_scene(scene_dir, "sync", "train"))
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    idx = np.random.default_rng(10).integers(0, table.num_pix, (10, 32)).astype(np.int32)
    jk_inv = jmake_k_inv(jtable.height, jtable.width, jtable.focal)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    return jtable, table, idx, jk_inv, k_inv


def _jax_grads(jcfg, jtable, jk_inv, jparams, idx, force_pallas=False):
    field_fn = jtrain.make_field_fn(jcfg, force_pallas=force_pallas)
    loss_fn = jtrain.make_loss_fn(jcfg, jk_inv, field_fn)
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams, jtable.gather(jnp.asarray(idx)), jax.random.PRNGKey(0), None)
    return float(loss), grads


def _check_grads(grads, ref, cos_min=0.9999, norm_tol=1e-3):
    """Per trained part: cosine and norm ratio of the flattened gradients."""
    for name in _parts(grads):
        got, want = _flat(_part(grads, name)), _flat(_part(ref, name))
        assert _cos(got, want) >= cos_min, name
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= norm_tol, name


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_step_loss_and_gradients_match_jax_with_grid_pallas(step_setup, precision,
                                                            monkeypatch):
    """One ``lego_grid``-shaped step (grid field, proposal grid, GRID_TV,
    WHITE_BKGD, GRID_PALLAS) from the same params and batch, against
    ``make_loss_fn`` with both grid fields through JAX's Pallas kernels in
    interpret mode (``force_pallas``): the loss to rel 1e-5, and each part's
    gradient (net lines, net decoder, proposal lines, proposal decoder) to
    cosine >= 0.9999 and norm within 1e-3; at bf16 (the kernels' bf16 form
    on both sides) the loss to rel 1e-4, cosine >= 0.999 and norm within
    1e-2, slice 3's bf16 bounds (measured: the loss equal, cosine >=
    0.9999995, norm within 1.7e-4, on the line tables)."""
    jtable, table, idx, jk_inv, k_inv = step_setup
    jcfg, cfg = _cfgs(grid_pallas=True, precision=precision)
    jparams, params = _with_content(jcfg, 3)
    monkeypatch.setattr(jtrain, "make_prop_field_fn", functools.partial(
        jtrain.make_prop_field_fn, force_pallas=True))
    loss_ref, g_ref = _jax_grads(jcfg, jtable, jk_inv, jparams, idx[0], force_pallas=True)
    before = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx[0])))
    assert (gk.grid_rays.launches, gk.grid_rays_bwd.launches) == before
    tol = (1e-5, 0.9999, 1e-3) if precision == "fp32" else (1e-4, 0.999, 1e-2)
    assert abs(loss.item() / loss_ref - 1) <= tol[0]
    _check_grads(grads, g_ref, *tol[1:])
    assert float(grads["net"]["extent"]) == 0.0 == float(grads["prop"]["extent"])


def test_mlp_field_with_the_proposal_grid_matches_jax(step_setup):
    """The ``lego_fast`` / ``lego_prop`` shape: the 8x256 MLP fine field
    (through its kernels' plain versions) with the grid proposal (through
    ``grid_rays`` with GRID_PALLAS): the loss to rel 1e-5, each part's
    gradient to cosine >= 0.9999 and norm within 1e-3."""
    jtable, table, idx, jk_inv, k_inv = step_setup
    jcfg, cfg = _cfgs(fine_field="mlp", grid_pallas=True, grid_tv=0.0)
    jparams, params = _with_content(jcfg, 4)
    loss_ref, g_ref = _jax_grads(jcfg, jtable, jk_inv, jparams, idx[1])
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx[1])))
    assert abs(loss.item() / loss_ref - 1) <= 1e-5
    _check_grads(grads, g_ref)
    assert train.make_lr_scale(cfg, params)["net"]["trunk_0"]["w"] == 1.0


def test_ten_indexed_steps_track_jax(step_setup):
    """Ten steps of ``make_indexed_train_step`` in each package from the same
    params and index stream, the lines at GRID_LR_MULT = 20 times the rate.

    - Each step's loss to rel 1e-3 (measured on the CPU: at most 1.2e-6).
    - At each step, the port's gradient on JAX's current params against
      JAX's: cosine >= 0.9999 per part.
    - The params at the end, per part, max-normalised (max|diff| / max|p|):
      within 2e-2 (measured: at most 2.1e-6, on the net's decoder). Wider
      than slice 2's 1e-2: Adam's first updates are close to ``lr * sign(g)``
      whatever |g|, and the lines move at 20 x 5e-4 = 1e-2 a step, so one
      element whose gradient is near zero and whose sign the two packages'
      float32 sums decide differently would end up 2e-2 a step apart (about
      1e-2 of max|p|); this stream has none.
    - Both extents stay exactly 1.5: their gradient is zero, and so is
      Adam's update."""
    jtable, table, idx, jk_inv, k_inv = step_setup
    jcfg, cfg = _cfgs(grid_pallas=True)
    jparams, params = _with_content(jcfg, 5)
    jstep = jtrain.make_indexed_train_step(jcfg, jtable, jk_inv)
    step = train.make_indexed_train_step(cfg, table, k_inv)
    loss_fn = train.make_loss_fn(cfg, k_inv)
    jstate = jtrain.init_state(jcfg, params=jparams)
    state = train.init_state(cfg, torch.device("cpu"), params=params)
    for i in range(10):
        _, g_ref = _jax_grads(jcfg, jtable, jk_inv, jstate.params, idx[i])
        now = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params))
        _, _, grads = train.loss_and_grads(loss_fn, now, table.gather(torch.from_numpy(idx[i])))
        _check_grads(grads, g_ref, norm_tol=1e-2)
        jstate, jm = jstep(jstate, jnp.asarray(idx[i]))
        state, m = step(state, torch.from_numpy(idx[i]))
        assert abs(m["loss"].item() / float(jm["loss"]) - 1) <= 1e-3, i
    assert state.iteration == int(jstate.iteration) == 10 == state.opt.count
    for name in _parts(state.params):
        got, want = _flat(_part(state.params, name)), _flat(_part(jstate.params, name))
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2, name
    for part in ("net", "prop"):
        assert float(state.params[part]["extent"]) == 1.5 == float(jstate.params[part]["extent"])


# ---------------------------------------------------------------- Runner, CLI

GRID_INI = dict(FINE_FIELD="grid", GRID_RES=16, GRID_COMP_DENSITY=4, GRID_COMP_APP=8,
                GRID_DECODER_WIDTH=16, GRID_TV=0.1, PROPOSAL="True", PROP_FIELD="grid",
                PROP_GRID_RES=8, PROP_GRID_COMP_DENSITY=4, PROP_GRID_COMP_APP=4,
                PROP_GRID_DECODER_WIDTH=8, GRID_PALLAS="True", OCC_GRID="True", OCC_RES=8,
                WHITE_BKGD="True", PRECISION="bf16")


def _write_ini(tmp_path, scene_dir, **extra):
    keys = dict(IMG_DIR=f"{scene_dir}/", RESULTS_PATH=f"{tmp_path}/results/",
                CKPT_PATH=f"{tmp_path}/ckpt/", LOG_DIR=f"{tmp_path}/runs/",
                N_COARSE=8, N_FINE=16, RENDER_CHUNK=64, BATCH_RAY=32,
                DATA_TYPE="sync", LEARNING=2e-3, DECAY_END=40, **GRID_INI)
    keys.update(extra)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ini = tmp_path / "scene.ini"
    ini.write_text("\n".join(["[scene]"] + [f"{k} = {v}" for k, v in keys.items()]) + "\n")
    return str(ini)


def test_python_m_trains_and_renders_lego_grid_keys(sync_scene_dir, tmp_path):
    """``python -m tinynerf_torch --mode all`` on a tiny INI with
    ``conf/lego_grid.ini``'s keys and GRID_PALLAS: trains, checkpoints the
    ``{"net", "prop"}`` state with its grid, and renders the test split."""
    ini = _write_ini(tmp_path, sync_scene_dir, TOTAL_ITER=4, STEP=4)
    proc = subprocess.run(
        [sys.executable, "-m", "tinynerf_torch", "--conf", ini, "--mode", "all",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[ITER] 3 [LOSS]" in proc.stdout and "Test PSNR" in proc.stdout
    (path,) = glob.glob(str(tmp_path / "ckpt" / "*_3.npz"))
    with np.load(path) as archive:
        assert "params::net::lines::x" in archive.files and "occ::raw" in archive.files
        assert archive["params::prop::lines::x"].shape == (8, 8)
        assert archive["mu::net::extent"].shape == ()


def test_runner_resumes_the_pair_checkpoint(sync_scene_dir, tmp_path):
    """Stopping at a ``{"net", "prop"}`` checkpoint and resuming gives the
    run that never stopped (the params, moments, grid and sample stream),
    with both extents untouched."""
    whole = Runner(load_config(_write_ini(tmp_path / "a", sync_scene_dir, TOTAL_ITER=4,
                                          STEP=2)), device="cpu")
    whole.train()
    first = Runner(load_config(_write_ini(tmp_path / "b", sync_scene_dir, TOTAL_ITER=2,
                                          STEP=2)), device="cpu")
    first.train()
    resumed = Runner(load_config(_write_ini(tmp_path / "b", sync_scene_dir, TOTAL_ITER=4,
                                            STEP=2, CONTINUE="True")), device="cpu")
    assert resumed.state.iteration == 2 and resumed.state.opt.count == 2
    assert torch.equal(resumed.state.occ.raw, first.state.occ.raw)
    resumed.train()
    for part in ("net", "prop"):
        for ax in "xyz":
            assert torch.equal(resumed.params[part]["lines"][ax],
                               whole.params[part]["lines"][ax]), (part, ax)
        assert float(resumed.params[part]["extent"]) == 1.5
    assert np.isfinite(resumed.display(max_views=1))


def test_grid_level_fold_leaves_the_proposal_grid_alone():
    """``GRID_LEVEL_FOLD`` is a main-grid option: with the MLP fine field and
    the proposal grid the port builds the proposal field (the fold not
    applied), as JAX's ``train.make_prop_field_fn`` does, and the two agree
    on the same params."""
    kw = dict(SMALL, fine_field="mlp", grid_level_fold=True)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    from tinynerf_torch import eval as evallib
    jparams, params = _with_content(jcfg, 0)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.6, 1.6, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jtrain.make_prop_field_fn(jcfg)(jparams["prop"], jnp.asarray(pts), jnp.asarray(dirs))
    got = evallib.make_prop_field_fn(cfg)(params["prop"], torch.from_numpy(pts),
                                          torch.from_numpy(dirs))
    for g, r in zip(got, ref):
        r = np.stack(r, -1) if isinstance(r, (tuple, list)) else np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r, atol=1e-5, rtol=1e-5)
