"""The proposal MLP on the port's paths (``PROPOSAL``, ``PROP_FIELD = mlp``,
``PROP_PALLAS``) against the JAX package's, on the CPU at small sizes: the
renderer with the kernelized proposal field, one training step of a tiny
``conf/lego_prop.ini`` with the 8x256 MLP and with the grid fine field,
checkpoints in both directions with a resume that disagrees with the config,
and ``python -m tinynerf_torch --mode all``. The JAX side runs its Pallas
kernels in interpret mode (``force_pallas``); the port takes its kernels'
plain versions. Inputs and index streams are made with numpy from a seed.

The fields get content (sigma bias +1; the grid's density columns x3): at
random init the coarse weights are near zero, where the resampler's slope
amplifies last-ulp differences into shifts of the fine samples (ROADMAP
section 3)."""

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
from tinynerf import ckpt as jckpt, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import render as jrender
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf_torch import ckpt, eval as evallib, train
from tinynerf_torch.config import Config
from tinynerf_torch.core import render
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.kernels import proposal_kernel as pk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_ATOL = 1e-4   # the frame tolerance (tests/test_torch_slice.py)

# conf/lego_prop.ini with PROP_FIELD = mlp and PROP_PALLAS at small sizes
SMALL = dict(n_coarse=8, n_fine=16, proposal=True, prop_field="mlp", prop_pallas=True,
             proposal_width=64, proposal_depth=3, batch_ray=32, learning=5e-4,
             decay_end=100)
# the grid fine field's small geometry (tests/test_torch_proposal.py)
GRID = dict(fine_field="grid", grid_res=16, grid_comp_density=4, grid_comp_app=8,
            grid_decoder_width=16, grid_pallas=True)


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's proposal field through its Pallas kernels (interpret
    mode) wherever ``make_loss_fn`` builds it."""
    monkeypatch.setattr(jtrain, "make_prop_field_fn", functools.partial(
        jtrain.make_prop_field_fn, force_pallas=True))


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return JConfig(**base), Config(**base)


def _with_content(jcfg, seed):
    """JAX's fresh ``{"net", "prop"}`` params with content (every MLP's sigma
    bias +1, a grid's density columns x3): (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        jcfg, jax.random.PRNGKey(seed)).params)
    for part in ("net", "prop"):
        if "lines" in tree[part]:
            for ax in "xyz":
                tree[part]["lines"][ax][:, :jcfg.grid_comp_density] *= np.float32(3.0)
        else:
            tree[part]["sigma"]["b"] = tree[part]["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _pose_rows(rng, B):
    rows = np.zeros((B, 17), np.float32)
    for i in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.concatenate([q, rng.normal(size=(3, 1)) * 0.5 + q[:, 2:3] * 3.0], axis=1)
        rows[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], axis=1).ravel()
        rows[i, 15:] = (1.5, 4.5)
    return rows


# ---------------------------------------------------------------- render


def test_render_rays_with_the_proposal_mlp_kernels_matches_jax(jax_kernels):
    """The slice's render: the 8x256 MLP through its kernels' plain versions,
    the coarse pass on the proposal MLP through ``prop_rays`` (its plain
    versions), against JAX's ``render_rays`` with the proposal field through
    ``prop_field_pallas_rays`` in interpret mode (built as
    tests/test_proposal_kernel.py:103-140 builds it): both passes' pixels,
    depth and opacity within the frame tolerance; no kernel launches here."""
    jcfg, cfg = _cfgs()
    jparams, params = _with_content(jcfg, 1)
    rng = np.random.default_rng(2)
    B = 16
    rows, cols = (rng.integers(0, 16, B).astype(np.float32) for _ in range(2))
    pose = _pose_rows(rng, B)
    ref = jax.jit(lambda p: jrender.render_rays(
        p["net"], jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(pose),
        jmake_k_inv(16, 16, 20.0), 8, 16, field_fn=jtrain.make_field_fn(jcfg), extras=True,
        prop_params=p["prop"], prop_field_fn=jtrain.make_prop_field_fn(jcfg)))(jparams)
    before = pk.prop_rays.launches
    got = render.render_rays(params["net"], torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(pose), make_k_inv(16, 16, 20.0), 8, 16,
                             field_fn=evallib.make_field_fn(cfg), extras=True,
                             prop_params=params["prop"],
                             prop_field_fn=evallib.make_prop_field_fn(cfg))
    assert pk.prop_rays.launches == before
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PIXEL_ATOL, rtol=1e-4)


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def step_setup(request):
    scene_dir = request.getfixturevalue("sync_scene_dir")
    jtable = JRayTable(jload_scene(scene_dir, "sync", "train"))
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    idx = np.random.default_rng(10).integers(0, table.num_pix, (3, 32)).astype(np.int32)
    jk_inv = jmake_k_inv(jtable.height, jtable.width, jtable.focal)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    return jtable, table, idx, jk_inv, k_inv


def _compare_step(setup, jcfg, cfg, jparams, params, row, loss_rtol, cos_min):
    """One step's loss (relative) and each part's gradient (cosine): the
    net and the proposal MLP, the JAX side through its kernels."""
    jtable, table, idx, jk_inv, k_inv = setup
    # the net's kernels in interpret mode where their function differs from
    # the plain field's (bf16); at fp32 the plain field is the same function
    loss_fn = jtrain.make_loss_fn(jcfg, jk_inv, jtrain.make_field_fn(
        jcfg, force_pallas=jcfg.precision == "bf16"))
    (loss_ref, _), g_ref = jax.jit(jax.value_and_grad(
        lambda p, batch: loss_fn(p, batch, jax.random.PRNGKey(0), None), has_aux=True))(
            jparams, jtable.gather(jnp.asarray(idx[row])))
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx[row])))
    assert abs(loss.item() / float(loss_ref) - 1) <= loss_rtol
    cosines = {part: _cos(_flat(grads[part]), _flat(g_ref[part])) for part in ("net", "prop")}
    assert min(cosines.values()) >= cos_min, cosines


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_step_with_the_proposal_mlp_matches_jax(step_setup, jax_kernels, precision):
    """One step of the tiny ``lego_prop`` + ``PROP_FIELD = mlp`` +
    ``PROP_PALLAS`` config from the same params and batch, against JAX's
    ``make_loss_fn`` with the proposal field through its Pallas kernel (and
    at bf16 the net through its kernels too): the loss to
    rel 1e-4, each part's gradient (the 8x256 net, the proposal MLP) to
    cosine >= 0.9999 at fp32 and 0.999 at bf16 (the kernels' bf16 form on
    both sides). ``make_lr_scale`` stays None for the MLP pair."""
    jcfg, cfg = _cfgs(precision=precision)
    jparams, params = _with_content(jcfg, 3)
    _compare_step(step_setup, jcfg, cfg, jparams, params, 0, 1e-4,
                  0.9999 if precision == "fp32" else 0.999)
    assert train.make_lr_scale(cfg, params) is None


def test_grid_fine_field_with_the_proposal_mlp_matches_jax(step_setup, jax_kernels):
    """The grid fine field (``GRID_PALLAS``) with the proposal MLP
    (``PROP_PALLAS``), the pairing ``tests/test_gridfield.py:94`` uses: one
    step's loss to rel 1e-4 and each part's gradient to cosine >= 0.9999;
    ``GRID_LR_MULT`` reaches the lines only, never the proposal MLP."""
    jcfg, cfg = _cfgs(**GRID, grid_lr_mult=20.0)
    jparams, params = _with_content(jcfg, 4)
    _compare_step(step_setup, jcfg, cfg, jparams, params, 1, 1e-4, 0.9999)
    scale = train.make_lr_scale(cfg, params)
    assert scale["net"]["lines"]["x"] == 20.0 and scale["net"]["decoder"]["hidden"]["w"] == 1.0
    assert {v for layer in scale["prop"].values() for v in layer.values()} == {1.0}


# ---------------------------------------------------------------- checkpoints


def test_checkpoints_cross_both_ways_and_a_mismatched_resume_is_refused(tmp_path):
    """A JAX checkpoint of the MLP pair (with its Adam moments) loads in the
    port and renders the same chunk as JAX from it; the port's checkpoint
    loads in JAX with the same arrays; resuming either with another
    ``PROPOSAL_WIDTH`` (or ``PROPOSAL_DEPTH``, ``PROPOSAL_ENC_L``, a grid
    proposal) is refused, naming the key."""
    jcfg, cfg = _cfgs()
    jstate = jtrain.init_state(jcfg, jax.random.PRNGKey(5))
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), "jax", 7, jax.device_get(jstate.params),
                                  jax.device_get(jstate.opt))
    it, params, opt, _ = ckpt.load_train_state(jpath)
    assert it == 7 and sorted(params["prop"]) == ["color", "sigma", "trunk_0", "trunk_1",
                                                  "trunk_2"]
    assert opt.mu["prop"]["trunk_2"]["w"].shape == (64, 64)
    rng = np.random.default_rng(6)
    rows, cols = (rng.integers(0, 16, 8).astype(np.float32) for _ in range(2))
    pose = _pose_rows(rng, 8)
    ref = jax.jit(lambda p: jrender.render_rays(
        p["net"], jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(pose),
        jmake_k_inv(16, 16, 20.0), 8, 16, prop_params=p["prop"]))(jstate.params)
    got = render.render_rays(params["net"], torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(pose), make_k_inv(16, 16, 20.0), 8, 16,
                             prop_params=params["prop"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=PIXEL_ATOL)

    ppath = ckpt.save_checkpoint(str(tmp_path / "p"), "port", 7, params, opt)
    j_it, j_params, j_opt, _, _ = jckpt.load_checkpoint_full(ppath)
    assert j_it == 7 and int(j_opt.count) == int(jstate.opt.count)
    for got_leaf, ref_leaf in zip(jax.tree_util.tree_leaves_with_path(j_params),
                                  jax.tree_util.tree_leaves_with_path(jstate.params)):
        assert got_leaf[0] == ref_leaf[0]
        np.testing.assert_array_equal(np.asarray(got_leaf[1]), np.asarray(ref_leaf[1]))

    train.init_state(cfg, torch.device("cpu"), params=params)   # the config's own shapes
    for key, value in (("proposal_width", 32), ("proposal_depth", 2), ("proposal_enc_l", 6)):
        bad = Config(**dict(SMALL, **{key: value}))
        with pytest.raises(ValueError, match=key.upper()):
            train.init_state(bad, torch.device("cpu"), params=params)
    grid_prop = train._fresh_params(Config(**dict(SMALL, prop_field="grid", prop_grid_res=8)),
                                    torch.device("cpu"))
    with pytest.raises(ValueError, match="PROP_FIELD = mlp"):
        train.init_state(cfg, torch.device("cpu"), params=grid_prop)


# ---------------------------------------------------------------- the CLI


def test_python_m_trains_and_renders_with_the_proposal_mlp(sync_scene_dir, tmp_path):
    """``python -m tinynerf_torch --mode all`` on a tiny synthetic scene with
    ``PROP_FIELD = mlp`` and ``PROP_PALLAS`` (the kernels' plain versions on
    the CPU): trains, checkpoints the pair, renders the test split."""
    keys = dict(IMG_DIR=f"{sync_scene_dir}/", RESULTS_PATH=f"{tmp_path}/results/",
                CKPT_PATH=f"{tmp_path}/ckpt/", LOG_DIR=f"{tmp_path}/runs/", N_COARSE=8,
                N_FINE=16, RENDER_CHUNK=64, BATCH_RAY=32, DATA_TYPE="sync", LEARNING=2e-3,
                DECAY_END=40, TOTAL_ITER=4, STEP=4, PRECISION="bf16", PROPOSAL="True",
                PROP_FIELD="mlp", PROP_PALLAS="True", PROPOSAL_WIDTH=32, PROPOSAL_DEPTH=2)
    ini = tmp_path / "scene.ini"
    ini.write_text("\n".join(["[scene]"] + [f"{k} = {v}" for k, v in keys.items()]) + "\n")
    proc = subprocess.run([sys.executable, "-m", "tinynerf_torch", "--conf", str(ini),
                           "--mode", "all", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[ITER] 3 [LOSS]" in proc.stdout and "Test PSNR" in proc.stdout
    (path,) = glob.glob(str(tmp_path / "ckpt" / "*_3.npz"))
    with np.load(path) as archive:
        assert archive["params::prop::trunk_0::w"].shape == (60, 32)
        assert archive["mu::prop::color::w"].shape == (56, 3)
        assert "params::net::point_info::w" in archive.files
