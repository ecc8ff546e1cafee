"""The flagship's grid stack in the port (``tinynerf_torch``): the hybrid
sigma net (``GRID_HYBRID``, ``PROP_GRID_HYBRID``), the pyramid
(``GRID_LEVELS``), its fold (``GRID_LEVEL_FOLD``, ``upsample_matrix``),
``GRID_LEVEL_LR``, ``tv_loss``, a training step, the occupancy refresh,
checkpoints and the resume rules, against the JAX package's, on the CPU at
tiny widths. Inputs are made with numpy from a seed and handed to both
packages (the port's params through ``ckpt.params_from_numpy``).

Bounds are the point field's (``tests/test_torch_gridfield.py``): fp32
1e-5 absolute, bf16 2e-3 of max|ref|, gradients 2e-5 of max|ref|; a step's
gradient per part by cosine and norm, as ``tests/test_torch_proposal.py``
holds a ``lego_grid`` step."""

import dataclasses
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import ckpt as jckpt, optim as joptim, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import gridfield as jgf, occupancy as joccupancy
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf_torch import ckpt, eval as evallib, optim, train
from tinynerf_torch.config import Config, load_config
from tinynerf_torch.core import gridfield, occupancy
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.logging import MetricLogger
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_ATOL = 1e-5
BF16_RTOL = 2e-3
GRAD_RTOL = 2e-5
DENSITY_SCALE = 3.0   # a grid with content (tests/test_torch_proposal.py)

# conf/lego_hybrid.ini's structure at tiny widths: the sigma width (6) is not
# the decoder's (8), so that a swap of the two shows
TINY = dict(n_coarse=8, n_fine=16, precision="fp32", proposal=True, prop_field="grid",
            white_bkgd=True, occ_grid=True, occ_res=8, fine_field="grid", grid_res=9,
            grid_comp_density=3, grid_comp_app=4, grid_decoder_width=8, grid_sigma_width=6,
            grid_lr_mult=20.0, grid_tv=0.1, grid_hybrid=True, prop_grid_hybrid=True,
            prop_grid_res=8, prop_grid_comp_density=2, prop_grid_comp_app=2,
            prop_grid_decoder_width=8, batch_ray=32, learning=5e-4, decay_end=100)
# GRID_LEVELS = 2 on a nested lattice (9 + 5) and a non-nested one (8 + 4)
PYRAMIDS = {"nested": 9, "non-nested": 8}
# the full widths of the shipped flagship configs: (net, proposal) params,
# as the JAX package's init_state gives them
FULL_COUNTS = {"lego_hybrid": (184_069, 7_397), "lego_levels": (257_797, 7_397),
               "lego_fold": (258_565, 7_397)}
FLAGSHIP_CONFS = ("lego_hybrid", "lego_levels", "lego_fold", "texture", "synthetic360")


def _cfgs(**kw):
    base = dict(TINY)
    base.update(kw)
    return JConfig(**base), Config(**base)


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_random(jcfg, seed):
    """A tree of JAX's fresh params' structure (``init_state`` traced, not
    run) holding seeded normal numpy values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jtrain.init_state(jcfg, jax.random.PRNGKey(0)).params)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _with_content(jcfg, seed):
    """JAX's fresh ``{"net", "prop"}`` params with content: every level
    table random (not the zero init), each level-0 table's density columns
    scaled by 3. (JAX params, the port's)."""
    tree = _numpy(jax.jit(lambda k: jtrain.init_state(jcfg, k).params)(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for part, nd in (("net", jcfg.grid_comp_density), ("prop", jcfg.prop_grid_comp_density)):
        lines = tree[part]["lines"]
        for name in lines:
            if len(name) > 1:
                lines[name] = (0.3 * rng.normal(size=lines[name].shape)).astype(np.float32)
            else:
                lines[name][:, :nd] *= np.float32(DENSITY_SCALE)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _points(seed, n, extent=1.5):
    """Points in and around the grid (some clipped), unit directions."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2 * extent, 1.2 * extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_outputs(got, ref, precision):
    color, sigma = (t.detach().numpy() for t in got)
    ref_color, ref_sigma = np.stack(ref[0], -1), np.asarray(ref[1])
    assert color.shape == ref_color.shape and sigma.shape == ref_sigma.shape
    if precision == "fp32":
        np.testing.assert_allclose(color, ref_color, atol=FP32_ATOL)
        np.testing.assert_allclose(sigma, ref_sigma, atol=FP32_ATOL)
    else:
        assert _rel(color, ref_color) <= BF16_RTOL
        assert _rel(sigma, ref_sigma) <= BF16_RTOL


def _leaves_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- init


@pytest.mark.parametrize("conf", sorted(FULL_COUNTS))
def test_fresh_params_have_the_jax_structure_at_full_width(conf):
    """``_fresh_params`` on the shipped config: the tree of JAX's
    ``init_state`` (every shape; traced, not run), its parameter counts, and
    the level tables zero."""
    path = os.path.join(REPO, "conf", f"{conf}.ini")
    from tinynerf.config import load_config as jload_config
    params = train._fresh_params(load_config(path), torch.device("cpu"))
    jshapes = jax.eval_shape(lambda: jtrain.init_state(jload_config(path),
                                                       jax.random.PRNGKey(0)).params)
    assert optim.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(lambda s: s.shape, jshapes)
    counts = tuple(gridfield.num_params(params[k]) for k in ("net", "prop"))
    assert counts == FULL_COUNTS[conf] == tuple(
        sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jshapes[k]))
        for k in ("net", "prop"))
    for name, table in params["net"]["lines"].items():
        assert (len(name) == 1) != bool(torch.all(table == 0)), name


# ---------------------------------------------------------------- the point field


@pytest.fixture(scope="module")
def hybrid_params():
    """``TINY``'s params with content (``_with_content``), made once."""
    return _with_content(_cfgs()[0], 1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("part", ["net", "prop"])
def test_hybrid_field_matches_jax(hybrid_params, part, precision):
    """The hybrid fine field (sigma width 6) and the hybrid proposal field
    (sigma width = its decoder's), each as the config builds it
    (``make_field_fn`` / ``make_prop_field_fn``), on the same params and
    points: color and sigma within the point field's bounds."""
    jcfg, cfg = _cfgs(precision=precision)
    jparams, params = hybrid_params
    assert params["net"]["sigma_net"]["hidden"]["w"].shape == (3, 6)
    assert params["prop"]["sigma_net"]["hidden"]["w"].shape == (2, 8)
    jfn, fn = ((jtrain.make_field_fn(jcfg), evallib.make_field_fn(cfg)) if part == "net"
               else (jtrain.make_prop_field_fn(jcfg), evallib.make_prop_field_fn(cfg)))
    pts, dirs = _points(2, 300)
    ref = jfn(jparams[part], jnp.asarray(pts), jnp.asarray(dirs))
    _check_outputs(fn(params[part], torch.from_numpy(pts), torch.from_numpy(dirs)), ref,
                   precision)


def _pyramid(res, seed, hybrid=True):
    """A two-level grid field (hybrid by default) with random level tables:
    (JAX params, the port's)."""
    tree = _numpy(jgf.init_grid_field(jax.random.PRNGKey(seed), res=res, n_density=3,
                                      n_app=4, decoder_width=8, hybrid=hybrid,
                                      sigma_width=6, levels=2))
    rng = np.random.default_rng(seed)
    for name in tree["lines"]:
        tree["lines"][name] = (0.5 * rng.normal(size=tree["lines"][name].shape)
                               ).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_pyramid_field_matches_jax(pyramid, precision):
    """``GRID_LEVELS = 2``: level 1 at ``((R - 1) >> 1) + 1`` rows (9 -> 5,
    8 -> 4), interpolated at its own resolution and summed in: color and
    sigma within the point field's bounds; at fp32 every gradient (both
    levels' tables, the decoder, the sigma net, the points) within 2e-5 of
    max|ref|."""
    res = PYRAMIDS[pyramid]
    jparams, params = _pyramid(res, 3)
    assert params["lines"]["x1"].shape == ({9: 5, 8: 4}[res], 7)
    pts, dirs = _points(4, 300)
    dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
    ref = jgf.apply_grid_field(jparams, jnp.asarray(pts), jnp.asarray(dirs), n_density=3,
                               compute_dtype=dtype)
    leaves = optim.tree_map(lambda t: t.requires_grad_(True), params)
    x = torch.from_numpy(pts).requires_grad_(True)
    got = gridfield.apply_grid_field(leaves, x, torch.from_numpy(dirs), n_density=3,
                                     precision=precision)
    _check_outputs(got, ref, precision)
    if precision == "bf16":
        return
    w = np.random.default_rng(5).normal(size=(len(pts), 4)).astype(np.float32)

    def jloss(p, xs):
        c, s = jgf.apply_grid_field(p, xs, jnp.asarray(dirs), n_density=3)
        return jnp.sum(jnp.stack(c, -1) * w[:, :3]) + jnp.sum(s[:, 0] * w[:, 3])

    g_p, g_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(pts))
    (torch.sum(got[0] * torch.from_numpy(w[:, :3]))
     + torch.sum(got[1][:, 0] * torch.from_numpy(w[:, 3]))).backward()
    assert _rel(x.grad.numpy(), g_x) <= GRAD_RTOL
    ref_grads = _leaves_by_path(g_p)
    for path, leaf in _leaves_by_path(optim.tree_map(
            lambda t: t.grad if t.grad is not None else torch.zeros_like(t), leaves)).items():
        assert _rel(leaf, ref_grads[path]) <= GRAD_RTOL or not ref_grads[path].any(), path


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fold_matches_jax_and_the_per_level_sum(precision):
    """``GRID_LEVEL_FOLD`` on the nested lattice (9 + 5): the port's fold
    against JAX's fold within the point field's bounds; at fp32 also
    against the port's per-level sum within JAX's own agreement bound
    (``tests/test_gridfield.py``: rtol 2e-5, atol 2e-6), and its gradients
    reach every level table, as JAX's do (to 2e-5 of max|ref|)."""
    jparams, params = _pyramid(PYRAMIDS["nested"], 6)
    pts, dirs = _points(7, 256)
    dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
    ref = jgf.apply_grid_field(jparams, jnp.asarray(pts), jnp.asarray(dirs), n_density=3,
                               compute_dtype=dtype, fold=True)
    leaves = optim.tree_map(lambda t: t.requires_grad_(True), params)
    field = evallib.make_field_fn(Config(fine_field="grid", grid_comp_density=3,
                                         grid_levels=2, grid_level_fold=True,
                                         precision=precision))
    got = field(leaves, torch.from_numpy(pts), torch.from_numpy(dirs))
    _check_outputs(got, ref, precision)
    if precision == "bf16":
        return
    with torch.no_grad():
        feats = [gridfield._line_features(params["lines"], torch.from_numpy(pts),
                                          params["extent"], gridfield.rounding("fp32"), fold)
                 for fold in (True, False)]
    for f_fold, f_sum in zip(*feats):
        np.testing.assert_allclose(f_fold.numpy(), f_sum.numpy(), rtol=2e-5, atol=2e-6)
    (torch.sum(got[1]) + torch.sum(got[0])).backward()

    def jloss(p):
        c, s = jgf.apply_grid_field(p, jnp.asarray(pts), jnp.asarray(dirs), n_density=3,
                                    fold=True)
        return jnp.sum(s) + jnp.sum(jnp.stack(c, -1))

    g = jax.jit(jax.grad(jloss))(jparams)["lines"]
    for name, table in leaves["lines"].items():
        assert float(table.grad.abs().max()) > 0.0, name
        assert _rel(table.grad.numpy(), g[name]) <= GRAD_RTOL, name


@pytest.mark.parametrize("old,new", [(5, 9), (4, 8), (193, 385), (192, 384), (97, 385),
                                     (3, 7), (7, 3), (64, 1000), (2, 2)])
def test_upsample_matrix_is_jax_bit_for_bit(old, new):
    """``upsample_matrix``: JAX's float32 linspace nodes and hat weights,
    bit for bit, on nested (9 <- 5, 385 <- 193) and non-nested lattices."""
    got = gridfield.upsample_matrix(old, new)
    assert got.dtype == torch.float32 and got.shape == (new, old)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgf.upsample_matrix(old, new)))


# ---------------------------------------------------------------- training


def test_lr_scale_matches_jax_on_a_pyramid():
    """``GRID_LEVEL_LR`` = 0.5 over three levels: a table ``{x,y,z}{l}`` at
    ``GRID_LR_MULT * 0.5 ** l``, the proposal grid's tables at
    ``GRID_LR_MULT``, every sigma net and decoder leaf at 1."""
    jcfg, cfg = _cfgs(grid_levels=3, grid_level_lr=0.5)
    jparams = _jax_random(jcfg, 0)
    ref = jtrain.make_lr_scale(jcfg, jparams)
    got = train.make_lr_scale(cfg, ckpt.params_from_numpy(_numpy(jparams)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    assert jax.tree_util.tree_leaves(got) == [float(x) for x in jax.tree_util.tree_leaves(ref)]
    assert got["net"]["lines"]["z2"] == 5.0 and got["net"]["sigma_net"]["sigma"]["w"] == 1.0
    only_levels = dataclasses.replace(cfg, grid_lr_mult=1.0)
    assert train.make_lr_scale(only_levels, got)["net"]["lines"]["y1"] == 0.5


def test_tv_loss_matches_jax_on_a_pyramid():
    jparams, params = _pyramid(PYRAMIDS["non-nested"], 8)
    np.testing.assert_allclose(gridfield.tv_loss(params).item(),
                               float(jgf.tv_loss(jparams)), rtol=1e-6)


def _random_occ(seed, res):
    """An occupancy grid with empty, occupied and unprobed cells, in both
    packages."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.uniform(size=(res,) * 3) < 0.4, rng.uniform(0.02, 2.0, (res,) * 3),
                   rng.uniform(0.0, 0.009, (res,) * 3)).astype(np.float32)
    raw[rng.uniform(size=raw.shape) < 0.03] = np.inf
    jgrid = joccupancy.OccGrid(density=joccupancy._dilate(jnp.asarray(raw)),
                               raw=jnp.asarray(raw), half_extent=jnp.float32(1.5),
                               threshold=jnp.float32(0.01))
    grid = occupancy.OccGrid(density=occupancy._dilate(torch.from_numpy(raw)),
                             raw=torch.from_numpy(raw), half_extent=torch.tensor(1.5),
                             threshold=torch.tensor(0.01))
    return jgrid, grid


@pytest.fixture(scope="module")
def step_setup(request):
    scene_dir = request.getfixturevalue("sync_scene_dir")
    jtable = JRayTable(jload_scene(scene_dir, "sync", "train"))
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    idx = np.random.default_rng(10).integers(0, table.num_pix, 32).astype(np.int32)
    return (jtable, table, idx, jmake_k_inv(jtable.height, jtable.width, jtable.focal),
            make_k_inv(table.height, table.width, table.focal))


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _weights(tree):
    """A part's leaves without its biases (``b``)."""
    return {k: _weights(v) for k, v in tree.items() if k != "b"} if isinstance(tree, dict) \
        else tree


@pytest.mark.parametrize("form,precision", [("hybrid", "bf16"), ("fold", "fp32")])
def test_step_loss_and_gradients_match_jax(step_setup, hybrid_params, form, precision):
    """One ``lego_hybrid``-shaped step (both grids hybrid, the occupancy
    grid, WHITE_BKGD, GRID_TV; ``fold``: with a folded two-level pyramid)
    from the same params, batch and grid: the loss to rel 1e-5 and each
    part's gradient (each grid's lines, decoder and sigma net) to cosine >=
    0.9999 and norm within 1e-3; at bf16 the loss to rel 1e-4, cosine >=
    0.999 and norm within 1e-2 (the bounds of
    ``tests/test_torch_proposal.py``'s ``lego_grid`` step). At bf16 the norm
    is taken over the weights alone: JAX sums a bias's cotangents over the
    batch's rows in bfloat16 (the broadcast's transpose: 217 where the
    exact sum of 768 rows is 219.2), the port in float32, which moves the
    sigma net's small norm by 2-4%; the cosine covers every leaf."""
    jtable, table, idx, jk_inv, k_inv = step_setup
    jcfg, cfg = _cfgs(precision=precision,
                      **(dict(grid_levels=2, grid_level_fold=True) if form == "fold" else {}))
    jparams, params = hybrid_params if form == "hybrid" else _with_content(jcfg, 11)
    jocc, occ = _random_occ(12, TINY["occ_res"])
    loss_fn = jtrain.make_loss_fn(jcfg, jk_inv)
    (loss_ref, _), g_ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, jtable.gather(jnp.asarray(idx)), jax.random.PRNGKey(0), jocc)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx)), None, occ)
    rtol, cos_min, norm_tol = (1e-5, 0.9999, 1e-3) if precision == "fp32" else (1e-4, 0.999, 1e-2)
    normed = (lambda t: t) if precision == "fp32" else _weights
    assert abs(loss.item() / float(loss_ref) - 1) <= rtol
    for part in ("net", "prop"):
        for sub in ("lines", "decoder", "sigma_net"):
            got, want = grads[part][sub], g_ref[part][sub]
            assert _cos(_flat(got), _flat(want)) >= cos_min, (part, sub)
            ratio = np.linalg.norm(_flat(normed(got))) / np.linalg.norm(_flat(normed(want)))
            assert abs(ratio - 1) <= norm_tol, (part, sub)
    assert float(grads["net"]["extent"]) == 0.0


def test_occupancy_refresh_through_the_hybrid_field_matches_jax():
    """A full refresh of the grid through the hybrid pyramid's point field
    (``train.refresh_occ`` with JAX's jitter injected) against JAX's
    ``update_grid``: raw and density within the fp32 bound."""
    jcfg, cfg = _cfgs(grid_levels=2)
    jparams, params = _with_content(jcfg, 13)
    jocc, occ = _random_occ(14, 6)
    key = jax.random.PRNGKey(15)
    ref = jax.jit(lambda g, p: joccupancy.update_grid(g, p, jtrain.make_field_fn(jcfg), key))(
        jocc, jparams["net"])
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6 ** 3, 3))))
    state = train.TrainState(params=params, opt=optim.adam_init(params), iteration=0,
                             generator=torch.Generator(), occ=occ)
    got = train.refresh_occ(dataclasses.replace(cfg, occ_subset=1.0), state,
                            evallib.make_field_fn(cfg), draws=(None, u))
    assert np.isfinite(got.raw.numpy()).all()
    np.testing.assert_allclose(got.raw.numpy(), np.asarray(ref.raw), atol=FP32_ATOL, rtol=1e-6)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(ref.density),
                               atol=FP32_ATOL, rtol=1e-6)


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("form", ["hybrid", "pyramid"])
def test_checkpoint_round_trips_jax_port_jax(tmp_path, form):
    """A ``{"net", "prop"}`` state with Adam moments, written by JAX, loads in
    the port (``params::net::sigma_net::hidden::w``,
    ``params::net::lines::x1``, the same under ``mu::`` and ``nu::``), is
    written again by the port and loads in JAX: every key and value
    unchanged."""
    extra = {"hybrid": {}, "pyramid": dict(grid_levels=3, grid_hybrid=False)}[form]
    jcfg, cfg = _cfgs(**extra)
    jparams = _jax_random(jcfg, 16)
    jopt = joptim.AdamState(count=np.int32(1), mu=_jax_random(jcfg, 17),
                            nu=jax.tree_util.tree_map(np.abs, _jax_random(jcfg, 18)))
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), "jax", 4, jparams, jopt)
    it, params, opt, _ = ckpt.load_train_state(jpath)
    assert it == 4 and opt.count == 1
    key = "params::net::sigma_net::hidden::w" if form == "hybrid" else "params::net::lines::z2"
    for got, ref in ((params, jparams), (opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        got_leaves, ref_leaves = _leaves_by_path(got), _leaves_by_path(ref)
        assert list(got_leaves) == list(ref_leaves)
        for path, leaf in got_leaves.items():
            np.testing.assert_array_equal(leaf, ref_leaves[path], err_msg=path)
    ppath = ckpt.save_checkpoint(str(tmp_path / "p"), "port", 4, params, opt)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert key in b.files and f"mu::{key[len('params::'):]}" in b.files
        assert set(a.files) - {"prng_key"} == set(b.files) - {ckpt.GENERATOR_KEY}
        for k in set(a.files) & set(b.files):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    j_it, j_params, j_opt, _, _ = jckpt.load_checkpoint_full(ppath)
    assert j_it == 4 and int(j_opt.count) == 1
    assert _leaves_by_path(j_params).keys() == _leaves_by_path(jparams).keys()
    for path, leaf in _leaves_by_path(j_opt.nu).items():
        np.testing.assert_array_equal(leaf, _leaves_by_path(jopt.nu)[path], err_msg=path)


def test_checkpoint_shapes_are_checked():
    """A sigma net or a level table of the wrong shape, or a level missing
    an axis, is refused as the other grid shapes are."""
    tree = _numpy(jgf.init_grid_field(jax.random.PRNGKey(0), res=9, n_density=3, n_app=4,
                                      decoder_width=8, hybrid=True, sigma_width=6, levels=2))
    ckpt.params_from_numpy(tree)
    bad_sigma = _numpy(tree)
    bad_sigma["sigma_net"]["hidden"]["w"] = np.zeros((4, 6), np.float32)
    bad_level = _numpy(tree)
    bad_level["lines"]["y1"] = np.zeros((4, 7), np.float32)
    no_sigma_net = _numpy(tree)
    del no_sigma_net["sigma_net"]
    for bad in (bad_sigma, bad_level, no_sigma_net):
        with pytest.raises(ValueError, match="grid field shapes do not agree"):
            ckpt.params_from_numpy(bad)
    del bad_level["lines"]["y1"]
    with pytest.raises(ValueError, match="grid line tables"):
        ckpt.params_from_numpy(bad_level)


# ---------------------------------------------------------------- resume rules


def test_resume_with_another_level_count_warns_and_keeps_the_checkpoint(capsys):
    """Resumed params whose level count is not ``GRID_LEVELS``: the JAX
    package's warning, in both packages, and the checkpoint's levels
    stay."""
    jcfg, cfg = _cfgs(grid_levels=2)
    jparams = _jax_random(jcfg, 0)
    one = dataclasses.replace(cfg, grid_levels=1)
    state = train.init_state(one, torch.device("cpu"),
                             params=ckpt.params_from_numpy(_numpy(jparams)))
    ours = capsys.readouterr().out
    jtrain.init_state(dataclasses.replace(jcfg, grid_levels=1), params=jparams)
    theirs = capsys.readouterr().out
    assert ours == theirs and "WARNING: checkpoint has 2 grid level(s) but GRID_LEVELS=1" in ours
    assert "x1" in state.params["net"]["lines"]
    train.init_state(cfg, torch.device("cpu"), params=state.params)
    assert capsys.readouterr().out == ""


def test_grid_upsample_with_levels_raises_jax_value_error():
    """``GRID_UPSAMPLE`` with ``GRID_LEVELS > 1``: the JAX package's
    ``ValueError`` on a fresh and a resumed state; ``GRID_UPSAMPLE`` on a
    single level, once refused as not ported, builds its state."""
    jcfg, cfg = _cfgs(grid_levels=2, grid_upsample="100:16")
    params = train._fresh_params(dataclasses.replace(cfg, grid_upsample=""),
                                 torch.device("cpu"))
    for kw in ({}, {"params": params}):
        with pytest.raises(ValueError, match="GRID_UPSAMPLE is incompatible with GRID_LEVELS>1"):
            train.init_state(cfg, torch.device("cpu"), **kw)
    with pytest.raises(ValueError, match="GRID_UPSAMPLE is incompatible with GRID_LEVELS>1"):
        jtrain.init_state(jcfg)
    state = train.init_state(dataclasses.replace(cfg, grid_levels=1), torch.device("cpu"))
    net = state.params["net"] if cfg.proposal else state.params
    assert gridfield.num_levels(net["lines"]) == 1


# ---------------------------------------------------------------- the shipped configs


@pytest.mark.parametrize("conf", FLAGSHIP_CONFS)
def test_shipped_flagship_configs_are_accepted_and_train(conf, sync_scene_dir, tmp_path):
    """``conf/<conf>.ini`` unchanged passes ``check_supported``; at tiny
    widths (its keys kept, the sizes cut) a Runner trains two steps on the
    CPU, the first refreshing the occupancy grid where the config has one,
    and saves a checkpoint that resumes with the same tree."""
    cfg = load_config(os.path.join(REPO, "conf", f"{conf}.ini"))
    evallib.check_supported(cfg)
    tiny = {k: v for k, v in TINY.items() if k not in (
        "precision", "proposal", "prop_field", "white_bkgd", "occ_grid", "fine_field",
        "grid_hybrid", "prop_grid_hybrid", "grid_tv", "grid_lr_mult", "learning")}
    tiny["grid_res"] = 9 if cfg.grid_res % 2 else 8
    cfg = dataclasses.replace(cfg, **tiny, img_dir=f"{sync_scene_dir}/",
                              ckpt_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"),
                              results_path=str(tmp_path / "results"), total_iter=2, step=2,
                              render_chunk=64)
    runner = Runner(cfg, device="cpu")
    runner.logger = MetricLogger(cfg.log_dir, use_tensorboard=False)   # JSONL alone
    runner.train()
    assert runner.state.iteration == 2
    assert ("sigma_net" in runner.params["net"]) and ("sigma_net" in runner.params["prop"])
    assert gridfield.num_levels(runner.params["net"]["lines"]) == cfg.grid_levels
    (path,) = glob.glob(str(tmp_path / "ckpt" / "*_1.npz"))
    _, back = ckpt.load_checkpoint_full(path)
    assert optim.tree_map(lambda t: t.shape, back) == \
        optim.tree_map(lambda t: t.shape, runner.params)
