"""The port's CP grid field (``tinynerf_torch.core.gridfield``: init, the
point field, ``tv_loss``), ``train.make_lr_scale``, grid checkpoints, both
grid lookups and the flagship's keys accepted, against the JAX package's, on
the CPU at small sizes. Inputs are made with numpy from a seed and handed to
both."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import ckpt as jckpt, optim as joptim, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import gridfield as jgf, occupancy as joccupancy
from tinynerf_torch import ckpt, config, eval as evallib, optim, train
from tinynerf_torch.config import Config
from tinynerf_torch.core import gridfield
from tinynerf_torch.logging import MetricLogger
from tinynerf_torch.parallel import mesh as meshlib
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

# the JAX kernel test's own bounds (tests/test_grid_kernel.py): 1e-5 at the
# small geometry, sigma 1e-4 at R = 256; bf16 as in slice 3: 2e-3 of max|ref|
FP32_ATOL = {"small": 1e-5, "lego": 1e-4}
BF16_RTOL = 2e-3
GRAD_RTOL = 2e-5   # fp32 gradients, error / max|ref| (tests/test_grid_kernel.py)

GEOMETRY = {  # res, n_density, n_app, width
    "small": (32, 8, 16, 32),
    "lego": (256, 64, 64, 128),      # conf/lego_grid.ini's fine grid
    "prop": (64, 16, 16, 16),        # the proposal grid at the config defaults
    "odd": (33, 4, 8, 16),           # R odd: coordinate 0 is a grid node
}


def _jax_grid(seed, geometry, extent=1.5):
    res, nd, na, width = GEOMETRY[geometry]
    return jgf.init_grid_field(jax.random.PRNGKey(seed), res=res, n_density=nd, n_app=na,
                               decoder_width=width, extent=extent)


def _port(jparams):
    return ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _points(rng, n, extent=1.5):
    """Points in and around the grid (some clipped), unit directions."""
    pts = rng.uniform(-1.2 * extent, 1.2 * extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------- init


@pytest.mark.parametrize("geometry,count", [("lego", 110_084), ("prop", 6_852)])
def test_param_counts_at_the_lego_widths(geometry, count):
    res, nd, na, width = GEOMETRY[geometry]
    params = gridfield.init_grid_field(torch.Generator().manual_seed(0), res=res,
                                       n_density=nd, n_app=na, decoder_width=width)
    assert gridfield.num_params(params) == count == jgf.num_params(_jax_grid(0, geometry))
    jshapes = jax.tree_util.tree_map(np.shape, _jax_grid(0, geometry))
    assert optim.tree_map(lambda t: tuple(t.shape), params) == jshapes
    assert params["extent"].shape == () and float(params["extent"]) == 1.5
    assert abs(float(params["lines"]["x"].std()) - 0.2) < 0.01


def test_fresh_state_is_seeded_with_a_second_stream_for_the_proposal():
    cfg = Config(fine_field="grid", proposal=True, grid_res=16, grid_comp_density=4,
                 grid_comp_app=8, grid_decoder_width=16)
    a, b = (train.init_state(cfg, torch.device("cpu")).params for _ in range(2))
    assert torch.equal(a["net"]["lines"]["x"], b["net"]["lines"]["x"])
    assert torch.equal(a["prop"]["lines"]["y"], b["prop"]["lines"]["y"])
    assert a["prop"]["lines"]["x"].shape == (64, 32)
    assert not torch.equal(a["net"]["lines"]["x"][:16, :12], a["prop"]["lines"]["x"][:16, :12])


# ---------------------------------------------------------------- the point field


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", ["small", "lego"])
def test_point_field_matches_jax(geometry, precision):
    """fp32: color 1e-5, sigma 1e-5 (1e-4 at R = 256). bf16: the JAX
    package's jnp bf16 function (every product, sum and the sigmoid's steps
    rounded), 2e-3 of max|ref| per output (measured: equal)."""
    jparams = _jax_grid(1, geometry)
    nd = GEOMETRY[geometry][1]
    pts, dirs = _points(np.random.default_rng(2), 300)
    dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
    jc, js = jgf.apply_grid_field(jparams, jnp.asarray(pts), jnp.asarray(dirs),
                                  n_density=nd, compute_dtype=dtype)
    color, sigma = gridfield.apply_grid_field(_port(jparams), torch.from_numpy(pts),
                                              torch.from_numpy(dirs), n_density=nd,
                                              precision=precision)
    assert color.shape == (300, 3) and sigma.shape == (300, 1)
    assert color.dtype == sigma.dtype == torch.float32
    for c in range(3):
        if precision == "fp32":
            np.testing.assert_allclose(color[:, c].numpy(), np.asarray(jc[c]), atol=1e-5)
        else:
            assert _rel(color[:, c].numpy(), jc[c]) <= BF16_RTOL
    if precision == "fp32":
        np.testing.assert_allclose(sigma.numpy(), np.asarray(js), atol=FP32_ATOL[geometry])
    else:
        assert _rel(sigma.numpy(), js) <= BF16_RTOL


def _special_points(geometry, extent=1.5):
    """Coordinates on grid nodes, on the clip boundary (+-extent) and outside
    it, with a dyadic interior point, combined per axis."""
    res = GEOMETRY[geometry][0]
    # R odd: coordinate 0 is node (R - 1) / 2; at R = 256, E = 1.5, +-0.5
    # land on nodes 85 and 170 in float32
    node = [0.0] if res % 2 else [0.5, -0.5]
    coords = node + [extent, -extent, 1.75, -2.0, 0.3125]
    grid = np.array(np.meshgrid(coords, coords, coords, indexing="ij"), np.float32)
    return grid.reshape(3, -1).T.copy()


def _xg(coord, res, extent=1.5):
    raw = (np.float32(coord) + np.float32(extent)) / np.float32(2 * extent)
    return np.float32(np.clip(raw, 0, 1)) * np.float32(res - 1)


@pytest.mark.parametrize("geometry", ["odd", "lego"])
def test_point_field_gradient_at_nodes_and_the_clip_boundary(geometry):
    """``jax.grad`` of the point field at exact grid-node hits (abs'(0) = +1,
    relu'(0) = 0: d xg = -dF . T[k]), on the clip boundary (0.5) and outside
    it (0): every gradient (lines, decoder, points) within 2e-5 of
    max|ref|."""
    res, nd = GEOMETRY[geometry][:2]
    pts = _special_points(geometry)
    if res % 2:
        assert _xg(0.0, res) == (res - 1) // 2
    else:
        assert (_xg(-0.5, res), _xg(0.5, res)) == (85.0, 170.0)
    dirs = np.tile(np.float32([[0.0, 0.6, 0.8]]), (len(pts), 1))
    jparams = _jax_grid(3, geometry)
    w = np.random.default_rng(4).normal(size=(len(pts), 4)).astype(np.float32)

    def jloss(p, x):
        c, s = jgf.apply_grid_field(p, x, jnp.asarray(dirs), n_density=nd)
        return jnp.sum(jnp.stack(c, -1) * w[:, :3]) + jnp.sum(s[:, 0] * w[:, 3])

    g_p, g_x = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(pts))
    params = optim.tree_map(lambda t: t.requires_grad_(True), _port(jparams))
    x = torch.from_numpy(pts).requires_grad_(True)
    c, s = gridfield.apply_grid_field(params, x, torch.from_numpy(dirs), n_density=nd)
    (torch.sum(c * torch.from_numpy(w[:, :3])) + torch.sum(s[:, 0] * torch.from_numpy(w[:, 3]))
     ).backward()
    assert _rel(x.grad.numpy(), g_x) <= GRAD_RTOL
    on_boundary = np.abs(pts) == 1.5
    assert np.all(x.grad.numpy()[np.abs(pts) > 1.5] == 0)
    assert np.any(x.grad.numpy()[on_boundary] != 0)
    for ax in gridfield.AXES:
        assert _rel(params["lines"][ax].grad.numpy(), g_p["lines"][ax]) <= GRAD_RTOL
    for name in ("hidden", "color"):
        for k in ("w", "b"):
            assert _rel(params["decoder"][name][k].grad.numpy(),
                        g_p["decoder"][name][k]) <= GRAD_RTOL
    assert params["extent"].grad is None and float(g_p["extent"]) == 0.0


def test_tv_loss_matches_jax():
    jparams = _jax_grid(5, "small")
    got = gridfield.tv_loss(_port(jparams)).item()
    np.testing.assert_allclose(got, float(jgf.tv_loss(jparams)), rtol=1e-6)


def _grid_cfgs(**kw):
    base = dict(fine_field="grid", proposal=True, prop_field="grid", grid_lr_mult=20.0)
    base.update(kw)
    return JConfig(**base), Config(**base)


@pytest.mark.parametrize("fine_field", ["grid", "mlp"])
def test_lr_scale_matches_jax(fine_field):
    """GRID_LR_MULT on every leaf under ``lines``, in the net and in the
    proposal grid alike; 1 on the decoders, the extents and an MLP."""
    jcfg, cfg = _grid_cfgs(fine_field=fine_field, grid_res=8, grid_comp_density=2,
                           grid_comp_app=2, grid_decoder_width=8, prop_grid_res=8)
    jparams = jtrain.init_state(jcfg, jax.random.PRNGKey(0)).params
    ref = jtrain.make_lr_scale(jcfg, jparams)
    got = train.make_lr_scale(cfg, _port(jparams))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    assert jax.tree_util.tree_leaves(got) == [float(x) for x in jax.tree_util.tree_leaves(ref)]
    assert train.make_lr_scale(dataclasses.replace(cfg, grid_lr_mult=1.0), got) is None
    assert train.make_lr_scale(Config(), {}) is None


# ---------------------------------------------------------------- checkpoints


def _pair_state():
    jcfg = JConfig(fine_field="grid", proposal=True, grid_res=8, grid_comp_density=2,
                   grid_comp_app=3, grid_decoder_width=8, prop_grid_res=4,
                   prop_grid_comp_density=2, prop_grid_comp_app=2,
                   prop_grid_decoder_width=8, occ_grid=True, occ_res=4)
    state = jtrain.init_state(jcfg, jax.random.PRNGKey(7))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.25), state.params)
    params, opt = joptim.adam_update(grads, state.opt, state.params, jnp.float32(1e-3))
    occ = joccupancy.init_grid(4, 1.5, 0.01)
    occ = occ._replace(raw=jnp.arange(64, dtype=jnp.float32).reshape(4, 4, 4))
    return params, opt, occ


def test_grid_pair_checkpoint_round_trips_between_the_packages(tmp_path):
    """A ``{"net", "prop"}`` grid state with Adam moments and the occupancy
    grid, written by either package, loads in the other: the same keys,
    the same values, a 0-d ``params::net::extent``."""
    jparams, jopt, jocc = _pair_state()
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), "jax", 3, jax.device_get(jparams),
                                  jax.device_get(jopt), occ=jocc)
    it, params, opt, _ = ckpt.load_train_state(jpath)
    occ = ckpt.load_occ_grid(jpath)
    assert it == 3 and opt.count == 1
    for got, ref in ((params, jparams), (opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
        for (_, a), (_, b) in zip(flat_got, flat_ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(occ.raw.numpy(), np.asarray(jocc.raw))

    ppath = ckpt.save_checkpoint(str(tmp_path / "p"), "port", 3, params, opt, occ=occ)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert set(a.files) - {"prng_key"} == set(b.files) - {ckpt.GENERATOR_KEY}
        assert b["params::net::extent"].shape == () == a["params::net::extent"].shape
        for k in a.files:
            if k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    j_it, j_params, j_opt, _, j_occ = jckpt.load_checkpoint_full(ppath)
    assert j_it == 3 and int(j_opt.count) == 1
    np.testing.assert_array_equal(np.asarray(j_params["prop"]["lines"]["z"]),
                                  params["prop"]["lines"]["z"].numpy())
    np.testing.assert_array_equal(np.asarray(j_occ.raw), occ.raw.numpy())


# ---------------------------------------------------------------- refusals


def test_unported_grid_forms_are_refused_by_name(sync_scene_dir, tmp_path):
    """No grid form is refused any more: ``GRID_LOOKUP = gather``, once
    refused by name, builds (plain and folded; ``tests/test_torch_grid_lookup.py``
    holds it against the JAX package), and a Runner trains two steps with it
    on the fine grid's fold. The hybrid sigma net, the pyramid and its fold
    are ported too (``tests/test_torch_grid_hybrid.py``)."""
    for fold in (False, True):
        field = gridfield.make_field_grid(n_density=2, lookup="gather", fold=fold)
        params = gridfield.init_grid_field(torch.Generator().manual_seed(0), res=9, n_density=2,
                                           n_app=3, decoder_width=8, levels=2)
        color, sigma = field(params, torch.zeros(5, 3), torch.ones(5, 3) / 3 ** 0.5)
        assert color.shape == (5, 3) and sigma.shape == (5, 1)
    _train_two_steps(dict(fine_field="grid", grid_lookup="gather", grid_levels=2,
                          grid_level_fold=True), sync_scene_dir, tmp_path)


def _train_two_steps(kw, scene_dir, tmp_path):
    """A Runner on ``kw`` at small widths trains two steps on the CPU."""
    cfg = Config(img_dir=f"{scene_dir}/", data_type="sync", n_coarse=8, n_fine=16,
                 batch_ray=32, total_iter=2, step=1000, grid_res=9, grid_comp_density=2,
                 grid_comp_app=3, grid_decoder_width=8, ckpt_path=str(tmp_path / "ckpt"),
                 log_dir=str(tmp_path / "runs"), **kw)
    evallib.check_supported(cfg)
    runner = Runner(cfg, device="cpu")
    runner.logger = MetricLogger(cfg.log_dir, use_tensorboard=False)   # JSONL alone
    runner.train()
    assert runner.state.iteration == 2
    return runner


@pytest.mark.parametrize("kw,what", [
    (dict(fine_field="grid", grid_upsample="1:12"), None),
    (dict(fine_field="grid", grid_lookup="gather"), "GRID_LOOKUP=gather"),
    (dict(mesh_shape=4), "MESH_SHAPE=4"),
    (dict(mesh_shape=3, sample_shard=2), "SAMPLE_SHARD=2")])
def test_check_supported_refuses_unported_keys(kw, what, sync_scene_dir, tmp_path):
    """``GRID_UPSAMPLE`` and ``GRID_LOOKUP = gather``, once refused here, are
    accepted, and a Runner trains two steps with each (the grid at small
    widths; the milestone at 1 resizes it to R = 12; the gather on both
    grids, the proposal's too). A mesh over several ranks is ported
    (``parallel/``): what is refused by name now is a ``MESH_SHAPE`` other
    than the job's world size (1 here) and a ``SAMPLE_SHARD`` that does not
    divide it (a job of 3)."""
    if what == "GRID_LOOKUP=gather":
        runner = _train_two_steps(dict(kw, proposal=True, prop_field="grid", prop_grid_res=8,
                                       prop_grid_comp_density=2, prop_grid_comp_app=2,
                                       prop_grid_decoder_width=8), sync_scene_dir, tmp_path)
        assert runner.cfg.grid_lookup == "gather"
        return
    if what is not None:
        # the world size of this process (1), or of a job of 3
        check = (functools.partial(meshlib.check_mesh, world=kw["mesh_shape"])
                 if "sample_shard" in kw else evallib.check_supported)
        with pytest.raises(ValueError, match=what):
            check(Config(**kw))
        return
    runner = _train_two_steps(kw, sync_scene_dir, tmp_path)
    assert runner.params["lines"]["x"].shape[0] == 12


@pytest.mark.parametrize("kw", [
    dict(fine_field="grid", grid_hybrid=True),
    dict(proposal=True, prop_grid_hybrid=True),
    dict(fine_field="grid", grid_levels=2),
    dict(fine_field="grid", grid_level_fold=True)],
    ids=["GRID_HYBRID", "PROP_GRID_HYBRID", "GRID_LEVELS=2", "GRID_LEVEL_FOLD"])
def test_check_supported_accepts_the_flagship_keys(kw, sync_scene_dir, tmp_path):
    """The keys once refused here as the flagship's are ported: accepted,
    and a Runner takes one step on the tiny scene with each (the grids at
    small widths)."""
    cfg = Config(img_dir=f"{sync_scene_dir}/", data_type="sync", n_coarse=8, n_fine=16,
                 batch_ray=32, total_iter=1, step=1000, grid_res=9, grid_comp_density=2,
                 grid_comp_app=3, grid_decoder_width=8, prop_grid_res=8,
                 prop_grid_comp_density=2, prop_grid_comp_app=2, prop_grid_decoder_width=8,
                 ckpt_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"), **kw)
    evallib.check_supported(cfg)
    runner = Runner(cfg, device="cpu")
    runner.logger = MetricLogger(cfg.log_dir, use_tensorboard=False)   # JSONL alone
    runner.train()
    assert runner.state.iteration == 1
    net = runner.params["net"] if cfg.proposal else runner.params
    assert ("sigma_net" in net) == cfg.grid_hybrid
    if cfg.proposal:
        assert "sigma_net" in runner.params["prop"]
    else:
        assert gridfield.num_levels(net["lines"]) == cfg.grid_levels


@pytest.mark.parametrize("mesh,shard", [("auto", "0"), ("", "1"), ("1", "0")])
def test_check_supported_takes_one_device(mesh, shard):
    """``MESH_SHAPE`` unset, ``auto`` or 1 and ``SAMPLE_SHARD`` 0 or 1 ask for
    no mesh over several devices (``tinynerf/parallel/mesh.py::mesh_for_config``
    builds none on one device): the port runs them on its one device."""
    cfg = Config()
    config.apply_key(cfg, "MESH_SHAPE", mesh)
    config.apply_key(cfg, "SAMPLE_SHARD", shard)
    evallib.check_supported(cfg)


@pytest.mark.parametrize("kw", [dict(dist_loss=0.01), dict(prop_interlevel=1.0)],
                         ids=["DIST_LOSS", "PROP_INTERLEVEL"])
def test_check_supported_accepts_the_aux_losses(kw):
    """``DIST_LOSS`` and ``PROP_INTERLEVEL`` are ported (their agreement with
    JAX: tests/test_torch_unbounded.py): accepted with ``PROPOSAL``; without
    it the loss raises the JAX package's ``ValueError``, as
    ``tinynerf/train.py:331-334`` does."""
    evallib.check_supported(Config(proposal=True, **kw))
    train.make_loss_fn(Config(proposal=True, fine_field="grid", grid_res=8, **kw),
                       torch.eye(3))
    with pytest.raises(ValueError, match="require PROPOSAL=True"):
        train.make_loss_fn(Config(**kw), torch.eye(3))


@pytest.mark.parametrize("prop_pallas", [False, True])
def test_check_supported_accepts_the_proposal_mlp(prop_pallas):
    """``PROP_FIELD = mlp`` is ported: accepted, and its field runs. With
    ``PROP_PALLAS`` the field's ``eval_rays`` is ``prop_rays`` (here its
    plain versions); without it the plain field. A ``PROP_FIELD`` that is
    neither grid nor mlp raises."""
    cfg = Config(proposal=True, prop_field="mlp", prop_pallas=prop_pallas,
                 proposal_width=32, proposal_depth=2)
    evallib.check_supported(cfg)
    fn = evallib.make_prop_field_fn(cfg)
    assert hasattr(fn, "eval_rays") == prop_pallas
    params = train._fresh_params(cfg, torch.device("cpu"))["prop"]
    pts = torch.zeros((5, 3))
    color, sigma = fn(params, pts, pts + torch.tensor([0.0, 0.0, 1.0]))
    assert color.shape == (5, 3) and sigma.shape == (5, 1)
    assert torch.all(torch.isfinite(color)) and torch.all(sigma >= 0)
    with pytest.raises(ValueError, match="PROP_FIELD must be grid or mlp"):
        evallib.check_supported(Config(proposal=True, prop_field="net"))


@pytest.mark.parametrize("kw,what", [
    (dict(fine_field="grid", grid_hybrid=True), "GRID_HYBRID sigma net"),
    (dict(fine_field="grid", grid_levels=2), "GRID_LEVELS pyramid"),
    (dict(proposal=True, prop_grid_hybrid=True), "PROP_GRID_HYBRID sigma net")])
def test_grid_pallas_refuses_what_its_kernels_do_not_compute(kw, what):
    """The JAX package's ValueErrors (``train.py:147-155, 231-235``), before
    the not-ported refusals: they hold once those forms are ported too."""
    with pytest.raises(ValueError, match=what):
        evallib.check_supported(Config(grid_pallas=True, **kw))
    with pytest.raises(ValueError, match=what):
        jcfg = JConfig(grid_pallas=True, **kw)
        jtrain.make_field_fn(jcfg, force_pallas=True)
        jtrain.make_prop_field_fn(jcfg, force_pallas=True)
