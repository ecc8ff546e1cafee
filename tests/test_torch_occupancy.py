"""The port's occupancy grid (``tinynerf_torch.core.occupancy``, its hooks in
the renderer, the train state, checkpoints and the Runner) against the JAX
package's ``tinynerf.core.occupancy``, on the CPU at small sizes. Inputs and
draws are made with numpy or JAX from a seed and handed to both."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import ckpt as jckpt
from tinynerf.config import Config as JConfig
from tinynerf.core import mlp as jmlp, occupancy as joccupancy, render as jrender
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.runner import Runner as JRunner
from tinynerf_torch import ckpt, eval as evallib, train
from tinynerf_torch.__main__ import main as cli_main
from tinynerf_torch.config import Config, load_config
from tinynerf_torch.core import mlp, occupancy, render
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _jgrid(raw, half_extent=1.5, threshold=0.01):
    raw = jnp.asarray(raw)
    return joccupancy.OccGrid(density=joccupancy._dilate(raw), raw=raw,
                              half_extent=jnp.float32(half_extent),
                              threshold=jnp.float32(threshold))


def _grid(raw, half_extent=1.5, threshold=0.01):
    raw = _t(raw)
    return occupancy.OccGrid(density=occupancy._dilate(raw), raw=raw,
                             half_extent=torch.tensor(half_extent),
                             threshold=torch.tensor(threshold))


def _random_raw(seed, res):
    """Sigma per cell: mostly empty, some occupied, some never probed."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.uniform(size=(res,) * 3) < 0.15,
                   rng.uniform(0.02, 2.0, (res,) * 3),
                   rng.uniform(0.0, 0.009, (res,) * 3)).astype(np.float32)
    raw[rng.uniform(size=raw.shape) < 0.03] = np.inf
    return raw


def _field_with_content(seed):
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(seed)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


# ---------------------------------------------------------------- the grid

def test_init_grid_and_cell_centers_match_jax():
    jg = joccupancy.init_grid(8, 1.5, 0.01)
    g = occupancy.init_grid(8, 1.5, 0.01)
    for name in ("density", "raw", "half_extent", "threshold"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    for res, h in ((8, 1.5), (5, 0.75)):
        np.testing.assert_array_equal(
            occupancy.cell_centers(res, torch.tensor(h)).numpy(),
            np.asarray(joccupancy.cell_centers(res, jnp.float32(h))))


def test_dilate_matches_jax():
    raw = _random_raw(0, 8)
    raw[0, 0, 0] = np.inf  # an unprobed corner spreads
    np.testing.assert_array_equal(occupancy._dilate(_t(raw)).numpy(),
                                  np.asarray(joccupancy._dilate(jnp.asarray(raw))))


@pytest.mark.parametrize("res,h,span", [(64, 1.5, 4.0), (64, 0.25, 10.0), (128, 1.5, 4.0),
                                        (8, 0.1, 4.0), (16, 3.0, 7.3)])
def test_derive_march_steps_matches_jax(res, h, span):
    assert occupancy.derive_march_steps(res, h, span) == \
        joccupancy.derive_march_steps(res, h, span)
    if (res, h, span) == (64, 1.5, 4.0):  # lego_occ: near/far 2/6
        assert occupancy.derive_march_steps(res, h, span) == 64


def test_contracted_forms_match_jax():
    """The contracted grid's probe count, and its disparity-spaced march:
    ``derive_march_steps_contracted`` equal to JAX's, and one
    ``tighten_bounds`` with ``contract``, ``lindisp`` and ``march_res``
    exact (the rest: ``test_tighten_bounds_contracted_matches_jax``)."""
    for res, near, far in ((64, 0.5, 100.0), (128, 0.05, 1e4), (16, 1.0, 2.0), (64, 0.0, 5.0)):
        assert occupancy.derive_march_steps_contracted(res, near, far) == \
            joccupancy.derive_march_steps_contracted(res, near, far)
    assert occupancy.derive_march_steps_contracted(64, 0.5, 100.0) == 64
    _compare_contracted_march(contract=True, lindisp=True, march_res=4)


def _contracted_rays(seed, B):
    """Rays of an outward-facing capture: origins near the centre, every
    direction, near/far 0.5/100."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.2, size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full(B, 0.5, np.float32), np.full(B, 100.0, np.float32)


def _edge_rays(o, d, near, far, n_steps, lindisp, contract, lres, half_extent):
    """Rays with a probe within 1e-6 of a lookup cell's boundary, where two
    float32 evaluations of floor() may differ."""
    from tinynerf_torch.core.contract import contract_mip360
    near, far = _t(near), _t(far)
    frac = (torch.arange(n_steps, dtype=torch.float32) + 0.5) / n_steps
    if lindisp:
        ts = 1.0 / (1.0 / near[:, None] + (1.0 / far - 1.0 / near)[:, None] * frac[None, :])
    else:
        ts = near[:, None] + (far - near)[:, None] * frac[None, :]
    pts = _t(o)[:, None] + ts[..., None] * _t(d)[:, None]
    if contract:
        pts = contract_mip360(pts)
    pos = (pts / half_extent * 0.5 + 0.5) * lres
    return torch.any(torch.abs(pos - torch.round(pos)) < 1e-6 * lres, dim=(1, 2)).numpy()


def _compare_contracted_march(contract, lindisp, march_res):
    res, n_steps, B = 8, 48, 256
    h = 2.0 if contract else 1.5
    raw = _random_raw(11, res)
    raw[raw > 0.01] *= (np.random.default_rng(12).uniform(size=raw[raw > 0.01].shape) < 0.2)
    o, d, near, far = _contracted_rays(13, B)
    if not contract:
        near, far = near * 4, far / 20
    kw = dict(n_steps=n_steps, contract=contract, lindisp=lindisp, march_res=march_res)
    ref = joccupancy.tighten_bounds(_jgrid(raw, h), *map(jnp.asarray, (o, d, near, far)), **kw)
    got = occupancy.tighten_bounds(_grid(raw, h), *map(_t, (o, d, near, far)), **kw)
    edge = _edge_rays(o, d, near, far, n_steps, lindisp, contract, march_res or res, h)
    assert edge.sum() <= 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy()[~edge], np.asarray(r)[~edge])
    tightened = (got[0].numpy() > near) | (got[1].numpy() < far)
    assert int(tightened.sum()) > 0  # the grid tightened rays


@pytest.mark.parametrize("contract,lindisp,march_res", [
    (True, True, None), (True, False, None), (False, True, None), (False, True, 4),
    (True, True, 2)])
def test_tighten_bounds_contracted_matches_jax(contract, lindisp, march_res):
    """``tighten_bounds`` with the contracted lookup, the disparity march
    (local-spacing margins, floored at the cell diagonal without contract)
    and the pooled lookup, against JAX's: exact, except rays with a probe
    within 1e-6 of a cell boundary."""
    _compare_contracted_march(contract, lindisp, march_res)


def test_update_grid_contracted_matches_jax():
    """The contracted refresh: each probe at ``inv_contract`` of its jittered
    cell point, through the contracting wrapper, so the field sees the cell
    itself. A partial refresh with JAX's draws injected, against JAX's
    ``update_grid(contract=True)`` with its own wrapper; cells drawn twice
    left out, as in ``test_update_grid_subset_matches_jax``."""
    from tinynerf.core.contract import wrap_field_contract as jwrap
    from tinynerf_torch.core.contract import wrap_field_contract
    res, subset = 8, 200
    jparams, params = _field_with_content(14)
    raw = _random_raw(15, res)
    key = jax.random.PRNGKey(16)
    ref = joccupancy.update_grid(_jgrid(raw, 2.0), jparams, jwrap(jrender.field_jnp), key,
                                 subset=subset, contract=True)
    kidx, kjit = jax.random.split(key)
    idx = np.asarray(jax.random.randint(kidx, (subset,), 0, res ** 3))
    u = np.asarray(jax.random.uniform(kjit, (subset, 3)))
    got = occupancy.update_grid(_grid(raw, 2.0), params, wrap_field_contract(render.field_plain),
                                subset=subset, contract=True, draws=(_t(idx), _t(u)))
    once = np.bincount(idx, minlength=res ** 3) == 1
    g_raw, r_raw = got.raw.numpy().reshape(-1), np.asarray(ref.raw).reshape(-1)
    np.testing.assert_allclose(g_raw[once], r_raw[once], atol=SIGMA_ATOL, rtol=1e-5)
    # the probes went through the inverse: the field saw points at the cells
    seen = []
    occupancy.update_grid(_grid(raw, 2.0), None,
                          wrap_field_contract(lambda p, x, d: seen.append(x) or
                                              (torch.zeros_like(x), x[:, :1])),
                          subset=subset, contract=True, draws=(_t(idx), _t(u)))
    cells = torch.floor((seen[0] / 2.0 * 0.5 + 0.5) * res).long()
    flat = (cells[:, 0] * res + cells[:, 1]) * res + cells[:, 2]
    idx3 = np.stack([idx // (res * res), (idx // res) % res, idx % res], axis=-1)
    c = ((idx3 + 0.5) / res * 2.0 - 1.0) * 2.0 + (u - 0.5) * (4.0 / res)
    reachable = np.linalg.norm(c, axis=-1) < 1.98  # past 1.99 the inverse clamps
    assert (flat.numpy() == idx)[reachable].mean() > 0.99


def test_runner_refuses_the_contracted_grid_without_lindisp(sync_scene_dir, tmp_path):
    """``OCC_GRID`` with ``CONTRACT`` needs ``LINDISP``: the JAX package's
    ``ValueError`` (``tinynerf/runner.py:83-99``); with it the grid's extent
    is forced to 2 with a note."""
    def cfg(**kw):
        return Config(img_dir=sync_scene_dir, data_type="sync", occ_grid=True, white_bkgd=True,
                      contract=True, occ_res=8, n_coarse=8, n_fine=16, batch_ray=32,
                      ckpt_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"), **kw)
    with pytest.raises(ValueError, match="OCC_GRID with CONTRACT requires LINDISP"):
        Runner(cfg(), device="cpu")
    runner = Runner(cfg(lindisp=True, occ_extent=1.5), device="cpu")
    assert runner.cfg.occ_extent == 2.0
    assert runner.cfg.occ_march_steps == occupancy.derive_march_steps_contracted(8, 2.0, 6.0)


def _rays(seed, B):
    """Rays from a radius-4 sphere aimed near the origin, near/far 2/6."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3))
    o = (4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = -o + rng.normal(scale=0.8, size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full(B, 2.0, np.float32), np.full(B, 6.0, np.float32)


@pytest.mark.parametrize("march_res", [None, 4], ids=["gather", "march_res-4"])
def test_tighten_bounds_matches_jax(march_res):
    """Exact, except for rays with a probe within 1e-6 of a cell boundary,
    where floor() of two float32 evaluations of the same probe may land on
    either side; those are counted (at this seed one ray for the gather
    march, none for march_res 4)."""
    res, n_steps, B = 8, 64, 256
    raw = _random_raw(1, res)
    o, d, near, far = _rays(2, B)
    ref = joccupancy.tighten_bounds(_jgrid(raw), *map(jnp.asarray, (o, d, near, far)),
                                    n_steps=n_steps, march_res=march_res)
    got = occupancy.tighten_bounds(_grid(raw), *map(_t, (o, d, near, far)),
                                   n_steps=n_steps, march_res=march_res)
    frac = (np.arange(n_steps, dtype=np.float32) + 0.5) / n_steps
    ts = near[:, None] + (far - near)[:, None] * frac[None, :]
    pos = (o[:, None] + ts[..., None] * d[:, None]) / 1.5 * 0.5 + 0.5
    lres = march_res or res
    edge = np.any(np.abs(pos * lres - np.round(pos * lres)) < 1e-6 * lres, axis=(1, 2))
    assert edge.sum() <= 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy()[~edge], np.asarray(r)[~edge])
    hit = got[0].numpy() < far - 1e-3
    assert 0 < int(hit.sum()) < B  # some rays tightened, some missed


def test_tighten_bounds_with_fresh_grid_keeps_bounds_inside_the_cube():
    """A fresh grid (every cell inf, "occupied") tightens only to the cube."""
    o, d, near, far = _rays(3, 16)
    jn, jf = joccupancy.tighten_bounds(joccupancy.init_grid(8), *map(jnp.asarray, (o, d, near, far)))
    n, f = occupancy.tighten_bounds(occupancy.init_grid(8), *map(_t, (o, d, near, far)))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


# ---------------------------------------------------------------- refresh

SIGMA_ATOL = 1e-5  # the field's sigma, port vs JAX (tests/test_torch_field.py)


def test_update_grid_full_matches_jax():
    """A full sweep from a grid with earlier values and inf cells, JAX's
    jitter injected, the plain fp32 field in both: raw and density within
    the field's own sigma bound."""
    res = 6
    jparams, params = _field_with_content(3)
    raw = _random_raw(4, res)
    key = jax.random.PRNGKey(5)
    ref = joccupancy.update_grid(_jgrid(raw), jparams, jrender.field_jnp, key)
    u = np.asarray(jax.random.uniform(key, (res ** 3, 3)))
    got = occupancy.update_grid(_grid(raw), params, render.field_plain, draws=(None, _t(u)))
    assert np.isfinite(got.raw.numpy()).all()
    np.testing.assert_allclose(got.raw.numpy(), np.asarray(ref.raw), atol=SIGMA_ATOL, rtol=1e-6)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(ref.density),
                               atol=SIGMA_ATOL, rtol=1e-6)


def test_update_grid_subset_matches_jax():
    """A partial refresh with JAX's cell draw and jitter injected: the probed
    cells get the EMA (or their first value), the others keep theirs. JAX
    leaves it undefined which draw of a cell drawn twice wins, so those
    cells are left out of the comparison."""
    res, subset = 8, 160
    jparams, params = _field_with_content(6)
    raw = _random_raw(7, res)
    key = jax.random.PRNGKey(8)
    ref = joccupancy.update_grid(_jgrid(raw), jparams, jrender.field_jnp, key, subset=subset)
    kidx, kjit = jax.random.split(key)
    idx = np.asarray(jax.random.randint(kidx, (subset,), 0, res ** 3))
    u = np.asarray(jax.random.uniform(kjit, (subset, 3)))
    got = occupancy.update_grid(_grid(raw), params, render.field_plain, subset=subset,
                                draws=(_t(idx), _t(u)))
    counts = np.bincount(idx, minlength=res ** 3)
    once = counts <= 1
    assert (counts > 1).sum() >= 1  # the draw has duplicates
    g_raw, r_raw = got.raw.numpy().reshape(-1), np.asarray(ref.raw).reshape(-1)
    np.testing.assert_allclose(g_raw[once], r_raw[once], atol=SIGMA_ATOL, rtol=1e-6)
    untouched = counts == 0
    np.testing.assert_array_equal(g_raw[untouched], raw.reshape(-1)[untouched])


def test_update_grid_duplicate_cell_takes_the_last_draw():
    """A cell drawn twice takes the last draw's update on every device."""
    res = 4

    def field(params, points, dirs):  # sigma = x + 2 of the probe
        return torch.zeros(points.shape), points[:, :1] + 2.0

    g = occupancy.init_grid(res, half_extent=1.0)
    idx = torch.tensor([5, 9, 5, 5, 9])
    u = torch.tensor([[0.1] * 3, [0.2] * 3, [0.3] * 3, [0.9] * 3, [0.4] * 3])
    new = occupancy.update_grid(g, None, field, subset=5, draws=(idx, u))
    cell = 2.0 / res
    x = lambda i, k: ((i // (res * res) + 0.5) / res * 2 - 1) + (u[k, 0] - 0.5) * cell
    assert float(new.raw.reshape(-1)[5]) == pytest.approx(float(x(5, 3)) + 2.0)
    assert float(new.raw.reshape(-1)[9]) == pytest.approx(float(x(9, 4)) + 2.0)
    assert int(torch.isinf(new.raw).sum()) == res ** 3 - 2


def test_update_grid_draws_from_the_generator_and_makes_no_nan():
    g = occupancy.init_grid(8)
    _, params = _field_with_content(9)
    a = occupancy.update_grid(g, params, render.field_plain,
                              generator=torch.Generator().manual_seed(0), subset=64)
    b = occupancy.update_grid(g, params, render.field_plain,
                              generator=torch.Generator().manual_seed(0), subset=64)
    assert torch.equal(a.raw, b.raw)
    assert not torch.isnan(a.raw).any() and not torch.isnan(a.density).any()
    assert 0 < int(torch.isfinite(a.raw).sum()) <= 64


# ---------------------------------------------------------------- render

@pytest.mark.parametrize("march_res", [None, 4], ids=["gather", "march_res-4"])
def test_render_rays_with_grid_matches_jax(march_res):
    """Both passes through the tightened bounds, white background, 1e-4 per
    pixel (the slice tolerance)."""
    rng = np.random.default_rng(10)
    B = 24
    o, d, _, _ = _rays(11, B)
    rows = rng.integers(0, 16, B).astype(np.float32)
    cols = rng.integers(0, 16, B).astype(np.float32)
    pose = np.zeros((B, 17), np.float32)
    for i in range(B):  # camera at o[i] looking along -o[i]
        back = o[i] / np.linalg.norm(o[i])
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        c2w = np.stack([right, np.cross(back, right), back, o[i]], axis=1)
        pose[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], 1).ravel()
        pose[i, 15:] = (2.0, 6.0)
    raw = _random_raw(12, 8)
    jparams, params = _field_with_content(13)
    ref = jrender.render_rays(jparams, *map(jnp.asarray, (rows, cols, pose)),
                              jmake_k_inv(16, 16, 20.0), 8, 16, white_bkgd=True,
                              occ_grid=_jgrid(raw), occ_march=64, occ_march_res=march_res)
    got = render.render_rays(params, *map(_t, (rows, cols, pose)), make_k_inv(16, 16, 20.0),
                             8, 16, white_bkgd=True, occ_grid=_grid(raw), occ_march=64,
                             occ_march_res=march_res)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


# ---------------------------------------------------------------- Runner

def _occ_cfg(cls, scene_dir, tmp_path, **kw):
    base = dict(img_dir=f"{scene_dir}/", results_path=str(tmp_path / "r"),
                ckpt_path=str(tmp_path / "c"), log_dir=str(tmp_path / "l"),
                batch_ray=16, n_coarse=4, n_fine=4, render_chunk=72,
                occ_grid=True, occ_res=8, occ_extent=0.1, white_bkgd=True)
    base.update(kw)
    return cls(**base)


def test_runner_derives_march_steps_like_jax(sync_scene_dir, tmp_path):
    jcfg = _occ_cfg(JConfig, sync_scene_dir, tmp_path / "j", use_pallas=False)
    cfg = _occ_cfg(Config, sync_scene_dir, tmp_path / "t")
    JRunner(jcfg)
    Runner(cfg, device="cpu")
    assert cfg.occ_march_steps == jcfg.occ_march_steps > 64


def test_runner_refuses_occ_without_white_bkgd_like_jax(sync_scene_dir, tmp_path):
    jcfg = _occ_cfg(JConfig, sync_scene_dir, tmp_path / "j", use_pallas=False,
                    white_bkgd=False)
    cfg = _occ_cfg(Config, sync_scene_dir, tmp_path / "t", white_bkgd=False)
    with pytest.raises(ValueError, match="WHITE_BKGD") as j_err:
        JRunner(jcfg)
    with pytest.raises(ValueError, match="WHITE_BKGD") as t_err:
        Runner(cfg, device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_train_state_grid_is_only_made_with_occ_grid():
    """Without OCC_GRID the state has no grid and a step draws nothing for
    it: the batch stream is the one it was."""
    on = train.init_state(Config(occ_grid=True, occ_res=8), torch.device("cpu"))
    assert on.occ is not None and bool(torch.isinf(on.occ.raw).all())
    off = train.init_state(Config(), torch.device("cpu"))
    assert off.occ is None
    assert train.refresh_occ(Config(), off, None) is None


# ---------------------------------------------------------------- checkpoints

def test_occ_checkpoint_loads_in_both_packages(tmp_path):
    """The port writes occ::raw, occ::density, occ::half_extent and
    occ::threshold; JAX reads them, and the port reads JAX's."""
    params = mlp.init_network(torch.Generator().manual_seed(14))
    grid = _grid(_random_raw(15, 8), half_extent=1.25, threshold=0.02)
    path = ckpt.save_checkpoint(str(tmp_path / "t"), "run", 3, params, occ=grid)
    *_, j_occ = jckpt.load_checkpoint_full(path)
    for name in occupancy.OccGrid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_occ, name)),
                                      getattr(grid, name).numpy())
    jgrid = _jgrid(_random_raw(16, 8), half_extent=0.5)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), "run", 4,
                                  jax.tree_util.tree_map(np.asarray, jmlp.init_network(
                                      jax.random.PRNGKey(0))), occ=jgrid)
    back = ckpt.load_occ_grid(jpath)
    for name in occupancy.OccGrid._fields:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jgrid, name)))
    assert ckpt.load_occ_grid(ckpt.save_checkpoint(str(tmp_path), "n", 1, params)) is None


def test_lego_occ_cli_trains_saves_the_grid_and_renders(sync_scene_dir, tmp_path, capsys):
    """``python -m tinynerf_torch --mode all`` on a copy of conf/lego_occ.ini
    pointed at the small scene (shapes cut: 16 rays, 4 + 8 samples, an 8^3
    grid refreshed every 2 steps): it trains, writes a checkpoint with the
    grid, and renders the test split with it. The JAX package loads that
    checkpoint, grid and all, and a resumed Runner takes the grid back."""
    text = open(os.path.join(REPO, "conf", "lego_occ.ini")).read()
    overrides = dict(IMG_DIR=f"{sync_scene_dir}/", RESULTS_PATH=f"{tmp_path}/results/",
                     CKPT_PATH=f"{tmp_path}/ckpt/", TOTAL_ITER=4, STEP=4, BATCH_RAY=16,
                     N_COARSE=4, N_FINE=8, OCC_RES=8, OCC_UPDATE_EVERY=2)
    lines = [ln for ln in text.splitlines()
             if ln.split("=")[0].strip() not in overrides]
    lines += [f"{k} = {v}" for k, v in overrides.items()]
    lines += [f"LOG_DIR = {tmp_path}/runs/", "RENDER_CHUNK = 64"]
    ini = tmp_path / "lego_occ.ini"
    ini.write_text("\n".join(lines) + "\n")
    cfg = load_config(str(ini))
    assert cfg.precision == "bf16" and cfg.occ_grid and cfg.white_bkgd

    cli_main(["--conf", str(ini), "--mode", "all", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[ITER] 3 [LOSS]" in out and "Test PSNR" in out
    (path,) = glob.glob(str(tmp_path / "ckpt" / "*_3.npz"))
    with np.load(path) as archive:
        assert {f"occ::{k}" for k in occupancy.OccGrid._fields} <= set(archive.files)
    it, _, _, _, j_occ = jckpt.load_checkpoint_full(path)
    assert it == 3 and np.isfinite(np.asarray(j_occ.raw)).any()
    resumed = Runner(load_config(str(ini)), device="cpu")
    assert resumed.last_iter < 0  # CONTINUE is False in lego_occ.ini
    cfg.continue_ = True
    resumed = Runner(cfg, device="cpu")
    np.testing.assert_array_equal(resumed.state.occ.raw.numpy(), np.asarray(j_occ.raw))
    frames = evallib.render_test_set(cfg, resumed.params, resumed.test_table, resumed.k_inv,
                                     "x", 3, save=False, max_views=1,
                                     occ_grid=resumed.state.occ)
    assert frames.shape[0] == 1 and np.all(np.isfinite(frames))
