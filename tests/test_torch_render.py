"""The port's geometry, sampling and compositing (``tinynerf_torch.core``)
against the JAX package's, on the same inputs made with numpy from a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf.core import mlp as jmlp, occupancy as jocc, proposal as jproposal
from tinynerf.core import rays as jrays, render as jrender
from tinynerf.core import sampling as jsampling
from tinynerf_torch.ckpt import params_from_numpy
from tinynerf_torch.core import occupancy, rays, render, sampling


def _t(a):
    return torch.tensor(np.asarray(a))


def _pose_rows(rng, B):
    """(B, 17) rows: random rotations, camera 4 units out, h/w/f 16/16/20,
    near/far 2/6."""
    rows = np.zeros((B, 17), np.float32)
    for i in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.concatenate([q, rng.normal(size=(3, 1)) * 4.0], axis=1)
        hwf = np.array([[16.0], [16.0], [20.0]])
        rows[i, :15] = np.concatenate([c2w, hwf], axis=1).ravel()
        rows[i, 15:] = (2.0, 6.0)
    return rows


@pytest.fixture(scope="module")
def ray_batch():
    rng = np.random.default_rng(0)
    B = 32
    rows_px = rng.integers(0, 16, B).astype(np.float32)
    cols_px = rng.integers(0, 16, B).astype(np.float32)
    return rows_px, cols_px, _pose_rows(rng, B)


def test_make_k_inv_matches_jax():
    np.testing.assert_array_equal(rays.make_k_inv(12, 16, 20.5).numpy(),
                                  np.asarray(jrays.make_k_inv(12, 16, 20.5)))


def test_pixels_to_rays_within_one_ulp(ray_batch):
    rows_px, cols_px, pose = ray_batch
    k_inv = jrays.make_k_inv(16, 16, 20.0)
    o_ref, d_ref, n_ref, f_ref = jrays.pixels_to_rays(
        jnp.asarray(rows_px), jnp.asarray(cols_px), jnp.asarray(pose), k_inv)
    o, d, near, far = rays.pixels_to_rays(_t(rows_px), _t(cols_px), _t(pose),
                                          rays.make_k_inv(16, 16, 20.0))
    for got, ref in ((o, o_ref), (near, n_ref), (far, f_ref)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # unit directions: the rotation's 3-term sums round once per term on
    # XLA's CPU (an FMA chain) and twice here; components agree to 1 ulp at
    # the vector's scale (a near-zero component can differ by many of its
    # own ulps)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0,
                               atol=np.spacing(np.float32(1.0)))
    assert o.is_contiguous()  # the kernel takes contiguous origins


@pytest.mark.parametrize("n", [8, 64, 128, 192])
def test_coarse_ts_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    near = rng.uniform(0.5, 2.5, 16).astype(np.float32)
    far = (near + rng.uniform(1.0, 5.0, 16)).astype(np.float32)
    ref = np.asarray(jsampling.coarse_ts(jnp.asarray(near), jnp.asarray(far), n))
    got = sampling.coarse_ts(_t(near), _t(far), n).numpy()
    np.testing.assert_array_equal(got, ref)


def test_coarse_ts_takes_lindisp_and_stratified_jitter():
    """LINDISP is ported (disparity-linear t's, JAX's within 1e-6; with
    jitter: tests/test_torch_unbounded.py); stratified jitter (a generator)
    is ported."""
    near, far = torch.full((2,), 2.0), torch.full((2,), 6.0)
    lin = sampling.coarse_ts(near, far, 8, lindisp=True)
    ref = jsampling.coarse_ts(jnp.full((2,), 2.0), jnp.full((2,), 6.0), 8, lindisp=True)
    np.testing.assert_allclose(lin.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(1.0 / lin.numpy()[0], np.linspace(0.5, 1.0 / 6.0, 8), rtol=1e-6)
    jittered = sampling.coarse_ts(near, far, 8, generator=torch.Generator().manual_seed(0))
    assert jittered.shape == (2, 8) and not torch.equal(jittered, sampling.coarse_ts(near, far, 8))


def _coarse_weights(seed, B, n_c):
    rng = np.random.default_rng(seed)
    near = np.full(B, 2.0, np.float32)
    far = np.full(B, 6.0, np.float32)
    t_co = np.asarray(jsampling.coarse_ts(jnp.asarray(near), jnp.asarray(far), n_c))
    sigma = rng.gamma(0.7, 3.0, (B, n_c)).astype(np.float32)
    sigma[:, : n_c // 4] = 0.0  # empty space in front, as in a real scene
    delta = ((far - near) / n_c)[:, None] * np.ones((1, n_c), np.float32)
    dense = np.asarray(jrender.get_density(jnp.asarray(delta), jnp.asarray(sigma)))
    return near, far, t_co, sigma, delta, dense


def test_get_density_matches_jax():
    _, _, _, sigma, delta, dense = _coarse_weights(1, 16, 32)
    got = render.get_density(_t(delta), _t(sigma)).numpy()
    np.testing.assert_allclose(got, dense, atol=1e-6, rtol=1e-5)


def test_composite_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 0.1, (8, 16)).astype(np.float32)
    color = rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    ref = np.asarray(jrender.composite(jnp.asarray(w), jnp.asarray(color)))
    got = render.composite(_t(w), _t(color)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    planes = tuple(_t(np.ascontiguousarray(color[..., c])) for c in range(3))
    np.testing.assert_allclose(render.composite(_t(w), planes).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("n_c,n_f", [(8, 16), (64, 128)])
def test_resample_bins_then_values_match_jax(n_c, n_f):
    near, far, t_co, _, _, dense = _coarse_weights(3, 24, n_c)
    delta = (far - near) / (n_c - 1)
    # the bins first: the JAX package counts cdf entries below each level
    cdf = np.asarray(jsampling.matmul_cumsum(jnp.asarray(dense)))
    high, low = cdf.max(1), cdf.min(1)
    frac = np.arange(1, n_f + 1, dtype=np.float32) / np.float32(n_f + 1)
    levels = low[:, None] + (high - low)[:, None] * frac[None, :]
    ref_idx = np.clip((cdf[:, :, None] < levels[:, None, :]).sum(1) - 1, 0, n_c - 1)
    t_cdf = torch.cumsum(_t(dense), dim=1)
    got_idx = sampling.bin_indices(t_cdf, sampling.fine_levels(t_cdf, n_f)).numpy()
    np.testing.assert_array_equal(got_idx, ref_idx)
    # then the values
    ref = np.asarray(jsampling.resample(jnp.asarray(t_co), jnp.asarray(dense),
                                        jnp.asarray(delta), n_f))
    got = sampling.resample(_t(t_co), _t(dense), _t(delta), n_f).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    assert np.all(np.diff(got, axis=1) >= 0)


def _merge_inputs(seed, ties: bool):
    rng = np.random.default_rng(seed)
    B, n_c, n_f = 6, 8, 16
    t_co = np.sort(rng.uniform(2, 6, (B, n_c)), 1).astype(np.float32)
    t_fi = np.sort(rng.uniform(2, 6, (B, n_f)), 1).astype(np.float32)
    if ties:
        # every other fine sample lands exactly on a coarse one; the last
        # coarse and fine samples tie at the ray's end
        t_fi[:, ::2] = t_co[:, : n_f // 2]
        t_fi[:, -1] = t_co[:, -1]
        t_fi = np.sort(t_fi, 1)
    sig = lambda n: rng.gamma(0.7, 2.0, (B, n)).astype(np.float32)
    col = lambda n: tuple(rng.uniform(0, 1, (B, n)).astype(np.float32) for _ in range(3))
    return t_co, t_fi, sig(n_c), sig(n_f), col(n_c), col(n_f)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_merged_composite_matches_jax(ties, white_bkgd):
    t_co, t_fi, s_co, s_fi, c_co, c_fi = _merge_inputs(4, ties)
    ref = jrender.merged_composite(
        jnp.asarray(t_co), jnp.asarray(t_fi), jnp.asarray(s_co), jnp.asarray(s_fi),
        tuple(map(jnp.asarray, c_co)), tuple(map(jnp.asarray, c_fi)),
        white_bkgd=white_bkgd, return_extras=True)
    got = render.merged_composite(
        _t(t_co), _t(t_fi), _t(s_co), _t(s_fi), tuple(map(_t, c_co)),
        tuple(map(_t, c_fi)), white_bkgd=white_bkgd, return_extras=True)
    for g, r in zip(got, ref):  # rgb, depth, acc
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_merged_composite_orders_coarse_first_on_ties():
    """One ray, coarse t = [1, 2], fine t = [2, 3]: the tied pair is ordered
    coarse, fine, so the coarse sample at 2 gets delta 0 and contributes no
    weight while the fine one at 2 gets delta 1."""
    t_co, t_fi = torch.tensor([[1.0, 2.0]]), torch.tensor([[2.0, 3.0]])
    s_co, s_fi = torch.tensor([[0.0, 5.0]]), torch.tensor([[5.0, 0.0]])
    red = (torch.ones(1, 2), torch.zeros(1, 2), torch.zeros(1, 2))
    blue = (torch.zeros(1, 2), torch.zeros(1, 2), torch.ones(1, 2))
    out = render.merged_composite(t_co, t_fi, s_co, s_fi, red, blue)
    ref = jrender.merged_composite(*(jnp.asarray(x.numpy()) for x in (t_co, t_fi, s_co, s_fi)),
                                   tuple(jnp.asarray(x.numpy()) for x in red),
                                   tuple(jnp.asarray(x.numpy()) for x in blue))
    w = float(np.exp(-5.0) * (1 - np.exp(-5.0)))  # inclusive cumsum (Q5)
    np.testing.assert_allclose(out.numpy(), [[0.0, 0.0, w]], atol=1e-7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)


def field_with_content(seed):
    """JAX init with the sigma bias raised by 1: random init gives sigma ~1e-2
    everywhere, so every coarse weight is near zero, where the resampler's
    slope delta / (dense + 1e-7) turns last-ulp differences between two exp
    implementations into 1e-4-scale shifts of the fine samples (and the
    encoding turns those into pixel differences). A field with content, as a
    trained one has, concentrates its weights and is well conditioned.
    Returns (JAX params, the port's params)."""
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(seed)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_rays_matches_jax(ray_batch, white_bkgd):
    rows_px, cols_px, pose = ray_batch
    jparams, params = field_with_content(4)
    ref = jrender.render_rays(jparams, jnp.asarray(rows_px), jnp.asarray(cols_px),
                              jnp.asarray(pose), jrays.make_k_inv(16, 16, 20.0),
                              8, 16, merge_impl="twolist", white_bkgd=white_bkgd,
                              extras=True)
    got = render.render_rays(params, _t(rows_px), _t(cols_px), _t(pose),
                             rays.make_k_inv(16, 16, 20.0), 8, 16,
                             white_bkgd=white_bkgd, extras=True)
    # pixels and opacity: 1e-4, the slice tolerance (float32 sums and exp
    # in different orders and libraries, amplified through the resampler's
    # slopes); depth is in scene units (2..6), so relative as well
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = dict(atol=1e-4, rtol=1e-4) if i == 2 else dict(atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def _forward_facing(rng, B):
    """NDC-ready rows: cameras near the origin looking down -z (recentred
    LLFF poses), near/far 1/20."""
    rows = np.zeros((B, 17), np.float32)
    for i in range(B):
        q, _ = np.linalg.qr(np.eye(3) + rng.normal(scale=0.05, size=(3, 3)))
        q = q * np.sign(np.diag(q))[None, :]
        c2w = np.concatenate([q, rng.normal(scale=0.2, size=(3, 1))], axis=1)
        rows[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], axis=1).ravel()
        rows[i, 15:] = (1.0, 20.0)
    return rows


def _contracted_grid(seed, res=8):
    """A grid over the contracted ball (half extent 2), some cells empty."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.uniform(size=(res,) * 3) < 0.02, rng.uniform(0.02, 2.0, (res,) * 3),
                   0.0).astype(np.float32)
    j = jocc.OccGrid(density=jocc._dilate(jnp.asarray(raw)), raw=jnp.asarray(raw),
                     half_extent=jnp.float32(2.0), threshold=jnp.float32(0.01))
    raw_t = _t(raw)
    return j, occupancy.OccGrid(density=occupancy._dilate(raw_t), raw=raw_t,
                                half_extent=torch.tensor(2.0), threshold=torch.tensor(0.01))


@pytest.mark.parametrize("option", ["proposal-lindisp", "occ_contract", "ndc", "lindisp"])
def test_render_rays_slice7_options_match_jax(ray_batch, option):
    """The options slice 7 ports, once refused by name, against JAX's
    ``render_rays`` on a field with content (every output within the frame
    tolerance): LINDISP with a proposal field (the proposal MLP by default)
    and with the merge, the contracted occupancy grid (rays whose tightened
    bounds differ, a probe within 1e-6 of a cell boundary, are left out, at
    most 2), and NDC on forward-facing rays."""
    rows_px, cols_px, pose = ray_batch
    jparams, params = field_with_content(21)
    jkw, kw = {"extras": True}, {"extras": True}
    if option == "proposal-lindisp":
        tree = jax.tree_util.tree_map(np.asarray, jproposal.init_proposal(
            jax.random.PRNGKey(22), 32, 2))
        tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
        jkw.update(prop_params=jax.tree_util.tree_map(jnp.asarray, tree), lindisp=True)
        kw.update(prop_params=params_from_numpy(tree), lindisp=True)
    elif option == "occ_contract":
        jgrid, grid = _contracted_grid(23)
        jkw.update(occ_grid=jgrid, occ_contract=True, occ_march=64)
        kw.update(occ_grid=grid, occ_contract=True, occ_march=64)
    elif option == "ndc":
        pose = _forward_facing(np.random.default_rng(24), pose.shape[0])
        jkw["ndc_params"] = kw["ndc_params"] = (16.0, 16.0, 20.0)
    else:
        jkw["lindisp"] = kw["lindisp"] = True
    ref = jrender.render_rays(jparams, jnp.asarray(rows_px), jnp.asarray(cols_px),
                              jnp.asarray(pose), jrays.make_k_inv(16, 16, 20.0), 8, 16,
                              merge_impl="twolist", **jkw)
    got = render.render_rays(params, _t(rows_px), _t(cols_px), _t(pose),
                             rays.make_k_inv(16, 16, 20.0), 8, 16, merge_impl="twolist", **kw)
    keep = np.ones(rows_px.shape[0], bool)
    if option == "occ_contract":
        o, d, near, far = rays.pixels_to_rays(_t(rows_px), _t(cols_px), _t(pose),
                                              rays.make_k_inv(16, 16, 20.0))
        a = occupancy.tighten_bounds(grid, o, d, near, far, n_steps=64, contract=True)
        b = jocc.tighten_bounds(jgrid, *(jnp.asarray(x.numpy()) for x in (o, d, near, far)),
                                n_steps=64, contract=True)
        keep = np.all([x.numpy() == np.asarray(y) for x, y in zip(a, b)], axis=0)
        assert (~keep).sum() <= 2
        # the grid tightened some rays
        assert bool(torch.any((a[0] > near) | (a[1] < far)))
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = dict(atol=1e-4, rtol=1e-4) if i == 2 else dict(atol=1e-4)
        np.testing.assert_allclose(g.numpy()[keep], np.asarray(r)[keep], **tol)


@pytest.mark.parametrize("kwargs,error", [
    ({"merge_impl": "sorted"}, "merge_impl"), ({"compat_sort": True, "extras": True}, "extras")])
def test_render_rays_rejects_bad_combinations(ray_batch, kwargs, error):
    rows_px, cols_px, pose = ray_batch
    _, params = field_with_content(0)
    with pytest.raises(ValueError, match=error):
        render.render_rays(params, _t(rows_px), _t(cols_px), _t(pose),
                           rays.make_k_inv(16, 16, 20.0), 8, 16, **kwargs)


def test_ndc_rays_matches_jax(ray_batch):
    rows_px, cols_px, pose = ray_batch
    o, d, _, _ = jrays.pixels_to_rays(jnp.asarray(rows_px), jnp.asarray(cols_px),
                                      jnp.asarray(pose), jrays.make_k_inv(16, 16, 20.0))
    ref = jrays.ndc_rays(16.0, 16.0, 20.0, 1.0, o, d)
    got = rays.ndc_rays(16.0, 16.0, 20.0, 1.0, _t(o), _t(d))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
