"""The unbounded-360 stack's modules in the port (``tinynerf_torch``: the
contraction, LINDISP sampling, NDC, the proposal mode's distortion and
interlevel losses) against the JAX package's, on the CPU at small sizes, on
inputs made with numpy (or JAX's draws) from a seed.

Tolerances: the functions of one sample or one ray, rel 1e-6 (float32 in
other orders); frames 1e-4 per pixel on a field with content (the
resampler's slope amplifies last-ulp differences where the coarse weights
are near zero, ROADMAP section 3); gradients through the resampler by
cosine and norm bounds, never element by element."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf.core import contract as jcontract, mlp as jmlp, proposal as jproposal
from tinynerf.core import rays as jrays, render as jrender, sampling as jsampling
from tinynerf.data import poses as jposes
from tinynerf_torch import eval as evallib
from tinynerf_torch.ckpt import params_from_numpy
from tinynerf_torch.config import Config
from tinynerf_torch.core import contract, rays, render, sampling
from tinynerf_torch.data import poses
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

PIXEL_ATOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------- contraction

def _probe_points():
    """Points inside, on and far outside the unit ball, and the origin."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    radii = np.array([0.0, 1e-7, 0.3, 0.999, 1.0, 1.001, 1.7, 10.0, 1e3, 1e6])
    return (d * np.repeat(radii, 4)[:, None]).astype(np.float32)


def test_contract_and_its_gradient_match_jax():
    pts = _probe_points()
    ref, vjp = jax.vjp(jcontract.contract_mip360, jnp.asarray(pts))
    g = np.random.default_rng(1).normal(size=pts.shape).astype(np.float32)
    (g_ref,) = vjp(jnp.asarray(g))
    x = _t(pts).requires_grad_(True)
    got = contract.contract_mip360(x)
    (g_got,) = torch.autograd.grad(got, x, _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-7)
    assert np.isfinite(g_got.numpy()).all()  # the origin's gradient is finite
    norms = np.linalg.norm(got.detach().numpy(), axis=1)
    assert norms.max() < 2.0 + 1e-6
    inside = np.linalg.norm(pts, axis=1) <= 1.0
    np.testing.assert_array_equal(got.detach().numpy()[inside], pts[inside])


def test_inv_contract_matches_jax_and_round_trips():
    """The inverse against JAX's, and the round trips: contract(inv(c)) = c
    for |c| < 1.99, inv(contract(x)) = x for |x| below the clamp's radius
    100; past the clamp every point maps to a finite radius near 100."""
    c = contract.contract_mip360(_t(_probe_points()))
    np.testing.assert_allclose(contract.inv_contract_mip360(c).numpy(),
                               np.asarray(jcontract.inv_contract_mip360(jnp.asarray(c.numpy()))),
                               rtol=1e-6, atol=1e-7)
    x = _t(_probe_points())
    mid = torch.linalg.norm(x, dim=1) < 50.0
    np.testing.assert_allclose(contract.inv_contract_mip360(contract.contract_mip360(x))[mid],
                               x[mid], rtol=1e-4, atol=1e-7)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(64, 3))
    cc = _t((d / np.linalg.norm(d, axis=1, keepdims=True)
             * rng.uniform(0, 1.98, (64, 1))).astype(np.float32))
    np.testing.assert_allclose(contract.contract_mip360(contract.inv_contract_mip360(cc)), cc,
                               rtol=1e-5, atol=1e-6)
    edge = cc / torch.linalg.norm(cc, dim=1, keepdim=True) * 1.995
    far = contract.inv_contract_mip360(edge)
    np.testing.assert_allclose(far.numpy(), np.asarray(jcontract.inv_contract_mip360(
        jnp.asarray(edge.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(far, dim=1), 100.0, rtol=3e-3)


def test_contract_wrapper_takes_the_point_interface():
    """Under CONTRACT the fields lose ``eval_rays`` and ``render_fused``, so
    the MLP with USE_PALLAS runs ``field_flat`` (on the card kernels 3 and
    4), evaluated at the contracted points; CONTRACT with NDC raises."""
    cfg = Config(contract=True, fused_render=True, proposal=True, prop_field="mlp",
                 prop_pallas=True)
    for fn in (evallib.make_field_fn(cfg), evallib.make_prop_field_fn(cfg)):
        assert not hasattr(fn, "eval_rays") and not hasattr(fn, "render_fused")
    plain = evallib.make_field_fn(Config(fused_render=True))
    assert hasattr(plain, "eval_rays") and hasattr(plain, "render_fused")
    _, params = field_with_content(3)
    pts = _t(_probe_points())
    dirs = torch.nn.functional.normalize(torch.ones_like(pts), dim=-1)
    got = evallib.make_field_fn(cfg)(params, pts, dirs)
    want = plain(params, contract.contract_mip360(pts), dirs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CONTRACT is incompatible with NDC"):
        evallib.make_field_fn(Config(contract=True, ndc=True))


# ---------------------------------------------------------------- LINDISP sampling

@pytest.mark.parametrize("jitter", [False, True], ids=["linspace", "jittered"])
def test_coarse_ts_lindisp_matches_jax(jitter):
    """Disparity-linear coarse t's, with JAX's jitter injected on the level
    fraction: sorted per ray, inside [near, far]."""
    rng = np.random.default_rng(3)
    B, n = 24, 16
    near = rng.uniform(0.2, 1.0, B).astype(np.float32)
    far = (near * rng.uniform(5.0, 200.0, B)).astype(np.float32)
    key = jax.random.PRNGKey(4) if jitter else None
    ref = np.asarray(jsampling.coarse_ts(jnp.asarray(near), jnp.asarray(far), n, key=key,
                                         lindisp=True))
    u = _t(jax.random.uniform(key, (B, n), jnp.float32)) if jitter else None
    got = sampling.coarse_ts(_t(near), _t(far), n, lindisp=True, jitter=u).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.all(np.diff(got, axis=1) >= 0)
    # 1 / (1/near + (1/far - 1/near)) meets far within the rounding of 1/near
    assert np.all(got >= near[:, None] * (1 - 1e-4)) and np.all(got <= far[:, None] * (1 + 1e-4))


def test_lindisp_jitter_comes_from_the_generator():
    near, far = torch.full((3,), 0.5), torch.full((3,), 100.0)
    a = sampling.coarse_ts(near, far, 8, generator=torch.Generator().manual_seed(0),
                           lindisp=True)
    u = torch.rand((3, 8), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, sampling.coarse_ts(near, far, 8, lindisp=True, jitter=u))
    assert not torch.equal(a, sampling.coarse_ts(near, far, 8, lindisp=True))


def test_resample_with_per_bin_spacings_matches_jax():
    """LINDISP's resampler: bin i's spacing t[i + 1] - t[i] pairs with
    dense[:, i + 1] in the slope. The values and the gradient to the coarse
    weights (sum of the fine t's)."""
    rng = np.random.default_rng(5)
    B, n_c, n_f = 16, 12, 20
    near, far = np.full(B, 0.5, np.float32), np.full(B, 80.0, np.float32)
    t_co = np.asarray(jsampling.coarse_ts(jnp.asarray(near), jnp.asarray(far), n_c,
                                          lindisp=True))
    dense = rng.gamma(0.8, 0.2, (B, n_c)).astype(np.float32)
    delta = t_co[:, 1:] - t_co[:, :-1]

    def jfn(d):
        return jsampling.resample(jnp.asarray(t_co), d, jnp.asarray(delta), n_f)

    ref, vjp = jax.vjp(jfn, jnp.asarray(dense))
    (g_ref,) = vjp(jnp.ones_like(ref))
    d = _t(dense).requires_grad_(True)
    got = sampling.resample(_t(t_co), d, _t(delta), n_f)
    (g_got,) = torch.autograd.grad(got.sum(), d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert _cos(g_got.numpy(), g_ref) >= 0.9999


# ---------------------------------------------------------------- the renderer

def _pose_rows(rng, B, near=2.0, far=6.0):
    """(B, 17) rows: random rotations, the camera 4 units out, h/w/f
    16/16/20."""
    rows = np.zeros((B, 17), np.float32)
    for i in range(B):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w = np.concatenate([q, rng.normal(size=(3, 1)) * 4.0], axis=1)
        rows[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], axis=1).ravel()
        rows[i, 15:] = (near, far)
    return rows


def forward_facing_rows(rng, n, near=1.0, far=20.0):
    """LLFF-like rows before recentring: cameras near each other, all looking
    down -z (their back axis near +z), h/w/f 16/16/20."""
    rows = np.zeros((n, 17))
    for i in range(n):
        back = np.array([0.0, 0.0, 1.0]) + rng.normal(scale=0.05, size=3)
        c2w = poses.view_matrix(back, np.array([0.0, 1.0, 0.0]),
                                rng.normal(scale=0.3, size=3) + [0.0, 0.0, 3.0])
        rows[i, :15] = np.concatenate([c2w, [[16.0], [16.0], [20.0]]], axis=1).ravel()
        rows[i, 15:] = (near * rng.uniform(1.0, 1.5), far * rng.uniform(0.8, 1.0))
    return rows


def field_with_content(seed):
    """The reference MLP from JAX's init with the sigma bias +1: (JAX params,
    the port's)."""
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(seed)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree)


def prop_with_content(seed, width=32, depth=2):
    tree = jax.tree_util.tree_map(np.asarray, jproposal.init_proposal(
        jax.random.PRNGKey(seed), width, depth))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree)


def _render_both(rows_px, cols_px, pose, jparams, params, **kw):
    ref = jrender.render_rays(jparams, jnp.asarray(rows_px), jnp.asarray(cols_px),
                              jnp.asarray(pose), jrays.make_k_inv(16, 16, 20.0), 8, 16,
                              **{k: v[0] for k, v in kw.items()})
    got = render.render_rays(params, _t(rows_px), _t(cols_px), _t(pose),
                             rays.make_k_inv(16, 16, 20.0), 8, 16,
                             **{k: v[1] for k, v in kw.items()})
    return got, ref


@pytest.fixture(scope="module")
def ray_batch():
    rng = np.random.default_rng(6)
    B = 32
    return (rng.integers(0, 16, B).astype(np.float32), rng.integers(0, 16, B).astype(np.float32),
            _pose_rows(rng, B, near=0.5, far=30.0))


@pytest.mark.parametrize("with_proposal", [False, True], ids=["merged", "proposal"])
def test_render_rays_lindisp_matches_jax(ray_batch, with_proposal):
    """``lindisp=True``: per-bin density deltas and CDF spacings, with the
    reference merge or with a proposal MLP (the standalone fine composite):
    every output within the frame tolerance."""
    jparams, params = field_with_content(7)
    kw = dict(lindisp=(True, True), extras=(True, True))
    if with_proposal:
        jprop, prop = prop_with_content(8)
        kw["prop_params"] = (jprop, prop)
    else:
        kw["merge_impl"] = ("twolist", "twolist")
    got, ref = _render_both(*ray_batch, jparams, params, **kw)
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = dict(atol=PIXEL_ATOL, rtol=1e-4) if i == 2 else dict(atol=PIXEL_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


def test_render_rays_ndc_matches_jax():
    """``ndc_params``: rays warped into the NDC cube and marched at t in
    [0, 1], on recentred forward-facing poses; depth in NDC units."""
    rng = np.random.default_rng(9)
    rows17 = poses.recenter_and_rescale(forward_facing_rows(rng, 6)).astype(np.float32)
    B = 48
    pose = rows17[rng.integers(0, 6, B)]
    rows_px, cols_px = (rng.uniform(0, 16, B).astype(np.float32) for _ in range(2))
    jparams, params = field_with_content(10)
    ndc = (16.0, 16.0, 20.0)
    got, ref = _render_both(rows_px, cols_px, pose, jparams, params,
                            ndc_params=(ndc, ndc), extras=(True, True))
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=PIXEL_ATOL,
                                   rtol=1e-4 if i == 2 else 0)
    depth = got[2].numpy()
    assert np.all((depth >= 0) & (depth <= 1 + 1e-6))


def test_recenter_and_rescale_matches_jax():
    """The NDC ingest's pose normalisation, float64 as in JAX: bit-equal on
    a forward-facing pose set; the average camera lands at the origin
    looking down -z."""
    rows = forward_facing_rows(np.random.default_rng(11), 8)
    got = poses.recenter_and_rescale(rows)
    np.testing.assert_array_equal(got, jposes.recenter_and_rescale(rows))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got[:, 15].min(), 1.0 / 0.75)
    c2w = got[:, :15].reshape(-1, 3, 5)[:, :, :4]
    np.testing.assert_allclose(c2w[:, :, 3].mean(axis=0), 0.0, atol=1e-12)


def test_lindisp_with_ndc_and_aux_without_proposal_raise(ray_batch):
    rows_px, cols_px, pose = ray_batch
    args = ({}, _t(rows_px), _t(cols_px), _t(pose), rays.make_k_inv(16, 16, 20.0), 8, 16)
    with pytest.raises(ValueError, match="LINDISP is incompatible with NDC"):
        render.render_rays(*args, lindisp=True, ndc_params=(16.0, 16.0, 20.0))
    for kw in ({"want_dist": True}, {"want_interlevel": True}):
        with pytest.raises(ValueError, match="require PROPOSAL=True"):
            render.render_rays(*args, **kw)
    with pytest.raises(ValueError, match="aux losses and extras"):
        render.render_rays(*args, prop_params={}, want_dist=True, extras=True)


# ---------------------------------------------------------------- the aux losses

def _sorted_ts(rng, B, n, lo=0.5, hi=40.0):
    return np.sort(rng.uniform(lo, hi, (B, n)), axis=1).astype(np.float32)


def test_distortion_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(12)
    B, n = 16, 24
    t = _sorted_ts(rng, B, n)
    w = rng.gamma(0.5, 0.05, (B, n)).astype(np.float32)
    near = (t[:, 0] - rng.uniform(0, 0.4, B)).astype(np.float32)
    far = (t[:, -1] + rng.uniform(0, 4.0, B)).astype(np.float32)
    ref, vjp = jax.vjp(lambda tt, ww: jrender.distortion_loss(tt, ww, jnp.asarray(near),
                                                              jnp.asarray(far)),
                       jnp.asarray(t), jnp.asarray(w))
    g = rng.normal(size=B).astype(np.float32)
    g_t_ref, g_w_ref = vjp(jnp.asarray(g))
    tt, ww = _t(t).requires_grad_(True), _t(w).requires_grad_(True)
    got = render.distortion_loss(tt, ww, _t(near), _t(far))
    g_t, g_w = torch.autograd.grad(got, (tt, ww), _t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(g_w.numpy(), np.asarray(g_w_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_t_ref), rtol=1e-4, atol=1e-7)


def test_interlevel_loss_and_its_gradient_match_jax():
    """The proposal histogram's coverage loss; its overlap is strict, so
    intervals that only touch count as disjoint (ties are placed on
    purpose), and the fine weights get no gradient."""
    rng = np.random.default_rng(13)
    B, n_c, n_f = 12, 10, 20
    t_p = _sorted_ts(rng, B, n_c)
    t_f = np.sort(np.concatenate([_sorted_ts(rng, B, n_f - 4), t_p[:, 2:6]], axis=1), axis=1)
    w_p = rng.gamma(0.5, 0.1, (B, n_c)).astype(np.float32)
    w_f = rng.gamma(0.5, 0.1, (B, n_f)).astype(np.float32)
    ref, vjp = jax.vjp(lambda wp, wf: jrender.interlevel_loss(jnp.asarray(t_p), wp,
                                                              jnp.asarray(t_f), wf),
                       jnp.asarray(w_p), jnp.asarray(w_f))
    g = rng.normal(size=B).astype(np.float32)
    g_p_ref, g_f_ref = vjp(jnp.asarray(g))
    wp, wf = _t(w_p).requires_grad_(True), _t(w_f).requires_grad_(True)
    got = render.interlevel_loss(_t(t_p), wp, _t(t_f), wf)
    (g_p,) = torch.autograd.grad(got, wp, _t(g), retain_graph=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_p_ref), rtol=1e-4, atol=1e-7)
    # the fine weights are detached on both sides
    assert not np.any(np.asarray(g_f_ref))
    assert torch.autograd.grad(got.sum(), wf, allow_unused=True)[0] is None


def test_render_rays_aux_losses_match_jax(ray_batch):
    """``want_dist`` and ``want_interlevel`` with a proposal MLP under
    LINDISP: both passes' pixels and the per-ray losses, as the unbounded
    step computes them."""
    jparams, params = field_with_content(14)
    jprop, prop = prop_with_content(15)
    got, ref = _render_both(*ray_batch, jparams, params, prop_params=(jprop, prop),
                            lindisp=(True, True), want_dist=(True, True),
                            want_interlevel=(True, True))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=PIXEL_ATOL)
    assert set(got[2]) == {"dist", "interlevel"}
    for k in ("dist", "interlevel"):
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(ref[2][k]), rtol=1e-3,
                                   atol=1e-6)
