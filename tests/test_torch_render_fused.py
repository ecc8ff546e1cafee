"""The fused renderer (``FUSED_RENDER``; ``tinynerf_torch.kernels.render_kernel``)
against the JAX package's ``render_kernel.render_fused``, run in interpret
mode as its own tests run it, on the CPU at that test's shapes (B = 24, N_c =
8, N_f = 16, and a partial tile B = 11), on the same inputs; its place in
``render_rays`` and in frames."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
import tinynerf.kernels.render_kernel as jrk
from tinynerf import eval as jeval, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import mlp as jmlp, render as jrender, sampling as jsampling
from tinynerf.core.rays import make_k_inv as jmake_k_inv, pixels_to_rays as jpixels_to_rays
from tinynerf_torch import ckpt, eval as evallib
from tinynerf_torch.config import load_config
from tinynerf_torch.core import occupancy, rays as raylib, render, sampling
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.kernels import mlp_kernel as mk, render_kernel as rk
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

NC, NF, B = 8, 16, 24
PIXEL_ATOL = 1e-4   # the frame tolerance (tests/test_torch_slice.py)


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _camera(rng, n, hw=16.0, f=19.2):
    """(rows, cols, pose17) for n pixels of tests/test_render_kernel.py's view."""
    rows = rng.uniform(0, hw, n).astype(np.float32)
    cols = rng.uniform(0, hw, n).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.2, 4.0]
    hwf = np.array([[hw], [hw], [f]], np.float32)
    p17 = np.tile(np.concatenate([np.concatenate([c2w[:3, :4], hwf], 1).flatten(),
                                  [2.0, 6.0]]), (n, 1)).astype(np.float32)
    return rows, cols, p17


@pytest.fixture(scope="module")
def rays():
    """tests/test_render_kernel.py's rays (pixels_to_rays, coarse_ts) and
    params (JAX init at key 0), for both packages: (JAX inputs, the port's).
    The sigma bias is raised by 1 (tests/test_torch_render.py::
    field_with_content): at random init the coarse weights are near zero,
    where the resampler's slope delta / (w + 1e-7) turns the last-ulp
    differences of two float32 networks into 5e-5 shifts of the colors (the
    JAX test runs one network on both sides)."""
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(0)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    rows, cols, p17 = _camera(np.random.default_rng(3), B)
    o, d, near, far = jpixels_to_rays(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(p17),
                                      jmake_k_inv(16.0, 16.0, 19.2))
    t_co = jsampling.coarse_ts(near, far, NC)
    jax_in = (jax.tree_util.tree_map(jnp.asarray, tree), o, d, t_co, near, far)
    port_in = (ckpt.params_from_numpy(tree),
               *(torch.tensor(np.asarray(x)) for x in (o, d, t_co, near, far)))
    return jax_in, port_in


def _cut(inputs, n):
    params, *rest = inputs
    return (params, *(x[:n] for x in rest))


DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("n_rays", [B, 11])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_forward_matches_jax(rays, n_rays, precision, white_bkgd):
    """``render_fused_plain`` and ``render_fused`` on CPU tensors against the
    JAX kernel: fp32 within 2e-5 (the JAX kernel test's own bound), bf16
    within 2e-3 of max|ref|. B = 11 is a partial TPU tile."""
    jax_in, port_in = _cut(rays[0], n_rays), _cut(rays[1], n_rays)
    ref = jrk.render_fused(*jax_in, NF, white_bkgd=white_bkgd,
                           compute_dtype=DTYPES[precision])
    plain = rk.render_fused_plain(*port_in, NF, white_bkgd, precision)
    wrapped = rk.render_fused(*port_in, NF, white_bkgd, precision)
    for got in (plain, wrapped):
        for g, r in zip(got, ref):
            r = np.asarray(r)
            atol = 2e-5 if precision == "fp32" else 2e-3 * np.abs(r).max()
            np.testing.assert_allclose(g.detach().numpy(), r, atol=atol, rtol=0)


def _tie_tree(seed):
    """tests/test_torch_kernel_gpu.py::tie_params as a JAX tree: density only
    where 0 < x < 1 (trunk unit 0 reads 64 sin(pi x), sigma = 16 |h_0|, the
    rest of the trunk zero), the view branch from JAX's init."""
    tree = jax.tree_util.tree_map(np.array, jmlp.init_network(jax.random.PRNGKey(seed)))
    for name, layer in tree.items():
        if name.startswith("trunk_") or name == "sigma":
            layer["w"][:] = 0.0
            layer["b"][:] = 0.0
            layer["w"][0, 0] = 1.0
    tree["trunk_0"]["w"][0, 0] = 64.0
    tree["sigma"]["w"][0, 0] = 16.0
    return tree


def _shape_inputs(kind, n_rays, n_coarse, seed=5):
    """(JAX inputs, the port's) of ``n_rays`` rays with ``n_coarse`` coarse
    t's: "view", the test view's rays (near/far 2/6) and a field with
    content; "ndc", those rays warped to NDC (``ndc_rays``, near plane 1,
    bounds 0 and 1); "ties", rays along -x on which every fine t equals the
    first coarse t (tests/test_torch_kernel_gpu.py::tie_inputs)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        tree = _tie_tree(seed)
        o = np.stack([2.0 + rng.uniform(0.004, 0.012, n_rays), rng.uniform(-1, 1, n_rays),
                      rng.uniform(-1, 1, n_rays)], 1).astype(np.float32)
        d = np.stack([-np.ones(n_rays), rng.uniform(-0.01, 0.01, n_rays),
                      rng.uniform(-0.01, 0.01, n_rays)], 1).astype(np.float32)
        near, far = np.full(n_rays, 2.0, np.float32), np.full(n_rays, 2.9, np.float32)
    else:
        _, tree = _field_with_content(seed)
        rows, cols, p17 = (torch.from_numpy(a) for a in _camera(rng, n_rays))
        o, d, near, far = raylib.pixels_to_rays(rows, cols, p17,
                                                       make_k_inv(16.0, 16.0, 19.2))
        if kind == "ndc":
            o, d = raylib.ndc_rays(16.0, 16.0, 19.2, 1.0, o, d)
            near, far = torch.zeros_like(near), torch.ones_like(far)
        o, d, near, far = (x.numpy() for x in (o, d, near, far))
    t_co = sampling.coarse_ts(torch.from_numpy(near), torch.from_numpy(far), n_coarse).numpy()
    jax_in = (jax.tree_util.tree_map(jnp.asarray, tree),
              *(jnp.asarray(x) for x in (o, d, t_co, near, far)))
    port_in = (ckpt.params_from_numpy(tree), *(torch.from_numpy(np.ascontiguousarray(x))
                                               for x in (o, d, t_co, near, far)))
    return jax_in, port_in


@pytest.mark.parametrize("kind,n_rays,n_coarse,n_fine,white_bkgd", [
    ("view", 5, 64, 64, True), ("ndc", 6, 8, 16, False), ("ndc", 3, 64, 128, True),
    ("ties", 4, 64, 128, False), ("ties", 3, 8, 16, True)])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_matches_jax_at_the_card_cases_shapes(kind, n_rays, n_coarse, n_fine,
                                                      white_bkgd, precision):
    """The plain version that the card holds kernel 9 to, against the JAX
    kernel at the card cases' new shapes, a few rays each: 64 + 64 samples,
    NDC rays with bounds 0 and 1, and rays whose every fine t ties with
    their first coarse t (coarse first: the plain version's stable sort;
    the JAX kernel's masks). fp32 within 2e-5, bf16 within 2e-3 of
    max|ref|, as ``test_forward_matches_jax``. At the ties the colors
    cannot tell the orders apart (the tied samples share a point); the
    JAX kernel's backward splits a tied delta's gradient among the tied
    samples, so gradients there are compared on the card only, against the
    plain backward."""
    jax_in, port_in = _shape_inputs(kind, n_rays, n_coarse)
    ref = jrk.render_fused(*jax_in, n_fine, white_bkgd=white_bkgd,
                           compute_dtype=DTYPES[precision])
    c_co, c_fi, t_fi = rk.render_fused_ts(*port_in, n_fine, white_bkgd, precision)
    for g, r in zip((c_co, c_fi), ref):
        r = np.asarray(r)
        atol = 2e-5 if precision == "fp32" else 2e-3 * np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, atol=atol, rtol=0)
    assert torch.isfinite(c_fi).all()
    if kind == "ties":
        t_co = port_in[3]
        assert torch.equal(t_fi, t_co[:, :1].expand_as(t_fi))
        assert float(c_fi.abs().max()) > 1e-2   # the tied sample carries the color


def test_plain_path_takes_shapes_the_kernels_refuse():
    """On CPU tensors ``render_fused`` is the plain version at any sample
    count: 2 + 6000 samples, whose per-ray state fits no block of either
    kernel (the card refuses it by name, tests/test_torch_kernel_gpu.py)."""
    _, (params, *prays) = _shape_inputs("view", 2, 2)
    got = rk.render_fused(params, *prays, 6000, True, "fp32")
    want = rk.render_fused_plain(params, *prays, 6000, True, "fp32")
    assert all(torch.equal(a, b) and torch.isfinite(a).all() for a, b in zip(got, want))
    assert rk.render_fused.launches == 0


def test_render_fused_bwd_ts_is_the_plain_backward_and_ts(rays):
    """On CPU tensors ``render_fused_bwd_ts`` gives the plain backward and the
    plain forward's fine t's (the card holds kernel 10's to kernel 9's bit
    for bit)."""
    _, (params, *prays) = rays
    g = [torch.from_numpy(np.random.default_rng(11).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    grads, t_fi = rk.render_fused_bwd_ts(params, *prays, *g, NF, True, "bf16")
    plain = rk.render_fused_bwd_plain(params, *prays, *g, NF, True, "bf16")
    assert all(torch.equal(grads[n][k], plain[n][k]) for n in plain for k in ("w", "b"))
    assert torch.equal(t_fi, rk.render_fused_ts(params, *prays, NF, True, "bf16")[2])
    assert rk.render_fused_bwd.launches == 0


def test_phase_shares_from_the_clock_arrays():
    """``fwd_phase_split``'s arithmetic on made-up clocks: each phase's share
    of the summed block cycles, and the share of the tail phases' warp
    cycles spent waiting (1 - busy / (warps x cycles))."""
    import ctypes
    blocks = 4096
    n = blocks * len(rk.PHASES)
    clocks, busy = (ctypes.c_longlong * n)(), (ctypes.c_longlong * n)()
    for block in (0, blocks - 1):
        for i, c in enumerate((100, 10, 5, 200, 20)):
            clocks[block * len(rk.PHASES) + i] = c
        for name, b in (("coarse weights", 80), ("resample", 40), ("merge", 160)):
            busy[block * len(rk.PHASES) + rk.PHASES.index(name)] = b
    split = rk.phase_shares(clocks, busy, 16)
    assert split["coarse field"] == pytest.approx(100 / 335)
    assert split["fine field"] == pytest.approx(200 / 335)
    assert sum(split[p] for p in rk.PHASES) == pytest.approx(1.0)
    assert split["tail warps waiting"] == pytest.approx(1 - 280 / (16 * 35))


def test_empty_rays_match_jax(rays):
    """Rays the occupancy grid empties (near == far: zero deltas, zero
    weights, a zero slope) give finite colors equal to the JAX kernel's,
    and their fine t's stay at near."""
    (jparams, o, d, _, near, far), (params, *_) = rays
    far = far.at[:6].set(near[:6])
    t_co = jsampling.coarse_ts(near, far, NC)
    ref = jrk.render_fused(jparams, o, d, t_co, near, far, NF, white_bkgd=True,
                           compute_dtype=jnp.float32)
    port = [torch.tensor(np.asarray(x)) for x in (o, d, t_co, near, far)]
    got = rk.render_fused(params, *port, NF, True)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=0)
    _, _, t_co, near, far = port
    dense = torch.zeros_like(t_co)
    t_fi = sampling.resample(t_co, dense, (far - near) / (NC - 1), NF)
    assert torch.equal(t_fi[:6], near[:6, None].expand(6, NF))


def _cos_and_ratio(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb + 1e-30)), float(na / (nb + 1e-30))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_gradients_match_jax(rays, precision, white_bkgd):
    """``render_fused``'s gradient (its backward, ``render_fused_bwd`` ->
    the plain VJP here) against ``jax.grad`` of the JAX kernel: every weight
    and bias at cosine > 0.9999 and norm within 1% at fp32, cosine >= 0.999
    at bf16 (element by element is chaotic through the resampler's 1/(w +
    1e-7), tests/test_render_kernel.py:131-136)."""
    (jparams, *jrays), (params, *prays) = rays
    rng = np.random.default_rng(7)
    g_co, g_fi = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))

    def loss_k(p):
        c_co, c_fi = jrk.render_fused(p, *jrays, NF, white_bkgd=white_bkgd,
                                      compute_dtype=DTYPES[precision])
        return jnp.sum(c_co * g_co) + jnp.sum(c_fi * g_fi)

    ref = jax.grad(loss_k)(jparams)
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    c_co, c_fi = rk.render_fused(leaves, *prays, NF, white_bkgd, precision)
    ((c_co * torch.from_numpy(g_co)).sum() + (c_fi * torch.from_numpy(g_fi)).sum()).backward()
    for name in ref:
        for leaf in ("w", "b"):
            cos, ratio = _cos_and_ratio(leaves[name][leaf].grad.numpy(), ref[name][leaf])
            if precision == "fp32":
                assert cos > 0.9999 and abs(ratio - 1) < 1e-2, (name, leaf, cos, ratio)
            else:
                assert cos >= 0.999, (name, leaf, cos)


def test_backward_is_the_plain_vjp(rays):
    """On CPU tensors ``render_fused_bwd`` is ``render_fused_bwd_plain``, and
    autograd through ``render_fused`` gives exactly it."""
    _, (params, *prays) = rays
    rng = np.random.default_rng(8)
    g_co, g_fi = (torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
                  for _ in range(2))
    plain = rk.render_fused_bwd_plain(params, *prays, g_co, g_fi, NF, True, "fp32")
    wrapped = rk.render_fused_bwd(params, *prays, g_co, g_fi, NF, True, "fp32")
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    c_co, c_fi = rk.render_fused(leaves, *prays, NF, True)
    ((c_co * g_co).sum() + (c_fi * g_fi).sum()).backward()
    for name in params:
        for leaf in ("w", "b"):
            assert torch.equal(wrapped[name][leaf], plain[name][leaf])
            torch.testing.assert_close(leaves[name][leaf].grad, plain[name][leaf],
                                       atol=1e-7, rtol=1e-6)
    assert rk.render_fused.launches == rk.render_fused_bwd.launches == 0


def test_render_fused_ts_is_the_plain_forward(rays):
    """On CPU tensors ``render_fused_ts`` gives the plain colors and the
    resampler's fine t's, and the plain backward taken at those t's is the
    plain backward bit for bit."""
    _, (params, *prays) = rays
    c_co, c_fi, t_fi = rk.render_fused_ts(params, *prays, NF, True)
    plain = rk.render_fused_plain(params, *prays, NF, True)
    assert torch.equal(c_co, plain[0]) and torch.equal(c_fi, plain[1])
    assert t_fi.shape == (B, NF) and not t_fi.requires_grad
    g = [torch.from_numpy(np.random.default_rng(9).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    at_ts = rk.render_fused_bwd_plain(params, *prays, *g, NF, True, "fp32", t_fi)
    own = rk.render_fused_bwd_plain(params, *prays, *g, NF, True, "fp32")
    assert all(torch.equal(at_ts[n][k], own[n][k]) for n in own for k in ("w", "b"))
    assert rk.grads_agree(at_ts, own, "fp32")[0]
    assert rk.render_fused.launches == 0


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("fault", ["no_resampler_backward", "no_d_ts"])
def test_grads_agree_fails_a_planted_fault(rays, monkeypatch, precision, fault):
    """The check that holds the backward kernel against the plain backward
    (``grads_agree``) fails a gradient that drops the resampler's backward,
    or the fine field's d_ts, at the test's shapes."""
    _, (params, *prays) = rays
    g = [torch.from_numpy(np.random.default_rng(10).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    good = rk.render_fused_bwd_plain(params, *prays, *g, NF, False, precision)
    if fault == "no_resampler_backward":
        resample = sampling.resample
        monkeypatch.setattr(sampling, "resample", lambda *a: resample(*a).detach())
    else:
        field = mk.field_rays_plain
        monkeypatch.setattr(mk, "field_rays_plain",
                            lambda p, o, d, ts, prec: field(p, o, d, ts.detach(), prec))
    bad = rk.render_fused_bwd_plain(params, *prays, *g, NF, False, precision)
    assert rk.grads_agree(good, good, precision)[0]
    assert not rk.grads_agree(bad, good, precision)[0]


@pytest.mark.parametrize("which", ["origins", "dirs", "t_co", "near", "far"])
def test_ray_inputs_get_no_gradient(rays, which):
    """The rays, coarse t's and bounds are data: the JAX VJP gives them zeros,
    the port ``None``."""
    _, (params, *prays) = rays
    names = ("origins", "dirs", "t_co", "near", "far")
    args = [x.clone().requires_grad_(n == which) for n, x in zip(names, prays)]
    _, c_fi = rk.render_fused(params, *args, NF)
    c_fi.sum().backward()
    assert args[names.index(which)].grad is None


def test_flops_per_ray():
    assert rk.flops_per_ray(64, 128) == 1_182_976 * 192 == mk.flops_per_row() * 192



# ---------------------------------------------------------------- kernel 10 from residuals


def _merge_inputs(kind, white_bkgd, n_rays=6, n_coarse=NC, n_fine=NF, seed=21):
    """Seeded inputs of the merge's backward (numpy, float32): t_co, t_fi,
    sig_co, sig_fi, col_co (3, B, N_c), col_fi (3, B, N_f), near, far,
    g_cco, g_cfi. "plain": both lists sorted, no ties; "ties": each ray's
    fine list starts at its first coarse t, the rest after it; "unsorted":
    the coarse list reversed and the fine one shuffled."""
    rng = np.random.default_rng(seed + 2 * ["plain", "ties", "unsorted"].index(kind)
                                + int(white_bkgd))
    f32 = lambda x: np.asarray(x, np.float32)
    near, far = f32(np.full(n_rays, 2.0)), f32(np.full(n_rays, 6.0))
    t_co = f32(2.0 + 4.0 * (np.arange(n_coarse) + rng.uniform(0, 1, (n_rays, n_coarse)))
               / n_coarse)
    t_fi = np.sort(f32(rng.uniform(2.0, 6.0, (n_rays, n_fine))), axis=1)
    if kind == "ties":
        rest = np.sort(rng.uniform(t_co[:, :1] + 1e-3, 6.0, (n_rays, n_fine - 1)), axis=1)
        t_fi = np.concatenate([t_co[:, :1], f32(rest)], 1)
    if kind == "unsorted":
        t_co = t_co[:, ::-1].copy()
        t_fi = np.stack([row[rng.permutation(n_fine)] for row in t_fi])
    sig_co, sig_fi = (f32(rng.uniform(0, 3, (n_rays, n))) for n in (n_coarse, n_fine))
    col_co, col_fi = (f32(rng.uniform(0, 1, (3, n_rays, n))) for n in (n_coarse, n_fine))
    g_cco, g_cfi = (f32(rng.normal(size=(n_rays, 3))) for _ in range(2))
    return t_co, f32(t_fi), sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi


def _jax_merge_vjp(t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi,
                   white_bkgd):
    """The JAX package's merged composite and coarse composite
    (``tinynerf.core.render``), their VJP (``jax.vjp``) to (sig_co, sig_fi,
    col_co, col_fi, t_fi, the coarse weights) -> numpy arrays in
    ``MergeGrads``' order, and C_fine. The JAX merge takes sorted lists:
    each list is sorted stably first (the port's stable sort of the
    concatenation gives the same merged order) and the cotangents go back."""
    pc, pf = np.argsort(t_co, axis=1, kind="stable"), np.argsort(t_fi, axis=1, kind="stable")
    take = lambda x, p: np.take_along_axis(x, p if x.ndim == 2 else p[None], axis=-1)
    n_coarse = t_co.shape[1]
    w_co = jrender.get_density(jnp.asarray(((far - near) / n_coarse)[:, None]
                                           * np.ones_like(t_co)), jnp.asarray(sig_co))

    def f(s_co, s_fi, c_co, c_fi, tf, w):
        out_co = jrender.composite(w, tuple(c_co))
        if white_bkgd:
            out_co = out_co + (1.0 - jnp.sum(w, axis=1))[:, None]
        out_fi = jrender.merged_composite(jnp.asarray(take(t_co, pc)), tf, s_co, s_fi,
                                          tuple(c_co), tuple(c_fi), white_bkgd=white_bkgd)
        return out_co, out_fi

    ins = [take(sig_co, pc), take(sig_fi, pf), take(col_co, pc), take(col_fi, pf),
           take(t_fi, pf), np.asarray(take(np.asarray(w_co), pc))]
    (_, c_fi), vjp = jax.vjp(f, *(jnp.asarray(x) for x in ins))
    gs_co, gs_fi, gcol_co, gcol_fi, gt_fi, gw_co = (np.asarray(g) for g in vjp(
        (jnp.asarray(g_cco), jnp.asarray(g_cfi))))
    back = lambda x, p: np.put_along_axis(out := np.empty_like(x),
                                          p if x.ndim == 2 else np.broadcast_to(p, x.shape),
                                          x, axis=-1) or out
    g_fi = np.concatenate([back(gs_fi, pf)[None], back(gcol_fi, pf)])
    g_co = np.concatenate([back(gs_co, pc)[None], back(gcol_co, pc)])
    return (g_fi, back(gt_fi, pf), g_co, back(gw_co, pc)), np.asarray(c_fi)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("kind", ["plain", "ties", "unsorted"])
def test_merge_bwd_plain_matches_jax_vjp(kind, white_bkgd):
    """``merge_bwd_plain`` (kernel 10's merge launch in plain PyTorch)
    against ``jax.vjp`` of the JAX package's merged composite and coarse
    composite on seeded inputs: every hand-off plane within 1e-6 of its
    max|ref|, C_fine within 1e-6, at sorted lists, at a fine t tied with
    the first coarse one (the coarse sample first: the two orders give
    other deltas), and at unsorted lists. A tie later in the list is no
    case here: the JAX merge takes each delta's successor as a min, whose
    gradient splits between two tied successors, where the stable sort
    gives it to the first (the card cases hold such ties against the plain
    version). On CPU tensors ``merge_bwd`` is the plain version, bit for
    bit, and launches nothing."""
    inputs = _merge_inputs(kind, white_bkgd)
    ref, ref_c_fi = _jax_merge_vjp(*inputs, white_bkgd)
    port = [torch.from_numpy(np.ascontiguousarray(x)) for x in inputs]
    got = rk.merge_bwd_plain(*port, white_bkgd)
    for name, g, r in zip(rk.MergeGrads._fields, got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-6 * np.abs(r).max(), rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(got.c_fi.numpy(), ref_c_fi, atol=1e-6, rtol=0)
    wrapped = rk.merge_bwd(*port, white_bkgd)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert rk.merge_bwd.launches == 0


@pytest.mark.parametrize("fault", ["none", "gt_fi", "g_co"])
def test_merge_agreement_fails_a_planted_fault(fault):
    """The check that holds kernel 10's merge launch against the float64
    evaluation of its plain version (``merge_agreement``) passes the plain
    version itself and fails a plane moved by 1e-4 of its max at one
    element."""
    port = [torch.from_numpy(np.ascontiguousarray(x)) for x in _merge_inputs("plain", True)]
    got = rk.merge_bwd_plain(*port, True)
    if fault != "none":
        plane = getattr(got, fault)
        plane[(0,) * (plane.dim() - 1) + (3,)] += 1e-4 * plane.abs().max()
    ok, rows = rk.merge_agreement(got, *port, True)
    assert ok == (fault == "none"), rows
    assert set(rows) == {*rk.MergeGrads._fields[:4], "c_fi"}

def test_merge_bwd_plain_from_the_forwards_residuals(rays):
    """Fed the plain forward's residuals (``render_fused_residuals``), the
    merge's C_fine is the forward's bit for bit, and its hand-off planes
    are the plain backward's cotangents at the merged composite."""
    _, (params, o, d, t_co, near, far) = rays
    c_co, c_fi, res = rk.render_fused_residuals(params, o, d, t_co, near, far, NF, True)
    r = rk.split_residuals(res, B, NC, NF)
    assert r.t_fi.shape == (B, NF) and r.col_co.shape == (3, B, NC)
    assert r.col_fi.shape == (3, B, NF) and r.sig_co.shape == (B, NC)
    g = [torch.from_numpy(np.random.default_rng(12).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    out = rk.merge_bwd(t_co, r.t_fi, r.sig_co, r.sig_fi, r.col_co, r.col_fi, near, far, *g,
                       True)
    assert torch.equal(out.c_fi, c_fi)
    assert all(torch.isfinite(x).all() for x in out)
    with pytest.raises(ValueError, match="residual buffer"):
        rk.split_residuals(res[:-1], B, NC, NF)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_backward_runs_no_second_forward(rays, monkeypatch, precision):
    """On CPU tensors ``render_fused``'s backward starts from what its
    forward kept (the plain forward's graph, as the card keeps kernel 9's
    residuals): the plain field runs twice in the forward and not at all in
    the backward, and the gradient is the plain backward's."""
    _, (params, *prays) = rays
    calls = []
    field = mk.field_rays_plain

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return field(*a, **k)

    g = [torch.from_numpy(np.random.default_rng(13).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    plain = rk.render_fused_bwd_plain(params, *prays, *g, NF, True, precision)
    monkeypatch.setattr(mk, "field_rays_plain", counting)
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    c_co, c_fi = rk.render_fused(leaves, *prays, NF, True, precision)
    assert calls == [True, True]
    ((c_co * g[0]).sum() + (c_fi * g[1]).sum()).backward()
    assert calls == [True, True]
    for name in params:
        for leaf in ("w", "b"):
            assert torch.equal(leaves[name][leaf].grad, plain[name][leaf]), (name, leaf)


def test_second_backward_on_cpu(rays):
    """On CPU tensors a second backward through one ``render_fused`` graph
    gives the first's gradient again where the first retained the graph,
    and raises autograd's own error where it did not."""
    _, (params, *prays) = rays
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    c_co, c_fi = rk.render_fused(leaves, *prays, NF, True)
    flat = [leaves[name][k] for name, k in mk._PARAM_KEYS]
    loss = c_co.sum() + 2 * c_fi.sum()
    first = torch.autograd.grad(loss, flat, retain_graph=True)
    second = torch.autograd.grad(loss, flat)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    with pytest.raises(RuntimeError, match="second time"):
        torch.autograd.grad(loss, flat)


def test_no_grad_call_asks_for_no_residuals(rays, monkeypatch):
    """``render_fused`` asks kernel 9 for its residuals only where a
    backward can follow: under ``torch.no_grad()`` (every frame) or with no
    param requiring grad it launches kernel 9 as a frame does, and on the
    CPU the plain forward keeps no graph. The card's branch is driven here
    with a stand-in launch that records what it was asked."""
    _, (params, *prays) = rays
    asked = []

    def launch(p, *args, residuals=False, defines=()):
        asked.append(residuals)
        c_co, c_fi, _, res = rk._plain(p, *args, residuals=True)
        return (c_co, c_fi, res) if residuals else (c_co, c_fi)

    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    with torch.no_grad():
        out = rk.render_fused(leaves, *prays, NF, True)
    assert not any(x.requires_grad for x in out)
    monkeypatch.setattr(rk, "_launch", launch)
    monkeypatch.setattr(mk, "_on_one_device", lambda tensors, what: True)
    with torch.no_grad():
        rk.render_fused(leaves, *prays, NF, True)
    rk.render_fused(params, *prays, NF, True)
    c_co, _ = rk.render_fused(leaves, *prays, NF, True)
    assert asked == [False, False, True]
    assert c_co.requires_grad


def test_backward_from_residuals_on_cpu(rays):
    """On CPU tensors ``render_fused_bwd`` and ``render_fused_bwd_ts`` with
    ``residuals=`` take the plain backward at the residuals' fine t's, and
    without them the plain forward's own: the same gradients, since the
    plain forward made the residuals."""
    _, (params, *prays) = rays
    g = [torch.from_numpy(np.random.default_rng(14).normal(size=(B, 3)).astype(np.float32))
         for _ in range(2)]
    _, _, res = rk.render_fused_residuals(params, *prays, NF, False, "bf16")
    t_fi = rk.split_residuals(res, B, NC, NF).t_fi
    grads, ts = rk.render_fused_bwd_ts(params, *prays, *g, NF, False, "bf16", residuals=res)
    own = rk.render_fused_bwd(params, *prays, *g, NF, False, "bf16")
    at_ts = rk.render_fused_bwd_plain(params, *prays, *g, NF, False, "bf16", t_fi)
    assert torch.equal(ts, t_fi)
    for n in own:
        for k in ("w", "b"):
            assert torch.equal(grads[n][k], at_ts[n][k]) and torch.equal(grads[n][k], own[n][k])
    assert rk.render_fused.launches == rk.render_fused_bwd.launches == 0

# ---------------------------------------------------------------- in the renderer


def _fused_field(calls):
    """The port's fp32 kernel field with ``render_fused``, each call of which
    appends to ``calls``."""
    fn = functools.partial(mk.field_flat, precision="fp32")
    fn.eval_rays = functools.partial(mk.field_rays, precision="fp32")

    def counting(*a, **k):
        calls.append(1)
        return rk.render_fused(*a, **k)

    fn.render_fused = counting
    return fn


def _render_inputs(n=B, seed=3):
    """(rows, cols, pose17, k_inv) of n pixels of the test view."""
    rows, cols, p17 = (torch.from_numpy(a) for a in _camera(np.random.default_rng(seed), n))
    return rows, cols, p17, make_k_inv(16.0, 16.0, 19.2)


def test_fused_composes_with_the_occupancy_grid(rays):
    """``render_rays`` routes through the fused renderer after
    ``tighten_bounds``: an all-occupied grid leaves the result as it was
    (tests/test_render_kernel.py::test_fused_composes_with_occ_grid)."""
    _, (params, *_) = rays
    calls = []
    field_fn, inputs = _fused_field(calls), _render_inputs()
    base = render.render_rays(params, *inputs, NC, NF, field_fn=field_fn,
                              merge_impl="twolist")
    grid = occupancy.init_grid(resolution=8, half_extent=8.0)
    with_occ = render.render_rays(params, *inputs, NC, NF, field_fn=field_fn,
                                  merge_impl="twolist", occ_grid=grid, occ_march=32)
    np.testing.assert_allclose(with_occ[1].numpy(), base[1].numpy(), atol=1e-6)
    assert len(calls) == 2


@pytest.mark.parametrize("kwargs,routed", [
    ({"merge_impl": "twolist"}, True), ({}, False), ({"merge_impl": "permute"}, False),
    ({"merge_impl": "twolist", "compat_sort": True}, False),
    ({"merge_impl": "twolist", "extras": True}, False),
    ({"merge_impl": "twolist", "n_fine": 0}, False),
    ({"merge_impl": "twolist", "prop_params": "proposal"}, False)])
def test_fused_routing_frames_only(rays, kwargs, routed):
    """As tests/test_render_kernel.py::test_fused_routing_eval_only: a field
    with ``render_fused`` takes the fused branch under the ``twolist`` merge
    alone (frames). The default merge is ``permute``, as in the JAX package,
    so training never reaches it; ``compat_sort``, extras, ``n_fine = 0``
    and a proposal field keep the unfused march."""
    _, (params, *_) = rays
    calls = []
    field_fn = _fused_field(calls)
    kwargs = dict(kwargs)
    n_fine = kwargs.pop("n_fine", NF)
    if kwargs.get("prop_params") == "proposal":
        from tinynerf_torch.core import proposal
        kwargs["prop_params"] = proposal.init_proposal(torch.Generator().manual_seed(0), 32, 2)
    out = render.render_rays(params, *_render_inputs(), NC, n_fine, field_fn=field_fn,
                             **kwargs)
    assert len(calls) == int(routed)
    assert all(torch.isfinite(x).all() for x in out)
    if routed:
        unfused = render.render_rays(params, *_render_inputs(), NC, NF,
                                     field_fn=render.field_plain, merge_impl="twolist")
        for a, b in zip(out, unfused):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_check_supported_accepts_fused_render_and_attaches_it():
    """``FUSED_RENDER`` is no longer refused; with ``USE_PALLAS`` the MLP
    field carries ``render_fused`` at ``PRECISION`` (``tinynerf/train.py:
    172-179``), without it none."""
    from tinynerf_torch.config import Config
    for precision in ("fp32", "bf16"):
        cfg = Config(fused_render=True, precision=precision)
        evallib.check_supported(cfg)
        fn = evallib.make_field_fn(cfg)
        assert fn.render_fused.func is rk.render_fused
        assert fn.render_fused.keywords == {"precision": precision}
    assert not hasattr(evallib.make_field_fn(Config(fused_render=True, use_pallas=False)),
                       "render_fused")
    assert not hasattr(evallib.make_field_fn(Config()), "render_fused")


# ---------------------------------------------------------------- frames


def _field_with_content(seed):
    """JAX init with the sigma bias raised by 1 (tests/test_torch_render.py::
    field_with_content): (JAX params, numpy tree)."""
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(seed)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_runner_renders_the_fused_frame_of_jax(tmp_path, monkeypatch, white_bkgd):
    """A Runner with ``FUSED_RENDER = True`` resumes a checkpoint and renders
    a 16x16 view through ``render_fused``, one call a ``RENDER_CHUNK``
    chunk; the frame matches JAX's fused frame (``make_frame_fn`` with
    ``train.make_field_fn(cfg, force_pallas=True)``, one kernel call over the
    frame) on the same params within 1e-4 a pixel."""
    from tests.util import make_sync_scene
    make_sync_scene(str(tmp_path / "scene"), n_pics=2, hw=16)
    lines = ["[scene]", f"IMG_DIR = {tmp_path}/scene/", f"RESULTS_PATH = {tmp_path}/results/",
             f"CKPT_PATH = {tmp_path}/ckpt/", "N_COARSE = 8", "N_FINE = 16",
             "RENDER_CHUNK = 96", "DATA_TYPE = sync", "CONTINUE = True",
             "FUSED_RENDER = True", f"WHITE_BKGD = {white_bkgd}"]
    (tmp_path / "scene.ini").write_text("\n".join(lines) + "\n")
    cfg = load_config(str(tmp_path / "scene.ini"))
    jparams, tree = _field_with_content(9)
    ckpt.save_checkpoint(cfg.ckpt_path, "run", 5, ckpt.params_from_numpy(tree))
    calls = []
    inner = rk.render_fused

    def counting(*a, **k):
        calls.append(a[1].shape[0])
        return inner(*a, **k)

    monkeypatch.setattr(rk, "render_fused", counting)
    runner = Runner(cfg, device="cpu")
    frames = evallib.render_test_set(cfg, runner.params, runner.test_table, runner.k_inv,
                                     runner.start_time, runner.last_iter, save=False,
                                     max_views=1)
    assert calls == [96, 96, 96]   # 256 pixels in chunks of 96, the last padded
    H, W = runner.test_table.height, runner.test_table.width
    assert (H, W) == (16, 16)
    jcfg = JConfig(n_coarse=8, n_fine=16, render_chunk=96, fused_render=True,
                   white_bkgd=white_bkgd)
    jfield = jtrain.make_field_fn(jcfg, force_pallas=True)
    k_inv = jnp.asarray(runner.k_inv.numpy())
    ref = jeval.make_frame_fn(jcfg, k_inv, H, W, field_fn=jfield)(
        jparams, jnp.asarray(runner.test_table.poses[0].numpy()))
    np.testing.assert_allclose(frames[0], np.clip(np.asarray(ref), 0, 1), atol=PIXEL_ATOL,
                               rtol=0)
