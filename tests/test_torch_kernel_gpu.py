"""The CUDA field kernels (the ray-major forward and backward, the flat
forward and backward; fp32 and bf16) against their plain PyTorch versions,
on the card.

This file imports neither JAX nor ``tinynerf``, so it also runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Without a card the test skips itself.
"""

import numpy as np
import pytest
import torch

from tinynerf_torch.core import mlp
from tinynerf_torch.kernels import mlp_kernel as mk


def _dyadic_rays(seed, B, N):
    """Coordinates quantized to 1/16, so o + t*d is exact in float32."""
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (B, N))).astype(np.float32), axis=1)
    return origins, dirs, ts


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(4096, 64), (4096, 128), (13, 7)])
def test_kernel_matches_plain_on_card(n_rays, n_samples):
    """At the render path's shapes (B=4096, N=64 and 128) and at a ragged
    one. Tolerances: color 1e-5, sigma 1e-4 abs + 1e-4 rel; cuBLAS and the
    kernel sum in different orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_samples, n_rays, n_samples))
    before = mk.field_rays.launches
    with torch.no_grad():
        planes, sigma = mk.field_rays(params, o, d, t)
        p_planes, p_sigma = mk.field_rays_plain(params, o, d, t)
    torch.cuda.synchronize()
    assert mk.field_rays.launches == before + 1
    for a, b in zip(planes, p_planes):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(sigma, p_sigma, atol=1e-4, rtol=1e-4)


def _errors(kernel, plain):
    """error / max|plain| for every output of field_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    return {name: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for name, a, b in pairs}


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [
    (400, 64), (400, 128), (600, 128), (13, 7), (5, 100)])
def test_bwd_kernel_matches_plain_on_card(n_rays, n_samples):
    """At a training step's shapes (B=400, N=64 and 128), across two chunks
    of rows (600 x 128 > 65,536) and at ragged ones: every gradient within
    1e-4 of max|plain|. Rows whose smallest |pre-activation| is under 2e-6
    get zero cotangents: there the two float32 sums may take the other side
    of a ReLU, which is not a fault of either. Two calls agree bit for bit
    (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = mlp.init_network(torch.Generator().manual_seed(1), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_rays, n_rays, n_samples))
    keep = (mk.preactivation_margin(params, o, d, t) > 2e-6).float()
    rng = np.random.default_rng(n_samples)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
            for _ in range(4)]
    before = mk.field_rays_bwd.launches
    kernel = mk.field_rays_bwd(params, o, d, t, *cots)
    again = mk.field_rays_bwd(params, o, d, t, *cots)
    plain = mk.field_rays_bwd_plain(params, o, d, t, *cots)
    torch.cuda.synchronize()
    assert mk.field_rays_bwd.launches == before + 2
    errors = _errors(kernel, plain)
    assert max(errors.values()) <= 1e-4, errors
    assert all(e == 0 for e in _errors(kernel, again).values())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("form,n_rays,n_samples", [
    ("rays", 333, 37), ("rays", 1, 200), ("rays", 520, 127), ("flat", 4097, 1),
    ("flat", 65537, 1)])
def test_fp32_bwd_tile_edges_on_card(form, n_rays, n_samples):
    """The fp32 form of kernels 2 ("rays") and 4 ("flat") at the edges of
    their tiles: 12,321 rows (no multiple of the 32-row weight-gradient
    K-slab, of the 128-row recompute tile, of the 128-wide output tile or
    of SPLIT_ROWS, and several row slices), one ray of 200 rows (two
    128-row tiles, so two blocks share the ray and ray_sums_kernel adds
    its samples from both), 66,040 and 65,537 rows (two chunks of
    CHUNK_ROWS, the second a few rays or one row), 4097 rows (one past
    SPLIT_ROWS). Every
    gradient within 1e-4 of max|plain|, rows within 2e-6 of a kink given no
    cotangent; two calls bit-identical."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(5), dev)
    rng = np.random.default_rng(n_rays)
    if form == "rays":
        o, d, t = (torch.from_numpy(a).to(dev)
                   for a in _dyadic_rays(n_rays, n_rays, n_samples))
        keep = (mk.preactivation_margin(params, o, d, t) > 2e-6).float()
        cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        run = lambda: mk.field_rays_bwd(params, o, d, t, *cots)
        plain = mk.field_rays_bwd_plain(params, o, d, t, *cots)
    else:
        pts, dirs = (torch.from_numpy(a).to(dev) for a in contracted_rows(rng, n_rays))
        keep = mk.preactivation_margin(params, pts, dirs, pts.new_zeros(n_rays, 1)) > 2e-6
        g = torch.from_numpy(rng.normal(size=(n_rays, 4)).astype(np.float32)).to(dev)
        g = g * keep.float()
        run = lambda: mk.field_flat_bwd(params, pts, dirs, g)
        plain = mk.field_flat_bwd_plain(params, pts, dirs, g)
    kernel, again = run(), run()
    torch.cuda.synchronize()
    errors = _errors(kernel, plain)
    worst = max(errors, key=errors.get)
    print(f"fp32 bwd edges {form} {n_rays}x{n_samples}: worst {worst} {errors[worst]:.3e}")
    assert errors[worst] <= 1e-4, errors
    assert all(e == 0 for e in _errors(kernel, again).values())


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# bf16: kernel and plain version round at the same points and sum in other
# orders, which can move a rounded activation by one bf16 ulp (2^-8
# relative) and flip a ReLU; errors are relative to max|plain|. The
# backward's recompute re-sums the forward outputs whose rounding is
# ambiguous in the plain version's order (csrc/field_tc.cuh, the fix-up).
BF16_FWD_RTOL = 1e-2
BF16_BWD_RTOL = 3e-2
BF16_COS = 0.999


def _grid_probes(rng, R):
    """Points in the occupancy grid's cube [-1.5, 1.5]^3, direction +z, as
    the grid refresh probes the field."""
    pts = rng.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    dirs = np.broadcast_to(np.float32([0, 0, 1]), (R, 3)).copy()
    return pts, dirs


@pytest.mark.gpu
@pytest.mark.parametrize("precision,R", [
    ("fp32", 32768), ("fp32", 13), ("bf16", 32768), ("bf16", 1001), ("bf16", 1016)])
def test_flat_kernel_matches_plain_on_card(precision, R):
    """Kernel 3 (the flat field forward) at one grid refresh's R = 32,768
    probes and at ragged R. fp32: color 1e-5, sigma 1e-4 abs + 1e-4 rel, as
    kernel 1; bf16: each output within BF16_FWD_RTOL of max|plain|."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(2), dev)
    pts, dirs = (torch.from_numpy(a).to(dev)
                 for a in _grid_probes(np.random.default_rng(R), R))
    before = mk.field_flat.launches
    with torch.no_grad():
        color, sigma = mk.field_flat(params, pts, dirs, precision)
        p_color, p_sigma = mk.field_flat_plain(params, pts, dirs, precision)
    torch.cuda.synchronize()
    assert mk.field_flat.launches == before + 1
    assert color.shape == (R, 3) and sigma.shape == (R, 1)
    if precision == "fp32":
        torch.testing.assert_close(color, p_color, atol=1e-5, rtol=0)
        torch.testing.assert_close(sigma, p_sigma, atol=1e-4, rtol=1e-4)
    else:
        errs = (_rel(color, p_color), _rel(sigma, p_sigma))
        print(f"flat bf16 R={R}: color {errs[0]:.3e} sigma {errs[1]:.3e}")
        assert max(errs) <= BF16_FWD_RTOL, errs
    # under autograd the backward is kernel 4's launch
    before = mk.field_flat_bwd.launches
    pts_g = pts.clone().requires_grad_(True)
    _, sigma_g = mk.field_flat(params, pts_g, dirs, precision)
    (g,) = torch.autograd.grad(sigma_g.sum(), pts_g)
    torch.cuda.synchronize()
    assert mk.field_flat_bwd.launches == before + 1
    assert torch.isfinite(g).all()


def _flat_errors(kernel, plain):
    """error / max|plain| and the cosine, for every output of field_flat_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_points", "d_dirs"), k_rest, p_rest))
    return {name: (_rel(a, b), float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))) for name, a, b in pairs}


def contracted_rows(rng, R):
    """Rows as the renderer hands them to the field under CONTRACT: points
    in the contracted radius-2 ball, unit directions."""
    d = rng.normal(size=(R, 3))
    radius = rng.uniform(0.0, 2.0, (R, 1))
    pts = (d / np.linalg.norm(d, axis=-1, keepdims=True) * radius).astype(np.float32)
    v = rng.normal(size=(R, 3))
    return pts, (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("R", [524288, 1001, 1016])
def test_flat_bwd_kernel_matches_plain_on_card(precision, R):
    """Kernel 4 (the flat field's recompute backward) at an unbounded360-mlp
    step's fine rows (4096 x 128 = 524,288, eight chunks of rows) and at a
    ragged R. fp32: every gradient within 1e-4 of max|plain|; bf16: within
    BF16_BWD_RTOL of max|plain| and at cosine >= BF16_COS. Rows whose
    smallest |pre-activation| in the form compared is under 2e-6 get zero
    cotangents (at bf16 too: with 1001 rows one row's ReLU taking the other
    side moves a bias gradient by 3.8% of its max). Two calls agree bit for
    bit."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(3), dev)
    rng = np.random.default_rng(R)
    pts, dirs = (torch.from_numpy(a).to(dev) for a in contracted_rows(rng, R))
    g = torch.from_numpy(rng.normal(size=(R, 4)).astype(np.float32)).to(dev)
    keep = mk.preactivation_margin(params, pts, dirs, pts.new_zeros(R, 1), precision) > 2e-6
    g = g * keep.float()
    before = mk.field_flat_bwd.launches
    kernel = mk.field_flat_bwd(params, pts, dirs, g, precision)
    again = mk.field_flat_bwd(params, pts, dirs, g, precision)
    plain = mk.field_flat_bwd_plain(params, pts, dirs, g, precision)
    torch.cuda.synchronize()
    assert mk.field_flat_bwd.launches == before + 2
    errors = _flat_errors(kernel, plain)
    worst = max(errors, key=lambda k: errors[k][0])
    cos = min(e[1] for e in errors.values())
    print(f"flat bwd {precision} R={R}: worst {worst} {errors[worst][0]:.3e}, "
          f"min cosine {cos:.7f}")
    if precision == "fp32":
        assert errors[worst][0] <= 1e-4, errors
    else:
        assert errors[worst][0] <= BF16_BWD_RTOL, errors
        assert cos >= BF16_COS, errors
    assert all(e[0] == 0 for e in _flat_errors(kernel, again).values())


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(4096, 64), (4096, 128), (13, 7)])
def test_bf16_kernel_matches_plain_on_card(n_rays, n_samples):
    """Kernel 1 in its bf16 form at the training step's B = 4096 (N = 64,
    128) and a ragged shape: each plane within BF16_FWD_RTOL of max|plain|."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_samples, n_rays, n_samples))
    before = mk.field_rays.launches
    with torch.no_grad():
        (r, g, b), sigma = mk.field_rays(params, o, d, t, "bf16")
        (pr, pg, pb), p_sigma = mk.field_rays_plain(params, o, d, t, "bf16")
    torch.cuda.synchronize()
    assert mk.field_rays.launches == before + 1
    errs = [_rel(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))]
    print(f"rays bf16 B={n_rays} N={n_samples}: r g b sigma {errs}")
    assert max(errs) <= BF16_FWD_RTOL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(4096, 64), (600, 128), (13, 7)])
def test_bf16_bwd_kernel_matches_plain_on_card(n_rays, n_samples):
    """Kernel 2 in its bf16 form at B = 4096, N = 64, across two chunks of
    rows and at a ragged shape: every gradient within BF16_BWD_RTOL of
    max|plain| and at cosine >= BF16_COS. The weight gradients stay
    float32. Two calls agree bit for bit."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(1), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_rays, n_rays, n_samples))
    rng = np.random.default_rng(n_samples)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev)
            for _ in range(4)]
    before = mk.field_rays_bwd.launches
    kernel = mk.field_rays_bwd(params, o, d, t, *cots, precision="bf16")
    again = mk.field_rays_bwd(params, o, d, t, *cots, precision="bf16")
    plain = mk.field_rays_bwd_plain(params, o, d, t, *cots, precision="bf16")
    torch.cuda.synchronize()
    assert mk.field_rays_bwd.launches == before + 2
    errors = _errors(kernel, plain)
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")] + list(zip(k_rest, p_rest))
    cos = min(float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0)) for a, b in pairs)
    worst = max(errors, key=errors.get)
    print(f"bwd bf16 B={n_rays} N={n_samples}: worst {worst} {errors[worst]:.3e}, "
          f"d_ts {errors['d_ts']:.3e}, min cosine {cos:.6f}")
    assert errors[worst] <= BF16_BWD_RTOL, errors
    assert cos >= BF16_COS
    assert all(e == 0 for e in _errors(kernel, again).values())


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(1001, 37), (37, 129)])
def test_bf16_mma_tile_edges_on_card(n_rays, n_samples):
    """Kernels 1 and 2 in their bf16 form, whose products run on the tensor
    cores in 16-row fragments of 64-row tiles, at row counts that are no
    multiple of 16 or of 64 (37,037 rows; and 4,773 rows at N = 129, where
    one ray spans three tiles of the backward): the forward within
    BF16_FWD_RTOL of max|plain|; the backward within BF16_BWD_RTOL and at
    cosine >= BF16_COS, rows within 2e-6 of a kink in the bf16 form given
    no cotangent (as kernel 4's check); two backward calls bit-identical."""
    dev = _card()
    params = mlp.init_network(torch.Generator().manual_seed(4), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_samples, n_rays, n_samples))
    with torch.no_grad():
        (r, g, b), sigma = mk.field_rays(params, o, d, t, "bf16")
        (pr, pg, pb), p_sigma = mk.field_rays_plain(params, o, d, t, "bf16")
    fwd = [_rel(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))]
    keep = (mk.preactivation_margin(params, o, d, t, "bf16") > 2e-6).float()
    rng = np.random.default_rng(n_rays)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
            for _ in range(4)]
    kernel = mk.field_rays_bwd(params, o, d, t, *cots, precision="bf16")
    again = mk.field_rays_bwd(params, o, d, t, *cots, precision="bf16")
    plain = mk.field_rays_bwd_plain(params, o, d, t, *cots, precision="bf16")
    torch.cuda.synchronize()
    (kg, *k_rest), (pg_, *p_rest) = kernel, plain
    pairs = [(kg[n][k], pg_[n][k]) for n in pg_ for k in ("w", "b")] + list(zip(k_rest, p_rest))
    cos = min(float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0)) for a, b in pairs)
    errors = _errors(kernel, plain)
    worst = max(errors, key=errors.get)
    print(f"mma edges B={n_rays} N={n_samples}: forward {max(fwd):.3e}; backward worst "
          f"{worst} {errors[worst]:.3e}, min cosine {cos:.7f}")
    assert max(fwd) <= BF16_FWD_RTOL, fwd
    assert errors[worst] <= BF16_BWD_RTOL, errors
    assert cos >= BF16_COS
    assert all(e == 0 for e in _errors(kernel, again).values())


# ---------------------------------------------------------------- the grid field

from tinynerf_torch.core import gridfield  # noqa: E402
from tinynerf_torch.kernels import grid_kernel as gk  # noqa: E402

GRID = {"fine": (256, 64, 64, 128),   # conf/lego_grid.ini's fine grid
        "prop": (64, 16, 16, 16),     # its proposal grid
        "hybrid": (384, 64, 64, 128)}  # conf/lego_hybrid.ini's resolution: a 590 KB partial
GRID_MARGIN = 1e-5   # rows this close to a ReLU's kink or to sigma = 0: no cotangent


def _grid_params(geometry, dev, seed):
    """Seeded weights, the density columns scaled by 3 (a grid with content)."""
    res, nd, na, width = GRID[geometry]
    params = gridfield.init_grid_field(torch.Generator().manual_seed(seed), res=res,
                                       n_density=nd, n_app=na, decoder_width=width,
                                       device=dev)
    for ax in gridfield.AXES:
        params["lines"][ax][:, :nd] *= 3.0
    return params, nd


def _grid_rays(seed, B, N):
    """Dyadic rays through [-1.5, 1.5]^3 and out of it (clipped points)."""
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(0.0, 2.5, (B, N))).astype(np.float32), axis=1)
    return origins, dirs, ts


def _one_cell_rays(seed, B, N):
    """Rays whose samples, 2^-16 apart, all fall in one cell of the fine grid
    (or two, where a ray starts by a cell's edge): the longest runs of rows
    that the backward's table gradient merges."""
    origins, dirs, ts = _grid_rays(seed, B, 1)
    return origins, dirs, ts + np.arange(N, dtype=np.float32) * np.float32(2.0 ** -16)


def _node_rays(N):
    """Axis-aligned rays on the fine grid's nodes 85 and 170 (+-0.5), on the
    clip boundary (+-1.5) and outside it."""
    o = np.float32([[-2.0, 0.5, 0.5], [0.5, -2.0, -0.5], [-0.5, 0.5, -2.0],
                    [-2.0, 1.5, -1.5]])
    d = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]])
    t = np.float32([0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.5, 3.75])[:N]
    return o, d, np.tile(t, (len(o), 1))


def _grid_errors(kernel, plain):
    """error / max|plain| and the cosine, for every output of grid_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"lines.{ax}", kg["lines"][ax], pg["lines"][ax]) for ax in gridfield.AXES]
    pairs += [(f"{n}.{k}", kg["decoder"][n][k], pg["decoder"][n][k])
              for n in ("hidden", "color") for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts", "d_de"), k_rest, p_rest))
    return {name: (_rel(a, b), float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))) for name, a, b in pairs}


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry,n_rays,n_samples", [
    ("fine", 4096, 128), ("prop", 4096, 64), ("fine", 13, 7), ("prop", 37, 5),
    ("fine", "nodes", 8), ("fine", "cell", 128), ("fine", 300, 100), ("fine", 300, 200),
    ("fine", 1, 128), ("prop", 13, 64), ("hybrid", 1024, 128)])
def test_grid_kernels_match_plain_on_card(geometry, n_rays, n_samples, precision):
    """Kernels 5 and 6 at conf/lego_grid.ini's fine (N = 128) and proposal
    (N = 64) grids at B = 4096, at ragged shapes and at grid-node hits and
    the clip boundary; and at the edges of the tiles and the table
    gradient's run merging: rays whose samples all fall in one cell, rays of
    N = 100 and 200 (across the 64-row tiles), fewer rays than the
    backward's slices (B = 1, 13), and R = 384 (lego_hybrid.ini). fp32: color 1e-5, sigma 1e-4 abs + 1e-4 rel, every
    gradient within 1e-4 of max|plain|; bf16: each output within
    BF16_FWD_RTOL, each gradient within BF16_BWD_RTOL of max|plain| and at
    cosine >= BF16_COS. Rows within 1e-5 of a ReLU kink or of sigma = 0 get
    zero cotangents. Two backward calls agree bit for bit."""
    dev = _card()
    params, nd = _grid_params(geometry, dev, seed=n_samples)
    rays = (_node_rays(n_samples) if n_rays == "nodes"
            else _one_cell_rays(7, 512, n_samples) if n_rays == "cell"
            else _grid_rays(7, n_rays, n_samples))
    o, d, t = (torch.from_numpy(a).to(dev) for a in rays)
    de = gk.encoding.encode_dirs(d)
    before = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
    with torch.no_grad():
        (r, g, b), sigma = gk.grid_rays(params, o, d, t, nd, precision)
        (pr, pg, pb), p_sigma = gk.grid_rays_plain(params, o, d, t, de, nd, precision)
    torch.cuda.synchronize()
    if precision == "fp32":
        for a, p in ((r, pr), (g, pg), (b, pb)):
            torch.testing.assert_close(a, p, atol=1e-5, rtol=0)
        torch.testing.assert_close(sigma, p_sigma, atol=1e-4, rtol=1e-4)
    else:
        errs = [_rel(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))]
        assert max(errs) <= BF16_FWD_RTOL, errs
    keep = (gk.preactivation_margin(params, o, d, t, nd, precision) > GRID_MARGIN).float()
    rng = np.random.default_rng(3)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
            for _ in range(4)]
    kernel = gk.grid_rays_bwd(params, o, d, t, de, *cots, n_density=nd, precision=precision)
    again = gk.grid_rays_bwd(params, o, d, t, de, *cots, n_density=nd, precision=precision)
    plain = gk.grid_rays_bwd_plain(params, o, d, t, de, *cots, n_density=nd,
                                   precision=precision)
    torch.cuda.synchronize()
    assert (gk.grid_rays.launches, gk.grid_rays_bwd.launches) == (before[0] + 1, before[1] + 2)
    errors = _grid_errors(kernel, plain)
    worst = max(errors, key=lambda k: errors[k][0])
    print(f"grid {geometry} {precision} B={n_rays} N={n_samples}: worst {worst} "
          f"{errors[worst][0]:.3e}, min cosine {min(e[1] for e in errors.values()):.7f}")
    if precision == "fp32":
        assert errors[worst][0] <= 1e-4, errors
    else:
        assert errors[worst][0] <= BF16_BWD_RTOL, errors
        assert min(e[1] for e in errors.values()) >= BF16_COS, errors
    assert all(e[0] == 0 for e in _grid_errors(kernel, again).values())
    assert float(kernel[0]["extent"]) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_grid_wrappers_refuse_tiles_that_do_not_fit_on_card(precision):
    """On CUDA tensors F = 264 (over the kernels' 256 table columns) is
    refused by name before any launch in both directions, and a decoder of
    width 256 at F = 128 in the backward, whose tile (dW1 held in shared
    memory) is over a block's, by the library's own count; its forward fits
    and launches. Every geometry of conf/ fits."""
    dev = _card()
    gen = torch.Generator().manual_seed(0)
    o, d, t = (torch.from_numpy(a).to(dev) for a in _grid_rays(7, 2, 3))
    de, cots = gk.encoding.encode_dirs(d), [torch.ones_like(t)] * 4
    bf16 = int(precision == "bf16")
    for (nd, na, width), fwd_fits, match in (((64, 64, 256), True, "shared memory"),
                                             ((8, 256, 16), False, "F <= 256")):
        params = gridfield.init_grid_field(gen, res=8, n_density=nd, n_app=na,
                                           decoder_width=width, device=dev)
        before = gk.grid_rays.launches
        if fwd_fits:
            gk.grid_rays(params, o, d, t, nd, precision)
        else:
            with pytest.raises(ValueError, match=match):
                gk.grid_rays(params, o, d, t, nd, precision)
        assert gk.grid_rays.launches == before + fwd_fits
        before = gk.grid_rays_bwd.launches
        with pytest.raises(ValueError, match=match):
            gk.grid_rays_bwd(params, o, d, t, de, *cots, n_density=nd, precision=precision)
        assert gk.grid_rays_bwd.launches == before
    assert gk._library(gk.BWD_SOURCE).grid_rays_bwd_smem_bytes(8, 64, 64, 256, bf16) > gk.MAX_SMEM
    for dims in GRID.values():
        assert gk._library(gk.FWD_SOURCE).grid_rays_fwd_smem_bytes(*dims, bf16) <= gk.MAX_SMEM
        assert gk._library(gk.BWD_SOURCE).grid_rays_bwd_smem_bytes(*dims, bf16) <= gk.MAX_SMEM


# ---------------------------------------------------------------- the proposal MLP

from tinynerf_torch.core import proposal  # noqa: E402
from tinynerf_torch.kernels import proposal_kernel as pk  # noqa: E402


def _prop_errors(kernel, plain):
    """error / max|plain| and the cosine, for every output of prop_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    return {name: (_rel(a, b), float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0))) for name, a, b in pairs}


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("width,depth,n_rays,n_samples", [
    (128, 4, 4096, 64), (128, 4, 1001, 64), (64, 3, 37, 5), (128, 4, 13, 100),
    (256, 2, 37, 5), (32, 1, 200, 3)])
def test_prop_kernels_match_plain_on_card(width, depth, n_rays, n_samples, precision):
    """Kernels 7 and 8 at conf/lego_prop.ini's proposal MLP (128 x 4) at the
    step's B = 4096, N = 64, at a ragged B, at 64 x 3, with rays longer than
    a 64-row tile, and at the ends of the widths and depths the kernels take
    (256 x 2; 32 x 1, with rays that straddle tiles). fp32: every plane within 1e-5, every gradient within
    1e-4 of max|plain|; bf16: each output within BF16_FWD_RTOL, each gradient
    within BF16_BWD_RTOL of max|plain| and at cosine >= BF16_COS. Rows within
    2e-6 of a ReLU kink or of sigma = 0 get zero cotangents. Two backward
    calls agree bit for bit."""
    _check_prop_kernels(width, depth, n_rays, n_samples, precision)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("width,depth,n_rays,n_samples", [
    (128, 4, 333, 37), (128, 4, 1, 300), (128, 4, 5000, 3), (160, 4, 70, 50),
    (128, 4, 600, 50), (192, 3, 700, 40), (256, 4, 530, 33), (128, 4, 65537, 1)])
def test_prop_kernels_tile_edges_on_card(width, depth, n_rays, n_samples, precision):
    """Kernels 7 and 8 at the edges of their 128-row tiles (the fp32
    backward's 64-row ones above width 160) and of the backward's ray
    slices, with the checks and bounds of
    ``test_prop_kernels_match_plain_on_card``: 12,321 rows (no multiple of
    a tile; rays that cross tiles, one or two slices of two rays each), one
    ray of 300 rows (three tiles, the ray's sums carried across two), 5000
    rays (more than the 264 slices: 19 rays a slice, the last slice short),
    160 x 4 (an odd number of n8-tiles a warp, and activations that do not
    fit in shared memory, so two buffers and the spill in both forms), 600
    rays of 50 (3 rays a slice: the third straddles two 128-row tiles), 192
    x 3 and 256 x 4 (the fp32 backward's 64-row tiles, all activations in
    shared memory at 192 x 3, two buffers and the spill at 256 x 4, more
    rays than slices and a ray straddling two tiles in each), and
    ``prop_flat``'s N = 1 at a ragged 65,537 rows (249 rays a slice: two
    tiles, the second short)."""
    _check_prop_kernels(width, depth, n_rays, n_samples, precision)


def _check_prop_kernels(width, depth, n_rays, n_samples, precision):
    dev = _card()
    params = proposal.init_proposal(torch.Generator().manual_seed(width + depth), width, depth,
                                    device=dev)
    o, d, t = (torch.from_numpy(a).to(dev) for a in _dyadic_rays(n_rays, n_rays, n_samples))
    before = (pk.prop_rays.launches, pk.prop_rays_bwd.launches)
    with torch.no_grad():
        (r, g, b), sigma = pk.prop_rays(params, o, d, t, precision)
        (pr, pg, pb), p_sigma = pk.prop_rays_plain(params, o, d, t, precision)
    torch.cuda.synchronize()
    errs = [_rel(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))]
    if precision == "fp32":
        for a, p in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma)):
            torch.testing.assert_close(a, p, atol=1e-5, rtol=0)
    else:
        assert max(errs) <= BF16_FWD_RTOL, errs
    keep = (mk.preactivation_margin(params, o, d, t) > 2e-6).float()
    rng = np.random.default_rng(n_samples)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
            for _ in range(4)]
    kernel = pk.prop_rays_bwd(params, o, d, t, *cots, precision=precision)
    again = pk.prop_rays_bwd(params, o, d, t, *cots, precision=precision)
    plain = pk.prop_rays_bwd_plain(params, o, d, t, *cots, precision=precision)
    torch.cuda.synchronize()
    assert (pk.prop_rays.launches, pk.prop_rays_bwd.launches) == (before[0] + 1, before[1] + 2)
    errors = _prop_errors(kernel, plain)
    worst = max(errors, key=lambda k: errors[k][0])
    print(f"prop {width}x{depth} {precision} B={n_rays} N={n_samples}: forward {max(errs):.3e}, "
          f"backward worst {worst} {errors[worst][0]:.3e}, min cosine "
          f"{min(e[1] for e in errors.values()):.7f}")
    if precision == "fp32":
        assert errors[worst][0] <= 1e-4, errors
    else:
        assert errors[worst][0] <= BF16_BWD_RTOL, errors
        assert min(e[1] for e in errors.values()) >= BF16_COS, errors
    assert all(e[0] == 0 for e in _prop_errors(kernel, again).values())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("width,depth,n_rays,n_samples", [
    (128, 4, 4096, 64), (256, 2, 37, 5), (32, 1, 200, 3)])
def test_prop_bwd_without_ray_gradients_on_card(width, depth, n_rays, n_samples, precision):
    """Kernel 8 asked for no ray gradient (``ray_grads=False``, what
    autograd asks when the rays take none, as on lego_prop's path) at
    conf/lego_prop.ini's proposal MLP and step (128 x 4, B = 4096, N = 64)
    and at 256 x 2 and 32 x 1: one launch, ``d_origins``, ``d_dirs`` and
    ``d_ts`` None, and every weight gradient equal to the full call's bit
    for bit. Through ``prop_rays``' autograd on rays that need no gradient,
    the same gradients again and none on the rays."""
    dev = _card()
    params = proposal.init_proposal(torch.Generator().manual_seed(width + depth), width, depth,
                                    device=dev)
    o, d, t = (torch.from_numpy(a).to(dev) for a in _dyadic_rays(n_rays, n_rays, n_samples))
    rng = np.random.default_rng(n_samples)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev)
            for _ in range(4)]
    full = pk.prop_rays_bwd(params, o, d, t, *cots, precision=precision)
    before = pk.prop_rays_bwd.launches
    skip = pk.prop_rays_bwd(params, o, d, t, *cots, precision=precision, ray_grads=False)
    torch.cuda.synchronize()
    assert pk.prop_rays_bwd.launches == before + 1
    assert skip[1:] == (None, None, None) and all(x is not None for x in full[1:])
    for n in full[0]:
        for k in ("w", "b"):
            assert torch.equal(skip[0][n][k], full[0][n][k]), (n, k)

    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
    (r, g, b), sigma = pk.prop_rays(leaves, o, d, t, precision)
    torch.autograd.backward([sigma, r, g, b], cots)
    assert o.grad is None and d.grad is None and t.grad is None
    for n in full[0]:
        for k in ("w", "b"):
            assert torch.equal(leaves[n][k].grad, full[0][n][k]), (n, k)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_prop_flat_matches_plain_on_card(precision):
    """``prop_flat`` (kernels 7 and 8 at N = 1, t = 0: what ``CONTRACT`` +
    ``PROP_FIELD = mlp`` + ``PROP_PALLAS`` runs) at conf/lego_prop.ini's
    proposal MLP (128 x 4) on 4096 x 64 contracted rows and its gradient by
    autograd, against the plain versions at N = 1 (``prop_rays_reference``
    with one sample a ray at t = 0). fp32: every plane within 1e-5, every
    gradient within 1e-4 of max|plain|; bf16: BF16_FWD_RTOL, and
    BF16_BWD_RTOL with cosine >= BF16_COS. Rows within 2e-6 of a ReLU kink
    or of sigma = 0 get zero cotangents."""
    dev = _card()
    params = proposal.init_proposal(torch.Generator().manual_seed(9), 128, 4, device=dev)
    R = 4096 * 64
    rng = np.random.default_rng(11)
    pts, dirs = (torch.from_numpy(a).to(dev) for a in contracted_rows(rng, R))
    zeros = pts.new_zeros(R, 1)
    keep = (mk.preactivation_margin(params, pts, dirs, zeros) > 2e-6).float()
    g = torch.from_numpy(rng.normal(size=(R, 4)).astype(np.float32)).to(dev) * keep

    def grads(fn):
        leaves = {n: {k: v.clone().requires_grad_(True) for k, v in l.items()}
                  for n, l in params.items()}
        p, d = pts.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
        color, sigma = fn(leaves, p, d)
        out = torch.cat([color, sigma], dim=-1)
        flat = [t for l in leaves.values() for t in l.values()]
        got = torch.autograd.grad(out, flat + [p, d], g)
        return out.detach(), got

    def plain(leaves, p, d):
        (r, gg, b), sigma = pk.prop_rays_reference(leaves, p, d, zeros, precision)
        return torch.cat([r, gg, b], dim=-1), sigma

    before = (pk.prop_rays.launches, pk.prop_rays_bwd.launches)
    k_out, k_grads = grads(lambda l, p, d: pk.prop_flat(l, p, d, precision))
    p_out, p_grads = grads(plain)
    torch.cuda.synchronize()
    assert (pk.prop_rays.launches, pk.prop_rays_bwd.launches) == (before[0] + 1, before[1] + 1)
    fwd = _rel(k_out, p_out)
    bwd = [_rel(a, b) for a, b in zip(k_grads, p_grads)]
    cos = min(float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0)) for a, b in zip(k_grads, p_grads))
    print(f"prop_flat {precision}: forward {fwd:.3e}, backward worst {max(bwd):.3e}, "
          f"min cosine {cos:.7f}")
    if precision == "fp32":
        torch.testing.assert_close(k_out, p_out, atol=1e-5, rtol=0)
        assert max(bwd) <= 1e-4, bwd
    else:
        assert fwd <= BF16_FWD_RTOL and max(bwd) <= BF16_BWD_RTOL, (fwd, bwd)
        assert cos >= BF16_COS


@pytest.mark.gpu
def test_prop_kernels_refuse_a_width_they_do_not_take():
    """A width that is no multiple of 32 (or over 256) raises on the card,
    naming the widths the kernels take; no kernel launches."""
    dev = _card()
    o, d, t = (torch.from_numpy(a).to(dev) for a in _dyadic_rays(0, 4, 8))
    before = (pk.prop_rays.launches, pk.prop_rays_bwd.launches)
    for width in (100, 288):
        params = proposal.init_proposal(torch.Generator().manual_seed(0), width, 2, device=dev)
        with pytest.raises(ValueError, match=r"width in \{32, 64, ..., 256\}"):
            pk.prop_rays(params, o, d, t)
        with pytest.raises(ValueError, match=r"width in \{32, 64, ..., 256\}"):
            pk.prop_rays_bwd(params, o, d, t, t, t, t, t)
    assert (pk.prop_rays.launches, pk.prop_rays_bwd.launches) == before


# ---------------------------------------------------------------- the fused renderer

from tinynerf_torch.core import rays as raylib, sampling  # noqa: E402
from tinynerf_torch.kernels import render_kernel as rk  # noqa: E402

FUSED_ATOL = {"fp32": 1e-4, "bf16": 1e-3}     # each color channel


def fused_inputs(dev, B, n_coarse, seed, empty=0, ndc=False):
    """A field with content (seeded weights, sigma bias +1) and B rays from
    pixels_to_rays through an 800x800 view 4 units out, near/far 2/6; the
    last ``empty`` rays get near == far, as rays the occupancy grid empties.
    With ``ndc`` the rays are warped to NDC (``ndc_rays``, near plane 1) and
    their bounds are 0 and 1, as fern_ndc's fused frames."""
    params = mlp.init_network(torch.Generator().manual_seed(seed), dev)
    params["sigma"]["b"] += 1.0
    rng = np.random.default_rng(seed)
    pose = np.concatenate([np.float32([[1, 0, 0, 0.3, 800], [0, 1, 0, -0.2, 800],
                                       [0, 0, 1, 4.0, 1111]]).ravel(), [2.0, 6.0]])
    rows, cols = (torch.from_numpy(rng.uniform(0, 800, B).astype(np.float32)).to(dev)
                  for _ in range(2))
    pose17 = torch.from_numpy(pose.astype(np.float32)).to(dev).expand(B, 17)
    o, d, near, far = raylib.pixels_to_rays(rows, cols, pose17,
                                            raylib.make_k_inv(800, 800, 1111.0).to(dev))
    if ndc:
        o, d = raylib.ndc_rays(800.0, 800.0, 1111.0, 1.0, o, d)
        near, far = torch.zeros_like(near), torch.ones_like(far)
    near, far = near.contiguous(), far.contiguous().clone()
    if empty:
        far[-empty:] = near[-empty:]
    return (params, o.contiguous(), d.contiguous(), sampling.coarse_ts(near, far, n_coarse),
            near, far)


def tie_inputs(dev, B, n_coarse, seed):
    """``tie_params`` and B rays along -x from x = 2 + eps, eps in [0.004,
    0.012], near/far 2/2.9: x falls from eps to eps - 0.9, so sigma is
    positive at each ray's first coarse sample and exactly 0 at the others
    (the next coarse t is 0.9/63 = 0.0143 on). Each ray's weight is all at
    its first sample, its cdf flat, every level equal to cdf_0 and every fine
    t equal to t_co[:, 0]: each fine sample ties with coarse sample 0 at one
    point, and the merged order decides which of them takes the delta to
    t_co[:, 1]. The forward cannot tell the orders apart (the tied samples
    share sigma and color); the fine t's gradient, through the resampler's
    slope delta / (w_1 + 1e-7) ~ 1.4e5, flips sign with the order."""
    params = tie_params(torch.Generator().manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    o = np.stack([2.0 + rng.uniform(0.004, 0.012, B), rng.uniform(-1, 1, B),
                  rng.uniform(-1, 1, B)], 1)
    d = np.stack([-np.ones(B), rng.uniform(-0.01, 0.01, B), rng.uniform(-0.01, 0.01, B)], 1)
    near, far = (torch.full((B,), v, device=dev) for v in (2.0, 2.9))
    o, d = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d))
    return params, o, d, sampling.coarse_ts(near, far, n_coarse), near, far


def tie_params(generator, dev):
    """A field whose density lives where 0 < x < 1: trunk unit 0 reads 64
    sin(pi x) (encoding column 0) and passes it down the trunk, the other
    trunk units and the skip are zero, sigma = 16 |h_0|; the view branch
    keeps its seeded weights. Every weight is exact in bf16."""
    params = mlp.init_network(generator, dev)
    for name, layer in params.items():
        if name.startswith("trunk_") or name == "sigma":
            layer["w"].zero_()
            layer["b"].zero_()
            layer["w"][0, 0] = 1.0
    params["trunk_0"]["w"][0, 0] = 64.0
    params["sigma"]["w"][0, 0] = 16.0
    return params


def _fused_case(id_, precision, n_rays, n_coarse, n_fine, white, rays="lego"):
    return pytest.param(precision, n_rays, n_coarse, n_fine, white, rays, id=id_)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,n_rays,n_coarse,n_fine,white,rays", [
    _fused_case("fp32-4096-64-128-False", "fp32", 4096, 64, 128, False),
    _fused_case("fp32-1001-64-128-True", "fp32", 1001, 64, 128, True),
    _fused_case("bf16-4096-64-128-True", "bf16", 4096, 64, 128, True),
    _fused_case("bf16-1001-64-128-False", "bf16", 1001, 64, 128, False),
    _fused_case("fp32-13-8-16-True", "fp32", 13, 8, 16, True),
    _fused_case("bf16-4097-64-128-False", "bf16", 4097, 64, 128, False),
    _fused_case("fp32-1024-64-64-False", "fp32", 1024, 64, 64, False),
    _fused_case("bf16-1024-64-64-True", "bf16", 1024, 64, 64, True),
    _fused_case("bf16-1001-8-16-False", "bf16", 1001, 8, 16, False),
    _fused_case("fp32-1001-64-128-True-ndc", "fp32", 1001, 64, 128, True, "ndc"),
    _fused_case("bf16-4096-64-128-False-ndc", "bf16", 4096, 64, 128, False, "ndc"),
    _fused_case("fp32-512-64-128-False-ties", "fp32", 512, 64, 128, False, "ties"),
    _fused_case("bf16-512-64-128-True-ties", "bf16", 512, 64, 128, True, "ties"),
    _fused_case("fp32-256-64-128-True-unsorted", "fp32", 256, 64, 128, True, "unsorted"),
    _fused_case("bf16-256-8-16-False-unsorted", "bf16", 256, 8, 16, False, "unsorted")])
def test_fused_kernels_match_plain_on_card(precision, n_rays, n_coarse, n_fine, white, rays):
    """Kernels 9 and 10 at the render chunk's B = 4096, 64 + 128 samples, at a
    ragged B = 1001 whose last 7 rays are empty (near == far), at B = 4097
    (no multiple of the bf16 form's 2 rays a block), at 64 + 64 samples, at
    8 + 16 samples (8 rays a block at fp32, 16 at bf16), on NDC rays with
    bounds 0 and 1, on rays whose every fine t equals their first coarse t
    (``tie_inputs``: a coarse sample comes first on a tie), and on coarse
    t's in reverse order (the merge's ranks by counts where a list is not
    sorted: the plain version's stable sort takes any order). Kernel
    9: each color within 1e-4 (fp32) or 1e-3 (bf16) of the plain version,
    and the same colors bit for bit where it also writes its residuals.
    Kernel 10 from those residuals, against the plain backward at kernel
    9's own fine t's (``render_kernel.grads_agree``): every gradient tensor
    at cosine >= 0.9999 and norm within 1% (fp32), cosine >= 0.999 (bf16);
    two launches agree bit for bit, and with the call that makes its own
    residuals (kernel 9, then kernel 10), and with autograd through
    ``render_fused``; the rays get no gradient. Its merge launch alone
    (``merge_bwd``) against ``merge_bwd_plain`` on the same residuals, both
    against the float64 evaluation (``render_kernel.merge_agreement``): each
    hand-off plane within 1e-5 of its max more than the float32 plain
    version (the tail is float32 in both forms); its C_fine equal to kernel
    9's bit for bit (the merge's order and weights are kernel 9's)."""
    dev = _card()
    if rays == "ties":
        params, o, d, t_co, near, far = tie_inputs(dev, n_rays, n_coarse, n_rays)
    else:
        params, o, d, t_co, near, far = fused_inputs(dev, n_rays, n_coarse, n_rays,
                                                     empty=7 if n_rays == 1001 else 0,
                                                     ndc=rays == "ndc")
        if rays == "unsorted":
            t_co = t_co.flip(1).contiguous()
    before = (rk.render_fused.launches, rk.render_fused_bwd.launches, rk.merge_bwd.launches)
    with torch.no_grad():
        c_co, c_fi = rk.render_fused(params, o, d, t_co, near, far, n_fine, white, precision)
        p_co, p_fi = rk.render_fused_plain(params, o, d, t_co, near, far, n_fine, white,
                                           precision)
    r_co, r_fi, res = rk.render_fused_residuals(params, o, d, t_co, near, far, n_fine, white,
                                                precision)
    torch.cuda.synchronize()
    errs = (float((c_co - p_co).abs().max()), float((c_fi - p_fi).abs().max()))
    assert torch.equal(r_co, c_co) and torch.equal(r_fi, c_fi)
    rng = np.random.default_rng(5)
    g_co, g_fi = (torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32)).to(dev)
                  for _ in range(2))
    args = (params, o, d, t_co, near, far, g_co, g_fi, n_fine, white, precision)
    kernel = rk.render_fused_bwd(*args, residuals=res)
    again = rk.render_fused_bwd(*args, residuals=res)
    standalone = rk.render_fused_bwd(*args)
    views = rk.split_residuals(res, n_rays, n_coarse, n_fine)
    merge_in = (t_co, views.t_fi, views.sig_co, views.sig_fi, views.col_co, views.col_fi, near,
                far, g_co, g_fi, white)
    merge = rk.merge_bwd(*merge_in)
    plain = rk.render_fused_bwd_plain(*args, views.t_fi)
    torch.cuda.synchronize()
    assert (rk.render_fused.launches, rk.render_fused_bwd.launches, rk.merge_bwd.launches) == (
        before[0] + 3, before[1] + 3, before[2] + 1)
    if rays == "ties":
        assert torch.equal(views.t_fi, t_co[:, :1].expand_as(views.t_fi))
    ok, worst, rows = rk.grads_agree(kernel, plain, precision)
    merge_ok, merge_rows = rk.merge_agreement(merge, *merge_in)
    print(f"fused {precision} B={n_rays} {n_coarse}+{n_fine} white={white}: |err| "
          f"coarse {errs[0]:.3e} fine {errs[1]:.3e}; backward vs plain at kernel 9's fine "
          f"t's: smallest cosine {rows[worst][0]:.8f} ({worst}), norm ratios "
          f"{min(r[1] for r in rows.values()):.6f}..{max(r[1] for r in rows.values()):.6f}; "
          f"merge launch, plain in brackets, vs float64, of max: "
          + ", ".join(f"{k} {v[0]:.2e} ({v[1]:.2e})" for k, v in merge_rows.items()))
    assert torch.isfinite(c_fi).all() and torch.isfinite(c_co).all()
    assert max(errs) <= FUSED_ATOL[precision], errs
    assert ok, rows
    assert all(torch.equal(kernel[n][k], again[n][k]) and torch.equal(kernel[n][k],
                                                                      standalone[n][k])
               for n in kernel for k in ("w", "b"))
    assert merge_ok, merge_rows
    assert torch.equal(merge.c_fi, c_fi)
    # through autograd: the params get the kernel's gradient, the rays none
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
    o_leaf = o.clone().requires_grad_(True)
    c_co, c_fi = rk.render_fused(leaves, o_leaf, d, t_co, near, far, n_fine, white, precision)
    ((c_co * g_co).sum() + (c_fi * g_fi).sum()).backward()
    assert o_leaf.grad is None
    assert all(torch.equal(leaves[n][k].grad, kernel[n][k]) for n in kernel for k in ("w", "b"))


@pytest.mark.gpu
def test_fused_kernels_refuse_shapes_that_do_not_fit_on_card():
    """Sample counts whose per-ray state does not fit in a block's shared
    memory, and fewer than 2 coarse or 1 fine samples, are refused by name
    before any launch: 64 + 6000 by both kernels in both forms (the
    backward needs kernel 9's residuals, so it refuses what kernel 9 does),
    1 + 16 by both. 64 + 3000 runs in bf16 both ways: kernel 10's merge
    launch holds no field tile. The plain versions take them all
    (``tests/test_torch_render_fused.py``)."""
    dev = _card()
    params, o, d, _, near, far = fused_inputs(dev, 4, 64, 0)
    g = torch.ones((4, 3), device=dev)
    before = (rk.render_fused.launches, rk.render_fused_bwd.launches)
    for precision in ("fp32", "bf16"):
        for n_coarse, n_fine in ((64, 6000), (1, 16)):
            t_co = sampling.coarse_ts(near, far, max(n_coarse, 2))[:, :n_coarse].contiguous()
            with pytest.raises(ValueError, match=r"render_fused: .*(do not fit|N_c >= 2)"):
                rk.render_fused(params, o, d, t_co, near, far, n_fine, False, precision)
            with pytest.raises(ValueError, match=r"render_fused: .*(do not fit|N_c >= 2)"):
                rk.render_fused_bwd(params, o, d, t_co, near, far, g, g, n_fine, False,
                                    precision)
    assert (rk.render_fused.launches, rk.render_fused_bwd.launches) == before
    t_co = sampling.coarse_ts(near, far, 64)
    with torch.no_grad():
        c_co, c_fi = rk.render_fused(params, o, d, t_co, near, far, 3000, False, "bf16")
    assert torch.isfinite(c_fi).all()
    grads = rk.render_fused_bwd(params, o, d, t_co, near, far, g, g, 3000, False, "bf16")
    assert all(torch.isfinite(t).all() for layer in grads.values() for t in layer.values())
    assert (rk.render_fused.launches, rk.render_fused_bwd.launches) == (before[0] + 2,
                                                                        before[1] + 1)
