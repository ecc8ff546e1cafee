"""The CUDA field kernels (the ray-major forward and backward, the flat
forward; fp32 and bf16) against their plain PyTorch versions, on the card.

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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# bf16: kernel and plain version round at the same points and sum in other
# orders, which can move a rounded activation by one bf16 ulp (2^-8
# relative) and flip a ReLU; errors are relative to max|plain|. Measured on
# an NVIDIA H100 80GB HBM3 at 700.00 W: at most 1.5e-3 forward (a ragged R
# of kernel 3), 1.5e-3 backward (d_ts), every cosine 1.000000.
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
    ("fp32", 32768), ("fp32", 13), ("bf16", 32768), ("bf16", 1001)])
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk.field_flat(params, pts.clone().requires_grad_(True), dirs, precision)


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


# ---------------------------------------------------------------- the grid field

from tinynerf_torch.core import gridfield  # noqa: E402
from tinynerf_torch.kernels import grid_kernel as gk  # noqa: E402

GRID = {"fine": (256, 64, 64, 128),   # conf/lego_grid.ini's fine grid
        "prop": (64, 16, 16, 16)}     # its proposal grid
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
    ("fine", "nodes", 8)])
def test_grid_kernels_match_plain_on_card(geometry, n_rays, n_samples, precision):
    """Kernels 5 and 6 at conf/lego_grid.ini's fine (N = 128) and proposal
    (N = 64) grids at B = 4096, at ragged shapes and at grid-node hits and
    the clip boundary. fp32: color 1e-5, sigma 1e-4 abs + 1e-4 rel, every
    gradient within 1e-4 of max|plain|; bf16: each output within
    BF16_FWD_RTOL, each gradient within BF16_BWD_RTOL of max|plain| and at
    cosine >= BF16_COS. Rows within 1e-5 of a ReLU kink or of sigma = 0 get
    zero cotangents. Two backward calls agree bit for bit."""
    dev = _card()
    params, nd = _grid_params(geometry, dev, seed=n_samples)
    rays = _node_rays(n_samples) if n_rays == "nodes" else _grid_rays(7, n_rays, n_samples)
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
