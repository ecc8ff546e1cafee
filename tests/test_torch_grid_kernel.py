"""``tinynerf_torch.kernels.grid_kernel.grid_rays`` on the CPU (its plain
versions, ``grid_rays_plain`` and ``grid_rays_bwd_plain``) against the JAX
package's ``grid_field_pallas_rays`` (TPU kernels 5 and 6) in interpret
mode: the forward and every gradient (the lines, the decoder, the origins,
the directions through the points and the encoding, the ts), at fp32 and
bf16, at a small geometry and at lego's fine grid, and at grid-node hits and
the clip boundary. Inputs are dyadic (1/16-quantized, so ``o + t * d`` is
exact in float32), made with numpy from a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.grid_kernel as jgk
import tinynerf.kernels.mlp_kernel as jmk
from tinynerf.core import gridfield as jgf
from tinynerf_torch import ckpt, optim
from tinynerf_torch.core import encoding, gridfield
from tinynerf_torch.kernels import grid_kernel as gk


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


GEOMETRY = {  # (res, n_density, n_app, width), (B, N)
    "small": ((32, 8, 16, 32), (20, 9)),      # tests/test_grid_kernel.py's
    "lego": ((256, 64, 64, 128), (3, 8)),     # conf/lego_grid.ini's fine grid
    "odd": ((33, 4, 8, 16), None),            # R odd: coordinate 0 is a node
    "wide": ((8, 64, 64, 256), (2, 3)),       # the backward over a block's shared memory
    "many": ((8, 8, 256, 16), (2, 3)),        # over the kernels' 256 columns
}
# fp32: the JAX kernel test's bounds (color 1e-5, sigma 1e-5 and 1e-4 at
# R = 256, every gradient 2e-5 of max|ref|); bf16: 2e-3 of max|ref| forward
# and 1e-2 backward, as in slice 3 (measured: forward equal, the line
# tables' gradients within 2.1e-3, all others within 4e-7)
SIGMA_ATOL = {"small": 1e-5, "lego": 1e-4, "odd": 1e-5, "wide": 1e-4, "many": 1e-5}
GRAD_RTOL = {"fp32": 2e-5, "bf16": 1e-2}


def _jax_grid(geometry, seed=0):
    res, nd, na, width = GEOMETRY[geometry][0]
    return jgf.init_grid_field(jax.random.PRNGKey(seed), res=res, n_density=nd,
                               n_app=na, decoder_width=width, extent=1.5)


def _rays(B, N, seed=0):
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    o = q(rng.uniform(-0.9, 0.9, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    d = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(0.1, 2.9, (B, N))), axis=1).astype(np.float32)
    return o, d, ts


def _special_rays(res):
    """Axis-aligned rays whose samples hit grid nodes (coordinate 0 for R
    odd; +-0.5, nodes 85 and 170, at R = 256), the clip boundary +-1.5 and
    points outside it, on every axis."""
    node = 0.0 if res % 2 else 0.5
    o = np.float32([[-2.0, node, node], [node, -2.0, -node], [node, node, -2.0],
                    [-2.0, 1.5, -1.5], [1.5, -2.0, 0.3125]])
    d = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0], [0, 1, 0]])
    t = np.float32([0.25, 0.5, 1.0, 1.5, 2.0 - node, 2.0 + node, 2.5, 3.5, 3.75])
    return o, d, np.tile(np.sort(t), (len(o), 1))


def _loss_weights(shape):
    rng = np.random.default_rng(1)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _jax_run(jparams, nd, rays, dtype):
    o, d, ts = (jnp.asarray(a) for a in rays)
    w = _loss_weights(ts.shape)

    def loss(p, o, d, ts):
        (r, g, b), s = jgk.grid_field_pallas_rays(p, o, d, ts, n_density=nd,
                                                  compute_dtype=dtype)
        return jnp.sum(jnp.sin(r * w[0] + g * w[1] + b * w[2])) + jnp.sum(jnp.cos(s * w[3]))

    out = jgk.grid_field_pallas_rays(jparams, o, d, ts, n_density=nd, compute_dtype=dtype)
    return out, jax.grad(loss, argnums=(0, 1, 2, 3))(jparams, o, d, ts)


def _port_run(params, nd, rays, precision):
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), params)
    o, d, ts = (torch.from_numpy(a).requires_grad_(True) for a in rays)
    w = [torch.from_numpy(x) for x in _loss_weights(ts.shape)]
    before = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
    (r, g, b), s = gk.grid_rays(leaves, o, d, ts, nd, precision)
    (torch.sum(torch.sin(r * w[0] + g * w[1] + b * w[2])) + torch.sum(torch.cos(s * w[3]))
     ).backward()
    assert (gk.grid_rays.launches, gk.grid_rays_bwd.launches) == before  # CPU: no kernel
    grads = optim.tree_map(lambda t: t.grad, leaves)
    return ((r, g, b), s), (grads, o.grad, d.grad, ts.grad)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _compare(geometry, rays, precision):
    jparams = _jax_grid(geometry)
    nd = GEOMETRY[geometry][0][1]
    dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
    ((jr, jg, jb), js), (jgp, jgo, jgd, jgt) = _jax_run(jparams, nd, rays, dtype)
    ((r, g, b), s), (gp, go, gd, gt) = _port_run(ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)), nd, rays, precision)
    for got, ref in ((r, jr), (g, jg), (b, jb), (s, js)):
        assert got.shape == ref.shape and got.dtype == torch.float32
    if precision == "fp32":
        for got, ref in ((r, jr), (g, jg), (b, jb)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                                   atol=SIGMA_ATOL[geometry])
    else:
        for got, ref in ((r, jr), (g, jg), (b, jb), (s, js)):
            assert _rel(got.detach().numpy(), ref) <= 2e-3
    errors = {f"lines.{ax}": _rel(gp["lines"][ax], jgp["lines"][ax]) for ax in "xyz"}
    errors.update({f"{n}.{k}": _rel(gp["decoder"][n][k], jgp["decoder"][n][k])
                   for n in ("hidden", "color") for k in ("w", "b")})
    errors.update(origins=_rel(go, jgo), dirs=_rel(gd, jgd), ts=_rel(gt, jgt))
    assert max(errors.values()) <= GRAD_RTOL[precision], errors
    assert float(gp["extent"]) == 0.0 == float(jgp["extent"])
    return errors


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", ["small", "lego"])
def test_grid_rays_matches_the_jax_kernels(geometry, precision):
    B, N = GEOMETRY[geometry][1]
    _compare(geometry, _rays(B, N, seed=B), precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", ["odd", "lego"])
def test_grid_rays_at_nodes_and_the_clip_boundary(geometry, precision):
    """Samples on grid nodes (the kernel's abs'(0) = +1 and relu'(0) = 0:
    d xg = -dF . T[k]), on the clip boundary (0.5) and outside it (0)."""
    rays = _special_rays(GEOMETRY[geometry][0][0])
    errors = _compare(geometry, rays, precision)
    assert errors["ts"] <= GRAD_RTOL[precision]


def test_plain_backward_is_the_gradient_of_the_point_field():
    """At fp32 the written-out backward is the VJP of the point field
    (``gridfield.apply_grid_field``, by autograd) at the rays' points, once
    the encoding's share of ``d_dirs`` is chained through ``d_de``."""
    params = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_grid("small", 2)))
    o, d, ts = (torch.from_numpy(a) for a in _rays(7, 5, seed=3))
    cots = [torch.from_numpy(c) for c in _loss_weights(ts.shape)]
    grads, d_o, d_d, d_ts, d_de = gk.grid_rays_bwd(params, o, d, ts, encoding.encode_dirs(d),
                                                   *cots, n_density=8)
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), params)
    o2, d2, t2 = (x.clone().requires_grad_(True) for x in (o, d, ts))
    pts = o2[:, None, :] + t2[..., None] * d2[:, None, :]
    color, sigma = gridfield.apply_grid_field(leaves, pts, d2[:, None, :].expand(pts.shape),
                                              n_density=8)
    (torch.sum(sigma[..., 0] * cots[0])
     + sum(torch.sum(color[..., c] * cots[1 + c]) for c in range(3))).backward()
    d_leaf = d.clone().requires_grad_(True)
    (d_enc,) = torch.autograd.grad(encoding.encode_dirs(d_leaf), d_leaf, d_de)
    for ax in "xyz":
        assert _rel(grads["lines"][ax], leaves["lines"][ax].grad) <= 2e-5
    for n in ("hidden", "color"):
        for k in ("w", "b"):
            assert _rel(grads["decoder"][n][k], leaves["decoder"][n][k].grad) <= 2e-5
    assert _rel(d_o, o2.grad) <= 2e-5 and _rel(d_ts, t2.grad) <= 2e-5
    assert _rel(d_d + d_enc, d2.grad) <= 2e-5


def test_wrappers_refuse_what_the_kernels_do_not_take():
    params = ckpt.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jgf.init_grid_field(jax.random.PRNGKey(0), res=8, n_density=2, n_app=2,
                                        decoder_width=24)))
    o, d, ts = (torch.from_numpy(a) for a in _rays(2, 3))
    with pytest.raises(ValueError, match="width dividing 256"):
        gk.grid_rays(params, o, d, ts, 2)
    with pytest.raises(ValueError, match="precision"):
        gk.grid_rays(params, o, d, ts, 2, "fp16")


def test_flop_counts():
    """The gather form's count (the bound) and the TPU kernel's own hat-form
    cost estimate, at lego's fine and proposal grids."""
    assert gk.flops_per_row(256, 64, 64, 128) == 25_152
    assert gk.flops_per_row(64, 16, 16, 16) == 1_840
    assert gk.hat_flops_per_row(256, 64, 64, 128) == jgk._flops_per_row(256, 128, 24, 128)
    assert gk.hat_flops_per_row(64, 16, 16, 16) == jgk._flops_per_row(64, 32, 24, 16)


@pytest.mark.parametrize("dims,split", [((256, 64, 64, 128), (22_528, 2_624)),
                                        ((64, 16, 16, 16), (1_280, 560)),
                                        ((384, 64, 64, 128), (22_528, 2_624)),
                                        ((32, 8, 16, 32), (2_560, 536))])
def test_flop_split(dims, split):
    """The split of the gather form's count into the decoder's product (the
    tensor cores' share in the bf16 forms) and the elementwise rest: at the
    fine and proposal grids, lego_hybrid's R = 384 and the small geometry;
    its two parts sum to ``flops_per_row``."""
    assert gk.flops_split_per_row(*dims) == split
    assert sum(gk.flops_split_per_row(*dims)) == gk.flops_per_row(*dims)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", ["wide", "many"])
def test_plain_path_takes_tiles_the_kernels_refuse(geometry, precision):
    """A decoder of width 256 at F = 128 (its backward's tile is over a
    block's shared memory in either form) and F = 264 (over the kernels' 256
    table columns) run on CPU tensors, whose plain versions have no such
    limit, and match the JAX kernels; the refusal is the launch's
    (``_check_fits``), by name."""
    B, N = GEOMETRY[geometry][1]
    _compare(geometry, _rays(B, N, seed=B), precision)
    dm = GEOMETRY[geometry][0]
    if dm[1] + dm[2] > gk.MAX_F:
        with pytest.raises(ValueError, match="F <= 256"):
            gk._check_fits(lambda *a: 0, dm, precision)
    with pytest.raises(ValueError, match="shared memory"):
        gk._check_fits(lambda *a: gk.MAX_SMEM + 1, dm[:1] + (8, 8, dm[3]), precision)
    gk._check_fits(lambda *a: gk.MAX_SMEM, dm[:1] + (8, 8, dm[3]), precision)
