"""The proposal MLP (``tinynerf_torch.core.proposal``) and its kernels'
plain versions (``tinynerf_torch.kernels.proposal_kernel``) against the JAX
package's ``core/proposal.py`` and ``kernels/proposal_kernel.py`` (TPU kernels
7 and 8, run in interpret mode), on the CPU: the parameters, the plain field,
both functions called bf16, the kernels' forward and backward at fp32 and
bf16 at 128 x 4 and 64 x 3, and the point form. Inputs are dyadic
(1/16-quantized, so ``o + t * d`` is exact in float32), made with numpy from
a seed; the JAX weights are carried across with ``ckpt.params_from_numpy``
(a torch generator cannot give JAX's numbers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
import tinynerf.kernels.proposal_kernel as jpk
from tinynerf.core import proposal as jprop
from tinynerf_torch import ckpt
from tinynerf_torch.core import encoding, proposal
from tinynerf_torch.kernels import mlp_kernel as mk
from tinynerf_torch.kernels import proposal_kernel as pk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

NETS = {"128x4": (128, 4), "64x3": (64, 3)}    # conf/lego_prop.ini's; the JAX test's variant
JAX_DTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
# forward: fp32 1e-5 (the JAX kernel test's), bf16 2e-3 of max|ref|; backward:
# 2e-5 of max|ref| (the JAX kernel test's), bf16 1e-2 (slice 3's bounds)
FWD_TOL = {"fp32": 1e-5, "bf16": 2e-3}
GRAD_RTOL = {"fp32": 2e-5, "bf16": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _jax_params(net, seed=0):
    width, depth = NETS[net]
    return jprop.init_proposal(jax.random.PRNGKey(seed), width=width, depth=depth)


def _port(jparams):
    return ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _rays(B=20, N=9, seed=0):
    """tests/test_proposal_kernel.py's ``data``: B, N not tile multiples."""
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    o = q(rng.uniform(-2, 2, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    d = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (B, N))), axis=1).astype(np.float32)
    return o, d, ts


def _cotangents(shape, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]   # sigma, r, g, b


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_kernels():
    """JAX's kernels in interpret mode, once per (net, precision): the
    forward planes and the VJP of every output's cotangent."""
    rays = _rays()
    cots = _cotangents(rays[2].shape)
    out = {}
    for net in NETS:
        jparams = _jax_params(net)
        for precision, dtype in JAX_DTYPE.items():
            fwd, vjp = jax.vjp(lambda p, o, d, t: jpk.prop_field_pallas_rays(
                p, o, d, t, compute_dtype=dtype), jparams, *(jnp.asarray(a) for a in rays))
            (r, g, b), s = fwd
            grads = vjp(((jnp.asarray(cots[1]), jnp.asarray(cots[2]), jnp.asarray(cots[3])),
                         jnp.asarray(cots[0])))
            out[net, precision] = (jparams, (r, g, b, s), grads)
    return rays, cots, out


def test_params_and_the_plain_field_match_jax():
    """``params_from_numpy`` of ``init_proposal`` at 128 x 4 holds 57,932
    parameters in the JAX layout; the plain field against
    ``field_proposal`` (color 1e-6, sigma 1e-5, the JAX kernel test's)."""
    jparams = _jax_params("128x4")
    params = _port(jparams)
    assert proposal.is_proposal(params) and proposal.dims(params) == (128, 4, 10)
    assert sum(t.numel() for layer in params.values() for t in layer.values()) == 57_932
    assert [(n, tuple(params[n]["w"].shape)) for n, _, _ in proposal.layer_dims()] == \
        [(n, (fi, fo)) for n, fi, fo in proposal.layer_dims()]
    o, d, _ = _rays()
    c_ref, s_ref = jprop.field_proposal(jparams, jnp.asarray(o), jnp.asarray(d))
    color, sigma = proposal.field_proposal(params, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(color.numpy(), np.asarray(c_ref), atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(s_ref), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    fresh = proposal.init_proposal(gen, 64, 3, enc_l=6)
    assert proposal.dims(fresh) == (64, 3, 6) and fresh["trunk_0"]["w"].shape == (36, 64)
    assert float(fresh["trunk_1"]["w"].abs().max()) <= 1 / 8


@pytest.mark.parametrize("enc_l", [10, 6])
def test_the_jax_bf16_network_matches(enc_l):
    """``make_field_proposal(enc_l, "bf16")`` against the JAX package's
    ``make_field_proposal(enc_l, compute_dtype=bfloat16)`` (its bf16 network
    without PROP_PALLAS): within 4e-2 of max|ref|, the bound of
    ``test_torch_bf16.py::test_field_plain_bf16_matches_jax_bf16_field``; at
    fp32 within the plain field's bounds."""
    jparams = jprop.init_proposal(jax.random.PRNGKey(enc_l), enc_l=enc_l)
    params = _port(jparams)
    o, d, _ = _rays(B=64, seed=enc_l)
    for precision in ("bf16", "fp32"):
        ref = jprop.make_field_proposal(
            enc_l, compute_dtype=jnp.bfloat16 if precision == "bf16" else None)(
                jparams, jnp.asarray(o), jnp.asarray(d))
        got = proposal.make_field_proposal(enc_l, precision)(
            params, torch.from_numpy(o), torch.from_numpy(d))
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == b.shape
            if precision == "bf16":
                assert _rel(a.numpy(), np.asarray(b, np.float32)) <= 4e-2
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with pytest.raises(ValueError, match="precision"):
        proposal.make_field_proposal(enc_l, "fp16")


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("net", list(NETS))
def test_prop_rays_plain_matches_the_jax_kernel(jax_kernels, net, precision):
    """The forward: ``prop_rays_plain`` against ``prop_field_pallas_rays``."""
    rays, _, out = jax_kernels
    jparams, ref, _ = out[net, precision]
    (r, g, b), s = pk.prop_rays_plain(_port(jparams), *(torch.from_numpy(a) for a in rays),
                                      precision)
    for got, want in zip((r, g, b, s), ref):
        assert got.shape == want.shape == rays[2].shape and got.dtype == torch.float32
        if precision == "fp32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL[precision])
        else:
            assert _rel(got.numpy(), want) <= FWD_TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("net", list(NETS))
def test_prop_rays_bwd_plain_matches_the_jax_kernel(jax_kernels, net, precision):
    """The backward: ``prop_rays_bwd_plain`` against ``jax.vjp`` of
    ``prop_field_pallas_rays`` for every weight and bias, ``d_o``, ``d_d``
    and ``d_ts``, each within GRAD_RTOL of max|ref|; and ``prop_rays``'
    autograd on the CPU is that plain backward (no kernel launches)."""
    rays, cots, out = jax_kernels
    jparams, _, (jg, jgo, jgd, jgt) = out[net, precision]
    params = _port(jparams)
    args = [torch.from_numpy(a) for a in rays + tuple(cots)]
    grads, d_o, d_d, d_ts = pk.prop_rays_bwd_plain(params, *args, precision=precision)
    errors = {f"{n}.{k}": _rel(grads[n][k], jg[n][k]) for n in jg for k in ("w", "b")}
    errors.update(d_o=_rel(d_o, jgo), d_d=_rel(d_d, jgd), d_ts=_rel(d_ts, jgt))
    assert max(errors.values()) <= GRAD_RTOL[precision], errors

    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    o, d, t = (a.clone().requires_grad_(True) for a in args[:3])
    before = (pk.prop_rays.launches, pk.prop_rays_bwd.launches)
    (r, g, b), s = pk.prop_rays(leaves, o, d, t, precision)
    (torch.sum(s * args[3]) + torch.sum(r * args[4]) + torch.sum(g * args[5])
     + torch.sum(b * args[6])).backward()
    assert (pk.prop_rays.launches, pk.prop_rays_bwd.launches) == before
    for n in grads:
        for k in ("w", "b"):
            assert torch.equal(leaves[n][k].grad, grads[n][k]), (n, k)
    assert torch.equal(o.grad, d_o) and torch.equal(d.grad, d_d) and torch.equal(t.grad, d_ts)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("net", list(NETS))
def test_prop_rays_without_ray_gradients_matches_the_jax_kernel(jax_kernels, net, precision):
    """Rays that take no gradient (the main paths': the proposal samples
    are not differentiated): ``prop_rays``' autograd asks the plain
    backward for no ray gradient, which then returns None for ``d_o``,
    ``d_d`` and ``d_ts``; the parameter gradients still match ``jax.vjp`` of
    ``prop_field_pallas_rays`` within GRAD_RTOL of max|ref|, equal the full
    call's bit for bit, and the rays get no gradient."""
    rays, cots, out = jax_kernels
    jparams, _, (jg, *_) = out[net, precision]
    params = _port(jparams)
    o, d, t = (torch.from_numpy(a) for a in rays)
    g = [torch.from_numpy(a) for a in cots]
    full, *ray_grads = pk.prop_rays_bwd_plain(params, o, d, t, *g, precision=precision)
    skip = pk.prop_rays_bwd_plain(params, o, d, t, *g, precision=precision, ray_grads=False)
    assert all(x is not None for x in ray_grads) and skip[1:] == (None, None, None)

    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for n, layer in params.items()}
    before = (pk.prop_rays.launches, pk.prop_rays_bwd.launches)
    (r, gg, b), s = pk.prop_rays(leaves, o, d, t, precision)
    (torch.sum(s * g[0]) + torch.sum(r * g[1]) + torch.sum(gg * g[2])
     + torch.sum(b * g[3])).backward()
    assert (pk.prop_rays.launches, pk.prop_rays_bwd.launches) == before
    assert o.grad is None and d.grad is None and t.grad is None
    errors = {f"{n}.{k}": _rel(leaves[n][k].grad, jg[n][k]) for n in jg for k in ("w", "b")}
    assert max(errors.values()) <= GRAD_RTOL[precision], errors
    for n in params:
        for k in ("w", "b"):
            assert torch.equal(leaves[n][k].grad, full[n][k]), (n, k)
            assert torch.equal(skip[0][n][k], full[n][k]), (n, k)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("n_rays,n_samples", [(129, 1), (3, 43)])
def test_prop_rays_plain_matches_the_jax_kernel_at_tile_edges(n_rays, n_samples, precision):
    """The plain versions at the fp32 kernels' tile edges against
    ``prop_field_pallas_rays`` and its ``jax.vjp`` (interpret mode), at
    conf/lego_prop.ini's 128 x 4: 129 rows at N = 1 (``prop_flat``'s one
    sample a ray, a row past a 128-row tile) and 3 rays of 43 samples (129
    rows, the last ray straddling the tile's edge). Each plane within
    FWD_TOL of max|ref|, every gradient and ``d_o``, ``d_d``, ``d_ts`` within GRAD_RTOL of
    max|ref|."""
    jparams = _jax_params("128x4", seed=5)
    params = _port(jparams)
    rays = _rays(B=n_rays, N=n_samples, seed=6)
    cots = _cotangents(rays[2].shape, seed=7)
    fwd, vjp = jax.vjp(lambda p, o, d, t: jpk.prop_field_pallas_rays(
        p, o, d, t, compute_dtype=JAX_DTYPE[precision]), jparams, *(jnp.asarray(a) for a in rays))
    jg, jgo, jgd, jgt = vjp(((jnp.asarray(cots[1]), jnp.asarray(cots[2]), jnp.asarray(cots[3])),
                             jnp.asarray(cots[0])))
    args = [torch.from_numpy(a) for a in rays + tuple(cots)]
    (r, g, b), s = pk.prop_rays_plain(params, *args[:3], precision)
    (jr, jgg, jb), js = fwd
    for got, want in zip((r, g, b, s), (jr, jgg, jb, js)):
        assert got.shape == want.shape == rays[2].shape
        assert _rel(got.numpy(), want) <= FWD_TOL[precision]
    grads, d_o, d_d, d_ts = pk.prop_rays_bwd_plain(params, *args, precision=precision)
    errors = {f"{n}.{k}": _rel(grads[n][k], jg[n][k]) for n in jg for k in ("w", "b")}
    errors.update(d_o=_rel(d_o, jgo), d_d=_rel(d_d, jgd), d_ts=_rel(d_ts, jgt))
    assert max(errors.values()) <= GRAD_RTOL[precision], errors


def test_prop_flat_matches_the_jax_point_form():
    """The point form rides the ray form at t = 0, as ``prop_field_pallas``
    does: its values (color 1e-6, sigma 1e-5) and its gradient to the
    points, directions and weights (2e-5 of max|ref|) against JAX's."""
    jparams = _jax_params("64x3", seed=2)
    params = _port(jparams)
    o, d, _ = _rays(B=7, seed=3)
    pts, dirs = o.reshape(7, 1, 3), d.reshape(7, 1, 3)
    w = _cotangents((7, 1, 4), seed=4)[0]

    def jloss(p, x, y):
        c, s = jpk.prop_field_pallas(p, x, y, compute_dtype=jnp.float32)
        return jnp.sum(jnp.concatenate([c, s], -1) * w), (c, s)

    (_, (c_ref, s_ref)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jparams, jnp.asarray(pts), jnp.asarray(dirs))
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in layer.items()}
              for n, layer in params.items()}
    x, y = (torch.from_numpy(a).requires_grad_(True) for a in (pts, dirs))
    color, sigma = pk.prop_flat(leaves, x, y)
    assert color.shape == (7, 1, 3) and sigma.shape == (7, 1, 1)
    np.testing.assert_allclose(color.detach().numpy(), np.asarray(c_ref), atol=1e-6)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(s_ref), atol=1e-5)
    torch.sum(torch.cat([color, sigma], -1) * torch.from_numpy(w)).backward()
    assert _rel(x.grad, jgrads[1]) <= 2e-5 and _rel(y.grad, jgrads[2]) <= 2e-5
    for n in params:
        for k in ("w", "b"):
            assert _rel(leaves[n][k].grad, jgrads[0][n][k]) <= 2e-5, (n, k)


def test_sigma_at_exactly_zero_takes_no_gradient():
    """The kernels' sigma cotangent is multiplied by ``sign(sigma_pre)``
    (``proposal_kernel.py:169``): 0 where the head's pre-activation is
    exactly 0. The plain point field keeps autodiff's ``abs'(0) = +1``, as
    JAX's ``field_proposal`` does. A 32 x 1 net whose every ReLU is off and
    whose sigma bias is 0 gives sigma_pre = 0 on every row."""
    jparams = jax.tree_util.tree_map(np.asarray, jprop.init_proposal(
        jax.random.PRNGKey(0), width=32, depth=1))
    jparams["trunk_0"]["b"] = np.full((32,), -100.0, np.float32)
    jparams["sigma"]["b"] = np.zeros(1, np.float32)
    params = _port(jparams)
    o, d, t = (torch.from_numpy(a) for a in _rays(B=3, N=4))
    ones = torch.ones_like(t)
    grads, *_ = pk.prop_rays_bwd_plain(params, o, d, t, ones, 0 * ones, 0 * ones, 0 * ones)
    assert float(grads["sigma"]["b"]) == 0.0
    pts, dirs = o[:, None, :] + t[..., None] * d[:, None, :], d[:, None, :].expand(3, 4, 3)
    p = {n: {k: v.clone().requires_grad_(True) for k, v in layer.items()}
         for n, layer in params.items()}
    proposal.field_proposal(p, pts, dirs)[1].sum().backward()
    jgrad = jax.grad(lambda q: jnp.sum(jprop.field_proposal(
        q, jnp.asarray(pts.numpy()), jnp.asarray(dirs.numpy()))[1]))(jparams)
    assert float(p["sigma"]["b"].grad) == float(jgrad["sigma"]["b"][0]) == 12.0


def test_margin_flop_count_and_refusals():
    """``mlp_kernel.preactivation_margin`` covers the proposal net (its trunk
    and sigma head); the FLOP count is the TPU kernel's; the wrappers refuse
    a width, depth or ``enc_l`` the kernels do not take, on any device."""
    params = proposal.init_proposal(torch.Generator().manual_seed(1), 32, 2)
    o, d, t = (torch.from_numpy(a) for a in _rays(B=4, N=3))
    pts = o[:, None, :] + t[..., None] * d[:, None, :]
    pres = proposal.forward_trunk(params, encoding.encode_points(pts))[1]
    h = torch.relu(pres[-1])
    want = torch.minimum(torch.stack([p.abs().amin(-1) for p in pres]).amin(0),
                         (h @ params["sigma"]["w"] + params["sigma"]["b"]).abs()[..., 0])
    torch.testing.assert_close(mk.preactivation_margin(params, o, d, t), want)
    assert pk.flops_per_row(128, 4) == jpk._prop_flops_per_row(128, 4) == 114_832
    assert pk.flops_per_row(64, 3) == jpk._prop_flops_per_row(64, 3)
    for width, depth, enc_l, what in ((100, 2, 10, "width in"), (288, 2, 10, "width in"),
                                      (64, 65, 10, "depth in 1..64"),
                                      (64, 2, 6, "PROPOSAL_ENC_L = 10")):
        bad = proposal.init_proposal(torch.Generator().manual_seed(0), width, depth, enc_l)
        with pytest.raises(ValueError, match=what):
            pk.prop_rays(bad, o, d, t)
        with pytest.raises(ValueError, match=what):
            pk.prop_rays_bwd(bad, o, d, t, t, t, t, t)
    with pytest.raises(ValueError, match="precision"):
        pk.prop_rays(params, o, d, t, "fp16")
