"""The flat field's backward in the port (``tinynerf_torch.kernels.mlp_kernel``:
``field_flat_bwd_plain`` and the ``autograd.Function`` behind ``field_flat``)
against ``jax.vjp`` of the JAX package's ``field_pallas``, whose VJP is the
Pallas recompute-backward kernel ``_fused_backward`` (TPU kernel 4), run in
interpret mode as the JAX package's own tests run it.

Tolerances: fp32, the JAX kernel test's own, error / max|ref| <= 2e-5 for
every gradient, with rows whose smallest |pre-activation| is under 2e-6
given zero cotangents (there two float32 sums may take opposite sides of a
ReLU: ``mlp_kernel.preactivation_margin``); bf16, 1e-2 of max|ref| (the same
rounding points, sums in other orders). Row counts are ragged: no multiple
of the JAX kernel's tiles (128, 1024) or of the CUDA kernel's 64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf.core import mlp as jmlp
from tinynerf_torch.ckpt import params_from_numpy
from tinynerf_torch.core import encoding, mlp
from tinynerf_torch.kernels import mlp_kernel as mk

FP32_TOL = 2e-5
BF16_TOL = 1e-2
MARGIN = 2e-6


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _points(seed, R):
    """Points inside, on and far outside the contraction's unit ball, as
    the renderer hands them to the field under CONTRACT, and unit dirs."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3))
    radius = rng.choice([0.3, 1.0, 1.7], size=(R, 1))
    pts = (d / np.linalg.norm(d, axis=-1, keepdims=True) * radius).astype(np.float32)
    v = rng.normal(size=(R, 3))
    dirs = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    return pts, dirs


def flat_margin(params, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(R,): each row's smallest |pre-activation|, the ray form's margin at
    t = 0 (the point is the origin)."""
    return mk.preactivation_margin(params, pts, dirs, torch.zeros(pts.shape[0], 1))[:, 0]


@pytest.fixture(scope="module", params=[("fp32", 97), ("fp32", 300), ("bf16", 97),
                                        ("bf16", 300)],
                ids=["fp32-R97", "fp32-R300", "bf16-R97", "bf16-R300"])
def case(request):
    """Params, rows, the (R, 4) cotangent, and JAX's VJP through the Pallas
    kernel: (grads, d_points, d_dirs) as numpy."""
    precision, R = request.param
    jparams = jmlp.init_network(jax.random.PRNGKey(R))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    pts, dirs = _points(R, R)
    g = np.random.default_rng(R + 1).normal(size=(R, 4)).astype(np.float32)
    if precision == "fp32":
        margin = flat_margin(params, torch.from_numpy(pts), torch.from_numpy(dirs))
        g[(margin < MARGIN).numpy()] = 0.0
    dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    _, vjp = jax.vjp(lambda p, x, d: jmk.field_pallas(p, x, d, compute_dtype=dtype),
                     jparams, jnp.asarray(pts), jnp.asarray(dirs))
    ref = vjp((jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:])))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return precision, params, (pts, dirs, g), ref


def _check_all(precision, grads, d_points, d_dirs, ref):
    tol = FP32_TOL if precision == "fp32" else BF16_TOL
    pairs = [(grads[name][part], ref[0][name][part], f"{name}.{part}")
             for name, _, _ in mlp.layer_dims() for part in ("w", "b")]
    pairs += [(d_points, ref[1], "d_points"), (d_dirs, ref[2], "d_dirs")]
    for got, want, what in pairs:
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == want.shape, what
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
        assert err <= tol, f"{what}: error / max|ref| = {err:.3e}"


def test_flat_bwd_plain_matches_pallas_vjp(case):
    precision, params, (pts, dirs, g), ref = case
    grads, d_p, d_d = mk.field_flat_bwd_plain(
        params, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g),
        precision)
    _check_all(precision, grads, d_p, d_d, ref)


def test_field_flat_autograd_matches_pallas_vjp(case):
    """Gradients of every weight, bias, point and direction through
    ``field_flat`` (the port's ``autograd.Function``) on the CPU, with the
    rows in a (.., 3) batch shape as the renderer passes them."""
    precision, params, (pts, dirs, g), ref = case
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in l.items()}
              for n, l in params.items()}
    p = torch.from_numpy(pts).requires_grad_(True)
    d = torch.from_numpy(dirs).requires_grad_(True)
    R = pts.shape[0]
    color, sigma = mk.field_flat(leaves, p.reshape(1, R, 3), d.reshape(1, R, 3), precision)
    assert color.shape == (1, R, 3) and sigma.shape == (1, R, 1)
    gt = torch.from_numpy(g)
    ((color[0] * gt[:, :3]).sum() + (sigma[0] * gt[:, 3:]).sum()).backward()
    _check_all(precision, {n: {k: v.grad for k, v in l.items()} for n, l in leaves.items()},
               p.grad, d.grad, ref)


def test_field_flat_bwd_on_cpu_is_the_plain_version(case):
    precision, params, (pts, dirs, g), _ = case
    args = (params, torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g))
    before = mk.field_flat_bwd.launches
    got = mk.field_flat_bwd(*args, precision=precision)
    want = mk.field_flat_bwd_plain(*args, precision=precision)
    assert mk.field_flat_bwd.launches == before  # nothing was launched
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            assert torch.equal(got[0][name][part], want[0][name][part])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_flat_bwd_bf16_rounds_the_heads_gradients():
    """At bf16 the flat backward rounds the heads' pre-activation gradients
    (``_bwd_core``'s casts): the sigma bias's gradient is the float32 sum of
    ``round_bf16(g_sigma * sign(sigma_pre))``, which the ray backward's
    convention (float32 heads) does not give."""
    params = mlp.init_network(torch.Generator().manual_seed(5))
    pts, dirs = (torch.from_numpy(a) for a in _points(6, 33))
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(33, 4)).astype(np.float32))
    g = g * (1.0 + 2.0 ** -10)  # off the bf16 grid
    grads, _, _ = mk.field_flat_bwd_plain(params, pts, dirs, g, "bf16")
    sign = torch.sign(_sigma_pre(params, pts))
    want = mlp.round_bf16(g[:, 3] * sign).sum()
    torch.testing.assert_close(grads["sigma"]["b"][0], want, rtol=1e-6, atol=0)
    assert abs(float(grads["sigma"]["b"][0] - (g[:, 3] * sign).sum())) > 1e-6


def _sigma_pre(params, pts):
    """The sigma head's pre-activation at bf16 (before the abs)."""
    value, act = mlp.rounding("bf16")
    pe = value(encoding.encode_points(pts))
    h = pe
    with torch.no_grad():
        for i in range(mlp.DEPTH):
            if i in mlp.SKIP_LAYERS:
                h = torch.cat([h, pe], dim=-1)
            h = act(torch.relu(h @ value(params[f"trunk_{i}"]["w"]) + params[f"trunk_{i}"]["b"]))
        return (h @ value(params["sigma"]["w"]) + params["sigma"]["b"])[:, 0]
