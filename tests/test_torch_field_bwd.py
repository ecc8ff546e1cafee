"""The field's backward in the port (``tinynerf_torch.kernels.mlp_kernel``:
``field_rays_bwd_plain`` and the ``autograd.Function`` behind
``field_rays``) against ``jax.grad`` through the JAX package's
``field_pallas_rays``, whose VJP is the Pallas recompute-backward kernel
(TPU kernel 2), run in interpret mode as the JAX package's own tests run it.

Tolerance: the JAX kernel test's own (``tests/test_pallas_kernel.py``),
error / max|ref| <= 2e-5 for every output. Inputs are dyadic (see
``tests/test_torch_field.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf.core import mlp as jmlp
from tinynerf_torch.ckpt import params_from_numpy
from tinynerf_torch.core import mlp
from tinynerf_torch.kernels import mlp_kernel as mk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    prev = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = prev


def _dyadic_rays(seed, B, N):
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (B, N))).astype(np.float32), axis=1)
    return origins, dirs, ts


@pytest.fixture(scope="module", params=[(8, 8), (5, 12)], ids=["B8-N8", "B5-N12"])
def case(request):
    """Rays, cotangents, params, and JAX's gradients through the Pallas
    kernel: ((grads, d_o, d_d, d_ts) as numpy)."""
    B, N = request.param
    origins, dirs, ts = _dyadic_rays(B + N, B, N)
    rng = np.random.default_rng(N)
    cots = [rng.normal(size=(B, N)).astype(np.float32) for _ in range(4)]
    jparams = jmlp.init_network(jax.random.PRNGKey(B))
    tree = jax.tree_util.tree_map(np.asarray, jparams)

    def loss(p, o, d, t):
        (r, g, b), s = jmk.field_pallas_rays(p, o, d, t, compute_dtype=jnp.float32)
        gs, gr, gg, gb = cots
        return jnp.sum(s * gs) + jnp.sum(r * gr) + jnp.sum(g * gg) + jnp.sum(b * gb)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jparams, *(jnp.asarray(a) for a in (origins, dirs, ts)))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return params_from_numpy(tree), (origins, dirs, ts), cots, ref


def _check(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err <= TOL, f"{what}: error / max|ref| = {err:.3e}"


def _check_all(grads, d_o, d_d, d_ts, ref):
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            _check(grads[name][part], ref[0][name][part], f"{name}.{part}")
    for got, r, what in zip((d_o, d_d, d_ts), ref[1:], ("d_origins", "d_dirs", "d_ts")):
        _check(got, r, what)


def test_bwd_plain_matches_pallas_vjp(case):
    params, rays, cots, ref = case
    t = [torch.from_numpy(a) for a in rays + tuple(cots)]
    grads, d_o, d_d, d_ts = mk.field_rays_bwd_plain(params, *t)
    _check_all({n: {k: v.numpy() for k, v in l.items()} for n, l in grads.items()},
               d_o.numpy(), d_d.numpy(), d_ts.numpy(), ref)


def test_autograd_function_matches_pallas_vjp(case):
    """Gradients of every weight, bias, origin, direction and t through
    ``field_rays`` (the port's ``autograd.Function``) on the CPU."""
    params, rays, cots, ref = case
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in l.items()}
              for n, l in params.items()}
    o, d, t = (torch.from_numpy(a).requires_grad_(True) for a in rays)
    (r, g, b), s = mk.field_rays(leaves, o, d, t)
    gs, gr, gg, gb = (torch.from_numpy(c) for c in cots)
    ((s * gs).sum() + (r * gr).sum() + (g * gg).sum() + (b * gb).sum()).backward()
    _check_all({n: {k: v.grad.numpy() for k, v in l.items()} for n, l in leaves.items()},
               o.grad.numpy(), d.grad.numpy(), t.grad.numpy(), ref)


def test_field_rays_bwd_on_cpu_is_the_plain_version(case):
    params, rays, cots, _ = case
    t = [torch.from_numpy(a) for a in rays + tuple(cots)]
    before = mk.field_rays_bwd.launches
    got = mk.field_rays_bwd(params, *t)
    want = mk.field_rays_bwd_plain(params, *t)
    assert mk.field_rays_bwd.launches == before  # nothing was launched
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            assert torch.equal(got[0][name][part], want[0][name][part])
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))


def test_unused_outputs_get_zero_cotangents():
    """A loss of sigma alone: the color planes' cotangents are zero, as for
    the plain field."""
    params = mlp.init_network(torch.Generator().manual_seed(0))
    o, d, t = (torch.from_numpy(a) for a in _dyadic_rays(1, 3, 4))
    t = t.requires_grad_(True)
    _, s = mk.field_rays(params, o, d, t)
    (g_t,) = torch.autograd.grad(s.sum(), t)
    _, s_plain = mk.field_rays_plain(params, o, d, t)
    (want,) = torch.autograd.grad(s_plain.sum(), t)
    torch.testing.assert_close(g_t, want, rtol=1e-6, atol=1e-7)


def test_preactivation_margin_is_the_smallest_unit():
    """With every weight zero, each pre-activation is its bias: the margin is
    the smallest |bias| over the trunk, the sigma head and the view branch."""
    params = mlp.init_network(torch.Generator().manual_seed(4))
    for name, _, fan_out in mlp.layer_dims():
        params[name]["w"] = torch.zeros_like(params[name]["w"])
        params[name]["b"] = torch.linspace(0.5, 2.0, fan_out)
    params["trunk_5"]["b"][7] = -0.25
    o, d, t = (torch.from_numpy(a) for a in _dyadic_rays(2, 2, 3))
    assert torch.equal(mk.preactivation_margin(params, o, d, t), torch.full((2, 3), 0.25))
    params["sigma"]["b"] = torch.tensor([0.125])
    assert torch.equal(mk.preactivation_margin(params, o, d, t), torch.full((2, 3), 0.125))
    params["dir_info"]["b"][3] = -1e-3
    assert torch.allclose(mk.preactivation_margin(params, o, d, t), torch.full((2, 3), 1e-3))


@pytest.mark.parametrize("precision,grad,want", [
    ("bf16", True, True), ("bf16", False, False), ("fp32", True, False),
    ("fp32", False, False)])
def test_saves_residuals_only_for_a_bf16_card_call_with_a_backward(precision, grad, want):
    """Kernel 1 on the card keeps its residuals only where the backward from
    them can follow: the bf16 form, with a gradient asked for (CPU tensors
    take the plain versions, below)."""
    assert mk.saves_residuals(precision, grad) is want


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("grad", [False, True])
def test_field_rays_on_cpu_takes_the_plain_versions(precision, grad):
    """On CPU tensors the forward and its backward are the plain versions
    bit for bit, with or without grad: nothing launched, no residual kept
    or missed (the counters), nothing saved beyond the rays and weights."""
    from tinynerf_torch import profiling
    params = mlp.init_network(torch.Generator().manual_seed(5))
    rays = [torch.from_numpy(a) for a in _dyadic_rays(5, 3, 6)]
    cots = [torch.from_numpy(np.random.default_rng(6).normal(size=(3, 6)).astype(np.float32))
            for _ in range(4)]
    counters = lambda: {k: profiling.snapshot()["counters"].get(k, 0)
                        for k in ("field.residual.saved", "field.residual.recomputed")}
    before, launches = counters(), (mk.field_rays.launches, mk.field_rays_bwd.launches)
    leaves = {n: {k: v.clone().requires_grad_(grad) for k, v in l.items()}
              for n, l in params.items()}
    o, d, t = (x.clone().requires_grad_(grad) for x in rays)
    with torch.set_grad_enabled(grad):
        (r, g, b), s = mk.field_rays(leaves, o, d, t, precision)
    (pr, pg, pb), ps = mk.field_rays_plain(params, *rays, precision)
    assert all(torch.equal(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (s, ps)))
    if grad:
        assert len(s.grad_fn.saved_tensors) == 3 + len(mk._PARAM_KEYS)
        gs, gr, gg, gb = cots
        ((s * gs).sum() + (r * gr).sum() + (g * gg).sum() + (b * gb).sum()).backward()
        want = mk.field_rays_bwd_plain(params, *rays, *cots, precision=precision)
        for name, _, _ in mlp.layer_dims():
            for part in ("w", "b"):
                assert torch.equal(leaves[name][part].grad, want[0][name][part])
        assert all(torch.equal(x.grad, y) for x, y in zip((o, d, t), want[1:]))
    assert counters() == before
    assert (mk.field_rays.launches, mk.field_rays_bwd.launches) == launches


@pytest.mark.parametrize("precision,grad_mode,requires,save", [
    ("bf16", True, True, True), ("bf16", False, True, False), ("bf16", True, False, False),
    ("fp32", True, True, False)])
def test_field_rays_hands_its_residuals_to_the_backward(monkeypatch, precision, grad_mode,
                                                        requires, save):
    """The autograd plumbing, with the kernels' launches stubbed by the plain
    versions as if on a card: the forward asks for the saving form exactly
    where ``saves_residuals`` says so (grad mode on and an input that
    requires grad, read outside the Function, where the grad mode is the
    caller's), and its backward gets the residuals that forward kept, or
    none."""
    seen = {}

    def launch(params, o, d, t, precision, save=False):
        seen["save"] = save
        (r, g, b), s = mk.field_rays_plain(params, o, d, t, precision)
        res = mk.Residuals(torch.zeros(4), torch.zeros(2, 2), -torch.ones_like(s), r, g, b)
        return (r, g, b), s, res if save else None

    def launch_bwd(params, o, d, t, gs, gr, gg, gb, precision, residuals=None):
        seen["residuals"] = residuals
        return mk.field_rays_bwd_plain(params, o, d, t, gs, gr, gg, gb, precision)

    monkeypatch.setattr(mk, "_launch", launch)
    monkeypatch.setattr(mk, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(mk, "_on_one_device", lambda tensors, what: True)
    params = mlp.init_network(torch.Generator().manual_seed(7))
    leaves = {n: {k: v.clone().requires_grad_(requires) for k, v in l.items()}
              for n, l in params.items()}
    o, d, t = (torch.from_numpy(a) for a in _dyadic_rays(7, 2, 5))
    with torch.set_grad_enabled(grad_mode):
        (r, g, b), s = mk.field_rays(leaves, o, d, t, precision)
    assert seen["save"] is save
    if not (grad_mode and requires):
        return
    (s.sum() + r.sum()).backward()
    res = seen["residuals"]
    if save:
        assert torch.equal(res.sign, -torch.ones_like(s))
        assert all(torch.equal(x, y) for x, y in ((res.r, r), (res.g, g), (res.b, b)))
    else:
        assert res is None
