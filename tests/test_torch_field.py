"""The port's field (``tinynerf_torch``: encoding, MLP, ``field_rays``) against
the JAX package's (``field_jnp`` and the Pallas ray kernel in interpret
mode), on the same weights and inputs made with numpy from a seed.

Inputs are dyadic (coordinates quantized to 1/16) so that ``o + t*d`` is
exact in float32 in both frameworks: otherwise a 1-ulp difference in a point,
at encoding arguments up to 2^10*pi*|x|, moves sin/cos by ~1e-3 and flips
relu masks, which would hide the comparison of the networks themselves.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf.core import encoding as jenc, mlp as jmlp, render as jrender
from tinynerf_torch.ckpt import params_from_numpy
from tinynerf_torch.core import encoding, mlp, render
from tinynerf_torch.kernels import mlp_kernel as mk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

# The JAX kernel test's own bounds (tests/test_pallas_kernel.py:37-38); the
# port meets them on the CPU, summing in another order than XLA.
COLOR_ATOL = 1e-6
SIGMA_ATOL = 1e-5


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


@pytest.fixture(scope="module")
def data():
    jparams = jmlp.init_network(jax.random.PRNGKey(2))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    origins, dirs, ts = _dyadic_rays(3, 13, 8)  # 13: not a multiple of a tile
    return jparams, params_from_numpy(np_params), origins, dirs, ts


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_ray_field(jparams, origins, dirs, ts):
    o, d, t = jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(ts)
    pts = o[:, None, :] + t[..., None] * d[:, None, :]
    color, sigma = jrender.field_jnp(jparams, pts, jnp.broadcast_to(d[:, None, :], pts.shape))
    return np.asarray(color), np.asarray(sigma)[..., 0]


def _stack(planes):
    return np.stack([p.numpy() for p in planes], axis=-1)


def test_param_count_is_593924(data):
    _, params, *_ = data
    assert mlp.num_params(params) == 593_924
    assert mlp.num_params(mlp.init_network(torch.Generator().manual_seed(0))) == 593_924
    assert [d for d in mlp.layer_dims()] == [d for d in jmlp.layer_dims()]


def test_init_network_is_seeded_and_bounded():
    a = mlp.init_network(torch.Generator().manual_seed(7))
    b = mlp.init_network(torch.Generator().manual_seed(7))
    c = mlp.init_network(torch.Generator().manual_seed(8))
    for name, fan_in, fan_out in mlp.layer_dims():
        assert a[name]["w"].shape == (fan_in, fan_out)
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert torch.equal(a[name]["b"], b[name]["b"])
        bound = 1.0 / fan_in ** 0.5
        assert float(a[name]["w"].abs().max()) <= bound
        assert float(a[name]["b"].abs().max()) <= bound
    assert not torch.equal(a["trunk_1"]["w"], c["trunk_1"]["w"])


@pytest.mark.parametrize("fn", ["encode_points", "encode_dirs"])
def test_encoding_matches_jax(fn):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    ref = np.asarray(getattr(jenc, fn)(jnp.asarray(x)))
    got = getattr(encoding, fn)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # the arguments are bit-equal; sin/cos of one f32 argument differ by at
    # most an ulp or two between the two CPU math libraries
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_apply_network_matches_jax(data):
    jparams, params, *_ = data
    rng = np.random.default_rng(5)
    pe = rng.uniform(-1, 1, (40, 60)).astype(np.float32)
    de = rng.uniform(-1, 1, (40, 24)).astype(np.float32)
    c_ref, s_ref = jmlp.apply_network(jparams, jnp.asarray(pe), jnp.asarray(de))
    c, s = mlp.apply_network(params, *_torch(pe, de))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=COLOR_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SIGMA_ATOL)


def test_radiance_field_module_matches_apply_network(data):
    _, params, *_ = data
    model = mlp.RadianceField(params)
    assert mlp.num_params(model.params()) == 593_924
    assert sum(p.numel() for p in model.parameters()) == 593_924
    pe, de = _torch(np.ones((2, 60), np.float32), np.ones((2, 24), np.float32))
    with torch.no_grad():
        c, s = model(pe, de)
    c_ref, s_ref = mlp.apply_network(params, pe, de)
    assert torch.equal(c, c_ref) and torch.equal(s, s_ref)


def test_field_rays_matches_field_jnp(data):
    jparams, params, origins, dirs, ts = data
    c_ref, s_ref = _jax_ray_field(jparams, origins, dirs, ts)
    planes, sigma = mk.field_rays(params, *_torch(origins, dirs, ts))
    assert len(planes) == 3 and all(p.shape == ts.shape for p in planes)
    assert sigma.shape == ts.shape
    np.testing.assert_allclose(_stack(planes), c_ref, atol=COLOR_ATOL)
    np.testing.assert_allclose(sigma.numpy(), s_ref, atol=SIGMA_ATOL)


@pytest.mark.parametrize("shape", [(13, 8), (5, 16)])
def test_field_rays_matches_pallas_interpret(data, shape):
    jparams, params, *_ = data
    origins, dirs, ts = _dyadic_rays(11, *shape)
    c_k, s_k = jmk.field_pallas_rays(jparams, jnp.asarray(origins),
                                     jnp.asarray(dirs), jnp.asarray(ts),
                                     compute_dtype=jnp.float32)
    planes, sigma = mk.field_rays(params, *_torch(origins, dirs, ts))
    np.testing.assert_allclose(_stack(planes),
                               np.stack([np.asarray(c) for c in c_k], -1),
                               atol=COLOR_ATOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(s_k), atol=SIGMA_ATOL)


def test_field_rays_on_cpu_is_the_plain_version(data):
    _, params, origins, dirs, ts = data
    before = mk.field_rays.launches
    planes, sigma = mk.field_rays(params, *_torch(origins, dirs, ts))
    p_planes, p_sigma = mk.field_rays_plain(params, *_torch(origins, dirs, ts))
    assert mk.field_rays.launches == before  # nothing was launched
    assert torch.equal(sigma, p_sigma)
    assert all(torch.equal(a, b) for a, b in zip(planes, p_planes))


def test_field_rays_refuses_grad_and_bf16(data):
    """Both precisions are ported (fp32, and bf16, the TPU kernels' bf16
    form), and an unknown one is refused. Under grad mode ``field_rays``
    records its backward at either precision, under ``no_grad`` it records
    nothing."""
    _, params, origins, dirs, ts = data
    o, d, t = _torch(origins, dirs, ts)
    with pytest.raises(ValueError, match="precision"):
        mk.field_rays(params, o, d, t, precision="fp16")
    for precision in ("fp32", "bf16"):
        _, sigma = mk.field_rays(params, o, d, t.clone().requires_grad_(True),
                                 precision=precision)
        assert sigma.requires_grad and sigma.grad_fn is not None
    with torch.no_grad():
        _, sigma = mk.field_rays(params, o, d, t.clone().requires_grad_(True))
    assert not sigma.requires_grad


def test_eval_rays_hook_matches_point_field(data):
    """``render._eval_field`` through the kernel wrapper (``eval_rays``) and
    through the plain point field give the same planes."""
    import functools
    _, params, origins, dirs, ts = data
    hooked = functools.partial(render.field_plain)
    hooked.eval_rays = mk.field_rays
    o, d, t = _torch(origins, dirs, ts)
    a_planes, a_sigma = render._eval_field(hooked, params, o, d, t)
    b_planes, b_sigma = render._eval_field(render.field_plain, params, o, d, t)
    assert torch.equal(a_sigma, b_sigma)
    assert all(torch.equal(a, b) for a, b in zip(a_planes, b_planes))


def test_flops_per_row_matches_jax():
    assert mk.flops_per_row() == jmk._flops_per_row() == 1_182_976
