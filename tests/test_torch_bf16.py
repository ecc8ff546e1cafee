"""``PRECISION=bf16`` in the port against the JAX package, on the CPU at small
sizes: the bf16 plain versions of the field kernels (kernel 3's flat
forward, kernels 1 and 2's ray-major forward and backward) against the JAX
package's Pallas kernels at ``compute_dtype=bfloat16`` in interpret mode;
the ``USE_PALLAS = False`` field against the JAX package's ``bf16_field``;
and one ``conf/lego_occ.ini``-shaped training step (bf16, an 8^3 occupancy
grid refreshed at iteration 0, white background) against the JAX step built
with ``force_pallas=True``.

Both bf16 forms round at the same points and differ in summation order,
which can move a rounded activation by one bf16 ulp (2^-8 relative) and
flip a ReLU. Bounds are relative to the reference's max, at least 4x the
worst measured here and within 1e-2 (forward) and 3e-2 (backward) of max.
Inputs are dyadic (see ``tests/test_torch_field.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf import train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core import mlp as jmlp, occupancy as joccupancy
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf_torch import ckpt, eval as evallib, train
from tinynerf_torch.config import Config
from tinynerf_torch.core import mlp, render
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.kernels import mlp_kernel as mk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

FWD_RTOL = 2e-3   # measured at most 4.7e-4 of max|ref| (sigma, B=13 N=8)
BWD_RTOL = 1e-2   # measured at most 6.6e-4 of max|ref| (sigma.w, B=5 N=12)
COS = 0.999       # per gradient tensor; measured >= 0.99999998
FP32_COLOR_ATOL, FP32_SIGMA_ATOL = 1e-6, 1e-5  # the JAX kernel test's own


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


def _params(seed):
    jparams = jmlp.init_network(jax.random.PRNGKey(seed))
    return jparams, ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def _flat_points(origins, dirs, ts):
    B, N = ts.shape
    pts = (origins[:, None] + ts[..., None] * dirs[:, None]).reshape(-1, 3)
    return pts, np.broadcast_to(dirs[:, None], (B, N, 3)).reshape(-1, 3).copy()


# ---------------------------------------------------------------- kernel 3

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_field_flat_plain_matches_field_pallas_interpret(precision):
    """Kernel 3's plain version against ``field_pallas`` (``_fused_forward``)
    in interpret mode: fp32 at the JAX kernel test's bounds, bf16 at
    FWD_RTOL of max|ref|. 97 rows: not a multiple of a tile."""
    jparams, params = _params(21)
    pts, dirs = _flat_points(*_dyadic_rays(22, 97, 1))
    dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    c_ref, s_ref = jmk.field_pallas(jparams, jnp.asarray(pts), jnp.asarray(dirs),
                                    compute_dtype=dtype)
    color, sigma = mk.field_flat_plain(params, torch.from_numpy(pts),
                                       torch.from_numpy(dirs), precision)
    assert color.shape == (97, 3) and sigma.shape == (97, 1)
    if precision == "fp32":
        np.testing.assert_allclose(color.numpy(), np.asarray(c_ref), atol=FP32_COLOR_ATOL)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(s_ref), atol=FP32_SIGMA_ATOL)
    else:
        assert _rel(color.numpy(), c_ref) <= FWD_RTOL
        assert _rel(sigma.numpy(), s_ref) <= FWD_RTOL


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_field_flat_on_cpu_is_the_plain_version(precision):
    """On CPU tensors ``field_flat`` launches nothing, takes the plain
    version, keeps the leading shape and stays differentiable."""
    _, params = _params(23)
    pts, dirs = (torch.from_numpy(a).reshape(4, 6, 3)
                 for a in _flat_points(*_dyadic_rays(24, 4, 6)))
    before = mk.field_flat.launches
    color, sigma = mk.field_flat(params, pts.requires_grad_(True), dirs, precision)
    assert mk.field_flat.launches == before
    assert color.shape == (4, 6, 3) and sigma.shape == (4, 6, 1)
    p_color, p_sigma = mk.field_flat_plain(params, pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                           precision)
    assert torch.equal(color.reshape(-1, 3), p_color)
    assert torch.equal(sigma.reshape(-1, 1), p_sigma)
    (g,) = torch.autograd.grad(sigma.sum(), pts)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    with pytest.raises(ValueError, match="precision"):
        mk.field_flat(params, pts, dirs, "fp16")


# ---------------------------------------------------------------- kernels 1, 2

@pytest.mark.parametrize("shape", [(13, 8), (5, 16)])
def test_field_rays_bf16_matches_pallas_interpret(shape):
    """Kernel 1's bf16 plain version against ``field_pallas_rays`` at
    bf16: every plane within FWD_RTOL of max|ref|."""
    jparams, params = _params(25)
    origins, dirs, ts = _dyadic_rays(26, *shape)
    (jr, jg, jb), js = jmk.field_pallas_rays(jparams, *map(jnp.asarray, (origins, dirs, ts)),
                                             compute_dtype=jnp.bfloat16)
    (r, g, b), s = mk.field_rays(params, *map(torch.from_numpy, (origins, dirs, ts)),
                                 precision="bf16")
    for got, ref in ((r, jr), (g, jg), (b, jb), (s, js)):
        assert _rel(got.numpy(), ref) <= FWD_RTOL


@pytest.fixture(scope="module", params=[(8, 8), (5, 12)], ids=["B8-N8", "B5-N12"])
def bwd_case(request):
    """JAX's gradients through ``field_pallas_rays`` at bf16 (the Pallas
    recompute backward, ``_ray_bwd_kernel``, in interpret mode)."""
    B, N = request.param
    origins, dirs, ts = _dyadic_rays(B + N, B, N)
    rng = np.random.default_rng(N)
    cots = [rng.normal(size=(B, N)).astype(np.float32) for _ in range(4)]
    jparams, params = _params(B)

    def loss(p, o, d, t):
        (r, g, b), s = jmk.field_pallas_rays(p, o, d, t, compute_dtype=jnp.bfloat16)
        return sum(jnp.sum(x * c) for x, c in zip((s, r, g, b), cots))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(jparams, *map(jnp.asarray, (origins, dirs, ts)))
    return params, (origins, dirs, ts), cots, jax.tree_util.tree_map(np.asarray, ref)


def _check_grads(grads, d_o, d_d, d_ts, ref):
    for name, _, _ in mlp.layer_dims():
        for part in ("w", "b"):
            got = np.asarray(grads[name][part])
            assert _rel(got, ref[0][name][part]) <= BWD_RTOL, f"{name}.{part}"
            assert _cos(got, ref[0][name][part]) >= COS, f"{name}.{part}"
    for got, r, what in zip((d_o, d_d, d_ts), ref[1:], ("d_origins", "d_dirs", "d_ts")):
        assert _rel(got, r) <= BWD_RTOL, what
        assert _cos(got, r) >= COS, what


def test_field_rays_bwd_bf16_plain_matches_pallas_vjp(bwd_case):
    """Kernel 2's bf16 plain version: every weight gradient (float32, as the
    TPU kernel keeps them) and d_origins, d_dirs, d_ts."""
    params, rays, cots, ref = bwd_case
    grads, d_o, d_d, d_ts = mk.field_rays_bwd_plain(
        params, *map(torch.from_numpy, rays + tuple(cots)), precision="bf16")
    assert all(t.dtype == torch.float32 for layer in grads.values() for t in layer.values())
    _check_grads({n: {k: v.numpy() for k, v in l.items()} for n, l in grads.items()},
                 d_o.numpy(), d_d.numpy(), d_ts.numpy(), ref)


def test_autograd_function_bf16_matches_pallas_vjp(bwd_case):
    """The same gradients through ``field_rays(precision="bf16")``, the
    port's ``autograd.Function``."""
    params, rays, cots, ref = bwd_case
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in l.items()}
              for n, l in params.items()}
    o, d, t = (torch.from_numpy(a).requires_grad_(True) for a in rays)
    (r, g, b), s = mk.field_rays(leaves, o, d, t, precision="bf16")
    sum((x * torch.from_numpy(c)).sum() for x, c in zip((s, r, g, b), cots)).backward()
    _check_grads({n: {k: v.grad.numpy() for k, v in l.items()} for n, l in leaves.items()},
                 o.grad.numpy(), d.grad.numpy(), t.grad.numpy(), ref)


# ---------------------------------------------------------------- USE_PALLAS off

def test_field_plain_bf16_matches_jax_bf16_field():
    """``USE_PALLAS = False`` at bf16: ``render.field_plain_bf16`` against
    the JAX package's ``bf16_field`` (``train.make_field_fn`` off the TPU),
    which runs the whole network in bfloat16 tensors. Bound: 4e-2 of
    max|ref| per output (measured 7.5e-3 on color, 0 on sigma: outputs in
    bf16, whose ulp is 2^-8 relative, from products that the two libraries
    sum in other orders). It is a different function from the kernels' bf16
    form, which sums in float32."""
    jparams, params = _params(27)
    pts, dirs = _flat_points(*_dyadic_rays(28, 16, 8))
    jfield = jtrain.make_field_fn(JConfig(precision="bf16", use_pallas=False))
    assert jfield.__name__ == "bf16_field"
    c_ref, s_ref = jfield(jparams, jnp.asarray(pts), jnp.asarray(dirs))
    color, sigma = render.field_plain_bf16(params, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert color.dtype == sigma.dtype == torch.float32
    assert _rel(color.numpy(), c_ref) <= 4e-2
    assert _rel(sigma.numpy(), s_ref) <= 4e-2
    k_color, k_sigma = mk.field_flat_plain(params, torch.from_numpy(pts),
                                           torch.from_numpy(dirs), "bf16")
    assert not torch.equal(k_sigma, sigma)  # the two bf16 functions differ


def test_make_field_fn_picks_the_field_by_precision():
    """With USE_PALLAS the point field is ``field_flat`` and ``eval_rays``
    is ``field_rays``, both at PRECISION (on the card, the kernels: no
    plain field on the path); without it the plain fields."""
    for precision in ("fp32", "bf16"):
        fn = evallib.make_field_fn(Config(precision=precision))
        assert fn.func is mk.field_flat and fn.keywords == {"precision": precision}
        assert fn.eval_rays.func is mk.field_rays
        assert fn.eval_rays.keywords == {"precision": precision}
    assert evallib.make_field_fn(Config(use_pallas=False)) is render.field_plain
    assert evallib.make_field_fn(Config(use_pallas=False, precision="bf16")) \
        is render.field_plain_bf16
    with pytest.raises(ValueError, match="PRECISION"):
        evallib.make_field_fn(Config(precision="fp16"))


# ---------------------------------------------------------------- one step

def test_lego_occ_shaped_step_matches_jax(sync_scene_dir):
    """One step of conf/lego_occ.ini's shape, cut to size: bf16, an 8^3
    occupancy grid refreshed at iteration 0 (64 of 512 cells, the JAX
    draws injected), WHITE_BKGD, 32 rays at 8 + 16 samples, the same
    params (sigma bias +1) and pixel indices. Against the JAX step's pieces
    built with ``make_field_fn(force_pallas=True)`` (the Pallas kernels in
    interpret mode): the grid after the refresh (probed cells within 1e-2
    of max; measured 1.5e-5), the loss (rel 1e-3; measured 1.1e-6) and the
    gradient of all 593,924 parameters (cosine >= 0.999; measured
    0.9999967)."""
    kw = dict(n_coarse=8, n_fine=16, batch_ray=32, precision="bf16", white_bkgd=True,
              occ_grid=True, occ_res=8, occ_extent=1.5, occ_subset=0.125,
              occ_update_every=256, occ_march_steps=64)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jtable = JRayTable(jload_scene(sync_scene_dir, "sync", "train"))
    table = RayTable(load_scene(sync_scene_dir, "sync", "train"))
    idx = np.random.default_rng(29).integers(0, table.num_pix, 32).astype(np.int32)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init_network(jax.random.PRNGKey(30)))
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    jparams, params = jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)

    # the JAX step: refresh at iteration 0, then the loss and its gradient
    jfield = jtrain.make_field_fn(jcfg, force_pallas=True)
    jk_inv = jmake_k_inv(jtable.height, jtable.width, jtable.focal)
    okey = jax.random.PRNGKey(31)
    jocc = joccupancy.update_grid(jtrain.init_state(jcfg, params=jparams).occ, jparams,
                                  jfield, okey, subset=64)
    j_loss_fn = jtrain.make_loss_fn(jcfg, jk_inv, jfield)
    (j_loss, _), j_grads = jax.value_and_grad(j_loss_fn, has_aux=True)(
        jparams, jtable.gather(jnp.asarray(idx)), jax.random.PRNGKey(0), jocc)

    # the port's step, with JAX's cell draw and jitter
    kidx, kjit = jax.random.split(okey)
    draws = (torch.tensor(np.asarray(jax.random.randint(kidx, (64,), 0, 512))),
             torch.tensor(np.asarray(jax.random.uniform(kjit, (64, 3)))))
    k_inv = make_k_inv(table.height, table.width, table.focal)
    state = train.init_state(cfg, torch.device("cpu"), params=params)
    field_fn = evallib.make_field_fn(cfg)
    occ = train.refresh_occ(cfg, state, field_fn, draws)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx)), None, occ)

    raw, j_raw = occ.raw.numpy().reshape(-1), np.asarray(jocc.raw).reshape(-1)
    probed = np.isfinite(j_raw)
    np.testing.assert_array_equal(np.isfinite(raw), probed)
    assert _rel(raw[probed], j_raw[probed]) <= 1e-2
    np.testing.assert_array_equal(occ.density.numpy() > 0.01, np.asarray(jocc.density) > 0.01)
    assert abs(loss.item() / float(j_loss) - 1) <= 1e-3
    flat = lambda g, get: np.concatenate([np.asarray(get(g[n][k])).ravel()
                                          for n, _, _ in mlp.layer_dims() for k in ("w", "b")])
    got, ref = flat(grads, lambda x: x.numpy()), flat(j_grads, np.asarray)
    assert got.size == 593_924 and _cos(got, ref) >= 0.999

    # the step itself: same grid and loss, one Adam update, the grid kept
    step = train.make_indexed_train_step(cfg, table, k_inv)
    new, metrics = step(state, torch.from_numpy(idx), occ_draws=draws)
    assert torch.equal(new.occ.raw, occ.raw) and new.iteration == 1
    assert metrics["loss"].item() == loss.item()
