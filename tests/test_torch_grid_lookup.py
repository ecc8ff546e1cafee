"""The gather form of the grid lookup (``GRID_LOOKUP = gather``) in the port
(``tinynerf_torch.core.gridfield``) against the JAX package's, on the CPU at
small sizes: the point field's values and gradients at fp32 and bf16, out of
the grid's extent, at exact nodes and at the last row; the pyramid, its fold
and the hybrid sigma net; a ``lego_grid`` + ``GRID_PALLAS`` step and its
occupancy refresh, a flagship step, two eager steps from one state. Inputs
are made with numpy from a seed and handed to both packages (the port's
params through ``ckpt.params_from_numpy``).

Bounds: values at fp32 within the JAX package's own gather bound
(``tests/test_gridfield.py``: rtol 1e-5, atol 1e-6), at bf16 within 2e-3 of
max|ref| (the bf16 hat form's, ``tests/test_torch_grid_hybrid.py``), and the
bf16 line features bit for bit (XLA on the CPU rounds every step of the
lerp to bfloat16, and so does the port); gradients at fp32 within 2e-5 of
max|ref|, at bf16 by cosine >= 0.999 and norm within 1% per tensor, at a
size where few taps share a table row (JAX's CPU scatter-add sums a row's
taps one by one in bfloat16, the port in float32, rounded once).

The last test takes the card: one step's gradient with the gather on the
card against the CPU's. It imports neither JAX nor ``tinynerf`` when they
are missing, so on a machine with PyTorch and CUDA alone:

    python -m pytest --noconftest tests/test_torch_grid_lookup.py -m gpu -q
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from tinynerf import train as jtrain
    from tinynerf.config import Config as JConfig
    from tinynerf.core import gridfield as jgf, occupancy as joccupancy
    from tinynerf.core.rays import make_k_inv as jmake_k_inv
    from tinynerf.data.poses import load_scene as jload_scene
    from tinynerf.data.rays import RayTable as JRayTable
    from tests.torch_workers import torch_threads  # noqa: F401 (autouse)
except ImportError:     # PyTorch alone: only the card's test runs (-m gpu)
    jax = None

from tinynerf_torch import ckpt, eval as evallib, optim, train
from tinynerf_torch.config import Config
from tinynerf_torch.core import gridfield, occupancy
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6     # tests/test_gridfield.py's gather bound
BF16_RTOL = 2e-3                      # values, error / max|ref|
GRAD_RTOL = 2e-5                      # fp32 gradients, error / max|ref|
BF16_COS, BF16_NORM = 0.999, 1e-2     # bf16 gradients, per tensor
EXTENT = 1.5
DENSITY_SCALE = 3.0

# conf/lego_hybrid.ini's structure at tiny widths, with the gather
TINY = dict(n_coarse=8, n_fine=16, precision="bf16", proposal=True, prop_field="grid",
            white_bkgd=True, occ_grid=True, occ_res=6, fine_field="grid", grid_res=9,
            grid_comp_density=3, grid_comp_app=4, grid_decoder_width=8, grid_sigma_width=6,
            grid_lr_mult=20.0, grid_tv=0.1, grid_hybrid=True, prop_grid_hybrid=True,
            prop_grid_res=8, prop_grid_comp_density=2, prop_grid_comp_app=2,
            prop_grid_decoder_width=8, batch_ray=32, learning=5e-4, decay_end=100,
            grid_lookup="gather")
# conf/lego_grid.ini's at small widths: plain CP grids, GRID_PALLAS
LEGO_GRID = dict(TINY, grid_hybrid=False, prop_grid_hybrid=False, grid_res=16,
                 grid_pallas=True)
needs_jax = pytest.mark.skipif(jax is None, reason="holds the port against the JAX package")


def _cfgs(base, **kw):
    cfg = dict(base, **kw)
    return JConfig(**cfg), Config(**cfg)


def _field(seed, res, nd=4, na=4, width=8, hybrid=False, levels=1):
    """A grid field with content: every table random (level tables too), the
    level-0 density columns scaled by 3. (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.array, jgf.init_grid_field(
        jax.random.PRNGKey(seed), res=res, n_density=nd, n_app=na, decoder_width=width,
        extent=EXTENT, hybrid=hybrid, sigma_width=6 if hybrid else 0, levels=levels))
    rng = np.random.default_rng(seed)
    for name, t in tree["lines"].items():
        tree["lines"][name] = (0.5 * rng.normal(size=t.shape)).astype(np.float32)
        if len(name) == 1:
            tree["lines"][name][:, :nd] *= np.float32(DENSITY_SCALE)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _points(seed, n, res):
    """``n`` points in and around the grid (some outside its extent, so
    clipped) and unit directions; the first ``res`` rows sit on every node of
    the x axis, the last of them at ``R - 1``, and two more on its clip
    boundaries."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2 * EXTENT, 1.2 * EXTENT, (n, 3)).astype(np.float32)
    pts[:res, 0] = (np.arange(res) / (res - 1) * 2 * EXTENT - EXTENT).astype(np.float32)
    pts[res:res + 2, 1] = (-EXTENT, EXTENT)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _dtype(precision):
    return jnp.float32 if precision == "fp32" else jnp.bfloat16


def _leaves_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jfield(jparams, pts, dirs, precision, nd=4, lookup="gather", fold=False):
    """The JAX package's point field, jitted (one compile each form)."""
    fn = jax.jit(lambda p, x, d: jgf.apply_grid_field(
        p, x, d, n_density=nd, lookup=lookup, compute_dtype=_dtype(precision), fold=fold))
    return fn(jparams, jnp.asarray(pts), jnp.asarray(dirs))


def _check_values(got, ref, precision):
    color, sigma = (t.detach().numpy() for t in got)
    for a, b in ((color, np.stack(ref[0], -1)), (sigma, np.asarray(ref[1]))):
        assert a.shape == b.shape
        if precision == "fp32":
            np.testing.assert_allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL)
        else:
            assert _rel(a, b) <= BF16_RTOL


def _check_grads(got, ref, precision):
    """Per tensor: fp32 within GRAD_RTOL of max|ref|; bf16 by cosine, and
    by norm but for a bias (JAX sums a bias's cotangents over the rows in
    bfloat16, the port in float32: ``tests/test_torch_grid_hybrid.py``). A
    tensor whose reference gradient is 0 (the frozen extent) must be 0."""
    for path, want in ref.items():
        have = got[path]
        if not want.any():
            assert not have.any(), path
        elif precision == "fp32":
            assert _rel(have, want) <= GRAD_RTOL, path
        else:
            assert _cos(have, want) >= BF16_COS, path
            if not path.endswith("['b']"):
                ratio = np.linalg.norm(have) / np.linalg.norm(want)
                assert abs(ratio - 1) <= BF16_NORM, path


def _grads_both(jparams, params, pts, dirs, precision, nd, fold=False):
    """Both packages' gradients of one weighted sum of color and sigma over
    the gather field, by path (the points' as ``"x"``); and the outputs."""
    w = np.random.default_rng(99).normal(size=(len(pts), 4)).astype(np.float32)

    def jloss(p, xs):
        c, s = jgf.apply_grid_field(p, xs, jnp.asarray(dirs), n_density=nd, lookup="gather",
                                    compute_dtype=_dtype(precision), fold=fold)
        return jnp.sum(jnp.stack(c, -1) * w[:, :3]) + jnp.sum(s[:, 0] * w[:, 3])

    g_p, g_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(pts))
    leaves = optim.tree_map(lambda t: t.clone().requires_grad_(True), params)
    x = torch.from_numpy(pts).requires_grad_(True)
    out = gridfield.make_field_grid(nd, "gather", precision, fold)(
        leaves, x, torch.from_numpy(dirs))
    (torch.sum(out[0] * torch.from_numpy(w[:, :3]))
     + torch.sum(out[1][:, 0] * torch.from_numpy(w[:, 3]))).backward()
    got = _leaves_by_path(optim.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t), leaves))
    ref = _leaves_by_path(g_p)
    got["x"], ref["x"] = x.grad.numpy(), np.asarray(g_x)
    return got, ref, out


# ---------------------------------------------------------------- the point field


@needs_jax
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("res", [16, 33])
def test_gather_field_matches_jax(res, precision):
    """Color and sigma within the bounds, out-of-extent points, exact nodes
    and ``R - 1`` among them; the three line features equal JAX's bit for
    bit at bf16 (each rounding point of the lerp in place) and within the
    gather bound at fp32."""
    jparams, params = _field(res, res)
    pts, dirs = _points(res + 1, 400, res)
    ref = _jfield(jparams, pts, dirs, precision)
    got = gridfield.apply_grid_field(params, torch.from_numpy(pts), torch.from_numpy(dirs),
                                     n_density=4, precision=precision, lookup="gather")
    _check_values(got, ref, precision)
    feats = gridfield._line_features(params["lines"], torch.from_numpy(pts), params["extent"],
                                     gridfield.rounding(precision), lookup="gather")
    jfeats = jax.jit(lambda lines, x, e: jgf._line_features(
        lines, x, e, "gather", _dtype(precision)))(jparams["lines"], jnp.asarray(pts),
                                                   jparams["extent"])
    for f, jf in zip(feats, jfeats):
        jf = np.asarray(jf).astype(np.float32)
        if precision == "bf16":
            np.testing.assert_array_equal(f.numpy(), jf)
        else:
            np.testing.assert_allclose(f.numpy(), jf, rtol=FP32_RTOL, atol=FP32_ATOL)


@needs_jax
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gather_gradients_match_jax(precision):
    """Every gradient (the three tables, the decoder, the points) against
    JAX's VJP; bf16 at R = 64 with 100 points, about two taps a row."""
    res, n = (16, 300) if precision == "fp32" else (64, 100)
    jparams, params = _field(7, res)
    pts, dirs = _points(8, n, res)
    got, ref, _ = _grads_both(jparams, params, pts, dirs, precision, nd=4)
    _check_grads(got, ref, precision)


@needs_jax
def test_gather_slope_at_exact_nodes_and_the_last_row():
    """``floor`` is constant, so at an exact node ``k`` the coordinate's
    gradient is ``dF . (T[k + 1] - T[k])`` (times ``R - 1``), JAX's too, and
    at ``R - 1`` (both taps one row) it is 0 in both packages, at fp32 and
    at bf16."""
    res = 12
    jparams, params = _field(3, res)
    coord = torch.arange(res, dtype=torch.float32) / (res - 1)
    dF = torch.from_numpy(np.random.default_rng(4).normal(size=(res, 8)).astype(np.float32))
    table = params["lines"]["x"]
    for precision in ("fp32", "bf16"):
        c = coord.clone().requires_grad_(True)
        out = gridfield._interp(table, c, gridfield.rounding(precision), "gather")
        (out * dF).sum().backward()

        def jf(cc):
            jtable = jparams["lines"]["x"].astype(_dtype(precision))
            xg = cc * (res - 1)
            i0 = jnp.floor(xg)
            frac = (xg - i0).astype(_dtype(precision))[..., None]
            i0 = i0.astype(jnp.int32)
            f = (jnp.take(jtable, i0, axis=0) * (1.0 - frac)
                 + jnp.take(jtable, jnp.minimum(i0 + 1, res - 1), axis=0) * frac)
            return jnp.sum(f.astype(jnp.float32) * dF.numpy())

        want = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(coord.numpy())))
        assert c.grad[-1].item() == 0.0 == float(want[-1]), precision
        if precision == "fp32":
            slope = (res - 1) * ((table[1:] - table[:-1]) * dF[:-1]).sum(-1)
            np.testing.assert_allclose(c.grad[:-1].numpy(), slope.numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(c.grad.numpy(), want, rtol=1e-5, atol=1e-6)
        else:
            assert _cos(c.grad.numpy(), want) >= BF16_COS


@needs_jax
@pytest.mark.parametrize("form", ["nested", "non-nested", "fold", "hybrid"])
def test_gather_under_the_pyramid_fold_and_hybrid_matches_jax(form):
    """``GRID_LEVELS = 2`` on a nested (9 + 5) and a non-nested (8 + 4)
    lattice, each level interpolated by the gather; ``GRID_LEVEL_FOLD``
    (the folded table interpolated once by it); the hybrid sigma net on the
    gather's CP product. Values within the bounds at fp32 and bf16; every
    gradient at fp32."""
    res = {"nested": 9, "non-nested": 8, "fold": 9, "hybrid": 33}[form]
    levels = 1 if form == "hybrid" else 2
    fold = form == "fold"
    jparams, params = _field(11, res, nd=3, hybrid=form == "hybrid", levels=levels)
    pts, dirs = _points(12, 300, res)
    got, ref, out = _grads_both(jparams, params, pts, dirs, "fp32", nd=3, fold=fold)
    for precision in ("fp32", "bf16"):
        if precision == "bf16":
            out = gridfield.make_field_grid(3, "gather", "bf16", fold)(
                params, torch.from_numpy(pts), torch.from_numpy(dirs))
        jout = _jfield(jparams, pts, dirs, precision, nd=3, fold=fold)
        _check_values(out, jout, precision)
    _check_grads(got, ref, "fp32")


@needs_jax
def test_table_gradient_sums_in_float32_where_jax_cpu_stalls():
    """The table's gradient at bf16: the port sums a row's tap cotangents in
    float32 and rounds once (``_TapRows``, ``segment_sums``); JAX's CPU
    scatter-add sums them one by one in bfloat16. 1,000 taps of 1.0 on one
    row: 256 in JAX (256 + 1 rounds back to 256), 1,000 in the port; the
    port's sum of random cotangents is the float32 sum rounded once."""
    table = torch.zeros(4, 2, requires_grad=True)
    i0 = torch.zeros(1000, dtype=torch.int64)
    rows0, _ = gridfield._tap_rows(gridfield.rounding("bf16")(table), i0)
    rows0.backward(torch.ones(1000, 2))
    assert table.grad[0].tolist() == [1000.0, 1000.0]

    def jtake(t):
        return jnp.take(t.astype(jnp.bfloat16), jnp.zeros(1000, jnp.int32), axis=0)

    _, vjp = jax.vjp(jtake, jnp.zeros((4, 2), jnp.float32))
    assert np.asarray(vjp(jnp.ones((1000, 2), jnp.bfloat16))[0])[0].tolist() == [256.0, 256.0]
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=(1000, 2)).astype(np.float32))
    cot = cot.to(torch.bfloat16).float()
    table.grad = None
    rows0, _ = gridfield._tap_rows(gridfield.rounding("bf16")(table), i0)
    rows0.backward(cot)
    np.testing.assert_array_equal(table.grad[0].numpy(),
                                  cot.sum(0).to(torch.bfloat16).float().numpy())


@needs_jax
def test_any_other_lookup_is_the_hat_form():
    """As in the JAX package, a lookup other than ``gather`` is the hat form:
    ``"bogus"`` gives the ``onehot`` field bit for bit, in both packages."""
    jparams, params = _field(2, 16)
    pts, dirs = _points(3, 100, 16)
    fields = [gridfield.make_field_grid(4, lookup, "bf16")(params, torch.from_numpy(pts),
                                                           torch.from_numpy(dirs))
              for lookup in ("onehot", "bogus")]
    assert all(torch.equal(a, b) for a, b in zip(*fields))
    jfields = [_jfield(jparams, pts, dirs, "bf16", lookup=lookup)
               for lookup in ("onehot", "bogus")]
    assert all(np.array_equal(a, b) for a, b in zip(jfields[0][0], jfields[1][0]))


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def step_setup(request):
    scene_dir = request.getfixturevalue("sync_scene_dir")
    jtable = JRayTable(jload_scene(scene_dir, "sync", "train"))
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    idx = np.random.default_rng(10).integers(0, table.num_pix, 32).astype(np.int32)
    return (jtable, table, idx, jmake_k_inv(jtable.height, jtable.width, jtable.focal),
            make_k_inv(table.height, table.width, table.focal))


def _state_params(jcfg, seed):
    """JAX's fresh ``{"net", "prop"}`` params, every level-0 table's density
    columns scaled by 3. (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: jtrain.init_state(jcfg, k).params)(jax.random.PRNGKey(seed)))
    for part, nd in (("net", jcfg.grid_comp_density), ("prop", jcfg.prop_grid_comp_density)):
        for ax in "xyz":
            tree[part]["lines"][ax][:, :nd] *= np.float32(DENSITY_SCALE)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _random_occ(seed, res):
    rng = np.random.default_rng(seed)
    raw = np.where(rng.uniform(size=(res,) * 3) < 0.5, rng.uniform(0.02, 2.0, (res,) * 3),
                   rng.uniform(0.0, 0.009, (res,) * 3)).astype(np.float32)
    jgrid = joccupancy.OccGrid(density=joccupancy._dilate(jnp.asarray(raw)),
                               raw=jnp.asarray(raw), half_extent=jnp.float32(1.5),
                               threshold=jnp.float32(0.01))
    grid = occupancy.OccGrid(density=occupancy._dilate(torch.from_numpy(raw)),
                             raw=torch.from_numpy(raw), half_extent=torch.tensor(1.5),
                             threshold=torch.tensor(0.01))
    return jgrid, grid


def _step_vs_jax(step_setup, jcfg, cfg, seed):
    """One step's loss and gradients in both packages from the same params,
    batch and occupancy grid, by ``"part.sub"``."""
    jtable, table, idx, jk_inv, k_inv = step_setup
    jparams, params = _state_params(jcfg, seed)
    jocc, occ = _random_occ(seed + 1, TINY["occ_res"])
    (loss_ref, _), g_ref = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, jk_inv), has_aux=True))(
        jparams, jtable.gather(jnp.asarray(idx)), jax.random.PRNGKey(0), jocc)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv), params,
                                          table.gather(torch.from_numpy(idx)), None, occ)
    return float(loss_ref), loss.item(), g_ref, grads


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@needs_jax
def test_lego_grid_pallas_step_and_refresh_with_the_gather_match_jax(step_setup):
    """``lego_grid``'s structure with ``GRID_PALLAS`` and the gather, at
    fp32. The ray-major calls take ``grid_rays`` (on the card kernels 5 and
    6, the lerp); on the CPU the JAX package ignores ``GRID_PALLAS`` and
    renders through its gather point field, the same function within the
    gather bound at fp32: the loss to rel 1e-5 and each part's gradient to
    cosine >= 0.9999 and norm within 1e-3 (``tests/test_torch_proposal.py``'s
    step bounds). The occupancy refresh probes the gather point field in
    both packages: raw and density within the gather bound."""
    jcfg, cfg = _cfgs(LEGO_GRID, precision="fp32")
    loss_ref, loss, g_ref, grads = _step_vs_jax(step_setup, jcfg, cfg, 20)
    assert abs(loss / loss_ref - 1) <= 1e-5
    for part in ("net", "prop"):
        for sub in ("lines", "decoder"):
            got, want = _flat(grads[part][sub]), _flat(g_ref[part][sub])
            assert _cos(got, want) >= 0.9999, (part, sub)
            assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= 1e-3, (part, sub)
    jparams, params = _state_params(jcfg, 22)
    jocc, occ = _random_occ(23, TINY["occ_res"])
    key = jax.random.PRNGKey(24)
    ref = jax.jit(lambda g, p: joccupancy.update_grid(g, p, jtrain.make_field_fn(jcfg), key))(
        jocc, jparams["net"])
    u = torch.from_numpy(np.array(jax.random.uniform(key, (TINY["occ_res"] ** 3, 3))))
    state = train.TrainState(params=params, opt=optim.adam_init(params), iteration=0,
                             generator=torch.Generator(), occ=occ)
    got = train.refresh_occ(dataclasses.replace(cfg, occ_subset=1.0), state,
                            evallib.make_field_fn(cfg), draws=(None, u))
    for a, b in ((got.raw, ref.raw), (got.density, ref.density)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FP32_RTOL, atol=FP32_ATOL)


@needs_jax
def test_flagship_step_with_the_gather_matches_jax(step_setup):
    """One ``lego_hybrid``-shaped step at bf16 (both grids hybrid, the gather
    in both, the occupancy grid, WHITE_BKGD, GRID_TV): the loss to rel 1e-4
    and each part's gradient (each grid's lines, decoder and sigma net) to
    cosine >= 0.999, the weights' norm within 1e-2 (the bf16 step bounds of
    ``tests/test_torch_grid_hybrid.py``, whose docstring says why the
    biases are left out of the norm)."""
    jcfg, cfg = _cfgs(TINY)
    loss_ref, loss, g_ref, grads = _step_vs_jax(step_setup, jcfg, cfg, 30)
    assert abs(loss / loss_ref - 1) <= 1e-4
    weights = lambda t: {k: weights(v) for k, v in t.items() if k != "b"} \
        if isinstance(t, dict) else t
    for part in ("net", "prop"):
        for sub in ("lines", "decoder", "sigma_net"):
            got, want = grads[part][sub], g_ref[part][sub]
            assert _cos(_flat(got), _flat(want)) >= 0.999, (part, sub)
            ratio = np.linalg.norm(_flat(weights(got))) / np.linalg.norm(_flat(weights(want)))
            assert abs(ratio - 1) <= 1e-2, (part, sub)


def _clone(state):
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    c = lambda t: t.clone()
    return train.TrainState(
        params=optim.tree_map(c, state.params),
        opt=optim.AdamState(state.opt.count, optim.tree_map(c, state.opt.mu),
                            optim.tree_map(c, state.opt.nu)),
        iteration=state.iteration, generator=gen,
        occ=None if state.occ is None else type(state.occ)(*[t.clone() for t in state.occ]))


@pytest.mark.parametrize("base", ["flagship", "lego_grid"])
def test_two_eager_steps_from_one_state_repeat_bit_for_bit(base, sync_scene_dir):
    """Two runs of three steps (the first refreshing the occupancy grid
    through the gather) from one state: losses, params, Adam's moments and
    the grid equal bit for bit, the table gradients summed in the fixed
    order of ``_TapRows``."""
    cfg = Config(**(TINY if base == "flagship" else LEGO_GRID), occ_update_every=2)
    table = RayTable(load_scene(sync_scene_dir, "sync", "train"))
    k_inv = make_k_inv(table.height, table.width, table.focal)
    s0 = train.init_state(cfg, torch.device("cpu"))
    step = train.make_train_step(cfg, table, k_inv)
    runs = []
    for _ in range(2):
        st, losses = _clone(s0), []
        for _ in range(3):
            st, m = step(st)
            losses.append(m["loss"])
        runs.append((st, torch.stack(losses)))
    (a, la), (b, lb) = runs
    assert torch.equal(la, lb) and torch.isfinite(la).all()
    tensors = lambda s: (optim.leaves(s.params) + optim.leaves(s.opt.mu)
                         + optim.leaves(s.opt.nu) + list(s.occ))
    assert all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b)))
    assert not torch.equal(a.params["net"]["lines"]["x"], s0.params["net"]["lines"]["x"])


# ---------------------------------------------------------------- the card


def _card_vs_cpu(base, device):
    """Three steps on ``device`` from fresh params on a 32x32 scene, then
    ``chip_smoke.gather_grad_vs_cpu`` at the state they leave."""
    from tinynerf_torch.runner import Runner
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    cfg = Config(**dict(TINY if base == "flagship" else LEGO_GRID, batch_ray=256))
    runner = Runner(cfg, device=device, scene=chip_smoke.blender_scene(2, 32, cfg.seed))
    step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
    for _ in range(3):
        runner.state, _ = step(runner.state)
    return chip_smoke.gather_grad_vs_cpu(base, cfg, runner, torch.device(device))


@pytest.mark.gpu
@pytest.mark.parametrize("base", ["lego_grid", "flagship"])
def test_gather_step_gradient_card_vs_cpu(base):
    """One step's gradient with the gather, on the card against the CPU, at
    the same params and batch (``chip_smoke.gather_grad_vs_cpu``, phase 32's
    check at a small size): per part, fp32 at cosine >= 0.9999 and norm
    within 1%, bf16 at cosine >= 0.999. ``lego_grid`` takes
    ``GRID_PALLAS`` (kernels 5 and 6 on the card) and the gather in its
    refresh; the flagship's plain field takes the gather on every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tinynerf_torch.kernels import build
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = _card_vs_cpu(base, "cuda")
    assert result["ok"], result
