"""The fixed-order backwards of the port's two gathers with repeated indices:
the resampler's (``sampling._BinGather``, its run sums ``run_sums``) and the
grid field's two taps (``gridfield._TapRows``, its sums ``segment_sums``).

Each is held against the JAX package's VJP at the bounds the port's other
tests hold these functions to (the resampler: cosine >= 0.9999 and the norm
within 1e-3, ``tests/test_torch_shipped_confs.py``; the grid field: 2e-5 of
max|ref|, ``tests/test_torch_gridfield.py``), against PyTorch's own backward
of the same gathers (``torch.gather``'s and ``index_select``'s scatter-add:
1e-12 of max|ref| in float64, 1e-5 in float32), over index patterns drawn
by hypothesis (every index one bin, a single bin, every bin, ragged runs, an
index at the last row), and two backward calls against each other, bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tinynerf.core import gridfield as jgf, sampling as jsampling
from tinynerf_torch import ckpt
from tinynerf_torch.core import gridfield, sampling
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

PATTERNS = ("one_bin", "single", "every", "ragged", "last")
HYP = settings(max_examples=25, deadline=None, derandomize=True)


def _keys(pattern: str, n: int, bins: int, rng) -> np.ndarray:
    """(n,) sorted indices into ``bins`` rows in the given pattern."""
    if pattern == "one_bin":
        return np.zeros(n, np.int64)
    if pattern == "single":
        return np.full(n, rng.integers(0, bins), np.int64)
    if pattern == "every":
        return np.sort(np.arange(n) % bins)
    if pattern == "ragged":
        cuts = np.sort(rng.integers(0, n + 1, rng.integers(1, bins + 1)))
        return np.minimum(np.searchsorted(cuts, np.arange(n), side="right"), bins - 1)
    keys = np.sort(rng.integers(0, bins, n))
    keys[-rng.integers(1, n + 1):] = bins - 1            # "last": a run at the last row
    return keys


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------- the resampler


def _bin_case(pattern, rays, levels, bins, seed, dtype):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.stack([_keys(pattern, levels, bins, rng) for _ in range(rays)]))
    sources = [torch.from_numpy(rng.normal(size=(rays, bins))).to(dtype).requires_grad_(True)
               for _ in range(3)]
    cot = [torch.from_numpy(rng.normal(size=(rays, levels))).to(dtype) for _ in range(3)]
    return idx, sources, cot


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@HYP
@given(pattern=st.sampled_from(PATTERNS), rays=st.integers(1, 6), levels=st.integers(1, 70),
       bins=st.integers(1, 20), seed=st.integers(0, 2 ** 16))
def test_bin_gather_backward_matches_torch_gather(dtype, pattern, rays, levels, bins, seed):
    """``_BinGather``'s values are ``torch.gather``'s bit for bit and its
    gradients its scatter-add's; two backward calls agree bit for bit."""
    idx, sources, cot = _bin_case(pattern, rays, levels, bins, seed, dtype)
    outs = sampling._BinGather.apply(idx, *sources)
    want_outs = [torch.gather(s, 1, idx) for s in sources]
    assert all(torch.equal(a, b) for a, b in zip(outs, want_outs))
    got = torch.autograd.grad(outs, sources, cot, retain_graph=True)
    again = torch.autograd.grad(outs, sources, cot)
    want = torch.autograd.grad(want_outs, sources, cot)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("n_levels", [1, 2, 63, 64, 65])
def test_run_sums_are_the_runs_prefix_sums(n_levels):
    """``run_sums`` at every position: the sum of its run of equal keys up to
    it, at sizes around the doubling steps' powers of two."""
    rng = np.random.default_rng(n_levels)
    keys = np.stack([_keys(p, n_levels, 5, rng) for p in PATTERNS])
    vals = rng.normal(size=(len(PATTERNS), n_levels, 2))
    got = sampling.run_sums(torch.from_numpy(vals), torch.from_numpy(keys)).numpy()
    want = np.empty_like(vals)
    for r in range(keys.shape[0]):
        for f in range(n_levels):
            start = f
            while start > 0 and keys[r, start - 1] == keys[r, f]:
                start -= 1
            want[r, f] = vals[r, start:f + 1].sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_coarse,n_fine", [(8, 16), (64, 128), (16, 3)])
def test_resampler_vjp_matches_jax(n_coarse, n_fine):
    """``sampling.resample``'s VJP in the coarse weights and t's against the
    JAX package's, at the bound the shipped configs' test holds it to; the
    values within 1e-5 of the far bound; two backward calls bit-identical."""
    rng = np.random.default_rng(n_coarse + n_fine)
    rays = 32
    near, far = 2.0, 6.0
    t_co = np.sort(rng.uniform(near, far, (rays, n_coarse)), axis=1).astype(np.float32)
    dense = rng.uniform(0, 1, (rays, n_coarse)).astype(np.float32)
    dense[:4] = 0.0                           # rays that every level sends to one bin
    dense[4:8, 1:] = 0.0
    dense[8:12, 3] = 50.0                     # one bin carrying most of the mass
    delta = np.full(rays, (far - near) / (n_coarse - 1), np.float32)
    cot = rng.normal(size=(rays, n_fine)).astype(np.float32)
    t, d = (torch.from_numpy(x).requires_grad_(True) for x in (t_co, dense))
    out = sampling.resample(t, d, torch.from_numpy(delta), n_fine)
    g_t, g_d = torch.autograd.grad(out, (t, d), torch.from_numpy(cot), retain_graph=True)
    again = torch.autograd.grad(out, (t, d), torch.from_numpy(cot))
    ref, vjp = jax.vjp(lambda tt, dd: jsampling.resample(tt, dd, jnp.asarray(delta), n_fine),
                       jnp.asarray(t_co), jnp.asarray(dense))
    want_t, want_d = vjp(jnp.asarray(cot))
    assert (np.abs(out.detach().numpy() - np.asarray(ref)) <= 1e-5 * far).all()
    for got, want, second in ((g_t, want_t, again[0]), (g_d, want_d, again[1])):
        assert torch.equal(got, second)
        a, b = got.numpy().ravel().astype(np.float64), np.asarray(want).ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999
        assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) <= 1e-3


# ---------------------------------------------------------------- the grid's taps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@HYP
@given(pattern=st.sampled_from(PATTERNS), taps=st.integers(1, 400), rows=st.integers(1, 40),
       width=st.integers(1, 5), seed=st.integers(0, 2 ** 16))
def test_tap_rows_backward_matches_index_select(dtype, pattern, taps, rows, width, seed):
    """``_TapRows``' values are ``index_select``'s bit for bit and its
    table gradient the sum of both taps' ``index_add_``; the taps are
    shuffled (the sort is the Function's); two backward calls agree bit for
    bit."""
    rng = np.random.default_rng(seed)
    i0 = torch.from_numpy(rng.permutation(_keys(pattern, taps, rows, rng)))
    table = torch.from_numpy(rng.normal(size=(rows, width))).to(dtype).requires_grad_(True)
    g0, g1 = (torch.from_numpy(rng.normal(size=(taps, width))).to(dtype) for _ in range(2))
    out = gridfield._TapRows.apply(table, i0)
    i1 = torch.clamp(i0 + 1, max=rows - 1)
    want_out = (table.index_select(0, i0), table.index_select(0, i1))
    assert all(torch.equal(a, b) for a, b in zip(out, want_out))
    (got,) = torch.autograd.grad(out, table, (g0, g1), retain_graph=True)
    (again,) = torch.autograd.grad(out, table, (g0, g1))
    (want,) = torch.autograd.grad(want_out, table, (g0, g1))
    assert torch.equal(got, again)
    assert _rel(got, want) <= (1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("n,block", [(1, 4), (4, 4), (5, 4), (16, 4), (17, 4), (64, 4),
                                     (65, 4), (1000, 32), (1024, 32), (1025, 32)])
def test_segment_sums_at_the_pyramids_edges(n, block):
    """``segment_sums`` against float64 sums at lengths on and around the
    pyramid's block powers, with empty segments, a segment of everything
    at the end and one-row segments."""
    rng = np.random.default_rng(n)
    for pattern in PATTERNS:
        keys = _keys(pattern, n, 7, rng)
        order = rng.permutation(n)
        x = np.empty((n, 3))
        x[order] = rng.normal(size=(n, 3))
        sorted_keys = keys                       # the keys at the positions of ``order``
        starts = np.searchsorted(sorted_keys, np.arange(8))
        got = gridfield.segment_sums(torch.from_numpy(x), torch.from_numpy(order),
                                     torch.from_numpy(starts), block).numpy()
        want = np.stack([x[order[a:b]].sum(axis=0) for a, b in zip(starts[:-1], starts[1:])])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_segment_sums_keep_small_segments_after_large_ones():
    """A running total over the whole array, then differences at the segment
    ends, loses a small segment's value after a large one; the pyramid's
    short sums keep it: float32 sums within 1e-5 relative of float64 on
    every segment, 10,000 rows of 1e4 before 1e-3-sized segments."""
    rng = np.random.default_rng(1)
    sizes = [10_000] + [int(s) for s in rng.integers(1, 40, 50)]
    scale = [1e4] + [1e-3] * 50
    x = np.concatenate([rng.uniform(0.5, 1.5, (s, 2)) * c for s, c in zip(sizes, scale)])
    starts = np.concatenate([[0], np.cumsum(sizes)])
    got = gridfield.segment_sums(torch.from_numpy(x).float(), torch.arange(len(x)),
                                 torch.from_numpy(starts)).numpy()
    want = np.stack([x[a:b].sum(axis=0) for a, b in zip(starts[:-1], starts[1:])])
    assert np.abs(got / want - 1).max() <= 1e-5


@pytest.mark.parametrize("points", ["nodes", "one_cell", "last_row", "random"])
def test_grid_field_vjp_matches_jax(points):
    """The point field's gradient in its line tables, decoder and points
    against ``jax.grad`` of the JAX package's field (2e-5 of max|ref|),
    where many points share a cell (one cell), sit on nodes, or reach the
    tables' last row (the clamped upper tap); two backward calls agree bit
    for bit."""
    res, nd, na, width = 33, 4, 8, 16
    jparams = jgf.init_grid_field(jax.random.PRNGKey(7), res=res, n_density=nd, n_app=na,
                                  decoder_width=width, extent=1.5)
    rng = np.random.default_rng(9)
    n = 300
    if points == "nodes":
        pts = (rng.integers(0, res, (n, 3)) / (res - 1) * 3.0 - 1.5).astype(np.float32)
    elif points == "one_cell":
        pts = (0.41 + rng.uniform(0, 0.05, (n, 3))).astype(np.float32)
    elif points == "last_row":
        pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
        pts[: n // 2, 0] = 1.5
        pts[n // 2:, 1] = 2.0
    else:
        pts = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    w = rng.normal(size=(n, 4)).astype(np.float32)

    def jloss(p, x):
        c, s = jgf.apply_grid_field(p, x, jnp.asarray(dirs), n_density=nd)
        return jnp.sum(jnp.stack(c, -1) * w[:, :3]) + jnp.sum(s[:, 0] * w[:, 3])

    g_p, g_x = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(pts))
    params = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = [params["lines"][ax].requires_grad_(True) for ax in gridfield.AXES]
    x = torch.from_numpy(pts).requires_grad_(True)
    c, s = gridfield.apply_grid_field(params, x, torch.from_numpy(dirs), n_density=nd)
    loss = (torch.sum(c * torch.from_numpy(w[:, :3]))
            + torch.sum(s[:, 0] * torch.from_numpy(w[:, 3])))
    got = torch.autograd.grad(loss, leaves + [x], retain_graph=True)
    again = torch.autograd.grad(loss, leaves + [x])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for ax, g in zip(gridfield.AXES, got[:3]):
        assert _rel(g.numpy(), g_p["lines"][ax]) <= 2e-5
    assert _rel(got[3].numpy(), g_x) <= 2e-5
