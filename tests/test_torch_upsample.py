"""The port's coarse-to-fine grid schedule (``GRID_UPSAMPLE``:
``config.parse_grid_upsample``, ``gridfield.upsample_lines``,
``train.upsample_grid_state`` and the Runner's milestones, resumes across
them and checkpoints written after them) against the JAX package's, on the
CPU at small sizes. Inputs are made with numpy from a seed and handed to
both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf import optim as joptim, train as jtrain
from tinynerf.config import Config as JConfig, parse_grid_upsample as jparse
from tinynerf.core import gridfield as jgf
from tinynerf.runner import Runner as JRunner
from tinynerf_torch import ckpt, optim, train
from tinynerf_torch.config import Config, parse_grid_upsample
from tinynerf_torch.core import gridfield
from tinynerf_torch.runner import Runner
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

# tables and moments: max |port - JAX| / max |JAX| (float32 products of at
# most two nonzero hat weights, summed in other orders)
UPSAMPLE_RTOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("spec", [
    "", "4000:512, 2000:384", "100:128;200:256", " 9:17 ,4:12, ",
    "2000:512,4000:384", "2000:384,2000:512", "2000"],
    ids=["empty", "unsorted", "semicolon", "spaces", "res-decreases", "duplicate-iter",
         "not-iter-res"])
def test_parse_grid_upsample_matches_jax(spec):
    """The schedules of ``tests/test_upsample.py`` and a few more: the same
    pairs, or the same ``ValueError`` message."""
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_grid_upsample(spec)
        assert str(got.value) == str(e)
        return
    assert parse_grid_upsample(spec) == want


def _grid_tree(seed, res, nd=4, na=8, width=16):
    return _np(jgf.init_grid_field(jax.random.PRNGKey(seed), res=res, n_density=nd,
                                   n_app=na, decoder_width=width))


@pytest.mark.parametrize("chain", [(8, 12, 17), (64, 128)], ids=["8-12-17", "64-128"])
def test_upsample_lines_matches_jax(chain):
    """Each resize of the chain from the same tables: every table within
    1e-6 of max|JAX|; the decoder and the extent passed through as they are."""
    tree = _grid_tree(1, chain[0])
    jp, p = jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)
    for res in chain[1:]:
        jp, new = jgf.upsample_lines(jp, res), gridfield.upsample_lines(p, res)
        for ax in gridfield.AXES:
            assert new["lines"][ax].shape == (res, 12)
            assert _rel(new["lines"][ax].numpy(), jp["lines"][ax]) <= UPSAMPLE_RTOL
        assert new["decoder"] is p["decoder"] and new["extent"] is p["extent"]
        p = new
    assert gridfield.upsample_lines(p, chain[-1]) is p   # the same R: nothing to do


def test_upsample_preserves_the_field_where_lattices_nest():
    """9 -> 17 keeps every old node on the new lattice: the field is the same
    at points in and around the grid (``tests/test_upsample.py:23-42``)."""
    params = ckpt.params_from_numpy(_grid_tree(0, 9))
    up = gridfield.upsample_lines(params, 17)
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-2.0, 2.0, (40, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    (c0, s0), (c1, s1) = (gridfield.apply_grid_field(q, pts, dirs, n_density=4)
                          for q in (params, up))
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=1e-5)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), atol=1e-5)


def test_upsample_lines_refuses_a_pyramid():
    params = gridfield.init_grid_field(torch.Generator().manual_seed(0), res=9, n_density=2,
                                       n_app=2, decoder_width=8, levels=2)
    with pytest.raises(ValueError, match="GRID_UPSAMPLE is incompatible with GRID_LEVELS>1"):
        gridfield.upsample_lines(params, 17)


@pytest.mark.parametrize("chain", [(8, 12, 17), (64, 128)], ids=["8-12-17", "64-128"])
def test_upsample_grid_state_matches_jax(chain):
    """The fine grid with the proposal grid, and Adam moments that two steps
    of random gradients made: after each resize the tables, ``mu`` and
    ``nu`` within 1e-6 of max|JAX|, ``nu`` >= 0; the decoder, the proposal
    field, the iteration and Adam's count the same, bit for bit."""
    kw = dict(fine_field="grid", grid_res=chain[0], grid_comp_density=4, grid_comp_app=8,
              grid_decoder_width=16, proposal=True, prop_field="grid", prop_grid_res=8,
              prop_grid_comp_density=4, prop_grid_comp_app=4, prop_grid_decoder_width=8,
              use_pallas=False)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jstate = jtrain.init_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jstate.params)
        params, opt = joptim.adam_update(g, jstate.opt, jstate.params, jnp.float32(1e-2))
        jstate = jstate._replace(params=params, opt=opt)
    state = train.init_state(cfg, torch.device("cpu"),
                             params=ckpt.params_from_numpy(_np(jstate.params)),
                             opt_state=optim.AdamState(
                                 count=int(jstate.opt.count),
                                 mu=ckpt.params_from_numpy(_np(jstate.opt.mu)),
                                 nu=ckpt.params_from_numpy(_np(jstate.opt.nu))),
                             iteration=7)
    for res in chain[1:]:
        jstate = jtrain.upsample_grid_state(jcfg, jstate, res)
        new = train.upsample_grid_state(cfg, state, res)
        for got, want in ((new.params, jstate.params), (new.opt.mu, jstate.opt.mu),
                          (new.opt.nu, jstate.opt.nu)):
            for ax in gridfield.AXES:
                assert got["net"]["lines"][ax].shape == (res, 12)
                assert _rel(got["net"]["lines"][ax].numpy(),
                            want["net"]["lines"][ax]) <= UPSAMPLE_RTOL
            assert got["prop"]["lines"]["x"].shape == (8, 8)
        for ax in gridfield.AXES:
            assert bool(torch.all(new.opt.nu["net"]["lines"][ax] >= 0))
        for tree, old in ((new.params, state.params), (new.opt.mu, state.opt.mu),
                          (new.opt.nu, state.opt.nu)):
            assert tree["prop"] is old["prop"]
            assert tree["net"]["decoder"] is old["net"]["decoder"]
            assert tree["net"]["extent"] is old["net"]["extent"]
        assert (new.iteration, new.opt.count) == (7, int(jstate.opt.count)) == (7, 2)
        assert new.generator is state.generator and new.occ is state.occ
        state = new


def _cfg(cls, scene_dir, root, total, **kw):
    """``tests/test_upsample.py``'s Runner config, writing under ``root``."""
    return cls(img_dir=scene_dir, results_path=f"{root}/r", ckpt_path=f"{root}/c",
               log_dir=f"{root}/l", total_iter=total, step=6, batch_ray=32, n_coarse=4,
               n_fine=4, learning=5e-3, use_pallas=False, fine_field="grid", grid_res=8,
               grid_comp_density=4, grid_comp_app=8, grid_decoder_width=16,
               grid_upsample="4:12,9:17", **kw)


def _leaves(tree):
    return [t.numpy() for t in optim.leaves(tree)]


def test_runner_upsample_exact_resume(sync_scene_dir, tmp_path, capsys):
    """The counterpart of ``tests/test_upsample.py::test_runner_upsample_exact_resume``:
    the field trains through two milestones (4:12, 9:17), and a resume from
    the checkpoint at iteration 5, across the pending milestone at 9,
    reproduces the uninterrupted run: every param within 1e-6."""
    a = Runner(_cfg(Config, sync_scene_dir, tmp_path / "a", 6), device="cpu")
    a.train()
    assert a.params["lines"]["x"].shape[0] == 12
    assert a.state.opt.nu["lines"]["y"].shape[0] == 12
    a2 = Runner(_cfg(Config, sync_scene_dir, tmp_path / "a", 12, continue_=True), device="cpu")
    assert a2.state.iteration == 6 and a2.params["lines"]["x"].shape[0] == 12
    a2.train()
    b = Runner(_cfg(Config, sync_scene_dir, tmp_path / "b", 12), device="cpu")
    b.train()
    out = capsys.readouterr().out
    assert out.count("[GRID] upsampled line tables to R=12 before iter 4") == 2
    assert out.count("[GRID] upsampled line tables to R=17 before iter 9") == 2
    assert a2.params["lines"]["x"].shape[0] == 17
    for pa, pb in zip(_leaves(a2.params), _leaves(b.params)):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_after_a_milestone_resumes_in_the_other_package(
        writer, sync_scene_dir, tmp_path):
    """A checkpoint written after the milestone at 4 holds R = 12 tables and
    moments; the other package's Runner resumes it at R = 12 (R from the
    file, not GRID_RES = 8) and trains on through the milestone at 9 to
    R = 17 with finite params."""
    root = tmp_path / "run"
    if writer == "jax":
        JRunner(_cfg(JConfig, sync_scene_dir, root, 6)).train("train")
        r = Runner(_cfg(Config, sync_scene_dir, root, 12, continue_=True), device="cpu")
        assert r.state.iteration == 6
        assert r.params["lines"]["x"].shape[0] == r.state.opt.mu["lines"]["x"].shape[0] == 12
        r.train()
        lines = r.params["lines"]
    else:
        Runner(_cfg(Config, sync_scene_dir, root, 6), device="cpu").train()
        r = JRunner(_cfg(JConfig, sync_scene_dir, root, 12, continue_=True))
        assert int(r.state.iteration) == 6
        assert r.state.params["lines"]["x"].shape[0] == r.state.opt.nu["lines"]["x"].shape[0] == 12
        r.train("train")
        lines = _np(r.state.params["lines"])
    for ax in gridfield.AXES:
        assert lines[ax].shape == (17, 12)
        assert np.all(np.isfinite(np.asarray(lines[ax])))
