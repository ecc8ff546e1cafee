"""The port's ``parallel/`` on the CPU under gloo, against the JAX package's
``tinynerf/parallel`` on the 8 fake devices of ``tests/conftest.py`` and
against the port's single-rank path.

One job of four ranks (``tests/torch_dist_workers.py``, spawned once for
the module: spawning is the cost) runs every case; the tests here read what
its rank 0 wrote and compute the references in this process. Bounds:

- the exclusive prefix, ``sharded_get_density`` and ``sharded_composite``
  on 1-4 ranks: rtol 1e-5, atol 1e-6 (``tests/test_parallel.py:167-196``);
- ``sharded_merged_fine`` on 2 and 4 ranks: rtol and atol 1e-5 (:230-262);
- ``make_sample_sharded_render`` on data 2 x sample 2: 1e-4 against JAX's
  (its deep-march bound, :266-291), 1e-5 against the port's single-rank
  two-list render;
- the partitioned occupancy refresh: atol 1e-6 against the unpartitioned
  one (:198-227);
- the summed gradient: coarse-only rtol 2e-4, atol 1e-5 elementwise; with
  the fine pass, whose inverse-CDF bins a last-bit difference can flip,
  cosine >= 0.999 and the norm within 25% (:58-95);
- three data-parallel steps on injected indices: the first loss within
  1e-5 relative and the grid of the refresh before it within 1e-6; the
  later losses within 5e-3 and the params within the JAX package's bound
  for this comparison (rtol 1e-3, atol 5e-3, :98-125). Adam's first
  updates are close to ``lr * sign(g)`` whatever |g|, so an element whose
  gradient is near zero, and whose sign the two summation orders decide
  differently, moves ``2 * lr`` apart (measured on the CPU, MLP at lr
  5e-4: 7.7e-4 after two steps, the third loss 6.2e-4 apart). Every
  rank's params bit-equal;
- the ray-sharded and sample-sharded frames: 1e-4 per pixel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tinynerf.core import mlp as jmlp
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.parallel import mesh as jmesh, sample_shard as jshard
from tinynerf_torch import ckpt, eval as evallib, optim, train
from tinynerf_torch.core import occupancy, render, sampling
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.parallel import distributed as dist
from tests import torch_dist_workers as workers
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

RANKS = 4
B_P, N_P = 4, 24            # the prefix / density case: 24 columns split 1-4 ways
NC_M, NF_M = 8, 16          # the merged composite
NC_R, NF_R, B_R = 8, 32, 8  # the sample-sharded render


def _inputs(scene_dir: str) -> dict:
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    k_inv = make_k_inv(table.height, table.width, table.focal).numpy()
    rows_rng = np.random.default_rng(2)
    occ_rng = np.random.default_rng(4)
    return {
        "scene_dir": scene_dir,
        "prefix_x": f32(rng.uniform(0, 2, (RANKS, B_P))),
        "delta": f32(rng.uniform(0.01, 0.1, (B_P, N_P))),
        "sigma": f32(rng.uniform(0.0, 5.0, (B_P, N_P))),
        "rgb": f32(rng.uniform(0, 1, (B_P, N_P, 3))),
        "t_co": f32(np.sort(rng.uniform(2, 6, (4, NC_M)), axis=1)),
        "t_fi": f32(np.sort(rng.uniform(2, 6, (4, NF_M)), axis=1)),
        "s_co": f32(rng.uniform(0, 3, (4, NC_M))),
        "s_fi": f32(rng.uniform(0, 3, (4, NF_M))),
        "c_co": f32(rng.uniform(0, 1, (3, 4, NC_M))),
        "c_fi": f32(rng.uniform(0, 1, (3, 4, NF_M))),
        "render_params": jax.tree_util.tree_map(np.asarray,
                                                jmlp.init_network(jax.random.PRNGKey(0))),
        "render_nc": NC_R, "render_nf": NF_R, "k_inv": k_inv,
        "rows": f32(rows_rng.uniform(0, table.height, B_R)),
        "cols": f32(rows_rng.uniform(0, table.width, B_R)),
        "pose": np.tile(table.poses[0].numpy(), (B_R, 1)),
        "occ_params": jax.tree_util.tree_map(np.asarray,
                                             jmlp.init_network(jax.random.PRNGKey(3))),
        "occ_draws": {"subset": (occ_rng.integers(0, 16 ** 3, 1024).astype(np.int64),
                                 f32(occ_rng.uniform(0, 1, (1024, 3)))),
                      "full": (None, f32(occ_rng.uniform(0, 1, (16 ** 3, 3))))},
        "grad_idx": rng.integers(0, table.num_pix, 30).astype(np.int64),
        "step_idx": rng.integers(0, table.num_pix, (3, 30)).astype(np.int64),
    }


@pytest.fixture(scope="module")
def job(sync_scene_dir, tmp_path_factory):
    """The four-rank job's results, with its inputs."""
    work = str(tmp_path_factory.mktemp("torch_parallel"))
    inp = _inputs(sync_scene_dir)
    torch.save(inp, os.path.join(work, "inputs.pt"))
    dist.spawn("tests.torch_dist_workers:run_all", RANKS, "cpu", (work,))
    return inp, torch.load(os.path.join(work, "results.pt"), weights_only=False)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in optim.leaves(optim.tree_map(np.asarray, tree))])


# ---------------------------------------------------------------- the sample axis


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_prefix_density_composite_match_jax_and_the_single_rank(job, k):
    inp, res = job
    mesh = Mesh(np.array(jax.devices()[:k]), ("sample",))

    def local(x, delta, sigma, rgb):
        return (jshard._exclusive_device_prefix_sum(x, "sample"),
                jshard.sharded_get_density(delta, sigma, "sample"),
                jshard.sharded_composite(jshard.sharded_get_density(delta, sigma, "sample"),
                                         rgb, "sample"))

    cols = P(None, "sample")
    jx, jw, jc = jax.shard_map(local, mesh=mesh, in_specs=(P("sample"), cols, cols, cols),
                               out_specs=(P("sample"), cols, P()), check_vma=False)(
        jnp.asarray(inp["prefix_x"][:k].reshape(-1)), jnp.asarray(inp["delta"]),
        jnp.asarray(inp["sigma"]), jnp.asarray(inp["rgb"]))
    _close(res[f"prefix_{k}"], np.asarray(jx).reshape(k, B_P), 1e-5, 1e-6)
    _close(res[f"weights_{k}"], jw, 1e-5, 1e-6)
    _close(res[f"composite_{k}"], jc, 1e-5, 1e-6)
    # and the port's own single-rank density and composite
    w = render.get_density(torch.from_numpy(inp["delta"]), torch.from_numpy(inp["sigma"]))
    _close(res[f"weights_{k}"], w, 1e-5, 1e-6)
    _close(res[f"composite_{k}"], render.composite(w, torch.from_numpy(inp["rgb"])),
           1e-5, 1e-6)
    # the exclusive prefix is the sum of the ranks before
    x = inp["prefix_x"][:k].astype(np.float64)
    _close(res[f"prefix_{k}"], np.cumsum(x, axis=0) - x, 1e-6, 1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_merged_fine_matches_jax(job, k):
    inp, res = job
    mesh = Mesh(np.array(jax.devices()[:k]), ("sample",))
    t_co, s_co = jnp.asarray(inp["t_co"]), jnp.asarray(inp["s_co"])
    c_co = tuple(jnp.asarray(c) for c in inp["c_co"])

    def local(t_fi, s_fi, r, g, b):
        return jshard.sharded_merged_fine(t_co, t_fi, s_co, s_fi, c_co, (r, g, b),
                                          white_bkgd=True, axis_name="sample")

    want = jax.shard_map(local, mesh=mesh, in_specs=(P(None, "sample"),) * 5, out_specs=P(),
                         check_vma=False)(jnp.asarray(inp["t_fi"]), jnp.asarray(inp["s_fi"]),
                                          *(jnp.asarray(c) for c in inp["c_fi"]))
    _close(res[f"merged_{k}"], want, 1e-5, 1e-5)
    assert res[f"merged_{k}_same_on_every_rank"]
    # the port's single-rank merge of the same samples
    t = lambda a: torch.from_numpy(a)
    single = render.merged_composite(t(inp["t_co"]), t(inp["t_fi"]), t(inp["s_co"]),
                                     t(inp["s_fi"]), tuple(t(c) for c in inp["c_co"]),
                                     tuple(t(c) for c in inp["c_fi"]), white_bkgd=True)
    _close(res[f"merged_{k}"], single, 1e-5, 1e-5)


@pytest.mark.parametrize("shards", [2, 4])
def test_resample_level_slices_concatenate_to_the_whole_march(shards):
    """Each slice of the levels (``level_start``, ``level_count``) is the
    matching columns of the whole march, bit for bit, as in the JAX
    package's ``resample``."""
    from tinynerf.core import sampling as jsampling
    rng = np.random.default_rng(7)
    B, NC, NF = 5, 16, 32
    t_co = np.sort(rng.uniform(2, 6, (B, NC)), axis=1).astype(np.float32)
    dense = rng.uniform(0, 0.2, (B, NC)).astype(np.float32)
    delta = np.full((B,), 4.0 / (NC - 1), np.float32)
    whole = sampling.resample(torch.from_numpy(t_co), torch.from_numpy(dense),
                              torch.from_numpy(delta), NF)
    n = NF // shards
    parts = [sampling.resample(torch.from_numpy(t_co), torch.from_numpy(dense),
                               torch.from_numpy(delta), NF, level_start=i * n, level_count=n)
             for i in range(shards)]
    assert torch.equal(torch.cat(parts, dim=1), whole)
    for i, part in enumerate(parts):
        want = jsampling.resample(jnp.asarray(t_co), jnp.asarray(dense), jnp.asarray(delta),
                                  NF, level_start=i * n, level_count=n)
        _close(part, want, 1e-5, 1e-5)


def test_sample_sharded_render_matches_jax_and_the_single_rank(job, sync_scene_dir):
    inp, res = job
    c_co, c_fi = res["sample_sharded_render"]
    assert res["sample_sharded_render_same"]
    from tinynerf.data.poses import load_scene as jload_scene
    from tinynerf.data.rays import RayTable as JRayTable
    jtable = JRayTable(jload_scene(sync_scene_dir, "sync", "train"))
    jk_inv = jmake_k_inv(jtable.height, jtable.width, jtable.focal)
    fn = jshard.make_sample_sharded_render(jmesh.make_mesh_2d(2, 2), jk_inv, NC_R, NF_R,
                                           white_bkgd=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, inp["render_params"])
    args = tuple(jnp.asarray(inp[k]) for k in ("rows", "cols", "pose"))
    j_co, j_fi = fn(jparams, *args)
    _close(c_co, j_co, 1e-4, 1e-4)
    _close(c_fi, j_fi, 1e-4, 1e-4)
    t = lambda k: torch.from_numpy(inp[k])
    s_co, s_fi = render.render_rays(ckpt.params_from_numpy(inp["render_params"]), t("rows"),
                                    t("cols"), t("pose"), t("k_inv"), NC_R, NF_R,
                                    merge_impl="twolist", white_bkgd=True)
    _close(c_co, s_co, 1e-5, 1e-5)
    _close(c_fi, s_fi, 1e-5, 1e-5)


# ---------------------------------------------------------------- the ray axis


@pytest.mark.parametrize("name", ["subset", "full"])
def test_partitioned_refresh_matches_the_unpartitioned_one(job, name):
    inp, res = job
    raw, density = res[f"occ_{name}"]
    assert res[f"occ_{name}_same"]
    draws = tuple(None if d is None else torch.from_numpy(d) for d in inp["occ_draws"][name])
    grid = occupancy.update_grid(occupancy.init_grid(16, 1.0, 0.01),
                                 ckpt.params_from_numpy(inp["occ_params"]), render.field_plain,
                                 subset=None if draws[0] is None else draws[0].shape[0],
                                 draws=draws)
    _close(raw, grid.raw, 0, 1e-6)
    _close(density, grid.density, 0, 1e-6)
    assert np.isfinite(raw).any()


def _single_rank_grads(inp, name):
    table = RayTable(load_scene(inp["scene_dir"], "sync", "train"))
    cfg = workers.step_config(inp["scene_dir"], **workers.GRAD_CONFIGS[name])
    k_inv = make_k_inv(table.height, table.width, table.focal)
    loss, _, grads = train.loss_and_grads(train.make_loss_fn(cfg, k_inv),
                                          workers.field_with_content(cfg),
                                          table.gather(torch.from_numpy(inp["grad_idx"])))
    return float(loss), grads


def test_summed_gradient_matches_the_single_rank_coarse(job):
    inp, res = job
    loss, grads = res["grad_coarse"]
    assert res["grad_coarse_same"]
    want_loss, want = _single_rank_grads(inp, "coarse")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(optim.leaves(grads), optim.leaves(want)):
        _close(a, b, 2e-4, 1e-5)


def test_summed_gradient_matches_the_single_rank_full(job):
    inp, res = job
    loss, grads = res["grad_full"]
    assert res["grad_full_same"]
    want_loss, want = _single_rank_grads(inp, "full")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    a, b = _flat(grads), _flat(want)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999
    # a missing sum would put the norm at a quarter
    assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) < 0.25


@pytest.mark.parametrize("name", list(workers.STEP_CONFIGS))
def test_three_data_parallel_steps_track_the_single_rank(job, name):
    """``make_indexed_train_step`` under a mesh of four ranks against the
    one-rank step on the same indices and seed: ``mlp_occ`` (the refresh at
    0 and 2, partitioned; STRATIFIED's jitter drawn for the whole batch),
    ``flagship_tv`` (``GRID_TV`` counted once: four times would move the
    tables' gradient), ``proposal_aux`` (``DIST_LOSS``,
    ``PROP_INTERLEVEL``)."""
    inp, res = job
    losses, params, occ_raw = res[f"steps_{name}"]
    assert res[f"steps_{name}_same"]
    table = RayTable(load_scene(inp["scene_dir"], "sync", "train"))
    cfg = workers.step_config(inp["scene_dir"], **workers.STEP_CONFIGS[name])
    k_inv = make_k_inv(table.height, table.width, table.focal)
    step = train.make_indexed_train_step(cfg, table, k_inv)
    state = train.init_state(cfg, torch.device("cpu"))
    for i, idx in enumerate(inp["step_idx"]):
        state, m = step(state, torch.from_numpy(idx))
        assert losses[i] == pytest.approx(float(m["loss"]), rel=1e-5 if i == 0 else 5e-3), i
        if i == 0 and occ_raw is not None:
            _close(occ_raw, state.occ.raw, 0, 1e-6)
    assert (occ_raw is not None) == cfg.occ_grid
    for a, b in zip(optim.leaves(params), optim.leaves(state.params)):
        _close(a, b, 1e-3, 5e-3)


def test_the_distributed_helpers(job):
    """``put_replicated`` and ``replicate_state`` leave every rank with rank
    0's tensors and generator; ``to_host`` assembles uneven rows in rank
    order; ``process_info`` names the job."""
    _, res = job
    assert res["put_replicated_same"] and res["replicate_state_same"]
    np.testing.assert_array_equal(res["to_host"], [0, 10, 11, 20, 21, 22, 30, 31, 32, 33])
    assert res["process_info"]["process_count"] == RANKS
    assert res["process_info"]["backend"] == "gloo"


def test_sharded_render_chunk_matches_the_single_rank(job):
    inp, res = job
    table = RayTable(load_scene(inp["scene_dir"], "sync", "train"))
    cfg = workers.step_config(inp["scene_dir"])
    k_inv = make_k_inv(table.height, table.width, table.focal)
    batch = table.gather(torch.from_numpy(inp["grad_idx"]))
    _, want = render.render_rays(workers.field_with_content(cfg), batch.rows, batch.cols,
                                 batch.pose17, k_inv, cfg.n_coarse, cfg.n_fine,
                                 merge_impl="twolist")
    _close(res["sharded_render_chunk"], want, 0, 1e-4)


def test_host_fed_steps_track_the_single_rank(job):
    """``HOST_FEED`` under a mesh: each rank uploads its rows of the host
    batch (``make_host_fed_train_step`` with ``mesh``), against the one-rank
    host-fed step, at the bounds of the indexed steps above."""
    inp, res = job
    losses, params = res["steps_host_fed"]
    assert res["steps_host_fed_same"]
    table = RayTable(load_scene(inp["scene_dir"], "sync", "train"))
    cfg = workers.step_config(inp["scene_dir"], host_feed=True, stratified=True)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    step = train.make_host_fed_train_step(cfg, k_inv)
    state = train.init_state(cfg, torch.device("cpu"))
    for i, idx in enumerate(inp["step_idx"]):
        host = tuple(t.numpy() for t in table.gather(torch.from_numpy(idx)))
        state, m = step(state, table.upload(host))
        assert losses[i] == pytest.approx(float(m["loss"]), rel=1e-5 if i == 0 else 5e-3), i
    for a, b in zip(optim.leaves(params), optim.leaves(state.params)):
        _close(a, b, 1e-3, 5e-3)


def test_frames_match_the_single_rank_frame(job):
    """The ray-sharded frame (with depth and opacity) and the sample-sharded
    one, at a chunk of 50 that is no multiple of the four ranks, against the
    single-rank frame."""
    inp, res = job
    table = RayTable(load_scene(inp["scene_dir"], "sync", "train"))
    cfg = workers.step_config(inp["scene_dir"], render_chunk=workers.FRAME_CHUNK)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    params = workers.field_with_content(cfg)
    want = evallib.make_frame_fn(cfg, k_inv, table.height, table.width, extras=True)(
        params, table.poses[0])
    for got, ref in zip(res["frame_rays"], want):
        _close(got, ref, 0, 1e-4)
    _close(res["frame_samples"], want[0], 0, 1e-4)
    assert res["frame_samples_same"]
    assert want[0].std() > 1e-3   # a frame with content
