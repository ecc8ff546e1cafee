"""Rank bodies of the port's multi-rank tests on the CPU (gloo).

``tests/test_torch_parallel.py`` starts four ranks through
``tinynerf_torch.parallel.distributed.spawn("tests.torch_dist_workers:run_all",
...)``; each rank reads the inputs the test wrote (``inputs.pt``), runs every
case below, and rank 0 writes what it saw to ``results.pt``, with each
rank's digest of what it holds where ranks must agree. The ranks are fresh
interpreters that import no JAX: the test compares their results with the
JAX package and with the port's single-rank path in its own process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from tinynerf_torch import ckpt, eval as evallib, optim, train
from tinynerf_torch.config import Config
from tinynerf_torch.core import occupancy, render
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.parallel import distributed as dist, mesh as meshlib, sample_shard

# the three data-parallel step configs: the MLP with its occupancy grid, a
# tiny flagship with GRID_TV, and a proposal grid with the aux losses
STEP_CONFIGS = {
    "mlp_occ": dict(occ_grid=True, occ_res=8, occ_extent=1.5, occ_update_every=2,
                    occ_subset=0.25, white_bkgd=True, stratified=True),
    "flagship_tv": dict(fine_field="grid", grid_hybrid=True, grid_res=9, grid_comp_density=3,
                        grid_comp_app=4, grid_decoder_width=8, grid_tv=0.1, grid_lr_mult=20.0,
                        proposal=True, prop_field="grid", prop_grid_hybrid=True,
                        prop_grid_res=8, prop_grid_comp_density=2, prop_grid_comp_app=2,
                        prop_grid_decoder_width=8),
    "proposal_aux": dict(proposal=True, prop_field="grid", prop_grid_res=8,
                         prop_grid_comp_density=2, prop_grid_comp_app=2,
                         prop_grid_decoder_width=8, dist_loss=0.01, prop_interlevel=1.0,
                         stratified=True),
}
GRAD_CONFIGS = {"coarse": dict(n_fine=0), "full": dict()}
FRAME_CHUNK = 50   # no multiple of the four ranks


def step_config(scene_dir: str, **kw) -> Config:
    base = dict(img_dir=scene_dir, data_type="sync", batch_ray=30, n_coarse=8, n_fine=16,
                learning=5e-4)
    base.update(kw)
    return Config(**base)


def field_with_content(cfg: Config):
    """``train.init_state``'s params, the MLP's sigma bias +1 (a density
    the frames can show)."""
    params = train.init_state(cfg, torch.device("cpu")).params
    if cfg.fine_field == "mlp" and not cfg.proposal:
        params["sigma"]["b"] += 1.0
    return params


def _to_numpy(tree):
    return optim.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _agree(value) -> bool:
    """True on every rank when every rank's ``value`` (a tensor tree) is the
    same bit for bit."""
    digest = dist.params_digest(value if isinstance(value, dict) else {"v": value})
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8)
    return all(torch.equal(mine, d) for d in dist.all_gather(mine))


def _columns(x: np.ndarray, k: int, r: int) -> np.ndarray:
    n = x.shape[1] // k
    return x[:, r * n:(r + 1) * n]


def sharded_density_cases(inp: dict, out: dict, groups: dict) -> None:
    """The exclusive prefix, ``sharded_get_density`` and
    ``sharded_composite`` on groups of 1-4 ranks."""
    r = dist.rank()
    for k, group in groups.items():
        if r >= k:
            continue
        x = torch.from_numpy(inp["prefix_x"][r])
        prefix = sample_shard._exclusive_device_prefix_sum(x, group)
        delta = torch.from_numpy(_columns(inp["delta"], k, r))
        sigma = torch.from_numpy(_columns(inp["sigma"], k, r))
        rgb = torch.from_numpy(_columns(inp["rgb"], k, r))
        w = sample_shard.sharded_get_density(delta, sigma, group)
        c = sample_shard.sharded_composite(w, rgb, group)
        out[f"prefix_{k}"] = torch.stack(dist.all_gather(prefix, group)).numpy()
        out[f"weights_{k}"] = torch.cat(dist.all_gather(w, group), dim=1).numpy()
        out[f"composite_{k}"] = c.numpy()


def merged_fine_cases(inp: dict, out: dict, groups: dict) -> None:
    r = dist.rank()
    for k in (2, 4):
        if r >= k:
            continue
        cut = lambda a: torch.from_numpy(_columns(a, k, r))
        got = sample_shard.sharded_merged_fine(
            torch.from_numpy(inp["t_co"]), cut(inp["t_fi"]), torch.from_numpy(inp["s_co"]),
            cut(inp["s_fi"]), tuple(torch.from_numpy(c) for c in inp["c_co"]),
            tuple(cut(c) for c in inp["c_fi"]), white_bkgd=True, group=groups[k])
        same = all(torch.equal(got, o) for o in dist.all_gather(got, groups[k]))
        out[f"merged_{k}"] = got.numpy()
        out[f"merged_{k}_same_on_every_rank"] = same


def helper_cases(inp: dict, out: dict, mesh4, table, k_inv) -> None:
    """``put_replicated``, ``replicate_state`` (the generator too),
    ``to_host`` of uneven rows, ``process_info``, ``barrier``,
    ``sharded_render_chunk`` and host-fed steps, each rank uploading its
    rows of the host batch."""
    r = dist.rank()
    tree = {"a": torch.full((3,), float(r)), "b": {"c": torch.arange(4) + r}}
    dist.put_replicated(tree)
    out["put_replicated_same"] = _agree(tree) and float(tree["a"][0]) == 0.0
    cfg = step_config(inp["scene_dir"])
    state = train.init_state(cfg, torch.device("cpu"))
    state.params["sigma"]["b"] += r
    torch.rand((r + 1,), generator=state.generator)
    meshlib.replicate_state(state)
    draw = torch.rand((4,), generator=state.generator)
    out["replicate_state_same"] = _agree({"p": state.params, "draw": draw})
    out["to_host"] = dist.to_host(torch.arange(r + 1) + 10 * r)
    out["process_info"] = dist.process_info()
    dist.barrier()
    params = field_with_content(cfg)
    render_fn = lambda p, rows, cols, pose: render.render_rays(
        p, rows, cols, pose, k_inv, cfg.n_coarse, cfg.n_fine, merge_impl="twolist")[1]
    batch = table.gather(torch.from_numpy(inp["grad_idx"]))
    out["sharded_render_chunk"] = meshlib.sharded_render_chunk(render_fn, mesh4)(
        params, batch.rows, batch.cols, batch.pose17).numpy()
    # HOST_FEED: the host batch's rows of this rank, uploaded
    cfg = step_config(inp["scene_dir"], host_feed=True, stratified=True)
    step = train.make_host_fed_train_step(cfg, k_inv, mesh=mesh4)
    state = train.init_state(cfg, torch.device("cpu"))
    losses = []
    for idx in inp["step_idx"]:
        host = tuple(t.numpy() for t in table.gather(torch.from_numpy(idx)))
        state, m = step(state, table.upload(mesh4.local_rows(host)))
        losses.append(float(m["loss"]))
    out["steps_host_fed"] = (losses, _to_numpy(state.params))
    out["steps_host_fed_same"] = _agree(state.params)


def run_all(work_dir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=False)
    rank, out = dist.rank(), {}
    # every rank makes every group, in one order
    groups = {1: dist.SELF, 2: tdist.new_group([0, 1]), 3: tdist.new_group([0, 1, 2]), 4: None}
    sharded_density_cases(inp, out, groups)
    merged_fine_cases(inp, out, groups)

    # the sample-sharded render on a data 2 x sample 2 mesh
    mesh22 = meshlib.make_mesh_2d(2, 2)
    params = ckpt.params_from_numpy(inp["render_params"])
    k_inv = torch.from_numpy(inp["k_inv"])
    fn = sample_shard.make_sample_sharded_render(mesh22, k_inv, inp["render_nc"],
                                                 inp["render_nf"], white_bkgd=True)
    c_co, c_fi = fn(params, *(torch.from_numpy(inp[k]) for k in ("rows", "cols", "pose")))
    out["sample_sharded_render"] = (c_co.numpy(), c_fi.numpy())
    out["sample_sharded_render_same"] = _agree(c_fi)

    # the occupancy refresh, its probes partitioned over the four ranks
    mesh4 = meshlib.make_mesh()
    occ_params = ckpt.params_from_numpy(inp["occ_params"])
    grid0 = occupancy.init_grid(16, 1.0, 0.01)
    for name, draws in inp["occ_draws"].items():
        draws = tuple(None if d is None else torch.from_numpy(d) for d in draws)
        grid = occupancy.update_grid(grid0, occ_params, render.field_plain,
                                     subset=None if draws[0] is None else draws[0].shape[0],
                                     draws=draws, cell_split=mesh4)
        out[f"occ_{name}"] = (grid.raw.numpy(), grid.density.numpy())
        out[f"occ_{name}_same"] = _agree(grid.raw)

    # the gradient: the rank's rays, summed over the ranks
    scene_dir = inp["scene_dir"]
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    k_inv = make_k_inv(table.height, table.width, table.focal)
    for name, kw in GRAD_CONFIGS.items():
        cfg = step_config(scene_dir, **kw)
        params = field_with_content(cfg)
        grad_fn = meshlib.make_grad_fn(train.make_loss_fn(cfg, k_inv), mesh4)
        loss, _, grads = grad_fn(params, table.gather(torch.from_numpy(inp["grad_idx"])))
        out[f"grad_{name}"] = (float(loss), _to_numpy(grads))
        out[f"grad_{name}_same"] = _agree(grads)

    # three data-parallel steps on injected indices
    for name, kw in STEP_CONFIGS.items():
        cfg = step_config(scene_dir, **kw)
        step = train.make_indexed_train_step(cfg, table, k_inv, mesh=mesh4)
        state = train.init_state(cfg, torch.device("cpu"))
        losses, occ_raw = [], None
        for idx in inp["step_idx"]:
            state, m = step(state, torch.from_numpy(idx))
            losses.append(float(m["loss"]))
            if occ_raw is None and state.occ is not None:   # the refresh at 0
                occ_raw = state.occ.raw.numpy()
        out[f"steps_{name}"] = (losses, _to_numpy(state.params), occ_raw)
        out[f"steps_{name}_same"] = _agree(state.params)

    helper_cases(inp, out, mesh4, table, k_inv)

    # frames: rays over the four ranks, and data 2 x sample 2
    cfg = step_config(scene_dir, render_chunk=FRAME_CHUNK)
    params = field_with_content(cfg)
    pose = table.poses[0]
    ray_fn = evallib.make_frame_fn(cfg, k_inv, table.height, table.width, extras=True,
                                   mesh=mesh4)
    out["frame_rays"] = ray_fn(params, pose)
    ss_cfg = step_config(scene_dir, render_chunk=FRAME_CHUNK, sample_shard=2)
    ss_fn = evallib.make_frame_fn(ss_cfg, k_inv, table.height, table.width, mesh=mesh22)
    out["frame_samples"] = ss_fn(params, pose)
    out["frame_samples_same"] = _agree(torch.from_numpy(out["frame_samples"]))

    if rank == 0:
        torch.save(out, os.path.join(work_dir, "results.pt"))


# ---------------------------------------------------------------- chunks (two ranks)

CHUNK_K = 3          # steps a chunk of the two-rank chunk cases
CHUNK_CONFIGS = ("mlp_occ", "flagship_tv")
RUNNER_ITERS, RUNNER_STEP = 10, 4   # the Runner's plan: chunks of 4 at 0 and 4, then 8, 9


def _chunk_cases(scene_dir: str, table, k_inv, mesh, out: dict) -> None:
    """Each of ``CHUNK_CONFIGS`` under ``mesh``: two chunks of ``CHUNK_K``
    drawn steps (``make_chunked_step``) against ``2 CHUNK_K`` single steps
    from the same state, and two indexed chunks against single indexed
    steps on the same indices."""
    for name in CHUNK_CONFIGS:
        cfg = step_config(scene_dir, **STEP_CONFIGS[name])
        for indexed in (False, True):
            make = train.make_indexed_train_step if indexed else train.make_train_step
            step = make(cfg, table, k_inv, mesh=mesh)
            idx = torch.from_numpy(np.random.default_rng(5).integers(
                0, table.num_pix, (2 * CHUNK_K, cfg.batch_ray)))
            single = train.init_state(cfg, torch.device("cpu"))
            losses = []
            for k in range(2 * CHUNK_K):
                single, m = step(single, idx[k]) if indexed else step(single)
                losses.append(m["loss"])
            chunked = train.init_state(cfg, torch.device("cpu"))
            chunk = (train.make_chunked_indexed_step if indexed else train.make_chunked_step)(
                step, CHUNK_K)
            chunk_losses = []
            for c in range(2):
                args = (idx[c * CHUNK_K:(c + 1) * CHUNK_K],) if indexed else ()
                chunked, m = chunk(chunked, *args)
                chunk_losses.append(m["loss"])
                if c == 0:
                    first = _to_numpy(chunked.params)
            same = (torch.equal(torch.stack(losses), torch.cat(chunk_losses))
                    and all(torch.equal(a, b) for a, b in zip(
                        optim.leaves(single.params) + optim.leaves(single.opt.mu),
                        optim.leaves(chunked.params) + optim.leaves(chunked.opt.mu)))
                    and (single.occ is None or torch.equal(single.occ.raw, chunked.occ.raw)))
            tag = f"chunk_{name}_{'indexed' if indexed else 'drawn'}"
            out[tag] = {"chunk_equals_single": same,
                        "losses": [float(x) for x in torch.cat(chunk_losses)],
                        "first_chunk_params": first, "idx": idx.numpy(),
                        "ranks_agree": _agree(chunked.params)}


def _runner_case(scene_dir: str, work_dir: str, out: dict) -> None:
    """``Runner.train`` under ``MESH_SHAPE = 2`` on the CPU: the calls that
    went through a chunk (iteration, steps), rank 0's ``[CHUNKS]`` line,
    the logged iterations and the ranks' digests; then the val epoch's
    indexed chunks."""
    import contextlib
    import io
    from tinynerf_torch.runner import Runner
    base = os.path.join(work_dir, "runner")
    cfg = step_config(scene_dir, mesh_shape=2, total_iter=RUNNER_ITERS, step=RUNNER_STEP,
                      ckpt_path=os.path.join(base, "ckpt"), log_dir=os.path.join(base, "runs"),
                      results_path=os.path.join(base, "results"),
                      **STEP_CONFIGS["mlp_occ"])
    calls, real = [], train.ChunkedStep.__call__

    def spy(self, state, *a, **kw):
        calls.append((state.iteration, self.unroll))
        return real(self, state, *a, **kw)

    train.ChunkedStep.__call__ = spy
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            runner = Runner(cfg, device="cpu")
            runner.train()
            train_calls, train_text = list(calls), text.getvalue()
            calls.clear()
            runner.train("val")
    finally:
        train.ChunkedStep.__call__ = real
    out["runner"] = {"train_calls": train_calls, "val_calls": list(calls),
                     "val_end": runner.state.iteration,
                     "lines": [line for line in train_text.splitlines()
                               if line.startswith(("[CHUNKS]", "[ITER]"))],
                     "iteration": runner.state.iteration,
                     "ranks_agree": _agree(runner.state.params)}


def run_chunks(work_dir: str) -> None:
    """The chunk cases of ``tests/test_torch_mesh_chunks.py`` on two ranks:
    ``distributed.captures`` under gloo, ``graphs.StepGraphs``' refusal,
    ``train.graphs_take``, chunks against single steps under the mesh, and
    the Runner's plan. Rank 0 writes ``chunks.pt``."""
    from tinynerf_torch import graphs
    torch.set_num_threads(1)
    scene_dir = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=False)["scene_dir"]
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    k_inv = make_k_inv(table.height, table.width, table.focal)
    mesh = meshlib.make_mesh()
    out = {"captures": {"world": dist.captures(None), "self": dist.captures(dist.SELF),
                        "mesh_data": dist.captures(mesh.data)}}
    step = train.make_train_step(step_config(scene_dir), table, k_inv, mesh=mesh)
    try:
        graphs.StepGraphs(step, 2)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    out["graphs_take"] = {dev: train.graphs_take(step, torch.device(dev))
                          for dev in ("cpu", "cuda")}
    _chunk_cases(scene_dir, table, k_inv, mesh, out)
    _runner_case(scene_dir, work_dir, out)
    if dist.rank() == 0:
        torch.save(out, os.path.join(work_dir, "chunks.pt"))
