"""The port's chunked training and its frames' chunk groups
(``train.make_chunked_step``, ``make_chunked_indexed_step``,
``make_multi_step``; the tensor-rate Adam, ``optim.adam_rates``; the
Runner's chunk plan and its per-iteration logging; ``make_frame_fn``'s
``host_chunks``) against the JAX package's, on the CPU at small sizes.

On the CPU a chunk is its plain version, K eager steps. The card's form
(``graphs.StepGraphs``, ``eval._graphed``) is driven here too, with the
capture replaced by a body that a replay runs eagerly: its bookkeeping
(the static buffers, the device cursor, the refresh graph, the chunk
groups' padding) against the plain chunk and the JAX frame. Inputs and
index streams are made with numpy from a seed; the JAX package's batch
indices and occupancy-refresh draws come from its own key stream and are
handed to the port's steps."""

import dataclasses
import glob
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tinynerf.kernels.mlp_kernel as jmk
from tinynerf import eval as jeval, optim as joptim, train as jtrain
from tinynerf.config import Config as JConfig
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf.data.rays import RayTable as JRayTable
from tinynerf.runner import Runner as JRunner
from tinynerf_torch import ckpt, eval as evallib, graphs, optim, train
from tinynerf_torch.config import Config
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.runner import Runner, takes_chunk
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

K = 3
B = 32
PIXEL_ATOL = {"fp32": 1e-4, "bf16": 1e-3}   # a rendered pixel (tests/test_torch_slice.py, _bf16.py)
# conf/lego_occ.ini's stack cut to size: bf16 MLP, an 8^3 grid refreshed at
# every second iteration (64 of 512 cells), so a chunk of 3 crosses two
OCC = dict(n_coarse=8, n_fine=16, batch_ray=B, precision="bf16", white_bkgd=True,
           occ_grid=True, occ_res=8, occ_extent=1.5, occ_subset=0.125, occ_update_every=2,
           occ_march_steps=64, learning=3e-4, decay_end=100)
# conf/lego_grid.ini's (tests/test_torch_proposal.py::SMALL) with GRID_PALLAS
# (the kernels' plain versions here) and the same grid
GRID = dict(OCC, precision="fp32", fine_field="grid", grid_res=16, grid_comp_density=4,
            grid_comp_app=8, grid_decoder_width=16, proposal=True, prop_field="grid",
            prop_grid_res=8, prop_grid_comp_density=4, prop_grid_comp_app=4,
            prop_grid_decoder_width=8, grid_tv=0.1, grid_pallas=True, grid_lr_mult=20.0,
            learning=5e-4)
STACKS = {"lego_occ": OCC, "lego_grid": GRID}


def _params(jcfg, seed):
    """JAX's fresh params with content (an MLP's sigma bias +1, a grid's
    density columns times 3): (JAX params, the port's)."""
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        jcfg, jax.random.PRNGKey(seed)).params)
    for part in (["net", "prop"] if jcfg.proposal else [None]):
        sub = tree if part is None else tree[part]
        if "lines" in sub:
            nd = jcfg.grid_comp_density if part == "net" else jcfg.prop_grid_comp_density
            for ax in "xyz":
                sub["lines"][ax][:, :nd] *= np.float32(3.0)
        else:
            sub["sigma"]["b"] = sub["sigma"]["b"] + np.float32(1.0)
    return jax.tree_util.tree_map(jnp.asarray, tree), ckpt.params_from_numpy(tree)


def _jax_stream(jcfg, key, start, n, num_pix, sampled):
    """Per step of JAX's chunk from ``key``: the batch indices it draws
    (the sampled form) and the occupancy refresh's draws (None on a step
    without one), as the port's ``occ_draws`` takes them
    (``tinynerf/train.py:_apply_batch``, ``core/occupancy.update_grid``)."""
    n_total = jcfg.occ_res ** 3
    subset = max(1, int(n_total * jcfg.occ_subset))
    out = []
    for k in range(n):
        if sampled:
            key, bkey, _, okey = jax.random.split(key, 4)
            idx = np.asarray(jax.random.randint(bkey, (B,), 0, num_pix))
        else:
            key, _, okey = jax.random.split(key, 3)
            idx = None
        draws = None
        if (start + k) % jcfg.occ_update_every == 0:
            kidx, kjit = jax.random.split(okey)
            draws = (torch.from_numpy(np.asarray(jax.random.randint(kidx, (subset,), 0,
                                                                    n_total))),
                     torch.from_numpy(np.asarray(jax.random.uniform(kjit, (subset, 3)))))
        out.append((idx, draws))
    return out


@pytest.fixture(scope="module")
def tables(request):
    scene_dir = request.getfixturevalue("sync_scene_dir")
    jtable = JRayTable(jload_scene(scene_dir, "sync", "train"))
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    return jtable, table


def _port_state(jstate, generator):
    """JAX's train state as the port's (params, Adam, iteration, grid)."""
    tree = lambda t: ckpt.params_from_numpy(jax.tree_util.tree_map(np.array, t))
    occ = type(train.init_state(Config(occ_grid=True, occ_res=2), torch.device("cpu")).occ)(
        *(torch.from_numpy(np.array(t)) for t in jstate.occ))
    return train.TrainState(params=tree(jstate.params),
                            opt=optim.AdamState(int(jstate.opt.count), tree(jstate.opt.mu),
                                                tree(jstate.opt.nu)),
                            iteration=int(jstate.iteration), generator=generator, occ=occ)


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("form", ["chunked", "indexed", "multi"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_chunks_track_jax_across_refreshes(tables, monkeypatch, stack, form):
    """Two chunks of K = 3 steps of each form in both packages from the same
    params, index stream and refresh draws (JAX's, handed to the port),
    iterations 0-5, the grid refreshed at 0, 2 and 4, each port chunk
    started from JAX's state at its start: each step's loss to
    rel 1e-3 and rate to rel 1e-6 (``tests/test_torch_train.py``'s step
    tolerances), the last step's batch fields equal and its fine pixel
    within the pixel tolerance, the params at the end within 1e-2 of
    max|p| (Adam's sign flips, ``tests/test_torch_train.py``), the grid's
    probed cells equal. ``multi`` returns the losses alone, as JAX's. Each
    stack at its config's learning rate (lego_occ.ini's 3e-4, lego_grid.ini's
    5e-4)."""
    jtable, table = tables
    kw = STACKS[stack]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jparams, params = _params(jcfg, 7)
    jk_inv = jmake_k_inv(jtable.height, jtable.width, jtable.focal)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    sampled = form != "indexed"
    # the JAX field the port's plain versions round as: its Pallas kernels in
    # interpret mode at bf16 (tests/test_torch_bf16.py), its XLA field at fp32
    monkeypatch.setattr(jmk, "INTERPRET", True)
    jfield = jtrain.make_field_fn(jcfg, force_pallas=cfg.precision == "bf16")
    if sampled:
        jstep = jtrain.make_train_step(jcfg, jtable, jk_inv, jfield)
        step = train.make_train_step(cfg, table, k_inv)
    else:
        jstep = jtrain.make_indexed_train_step(jcfg, jtable, jk_inv, jfield)
        step = train.make_indexed_train_step(cfg, table, k_inv)
    build = {"chunked": (jtrain.make_chunked_step, train.make_chunked_step),
             "indexed": (jtrain.make_chunked_indexed_step, train.make_chunked_indexed_step),
             "multi": (jtrain.make_multi_step, train.make_multi_step)}[form]
    jmulti, multi = build[0](jstep, K), build[1](step, K)
    jstate = jtrain.init_state(jcfg, params=jparams)
    state = train.init_state(cfg, torch.device("cpu"), params=params)
    rng = np.random.default_rng(11)
    for c in range(2):
        # each chunk from JAX's state, so that only the chunk is compared
        state = _port_state(jstate, state.generator)
        stream = _jax_stream(jcfg, jstate.key, c * K, K, table.num_pix, sampled)
        if sampled:   # the port's table draws JAX's indices
            queue = [torch.from_numpy(i) for i, _ in stream]
            monkeypatch.setattr(table, "sample", lambda gen, n: table.gather(queue.pop(0)))
        draws = [d for _, d in stream]
        if form == "indexed":
            idx = rng.integers(0, table.num_pix, (K, B)).astype(np.int32)
            jstate, jm = jmulti(jstate, jnp.asarray(idx))
            state, m = multi(state, torch.from_numpy(idx), occ_draws=draws)
        elif form == "multi":
            jstate, jlosses = jmulti(jstate)
            state, losses = multi(state, occ_draws=draws)
            jm, m = {"loss": jlosses}, {"loss": losses}
        else:
            jstate, jm = jmulti(jstate)
            state, m = multi(state, occ_draws=draws)
        assert m["loss"].shape == (K,)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-3)
        if form == "multi":
            continue
        np.testing.assert_allclose(m["lr"].numpy(), np.asarray(jm["lr"]), rtol=1e-6)
        for f in ("rows", "cols", "rgb", "pic", "c_true0"):
            np.testing.assert_array_equal(m[f].numpy(), np.asarray(jm[f]), err_msg=f)
        np.testing.assert_allclose(m["c_fine0"].numpy(), np.asarray(jm["c_fine0"]),
                                   atol=PIXEL_ATOL[cfg.precision])
    assert state.iteration == int(jstate.iteration) == 2 * K == state.opt.count
    got, want = _flat(state.params), _flat(jstate.params)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-2
    raw, jraw = state.occ.raw.numpy(), np.asarray(jstate.occ.raw)
    np.testing.assert_array_equal(np.isfinite(raw), np.isfinite(jraw))


# ---------------------------------------------------------------- Adam


def _adam_float_form(grads, state, params, lr, b1=0.9, b2=0.999, eps=1e-7, lr_scale=None):
    """The float form of ``optim.adam_update`` before its scalars became
    tensors: every scalar a Python float rounded to float32."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32).item()
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    pw = lambda b: torch.pow(torch.tensor(b, dtype=torch.float32), t)
    bc1, bc2 = (1.0 - pw(b1)).item(), (1.0 - pw(b2)).item()
    g, p = optim.leaves(grads), optim.leaves(params)
    mu = torch._foreach_add(torch._foreach_mul(optim.leaves(state.mu), f32(b1)),
                            torch._foreach_mul(g, f32(1 - b1)))
    nu = torch._foreach_add(torch._foreach_mul(optim.leaves(state.nu), f32(b2)),
                            torch._foreach_mul(torch._foreach_mul(g, f32(1 - b2)), g))
    lr = f32(float(lr))
    rate = ([lr] * len(p) if lr_scale is None
            else [f32(lr * f32(float(s))) for s in optim.leaves(lr_scale)])
    step = torch._foreach_mul(torch._foreach_div(mu, bc1), rate)
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), f32(eps))
    return torch._foreach_sub(p, torch._foreach_div(step, denom)), mu, nu


def _tree(rng):
    return {"lines": {"x": torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32)),
                      "x1": torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))},
            "decoder": {"w": torch.from_numpy(rng.normal(size=(40, 7)).astype(np.float32)),
                        "b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))}}


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("given", [False, True])
def test_tensor_rate_adam_is_bit_identical_to_the_float_form(scaled, given):
    """Forty Adam steps across EXP's decay: the tensor-rate update, its
    scalars made from ``lr`` or given as a chunk's row of
    ``optim.adam_rates``, against the float form it replaced, bit for bit
    (params and both moments), with one rate and with per-leaf multipliers
    (``GRID_LR_MULT``, ``GRID_LEVEL_LR``)."""
    rng = np.random.default_rng(21)
    scale = ({"lines": {"x": 20.0, "x1": 10.0}, "decoder": {"w": 1.0, "b": 1.0}}
             if scaled else None)
    lr_fn = optim.make_lr_fn(Config(learning=5e-4, lr_gamma=0.1, decay_end=30, sched="EXP"))
    params = _tree(rng)
    state = optim.adam_init(params)
    ref, ref_state = params, state
    for it in range(40):
        g = _tree(rng)
        lr = lr_fn(it).item()
        p, mu, nu = _adam_float_form(g, ref_state, ref, lr, lr_scale=scale)
        back = lambda flat: optim.unflatten_like(params, list(flat))
        ref, ref_state = back(p), optim.AdamState(it + 1, back(mu), back(nu))
        rates = (torch.tensor(optim.adam_rates(it + 1, lr, 4, scale), dtype=torch.float32)
                 if given else None)
        params, state = optim.adam_update(g, state, params, lr, lr_scale=scale, rates=rates)
        for a, b in zip(optim.leaves(ref) + optim.leaves(ref_state.mu)
                        + optim.leaves(ref_state.nu),
                        optim.leaves(params) + optim.leaves(state.mu) + optim.leaves(state.nu)):
            assert torch.equal(a, b), it
    assert optim.rate_groups(4, scale) == ([[0, 1], [2], [3]] if scaled else [[0, 1, 2, 3]])


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("step", [1, 2, 7, 10, 97, 100, 150, 200, 201, 250, 400, 1000, 3000])
def test_chunk_size_matches_jax(step):
    assert Runner._chunk_size(step) == JRunner._chunk_size(step)


def _port_plan(start, end, chunk, milestones, step):
    """``Runner.train``'s calls from ``start`` to ``end``, ``(iteration,
    steps)``: a chunk where ``runner.takes_chunk`` says so, else one step;
    a milestone pops at its iteration."""
    plan, it, ahead = [], start, [m for m in milestones if m >= start]
    while it < end:
        if ahead and it == ahead[0]:
            ahead.pop(0)
        n = chunk if takes_chunk(it, chunk, end, ahead, step) else 1
        plan.append((it, n))
        it += n
    return plan


def _jax_plan(start, end, chunk, milestones):
    """The calls of ``tinynerf/runner.py``'s training loop (:306-339): a
    chunk where it fits before ``end`` and crosses no pending milestone,
    else one step; a milestone pops at its iteration."""
    plan, it, upsample = [], start, [m for m in milestones if m >= start]
    while it < end:
        if upsample and it == upsample[0]:
            upsample.pop(0)
        if chunk > 1 and it + chunk <= end and not (upsample and it + chunk > upsample[0]):
            plan.append((it, chunk))
            it += chunk
        else:
            plan.append((it, 1))
            it += 1
    return plan


@pytest.mark.parametrize("start,end,step,milestones", [
    (0, 300, 3000, []), (0, 250, 100, [100, 200]), (0, 25, 10, []), (0, 2000, 1000, [600, 1400]),
    (100, 100, 50, []), (0, 9, 1, [4]), (200, 500, 100, [300]), (0, 47, 10, [20, 30])])
def test_chunk_plan_matches_jax(start, end, step, milestones):
    """On the chunk grid the port's calls are the JAX loop's: chunks of
    ``_chunk_size(STEP)``, single steps across a milestone and at the end."""
    chunk = Runner._chunk_size(step)
    plan = _port_plan(start, end, chunk, milestones, step)
    assert plan == _jax_plan(start, end, chunk, milestones)
    assert sum(n for _, n in plan) == end - start


@pytest.mark.parametrize("start,end,step,milestones", [
    (0, 250, 100, [120]), (5, 47, 10, [20, 30]), (0, 60, 10, [13, 37]), (7, 31, 3, []),
    (0, 2000, 1000, [700, 1400])])
def test_chunk_plan_keeps_every_step_boundary(start, end, step, milestones):
    """Off the chunk grid (a milestone or a start off it) the JAX loop's
    chunks cross ``STEP`` boundaries, which then get no [ITER] line or
    checkpoint; the port's calls end on every one, cross no milestone and
    cover the iterations once."""
    chunk = Runner._chunk_size(step)
    plan = _port_plan(start, end, chunk, milestones, step)
    ends = {it + n for it, n in plan}
    assert all(b in ends for b in range(step * (start // step + 1), end + 1, step))
    assert all(it + n <= m or it >= m for it, n in plan for m in milestones)
    assert [it for it, _ in plan] == sorted({it for it, _ in plan})
    assert sum(n for _, n in plan) == end - start
    jax_ends = {it + n for it, n in _jax_plan(start, end, chunk, milestones)}
    assert not all(b in jax_ends for b in range(step * (start // step + 1), end + 1, step))


# ---------------------------------------------------------------- the Runner


def _ini(tmp_path, scene_dir, **extra):
    keys = dict(IMG_DIR=f"{scene_dir}/", RESULTS_PATH=f"{tmp_path}/results/",
                CKPT_PATH=f"{tmp_path}/ckpt/", LOG_DIR=f"{tmp_path}/runs/",
                N_COARSE=8, N_FINE=16, RENDER_CHUNK=64, BATCH_RAY=B, DATA_TYPE="sync",
                LEARNING=2e-3, DECAY_END=40, TOTAL_ITER=8, STEP=3)
    keys.update(extra)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ini = tmp_path / "scene.ini"
    ini.write_text("[scene]\n" + "\n".join(f"{k} = {v}" for k, v in keys.items()) + "\n")
    return str(ini)


def test_runner_logs_every_step_of_a_chunk_and_checkpoints_like_jax(sync_scene_dir, tmp_path,
                                                                    capsys, monkeypatch):
    """``Runner.train`` with STEP = 3 over 8 iterations takes chunks of 3 at
    0 and 3 and single steps at 6 and 7 (the JAX Runner's calls); the
    logger gets 8 entries, iterations 0-7, each step's own loss (8
    distinct values from two chunks) and rate; the [ITER] lines and the
    checkpoints land on iterations 2 and 5, as the JAX Runner's on the
    same INI."""
    from tinynerf.config import load_config as jload_config
    from tinynerf_torch.config import load_config
    calls = []
    real = train.ChunkedStep.__call__

    def spy(self, state, *a, **kw):
        calls.append((state.iteration, self.unroll))
        return real(self, state, *a, **kw)

    monkeypatch.setattr(train.ChunkedStep, "__call__", spy)
    runner = Runner(load_config(_ini(tmp_path / "port", sync_scene_dir)), device="cpu")
    runner.train()
    out = capsys.readouterr().out
    jrunner = JRunner(jload_config(_ini(tmp_path / "jax", sync_scene_dir)))
    jrunner.train()
    jout = capsys.readouterr().out
    assert calls == [(0, K), (3, K)]
    rows = [json.loads(line) for line in open(runner.logger.path)]
    assert [r["iter"] for r in rows] == list(range(8))
    assert len({r["loss/train"] for r in rows}) == 8
    lr_fn = optim.make_lr_fn(runner.cfg)
    assert [r["lr/train"] for r in rows] == [lr_fn(i).item() for i in range(8)]
    iter_lines = lambda text: [int(line.split()[1]) for line in text.splitlines()
                               if line.startswith("[ITER]")]
    assert iter_lines(out) == iter_lines(jout) == [2, 5]
    ckpts = lambda root: sorted(int(os.path.basename(p).rsplit("_", 1)[1].split(".")[0])
                                for p in glob.glob(os.path.join(root, "ckpt", "*.npz")))
    assert ckpts(str(tmp_path / "port")) == ckpts(str(tmp_path / "jax")) == [2, 5]
    assert runner.state.iteration == 8 == runner.state.opt.count


def test_runner_val_epoch_goes_through_the_indexed_chunk(sync_scene_dir, tmp_path, monkeypatch):
    """The val epoch (``train("val")``) takes its batches in indexed chunks
    of ``_chunk_size(STEP)``, one logged loss a batch."""
    from tinynerf_torch.config import load_config
    seen = []
    real = train.make_chunked_indexed_step

    def spy(step_fn, unroll):
        seen.append(unroll)
        return real(step_fn, unroll)

    monkeypatch.setattr(train, "make_chunked_indexed_step", spy)
    runner = Runner(load_config(_ini(tmp_path, sync_scene_dir, BATCH_RAY=100, STEP=4)),
                    device="cpu")
    runner.train("val")
    n_batches = runner.val_table.num_pix // 100
    assert seen == [4] and runner.state.iteration == n_batches
    rows = [json.loads(line) for line in open(runner.logger.path)]
    assert [r["iter"] for r in rows if "loss/val" in r] == list(range(n_batches))


# ---------------------------------------------------------------- frames


@pytest.fixture(scope="module")
def frame_setup(request):
    """A 12x12 view of the fixture scene (focal scaled with the frame), 64-ray
    chunks: 3 chunks, the last one partly padding."""
    scene = jload_scene(request.getfixturevalue("sync_scene_dir"), "sync", "test")
    hw = 12
    focal = scene.focal * hw / scene.height
    tree = jax.tree_util.tree_map(np.array, jtrain.init_state(
        JConfig(), jax.random.PRNGKey(31)).params)
    tree["sigma"]["b"] = tree["sigma"]["b"] + np.float32(1.0)
    kw = dict(n_coarse=8, n_fine=16, render_chunk=64)
    return scene.poses_bounds.astype(np.float32), hw, focal, tree, kw


def _eager_capture(monkeypatch):
    """``graphs.warm`` and ``graphs.capture`` as eager calls: a capture records
    the body and each replay runs it; ``pin_memory`` a no-op (no card)."""

    class Eager:
        def __init__(self, body):
            self.body, self.launches, self.seconds, self.pool_bytes = body, {}, 0.0, 0
            self.nodes, self.replays = 0, 0
            self.graph = types.SimpleNamespace(pool=lambda: None)

        def replay(self):
            self.body()
            self.replays += 1

    monkeypatch.setattr(graphs, "warm", lambda body, device: body())
    monkeypatch.setattr(graphs, "capture", lambda body, device, pool=None, generators=(),
                        collectives=False: Eager(body))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a, **k: self)


@pytest.mark.parametrize("host_chunks", [0, 1, 3])
def test_frame_host_chunks_match_jax(frame_setup, monkeypatch, host_chunks):
    """``make_frame_fn`` with ``host_chunks`` 0, 1 and 3 against the JAX
    package's with the same ``host_chunks`` (its whole-frame program, its
    host loop, and its loop of 3-chunk groups padded with the last chunk):
    1e-4 a pixel. On the CPU the port's frame is the host loop; the card's
    form (``eval._graphed``: the static pixel, pose and output buffers, the
    group padding, the first call's eager warm-up) is driven too, with the
    capture replayed eagerly, twice, and equals the host loop bit for bit."""
    poses, hw, focal, tree, kw = frame_setup
    ref = np.asarray(jeval.make_frame_fn(JConfig(**kw), jmake_k_inv(hw, hw, focal), hw, hw,
                                         host_chunks=host_chunks)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(poses[1])))
    cfg, k_inv, params = Config(**kw), make_k_inv(hw, hw, focal), ckpt.params_from_numpy(tree)
    got = evallib.make_frame_fn(cfg, k_inv, hw, hw, host_chunks=host_chunks)(params, poses[1])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)

    _eager_capture(monkeypatch)
    field_fn = evallib.make_field_fn(cfg)
    from tinynerf_torch.core import render
    march = lambda p, r, c, pose: render.render_rays(
        p, r, c, pose, k_inv, cfg.n_coarse, cfg.n_fine, field_fn=field_fn,
        merge_impl="twolist")[1:2]
    rr, cc = np.meshgrid(np.arange(hw, dtype=np.float32), np.arange(hw, dtype=np.float32),
                         indexing="ij")
    pad = 3 * 64 - hw * hw
    rows = torch.from_numpy(np.pad(rr.reshape(-1), (0, pad)))
    cols = torch.from_numpy(np.pad(cc.reshape(-1), (0, pad)))
    group = 3 if host_chunks == 0 else host_chunks
    frame = evallib._graphed(march, rows, cols, 64, group, (hw, hw), False)
    for _ in range(2):
        np.testing.assert_array_equal(frame(params, poses[1]), got)
    n_groups = -(-3 // group)   # the first call warms up and captures at its first group
    assert frame.graph["graph"].replays == 2 * n_groups - 1


def test_step_graphs_bookkeeping_equals_the_plain_chunk(tables, monkeypatch):
    """``graphs.StepGraphs`` (the card's chunk) with the capture replayed
    eagerly, against the plain chunk, bit for bit, over four chunks of 3
    with an eager step after each (a chunk's tail: new tensors come back
    into the static buffers), the grid refreshed every second iteration:
    the losses, rates, last-step fields, every state tensor, the iteration
    and Adam's count. Two graphs (a plain step and a refresh step) are
    captured once each, after their warm-up steps, and replayed after."""
    _, table = tables
    _eager_capture(monkeypatch)
    cfg = Config(**dict(OCC, precision="fp32", stratified=True))
    k_inv = make_k_inv(table.height, table.width, table.focal)
    step = train.make_train_step(cfg, table, k_inv)
    plain, graphed = train.ChunkedStep(step, K), graphs.StepGraphs(step, K)
    a = train.init_state(cfg, torch.device("cpu"))
    b = train.init_state(cfg, torch.device("cpu"))
    for _ in range(4):
        a, ma = plain(a)
        rates, lrs = train.chunk_rates(cfg, b, K)
        b, mb = graphed(b, rates, lrs)
        for f in ("loss", "lr") + train.LAST_STEP_FIELDS:
            assert torch.equal(ma[f], mb[f]), f
        for x, y in zip(graphs._state_tensors(a), graphs._state_tensors(b)):
            assert torch.equal(x, y)
        assert (a.iteration, a.opt.count) == (b.iteration, b.opt.count)
        a, _ = step(a)
        b, _ = step(b)
    assert sorted(graphed.graphs) == [False, True]
    assert graphed.stats["warm_steps"] == graphed.stats["captures"] == 2
    assert graphed.stats["replays"] == 4 * K - 2


def test_step_graphs_capture_again_after_a_grid_upsample(tables, monkeypatch):
    """A ``GRID_UPSAMPLE`` milestone between chunks (lego_grid's stack, R 16
    -> 24): the card's chunk, with the capture replayed eagerly, takes the
    resized state's tensors as new static buffers and captures both step
    graphs again, and stays equal to the plain chunk bit for bit."""
    _, table = tables
    _eager_capture(monkeypatch)
    cfg = Config(**GRID)
    k_inv = make_k_inv(table.height, table.width, table.focal)
    step = train.make_train_step(cfg, table, k_inv)
    plain, graphed = train.ChunkedStep(step, K), graphs.StepGraphs(step, K)
    a = train.init_state(cfg, torch.device("cpu"))
    b = train.init_state(cfg, torch.device("cpu"))
    for c in range(4):
        if c == 2:
            a = train.upsample_grid_state(cfg, a, 24)
            b = train.upsample_grid_state(cfg, b, 24)
        a, ma = plain(a)
        rates, lrs = train.chunk_rates(cfg, b, K)
        b, mb = graphed(b, rates, lrs)
        assert torch.equal(ma["loss"], mb["loss"]), c
        for x, y in zip(graphs._state_tensors(a), graphs._state_tensors(b)):
            assert torch.equal(x, y), c
    assert b.params["net"]["lines"]["x"].shape[0] == 24
    assert graphed.stats["captures"] == 4 and graphed.stats["replays"] == 4 * K - 4
