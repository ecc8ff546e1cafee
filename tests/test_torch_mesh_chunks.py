"""Chunks of training steps under a mesh (``parallel/``) on the CPU: the
JAX package's chunk plan with or without a mesh, gloo's host loop chosen up
front, and the card's refusal by name.

One job of two ranks under gloo (``tests/torch_dist_workers.py:run_chunks``,
spawned once for the module) runs the cases; the tests read what its rank 0
wrote. Bounds, against the one-rank run on the same draws or indices over
the first chunk's three steps, those of ``tests/test_torch_parallel.py``'s
three data-parallel steps: the first loss within 1e-5 relative, the later
ones within 5e-3, the params within rtol 1e-3, atol 5e-3 (past three steps
an occupancy refresh from params an ulp apart may flip a cell); the two
chunks against the same mesh's six single steps, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from tinynerf_torch import graphs, optim, train
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.parallel import distributed as dist
from tinynerf_torch.runner import Runner, takes_chunk
from tests import torch_dist_workers as workers
from tests.test_torch_chunked import _jax_plan, _port_plan
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def job(sync_scene_dir, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_mesh_chunks"))
    torch.save({"scene_dir": sync_scene_dir}, os.path.join(work, "inputs.pt"))
    dist.spawn("tests.torch_dist_workers:run_chunks", 2, "cpu", (work,))
    return sync_scene_dir, torch.load(os.path.join(work, "chunks.pt"), weights_only=False)


def test_captures_is_false_under_gloo_and_true_for_one_rank(job):
    _, res = job
    assert res["captures"] == {"world": False, "self": True, "mesh_data": False}
    assert dist.captures(None)            # this process: no job, no collective


def test_captures_follows_the_backend_name(monkeypatch):
    """NCCL's collectives run on the card (a graph can hold them), gloo's
    copy through the host."""
    monkeypatch.setattr(dist, "world_size", lambda group=None: 2)
    for backend, want in (("nccl", True), ("gloo", False)):
        monkeypatch.setattr(dist.dist, "get_backend", lambda group=None, b=backend: b)
        assert dist.captures(None) is want


def test_step_graphs_refuse_a_gloo_mesh_by_name(job):
    _, res = job
    assert res["refusal"] is not None
    for words in ("gloo", "host", "CUDA graph", "test set-up", "NCCL"):
        assert words in res["refusal"]


def test_the_backend_decides_the_chunk_form_up_front(job, monkeypatch):
    """Under gloo a chunk is a host loop on the card too; under NCCL it
    replays graphs; without a mesh the device decides."""
    _, res = job
    assert res["graphs_take"] == {"cpu": False, "cuda": False}
    step = lambda: None
    step.mesh = None
    assert train.graphs_take(step, torch.device("cuda"))
    assert not train.graphs_take(step, torch.device("cpu"))
    step.mesh = type("M", (), {"data": "group"})()
    monkeypatch.setattr(dist, "captures", lambda group=None: group == "group")
    assert train.graphs_take(step, torch.device("cuda"))


def _one_rank(scene_dir, name, indexed, idx):
    """The one-rank steps on the same draws (the seed's) or indices."""
    table = RayTable(load_scene(scene_dir, "sync", "train"))
    cfg = workers.step_config(scene_dir, **workers.STEP_CONFIGS[name])
    k_inv = make_k_inv(table.height, table.width, table.focal)
    make = train.make_indexed_train_step if indexed else train.make_train_step
    step = make(cfg, table, k_inv)
    state, losses = train.init_state(cfg, torch.device("cpu")), []
    for k in range(idx.shape[0]):
        state, m = step(state, torch.from_numpy(idx[k])) if indexed else step(state)
        losses.append(float(m["loss"]))
    return losses, state.params


@pytest.mark.parametrize("indexed", [False, True], ids=["drawn", "indexed"])
@pytest.mark.parametrize("name", workers.CHUNK_CONFIGS)
def test_chunks_under_a_mesh_equal_single_steps_and_track_one_rank(job, name, indexed):
    """Two chunks of three steps under the two-rank mesh equal six single
    steps of the same mesh bit for bit (losses, params, Adam's moments, the
    grid), the ranks agree, and the first chunk tracks the one-rank run."""
    scene_dir, res = job
    case = res[f"chunk_{name}_{'indexed' if indexed else 'drawn'}"]
    assert case["chunk_equals_single"] and case["ranks_agree"]
    k = workers.CHUNK_K
    losses, params = _one_rank(scene_dir, name, indexed, case["idx"][:k])
    for i, (got, want) in enumerate(zip(case["losses"][:k], losses)):
        assert got == pytest.approx(want, rel=1e-5 if i == 0 else 5e-3), i
    for a, b in zip(optim.leaves(case["first_chunk_params"]), optim.leaves(params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-3, atol=5e-3)


def test_runner_chunk_plan_under_a_mesh_is_the_jax_runners(job):
    """``Runner.train`` under ``MESH_SHAPE = 2``: the chunks of the JAX
    Runner's plan (``tinynerf/runner.py:292-301``, which takes chunks with or
    without a mesh), single steps off it, the [ITER] lines on each STEP, one
    [CHUNKS] line naming the host loop, every rank's params equal; the val
    epoch in indexed chunks of the same size."""
    _, res = job
    run = res["runner"]
    chunk = Runner._chunk_size(workers.RUNNER_STEP)
    jax_plan = _jax_plan(0, workers.RUNNER_ITERS, chunk, [])
    assert run["train_calls"] == [(it, n) for it, n in jax_plan if n > 1]
    assert all(takes_chunk(it, chunk, workers.RUNNER_ITERS, [], workers.RUNNER_STEP)
               for it, _ in run["train_calls"])
    assert run["lines"][0] == "[CHUNKS] 4 steps a call on the CPU: a host loop"
    iters = [int(line.split()[1]) for line in run["lines"] if line.startswith("[ITER]")]
    assert iters == [3, 7]
    assert run["ranks_agree"]
    val_plan = _port_plan(workers.RUNNER_ITERS, run["val_end"], chunk, [], workers.RUNNER_STEP)
    assert run["val_calls"] and run["val_calls"] == [(it, n) for it, n in val_plan if n > 1]


def test_step_graphs_take_a_single_rank_step():
    """Without a mesh ``StepGraphs`` is built as before (its graphs are made
    at the first call on the card)."""
    step = lambda: None
    step.mesh, step.cfg, step.indexed = None, None, False
    made = graphs.StepGraphs(step, 3)
    assert made.unroll == 3 and not made.collectives and made.graphs == {}
