"""The device stopwatch of ``tinynerf_torch/profiling.py`` on the card: a
step graph captured with spans off holds no mark, and the sections of
replays captured with spans on time every layer of the step.

This file imports neither JAX nor ``tinynerf``, so it also runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest tests/test_torch_profiling_gpu.py -q

Without a card the test skips itself.
"""

import numpy as np
import pytest
import torch

from tinynerf_torch import profiling, train
from tinynerf_torch.config import Config
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import SceneData
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.device import resolve_device

HW = 12
# conf/lego_occ.ini's stack at toy widths: the bf16 MLP through the kernel
# wrappers (their plain versions on the CPU), an 8^3 grid refreshed every
# second step
OCC = dict(n_coarse=4, n_fine=8, batch_ray=16, precision="bf16", white_bkgd=True,
           occ_grid=True, occ_res=8, occ_extent=1.5, occ_subset=0.125, occ_update_every=2,
           occ_march_steps=16, use_pallas=True)


def scene(device="cpu"):
    """A two-view 12x12 scene of uniform noise, cameras at z = 4, near/far
    2/6: ``(RayTable, k_inv, pose rows)``."""
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    focal = 0.5 * HW / np.tan(0.4)
    rows = np.zeros((2, 17), np.float32)
    for i in range(2):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.0, 0.0, 4.0]
        hwf = np.array([[HW], [HW], [focal]], np.float32)
        rows[i] = np.concatenate([np.concatenate([c2w[:3, :4], hwf], 1).flatten(), [2.0, 6.0]])
    table = RayTable(SceneData(images=images, poses_bounds=rows, height=HW, width=HW,
                               focal=float(focal)), torch.device(device))
    return table, make_k_inv(HW, HW, focal, torch.device(device)), rows


@pytest.mark.gpu
def test_sections_time_a_graphed_step(monkeypatch):
    """On the card: a step graph captured with spans off launches no mark
    and has as many nodes as one captured with spans on, less its marks;
    replays with spans on charge every section of the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stopwatch's mark has no CPU mode)")
    dev = resolve_device("cuda")
    monkeypatch.setattr(profiling, "_rec", profiling.Recorder())
    table, kinv, _ = scene("cuda")
    nodes = {}
    for on in (False, True):
        profiling.spans_on(on)
        cfg = Config(**OCC)
        chunk = train.make_chunked_step(train.make_train_step(cfg, table, kinv), 1)
        state = train.init_state(cfg, dev)
        state.iteration = 1
        marks = profiling.marks_launched()
        for _ in range(3):
            state, _ = chunk(state)
        nodes[on] = chunk.graphs.graphs[False].nodes
        if not on:
            assert profiling.marks_launched() == marks
            continue
        profiling.reset()
        for _ in range(4):
            state, _ = chunk(state)
        dev_snap = profiling.snapshot()["device"]
        assert dev_snap["step"]["count"] == 4
        for path in ("step.sample", "step.render", "step.render/field.fwd", "step.backward",
                     "step.backward/field.bwd", "step.adam", "step.writeback"):
            assert dev_snap[path]["self_s"] > 0, path
    assert nodes[False] == nodes[True]
