"""The graphed data-parallel step and frame on the cards: two NCCL ranks, one
card each (``parallel/``, ``graphs.py``).

This file imports neither JAX nor ``tinynerf``; run it on a machine with two
cards or more:

    python -m pytest --noconftest tests/test_torch_mesh_gpu.py -q

Without two cards each test skips itself. Each test starts two ranks
(``parallel.distributed.spawn``) that run ``chip_smoke.mesh_gpu_rank``
(``chip_smoke.py`` at the repository's root, which the test puts on the
ranks' path) and write what they saw; the test reads it. At a small size
(lego_occ's 8x256 MLP at bf16, kernels 1-3, 1024 rays, the 64^3 grid
refreshed every two steps, 64x64 views): two eager mesh runs of 20 steps
from one state equal each other and two graphed chunks of 10 bit for bit,
the ranks' params agree after each chunk, the graphed steps launch what
the eager ones do; a view under the mesh is one graph, equal to its eager
host loop bit for bit, and to the other rank's.
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL ranks, one card each)")
    from tinynerf_torch.kernels import build
    from tinynerf_torch.parallel import distributed as dist
    build.build_all()
    if REPO not in sys.path:    # the ranks start with this process's path
        sys.path.insert(0, REPO)
    dist.spawn("chip_smoke:mesh_gpu_rank", 2, "cuda", (str(tmp_path),))
    return [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]


@pytest.mark.gpu
def test_graphed_mesh_chunks_equal_eager_mesh_steps_and_frames_their_host_loop(tmp_path):
    recs = _job(tmp_path)
    for r in recs:
        assert r["eager_deterministic"] and r["graph_bit_identical"], r
        assert r["losses_finite"] and r["graph_launches"] == r["eager_launches"]
        assert r["captures"]["captures"] == 2
        assert r["frame"]["0"]["graphed"] and r["frame"]["bit_identical"]
    assert recs[0]["digests"] == recs[1]["digests"]
    assert recs[0]["frame"]["sha256"] == recs[1]["frame"]["sha256"]
