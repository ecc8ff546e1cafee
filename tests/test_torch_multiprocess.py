"""``python -m tinynerf_torch --device cpu`` as a job of two ranks (gloo),
after ``tests/test_multiprocess.py``: launched through the JAX package's
variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``; one
process and one output directory a rank) and through the CLI's own spawn
(``MESH_SHAPE = 2`` outside a job; one directory for both), for the
reference MLP and a tiny flagship (``{net, prop}``, ``GRID_LR_MULT``),
against a one-rank run of the same INI:

- both ranks end with the same params digest (the ``[RANK r/2]`` line);
- the first step's loss within 1e-5 relative, and the params after it
  (``*_0.npz``) within the JAX harness's bound, rtol 2e-4 and atol 2e-6;
- only rank 0 writes checkpoints, previews, frames and logs, and prints
  and logs the val PSNR (``VAL_METRICS``; its first value within 1e-5
  relative of the one-rank run's, as ``tests/test_multiprocess.py``);
- the flagship's ``GRID_UPSAMPLE`` milestone (2:12) happens on both ranks
  alike (the digests).

Also the refusals by name that replace "not ported yet": a ``MESH_SHAPE``
other than the world size, a ``SAMPLE_SHARD`` that does not divide it,
more NCCL ranks than cards, and ranks on a card that is not there.
"""

import functools
import glob
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from tinynerf_torch import ckpt, eval as evallib, optim
from tinynerf_torch.__main__ import main as cli_main
from tinynerf_torch.config import Config
from tinynerf_torch.parallel import distributed as dist, mesh as meshlib
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4
FAMILIES = {
    "mlp": {},
    "flagship": {"FINE_FIELD": "grid", "GRID_HYBRID": True, "GRID_RES": 9,
                 "GRID_COMP_DENSITY": 3, "GRID_COMP_APP": 4, "GRID_DECODER_WIDTH": 8,
                 "GRID_LR_MULT": 20.0, "PROPOSAL": True, "PROP_FIELD": "grid",
                 "PROP_GRID_HYBRID": True, "PROP_GRID_RES": 8, "PROP_GRID_COMP_DENSITY": 2,
                 "PROP_GRID_COMP_APP": 2, "PROP_GRID_DECODER_WIDTH": 8,
                 "GRID_UPSAMPLE": "2:12"},
}
DIGEST = re.compile(r"\[RANK (\d)/(\d)\] params sha256 ([0-9a-f]{64})")


def _write_ini(path: str, scene: str, out: str, family: str, **extra) -> str:
    keys = {"IMG_DIR": scene + "/", "DATA_TYPE": "sync", "RESULTS_PATH": f"{out}/results/",
            "CKPT_PATH": f"{out}/ckpt/", "LOG_DIR": f"{out}/runs/", "TOTAL_ITER": ITERS,
            "STEP": 1, "BATCH_RAY": 32, "N_COARSE": 4, "N_FINE": 4, "LEARNING": 5e-4,
            "RENDER_CHUNK": 64, "VAL_METRICS": True, "CONTINUE": False,
            **FAMILIES[family], **extra}
    with open(path, "w") as f:
        f.write(f"[{os.path.splitext(os.path.basename(path))[0]}]\n")
        f.writelines(f"{k} = {v}\n" for k, v in keys.items())
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(ini: str, **env_extra) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                        "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               **env_extra)
    return subprocess.Popen([sys.executable, "-m", "tinynerf_torch", "--conf", ini,
                             "--device", "cpu", "--mode", "all"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout: int = 600):
    """Each process's output; drained at once so that no rank blocks on a
    full pipe while another waits for it in a collective."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(lambda p: p.communicate(timeout=timeout)[0], procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _files(out: str):
    return sorted(os.path.relpath(os.path.join(r, f), out)
                  for sub in ("ckpt", "results", "runs")
                  for r, _, fs in os.walk(os.path.join(out, sub)) for f in fs)


def _log(out: str):
    (path,) = glob.glob(os.path.join(out, "runs", "*", "metrics.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def _first_step(out: str):
    (path,) = glob.glob(os.path.join(out, "ckpt", "*_0.npz"))
    return ckpt.load_train_state(path)[1]


@pytest.fixture(scope="module")
def single(sync_scene_dir, tmp_path_factory):
    """One-rank runs of each family's INI: {family: output directory}."""
    root = tmp_path_factory.mktemp("one_rank")
    outs = {f: str(root / f) for f in FAMILIES}
    procs = [_start(_write_ini(str(root / f"one_{f}.ini"), sync_scene_dir, outs[f], f))
             for f in FAMILIES]
    _wait(procs)
    return outs


def _check_against_single(out: str, single_out: str):
    log, ref = _log(out), _log(single_out)
    loss = lambda entries: [e["loss/train"] for e in entries if "loss/train" in e]
    assert len(loss(log)) == len(loss(ref)) == ITERS
    assert loss(log)[0] == pytest.approx(loss(ref)[0], rel=1e-5)
    got, want = _first_step(out), _first_step(single_out)
    for a, b in zip(optim.leaves(got), optim.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-6)
    vals = [e["psnr/val"] for e in log if "psnr/val" in e]
    ref_vals = [e["psnr/val"] for e in ref if "psnr/val" in e]
    assert len(vals) == ITERS and all(np.isfinite(vals))
    # the val pass after the first step, each rank on its rows of the batch
    assert vals[0] == pytest.approx(ref_vals[0], rel=1e-5)


def _digests(*outs):
    found = [m.groups() for out in outs for m in DIGEST.finditer(out)]
    assert sorted(r for r, _, _ in found) == ["0", "1"] and {n for _, n, _ in found} == {"2"}
    return {d for _, _, d in found}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_ranks_through_the_jax_variables(family, single, sync_scene_dir, tmp_path):
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    inis = [_write_ini(str(tmp_path / f"r{r}.ini"), sync_scene_dir, outs[r], family,
                       MESH_SHAPE=2) for r in range(2)]
    port = _free_port()
    procs = [_start(inis[r], COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2",
                    PROCESS_ID=str(r)) for r in range(2)]
    text = _wait(procs)
    assert len(_digests(*text)) == 1
    # rank 0 alone prints the iteration lines and the val PSNR
    assert text[0].count("[VAL PSNR]") == ITERS and "[VAL PSNR]" not in text[1]
    assert "[ITER]" not in text[1]
    files = _files(outs[0])
    assert sum(f.startswith("ckpt") for f in files) == ITERS
    assert any(f.endswith(".jpg") and f.count("/") == 1 for f in files)     # previews
    assert any(f.endswith((".gif", ".mp4")) for f in files)                 # the video
    assert any(f.endswith("metrics.jsonl") for f in files)
    assert _files(outs[1]) == []
    _check_against_single(outs[0], single[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_cli_spawns_two_ranks(family, single, sync_scene_dir, tmp_path):
    out = str(tmp_path / "run")
    ini = _write_ini(str(tmp_path / "spawned.ini"), sync_scene_dir, out, family, MESH_SHAPE=2)
    (text,) = _wait([_start(ini)])
    assert len(_digests(text)) == 1
    assert text.count("[VAL PSNR]") == ITERS
    # one directory for both ranks: each artifact written once, by rank 0
    assert len(os.listdir(os.path.join(out, "runs"))) == 1
    assert sum(f.startswith("ckpt") for f in _files(out)) == ITERS
    assert len(glob.glob(os.path.join(out, "results", "*", "0.jpg"))) == 1
    _check_against_single(out, single[family])


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("kw,world,what", [
    (dict(mesh_shape=2), 1, "MESH_SHAPE=2 asks for 2 ranks but this job has 1"),
    (dict(mesh_shape=1), 4, "MESH_SHAPE=1 asks for 1 ranks but this job has 4"),
    (dict(mesh_shape=4, sample_shard=3), 4, "SAMPLE_SHARD=3 must divide the device count 4")])
def test_check_supported_refuses_a_mesh_the_job_is_not(kw, world, what):
    check = evallib.check_supported if world == 1 else functools.partial(
        meshlib.check_mesh, world=world)
    with pytest.raises(ValueError, match=what):
        check(Config(**kw))


@pytest.mark.parametrize("kw,world", [
    (dict(), 1), (dict(mesh_shape=4), 4), (dict(mesh_shape=4, sample_shard=2), 4),
    (dict(sample_shard=2), 1)])
def test_check_supported_takes_the_job_s_mesh(kw, world):
    """``MESH_SHAPE`` unset is the job's size; ``SAMPLE_SHARD`` on one rank
    asks for no mesh, as ``tinynerf/parallel/mesh.py::mesh_for_config``."""
    meshlib.check_mesh(Config(**kw), world)


def test_more_nccl_ranks_than_cards_are_refused():
    with pytest.raises(ValueError, match="NCCL rank 2 of this machine has no card of its own"):
        dist.check_ranks_fit("nccl", 2, 2)
    dist.check_ranks_fit("nccl", 1, 2)
    dist.check_ranks_fit("gloo", 3, 1)   # gloo may share a card


def test_the_cli_never_spawns_card_ranks_on_the_cpu(sync_scene_dir, tmp_path):
    """``MESH_SHAPE = 2`` without ``--device cpu`` asks for two cards: where
    there is none, the spawn raises instead of running on the CPU."""
    ini = _write_ini(str(tmp_path / "card.ini"), sync_scene_dir, str(tmp_path / "out"), "mlp",
                     MESH_SHAPE=2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is False"):
        cli_main(["--conf", ini, "--mode", "train"])
    assert not os.path.exists(tmp_path / "out")
