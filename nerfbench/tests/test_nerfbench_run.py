"""A run's command path on the CPU at a tiny size, its result line, its
refusals, and the check coming out false under each fault a cell can have
and under its control."""

import json
import os
import subprocess
import sys
import time

import pytest

from nerfbench import calibrate, check, harness, run
from nerfbench.tests import faults
from nerfbench.tests.tiny import tiny_cell, tiny_ranks_cell

SEED = 2 ** 31 + 12_345
ONE_RANK = ["train-lego_occ", "render-lego_occ"]


@pytest.fixture
def restore():
    """Put back what a planted fault replaced in the program."""
    from tinynerf_torch import eval as evallib, optim
    from tinynerf_torch.core import render
    from tinynerf_torch.parallel import mesh
    saved = [(optim, "adam_update"), (render, "ray_loss"), (mesh, "reduce_grads"),
             (evallib, "make_frame_fn")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    yield
    for m, a, v in saved:
        setattr(m, a, v)


@pytest.mark.parametrize("cell", ONE_RANK)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(cell, traced):
    c = tiny_cell(cell)
    line = run.execute(c, SEED, 0.5, traced, "cpu", time.time())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-3:] == ["checks", "_forbidden", "_numbers"]
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(c.limits)
    assert line["_forbidden"] == []
    json.dumps({k: v for k, v in line.items() if not k.startswith("_")})
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "nerfbench", "--workload", "train-lego_occ",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copy(harness.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "nerfbench", "--workload", "render-lego_occ",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell,fault", [
    ("train-lego_occ", faults.state_unchanged), ("train-lego_occ", faults.half_batch),
    ("render-lego_occ", faults.altered_frame)])
def test_fault_fails_the_check(cell, fault, restore):
    fault()
    line = run.execute(tiny_cell(cell), SEED, 0.5, False, "cpu", time.time())
    assert line["correct"] is False


@pytest.mark.parametrize("patch", [None, "nerfbench.tests.faults:no_exchange",
                                   "nerfbench.tests.faults:state_unchanged"])
def test_four_ranks(patch):
    """The training cell as one job of four gloo ranks: sound, its check
    holds every rank to the reference; without the exchange, or with a step
    that changes nothing, it fails."""
    line = run.execute(tiny_ranks_cell(), SEED, 0.5, False, "cpu", time.time(), patch=patch)
    assert line["device"]["count"] == 4 and line["attempted"] >= 1
    if patch is None:
        assert line["_numbers"]["rank_mismatch"] == 0.0 and line["correct"] is True
    else:
        assert line["correct"] is False


def test_control_fails_the_training_check():
    """The reference at float8 in the program's place."""
    import torch
    c = tiny_cell("train-lego_occ")
    numbers = calibrate.train_roles(c, SEED, ["control"], torch.device("cpu"))["control"]
    assert not check.verdict(numbers, c.limits)


def test_control_fails_the_frame_check():
    import torch
    c = tiny_cell("render-lego_occ")
    numbers = calibrate.frame_roles(c, SEED, ["control"], torch.device("cpu"))["control"]
    assert not check.verdict(numbers, c.limits)


def test_nothing_forbidden_is_loaded():
    """A run's process, the harness and the reference, hold no module whose
    top-level name is ``jax``, ``jaxlib``, ``flax`` or ``tinynerf`` (the
    port, ``tinynerf_torch``, is another name); the reference and the
    configurations' plain fields import nothing of the port."""
    code = """
import json, sys, time
from nerfbench import harness
for c in harness.load_json(harness.BENCHMARK)["configs"]:
    harness.load_module(f"{harness.BENCH_DIR}/configs/{c['name']}.py", "ref_" + c["name"])
import nerfbench.reference.train, nerfbench.reference.render, nerfbench.reference.precision
ref_only = sorted(m for m in sys.modules if m.split(".")[0] == "tinynerf_torch")
from nerfbench import run
from nerfbench.tests.tiny import tiny_cell, tiny_ranks_cell
run.execute(tiny_cell("render-lego_occ"), 3, 0.2, False, "cpu", time.time())
print(json.dumps({"ref": ref_only, "forbidden": harness.forbidden_modules(),
                  "port": "tinynerf_torch" in sys.modules}))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"ref": [], "forbidden": [], "port": True}
