"""The port's recorder (``tinynerf_torch/profiling.py``): host spans, device
sections and counters, off by default; its wiring into the step, the chunk
and the frame; ``TRACE_SPANS``; the benchmark's reader of the frame graph's
node count; and ``device_rows``' busy time and ``Throughput``'s
synchronise.

On the CPU a device section's mark only records its slot's path (the
plan), so the tests read the plan of a tiny ``lego_occ``-shaped step. The
marks' times on the card are tested by ``tests/test_torch_profiling_gpu.py``."""

import json
import types

import numpy as np
import pytest
import torch

from nerfbench import harness
from tinynerf_torch import eval as evallib, profiling, train
from tinynerf_torch.config import Config, apply_key
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import SceneData
from tinynerf_torch.data.rays import RayTable
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

from tests.test_torch_profiling_gpu import HW, OCC, scene as _scene


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test; spans off before and after."""
    monkeypatch.setattr(profiling, "_rec", profiling.Recorder())
    yield profiling._rec


def _step_and_state(**over):
    cfg = Config(**dict(OCC, **over))
    table, kinv, rows = _scene()
    step = train.make_train_step(cfg, table, kinv)
    return cfg, step, train.init_state(cfg, torch.device("cpu")), kinv, rows


def _profiled_names(fn):
    """The names of the CPU profiler's events while ``fn()`` runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


def test_spans_off_record_nothing(recorder):
    """Off (the default): an eager step, a chunk and a frame record no span,
    no mark and no ``tinynerf.*`` annotation."""
    cfg, step, state, kinv, rows = _step_and_state()
    chunk = train.make_chunked_step(step, 2)
    frame = evallib.make_frame_fn(cfg, kinv, HW, HW, occ_grid=state.occ)

    def work():
        st, _ = step(state)
        chunk(st)
        frame(st.params, rows[0])

    names = _profiled_names(work)
    assert not profiling.spans_enabled()
    assert not any(n.startswith("tinynerf.") for n in names)
    assert profiling.plan() == [] and profiling.marks_launched() == 0
    snap = profiling.snapshot()
    assert snap["host"] == {} and snap["device"] == {}


@pytest.mark.parametrize("iteration", [0, 1], ids=["refresh", "plain"])
def test_plan_of_an_eager_step(iteration):
    """On: the slot paths a step's marks charge, in order. The stopwatch
    opens with ``step.gap`` and closes on ``step``; each section's entry
    charges its parent, its exit itself; the field's forward and backward
    nest under the render, the backward and, on a refresh step, the
    refresh."""
    profiling.spans_on()
    _, step, state, _, _ = _step_and_state()
    state.iteration = iteration
    step(state)
    plan = profiling.plan()
    refresh = ({"step.refresh", "step.refresh/field.fwd"} if iteration == 0 else set())
    assert set(plan) == {"step.gap", "step", "step.sample", "step.render",
                         "step.render/field.fwd", "step.backward", "step.backward/field.bwd",
                         "step.adam"} | refresh
    assert plan[:3] == ["step.gap", "step", "step.sample"]
    assert plan[-3:] == ["step", "step.adam", "step"]
    # a nested section runs between its parent's marks: the coarse and the
    # fine pass each enter and leave the field once
    render = plan[plan.index("step.render"):plan.index("step.backward") - 1]
    assert render == ["step.render", "step.render/field.fwd"] * 2 + ["step.render"]
    assert plan.count("step.backward/field.bwd") == 2
    if iteration == 0:
        first = plan.index("step.refresh/field.fwd")
        assert plan[first - 1] == "step.refresh" and plan[first - 2] == "step"
    assert profiling.marks_launched() == 0   # the CPU launches nothing


def test_a_graph_body_opens_one_stopwatch():
    """A stopwatch opened inside a running one (the step inside a graph's
    body) is no-op, and a section with none running records nothing (a
    frame's field calls)."""
    profiling.spans_on()
    with profiling.section("field.fwd"):
        pass
    assert profiling.plan() == []
    with profiling.section("step", torch.device("cpu")):
        with profiling.section("step", torch.device("cpu")):
            with profiling.section("step.adam"):
                pass
        with profiling.section("step.writeback"):
            pass
    assert profiling.plan() == ["step.gap", "step", "step.adam", "step", "step.writeback",
                                "step"]


def test_chunk_and_frame_spans(recorder):
    """On: a chunk's spans and a frame's on the CPU; the frame's field calls
    launch no mark."""
    profiling.spans_on()
    cfg, step, state, kinv, rows = _step_and_state()
    state.iteration = 5
    train.make_chunked_step(step, 2)(state)
    host = profiling.snapshot()["host"]
    assert set(host) == {"chunk", "chunk/chunk.rates"}
    assert host["chunk"]["count"] == 1 and host["chunk"]["total_s"] > 0
    profiling.reset()
    frame = evallib.make_frame_fn(cfg, kinv, HW, HW, occ_grid=state.occ)
    names = _profiled_names(lambda: [frame(state.params, r) for r in rows])
    assert {"tinynerf.frame", "tinynerf.frame.pose", "tinynerf.frame.readback"} <= names
    host = profiling.snapshot()["host"]
    assert set(host) == {"frame", "frame/frame.pose", "frame/frame.readback"}
    assert host["frame"]["count"] == len(rows)
    assert profiling.plan() == []


def test_host_span_nesting_and_self_time(recorder, monkeypatch):
    """With a fake clock: paths by nesting, total and self time (self: less
    the children)."""
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(recorder, "clock", lambda: next(ticks) * 1000)
    profiling.spans_on()
    with profiling.span("chunk"):                 # 0 ... 50
        with profiling.span("chunk.rates"):       # 10 ... 20
            pass
        with profiling.span("chunk.replay"):      # 30 ... 40
            pass
    with profiling.span("chunk"):                 # 60 ... 70
        pass
    host = profiling.snapshot()["host"]
    assert host["chunk"] == {"count": 2, "total_s": pytest.approx(60e-6),
                             "self_s": pytest.approx(40e-6)}
    assert host["chunk/chunk.rates"] == {"count": 1, "total_s": pytest.approx(10e-6),
                                         "self_s": pytest.approx(10e-6)}
    assert set(host) == {"chunk", "chunk/chunk.rates", "chunk/chunk.replay"}


def test_reset_snapshot_and_counters(recorder):
    """``snapshot`` is JSON-able and round-trips; ``reset`` zeroes the spans
    and the plan and keeps the counters; off, nothing is recorded again."""
    profiling.spans_on()
    with profiling.span("frame"):
        with profiling.section("step", torch.device("cpu")):
            pass
    profiling.count("graph.captures")
    profiling.count("graph.captures")
    profiling.gauge("graph.nodes.frame", 4321)
    snap = profiling.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap["counters"] == {"graph.captures": 2, "graph.nodes.frame": 4321}
    assert snap["host"]["frame"]["count"] == 1 and snap["device"] == {}
    profiling.reset()
    assert profiling.plan() == []
    assert profiling.snapshot() == {"host": {}, "device": {}, "counters": snap["counters"]}
    profiling.spans_on(False)
    with profiling.span("frame"):
        pass
    assert profiling.snapshot()["host"] == {}


def test_spans_line():
    snap = {"host": {"chunk": {"count": 4, "total_s": 0.002, "self_s": 0.001}},
            "device": {"step.render": {"count": 4, "self_s": 0.004},
                       "step.render/field.fwd": {"count": 8, "self_s": 0.02}}}
    line = profiling.spans_line(snap, 4)
    assert line == ("[SPANS] ms a step over 4 steps: step.render 1.000, "
                    "step.render/field.fwd 5.000 | host: chunk 0.500")
    assert "not measured" in profiling.spans_line({"host": {}, "device": {}}, 4)


@pytest.mark.parametrize("raw,want", [("true", True), ("False", False), ("0", False)])
def test_trace_spans_and_grid_pallas_keys_are_booleans(raw, want):
    """``TRACE_SPANS`` (default off) and ``GRID_PALLAS`` parse as booleans:
    ``GRID_PALLAS = False`` in an INI is false, not the string ``"False"``."""
    assert Config().trace_spans is False
    cfg = Config()
    apply_key(cfg, "TRACE_SPANS", raw)
    apply_key(cfg, "GRID_PALLAS", raw)
    assert cfg.trace_spans is want and cfg.grid_pallas is want


def test_runner_applies_trace_spans(monkeypatch):
    """The Runner turns the recorder on or off as ``TRACE_SPANS`` says."""
    from tinynerf_torch import runner as runnerlib
    table, _, rows = _scene()
    scene = SceneData(images=np.zeros((2, HW, HW, 3), np.float32), poses_bounds=rows,
                      height=HW, width=HW, focal=table.focal)
    for flag in (True, False):
        runnerlib.Runner(Config(trace_spans=flag, data_type="sync"), device="cpu",
                         scene=scene)
        assert profiling.spans_enabled() is flag


def test_runner_prints_the_spans_line(tmp_path, capsys):
    """With ``TRACE_SPANS`` the Runner's training prints a ``[SPANS]`` line
    at each ``STEP``, after the ``[ITER]`` line; on the CPU the device
    sections read "not measured" and the chunk's host time is there."""
    from tinynerf_torch import runner as runnerlib
    _, _, rows = _scene()
    images = np.random.default_rng(4).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    scene = SceneData(images=images, poses_bounds=rows, height=HW, width=HW,
                      focal=float(0.5 * HW / np.tan(0.4)))
    out = str(tmp_path)
    cfg = Config(**dict(OCC, trace_spans=True, total_iter=4, step=2, data_type="sync",
                        results_path=out + "/results/", ckpt_path=out + "/ckpt/",
                        log_dir=out + "/runs/"))
    runnerlib.Runner(cfg, device="cpu", scene=scene).train()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("[ITER]", "[SPANS]"))]
    assert [ln.split()[0] for ln in lines] == ["[ITER]", "[SPANS]"] * 2
    assert all("over 2 steps" in ln and "not measured" in ln and "host: chunk" in ln
               for ln in lines[1::2])


def _frame_nodes_reader(kind="render"):
    run = types.SimpleNamespace(kind=kind)
    return harness.metric_reader("frame_graph_nodes").read(run)


def test_frame_graph_nodes_reader(monkeypatch):
    """The benchmark's ``frame_graph_nodes``: the program's counter
    ``graph.nodes.frame`` in a render run; None in a training run, where the
    counter is missing, and where the program has no recorder (a checkout
    before it)."""
    assert _frame_nodes_reader() is None
    profiling.gauge("graph.nodes.frame", 9418)
    assert _frame_nodes_reader() == 9418
    assert _frame_nodes_reader("train") is None
    monkeypatch.delattr(profiling, "snapshot")
    assert _frame_nodes_reader() is None


def test_busy_is_the_union_of_device_intervals():
    """``device_rows``' busy time: overlapping kernels (two streams) count
    once, copies and fills count, host events do not."""
    ev = lambda cat, ts, dur: {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": "k"}
    events = [ev("kernel", 0, 10), ev("kernel", 5, 10), ev("gpu_memcpy", 20, 5),
              ev("kernel", 22, 1), ev("gpu_memset", 30, 2), ev("cpu_op", 0, 100),
              {"ph": "i", "cat": "kernel", "ts": 50}]
    assert profiling.busy_us(events) == 15 + 5 + 2
    assert profiling.busy_us([]) == 0.0


def test_device_rows_on_the_cpu_give_no_busy_time():
    x = torch.ones(64, 64)
    wall_ms, rows, busy = profiling.device_rows(lambda: x @ x, 2, torch.device("cpu"))
    assert wall_ms > 0 and rows and busy is None


def test_throughput_synchronises_before_the_clock(monkeypatch):
    """On a card the meter synchronises before each reading of the clock, so
    a window counts finished steps."""
    calls = []
    clock = iter([10.0, 12.0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append("sync"))
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: calls.append("clock") or next(clock))
    meter = profiling.Throughput(rays_per_step=100, device=torch.device("cuda"))
    meter.tick(4)
    assert meter.rays_per_sec == pytest.approx(200.0)
    assert calls == ["sync", "clock", "sync", "clock"]
    calls.clear()
    cpu_clock = iter([1.0, 2.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(cpu_clock))
    assert profiling.Throughput(rays_per_step=10).rays_per_sec == pytest.approx(0.0)
    assert calls == []
