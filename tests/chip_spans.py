"""The recorder on the card (``tinynerf_torch/profiling.py``): what its spans,
sections and counters read, what they cost, and where the profiler's idle
gaps fall among the spans, on the benchmark's ``lego_occ`` cells (the
scene, weights and program objects of ``nerfbench/cells``).

    python3 tests/chip_spans.py quick      # a toy step: its graph's nodes with spans off and on
    python3 tests/chip_spans.py measure [--window S] [--out FILE]
    python3 tests/chip_spans.py nodes [--out FILE]

``measure``: two training set-ups of ``train-lego_occ`` (seed-for-seed the
same), one captured with spans off and one with spans on, driven as the
cell's window drives them (one step a call, four queued) in alternating
windows of ``--window`` seconds (off, on, on, off, ...), and the frame
function of ``render-lego_occ`` with spans off and on in turn; then with
spans on a traced span of 20 steps and one of 3 frames under
``torch.profiler``: the device sections of a step against the trace's busy
time a step, the readings of the five per-layer quantities the spans were
made for, and each idle gap's time by the innermost ``tinynerf.*`` span
over it. ``nodes``: the step graphs' and the frame graph's node counts of
whichever ``tinynerf_torch`` is importable (``PYTHONPATH`` may point at
another checkout), its graphs kept for counting and counted here, since a
checkout from before the recorder counts none. Each prints one JSON line
and writes it to ``--out`` where given.
"""

from __future__ import annotations

import argparse
import bisect
import ctypes
import json
import os
import statistics
import sys
import tempfile
import time

import torch

# the checkout's root, after any PYTHONPATH (``nodes`` may read another checkout)
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEP_SEED = 2147483001
FRAME_SEED = 7101
TRACE_STEPS = 20
TRACE_FRAMES = 3


def _card() -> dict:
    return {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}


def _count_nodes(graph) -> int:
    """A kept graph's nodes (``nodes`` counts a checkout that has no
    ``graphs.Captured.nodes``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: error {err}")
    return n.value


def quick() -> dict:
    """A toy lego_occ-shaped step (tests/test_torch_profiling_gpu.py's),
    graphed with spans off and on: nodes, marks, and the sections of 4
    replays."""
    from test_torch_profiling_gpu import OCC, scene
    from tinynerf_torch import profiling, train
    from tinynerf_torch.config import Config
    from tinynerf_torch.device import resolve_device
    dev = resolve_device("cuda")
    table, kinv, _ = scene("cuda")
    out = _card()
    for on in (False, True):
        profiling.spans_on(on)
        cfg = Config(**OCC)
        chunk = train.make_chunked_step(train.make_train_step(cfg, table, kinv), 1)
        state = train.init_state(cfg, dev)
        state.iteration = 1
        m0 = profiling.marks_launched()
        state, _ = chunk(state)
        m1 = profiling.marks_launched()
        profiling.reset()
        for _ in range(4):
            state, _ = chunk(state)
        g = chunk.graphs.graphs[False]
        out[f"spans_{'on' if on else 'off'}"] = {
            "nodes": g.nodes, "marks_warm_and_capture": m1 - m0,
            "device": profiling.snapshot()["device"]}
    profiling.spans_on(False)
    return out


def _traced(call, n):
    """``n`` calls under the profiler inside ``nerfbench.trace``'s window
    annotation: (wall seconds, the Chrome trace's events)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from nerfbench import trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return wall, events


def _by_span(events, n) -> dict:
    """The idle gaps' ms a call by the innermost ``tinynerf.*`` span over
    each gap's midpoint, and for a few CUDA API calls the innermost
    ``tinynerf.*`` span around each (counts)."""
    from nerfbench import trace
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs if e.get("name") == trace.WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    busy = trace._union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                         for e in xs if e.get("cat") in trace.DEVICE_CATS
                         and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0])
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in xs if e.get("cat") == "user_annotation"
                    and e["name"].startswith("tinynerf.")), key=lambda s: s[0])
    starts = [s[0] for s in spans]

    def inner(t):
        best = None
        for a, b, name in spans[:bisect.bisect_right(starts, t)]:
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, b, name)
        return best[2] if best else "(no tinynerf span)"

    gaps = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            name = inner(0.5 * (a + b))
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-3 / n
    calls = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cpu_op") and e["name"] in (
                "cudaGraphLaunch", "aten::is_pinned", "aten::pin_memory", "cudaMemcpyAsync"):
            key = f"{e['name']} in {inner(float(e['ts']) + 0.5 * float(e['dur']))}"
            calls[key] = calls.get(key, 0) + 1
    return {"gap_ms_per_call": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
            "api_calls": calls}


def _per_call(snap, root) -> dict:
    """Host ms a ``root`` span of each host path under it, over the spans
    recorded so far (the untraced windows with spans on)."""
    host = snap["host"]
    n = host[root]["count"]
    return {"calls": n, **{p: 1e3 * v["total_s"] / n for p, v in sorted(host.items())
                           if p == root or p.startswith(root + "/")}}


def _windows(kinds, run_one, seconds):
    """Alternating windows: {kind: [rate, ...]}, in the order of ``kinds``."""
    rates = {k: [] for k in set(kinds)}
    for k in kinds:
        rates[k].append(run_one(k, seconds))
    return rates


def measure(window_s: float) -> dict:
    from nerfbench import harness, trace
    from nerfbench.cells import render as rcell, train as tcell
    from tinynerf_torch import profiling
    dev = harness.start("cuda")
    out = _card()
    # -- training: one set-up captured with spans off, one with spans on
    cell = harness.load_cell("train-lego_occ")
    setups = {}
    for on in (False, True):
        profiling.spans_on(on)
        chunk, state, _ = tcell.build(cell, STEP_SEED, dev, 1)
        m = [profiling.marks_launched()]
        for _ in range(3):            # the refresh graph, the plain graph, a replay
            state, _ = chunk(state)
            m.append(profiling.marks_launched())
        setups[on] = [chunk, state]
        g = chunk.graphs.graphs
        out[f"step_graph_spans_{'on' if on else 'off'}"] = {
            "nodes_plain": g[False].nodes, "nodes_refresh": g[True].nodes,
            "marks_refresh_step": (m[1] - m[0]) // 2, "marks_plain_step": (m[2] - m[1]) // 2}
    profiling.spans_on(False)

    def run_steps(on, seconds):
        profiling.spans_on(on)
        chunk, state = setups[on]
        state, steps, elapsed, _, _ = tcell.window(chunk, state, seconds, cell.traffic, dev, None)
        setups[on][1] = state
        profiling.spans_on(False)
        return steps * cell.ini["BATCH_RAY"] / elapsed

    order = [False, True, True, False, False, True, True, False]
    rates = _windows(order, run_steps, window_s)
    out["train_rays_per_s"] = {("on" if k else "off"): v for k, v in rates.items()}
    med = {k: statistics.median(v) for k, v in rates.items()}
    out["train_cost_pct"] = 100.0 * (med[False] - med[True]) / med[False]
    out["train_windows_on"] = _per_call(profiling.snapshot(), "chunk")
    # a traced span of the spans-on set-up, the recorder reset before it
    profiling.spans_on(True)
    chunk, state = setups[True]
    holder = [state]

    def step_call():
        holder[0] = chunk(holder[0])[0]

    profiling.reset()
    wall, events = _traced(step_call, TRACE_STEPS)
    setups[True][1] = holder[0]
    snap = profiling.snapshot()
    profiling.spans_on(False)
    span = trace.summarise(events, wall, TRACE_STEPS)
    dev_s = snap["device"]
    steps = dev_s["step"]["count"]
    sections = sum(v["self_s"] for p, v in dev_s.items() if p != "step.gap")
    out["train_trace"] = {
        "steps": steps, "busy_ms_per_step": 1e3 * span.busy_s / TRACE_STEPS,
        "window_ms_per_step": 1e3 * span.window_s / TRACE_STEPS,
        "sections_ms_per_step": 1e3 * sections / steps,
        "sections_over_busy": sections / steps / (span.busy_s / TRACE_STEPS),
        "device_ms_per_step": {p: 1e3 * v["self_s"] / steps for p, v in sorted(dev_s.items())},
        "host_ms_per_step": {p: 1e3 * v["total_s"] / TRACE_STEPS
                             for p, v in sorted(snap["host"].items())},
        "records_lost": span.records_lost, "idle_pct": span.idle_pct,
        "launches_per_step": span.launches / TRACE_STEPS, **_by_span(events, TRACE_STEPS)}
    render = dev_s.get("step.render", {"count": 0, "self_s": 0.0})
    out["readings"] = {
        "step_render_ms": 1e3 * (render["self_s"] + dev_s["step.backward"]["self_s"])
        / max(1, render["count"]),
        "step_adam_ms": 1e3 * (dev_s["step.adam"]["self_s"] + dev_s["step.writeback"]["self_s"])
        / steps,
        "chunk_host_ms": 1e3 * snap["host"]["chunk"]["total_s"] / TRACE_STEPS}
    out["counters_train"] = snap["counters"]
    del setups, chunk, state, holder
    tcell.free(dev)
    # -- frames: one frame function; the graph has no marks either way
    rc = harness.load_cell("render-lego_occ")
    frame_fn, params, path, _ = rcell.build(rc, FRAME_SEED, dev)
    frame_fn(params, path[0])
    out["frame_graph_nodes"] = profiling.snapshot()["counters"].get("graph.nodes.frame")
    k = [1]

    def one_frame():
        frame_fn(params, path[k[0] % len(path)])
        k[0] += 1

    def run_frames(on, seconds):
        profiling.spans_on(on)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            one_frame()
            n += 1
        profiling.spans_on(False)
        return (time.perf_counter() - t0) / n

    frames = _windows(order, run_frames, window_s)
    out["frame_s"] = {("on" if k_ else "off"): v for k_, v in frames.items()}
    fmed = {k_: statistics.median(v) for k_, v in frames.items()}
    out["frame_cost_pct"] = 100.0 * (fmed[True] - fmed[False]) / fmed[False]
    out["frame_windows_on"] = _per_call(profiling.snapshot(), "frame")
    profiling.spans_on(True)
    profiling.reset()
    wall, events = _traced(one_frame, TRACE_FRAMES)
    snap = profiling.snapshot()
    profiling.spans_on(False)
    fspan = trace.summarise(events, wall, TRACE_FRAMES)
    out["frame_trace"] = {
        "busy_ms_per_frame": 1e3 * fspan.busy_s / TRACE_FRAMES,
        "window_ms_per_frame": 1e3 * fspan.window_s / TRACE_FRAMES,
        "idle_pct": fspan.idle_pct, "records_lost": fspan.records_lost,
        "host_ms_per_frame": {p: 1e3 * v["total_s"] / TRACE_FRAMES
                              for p, v in sorted(snap["host"].items())},
        "device_sections": snap["device"], "idle_gaps_by_api": fspan.idle_gaps,
        **_by_span(events, TRACE_FRAMES)}
    out["readings"]["frame_launch_ms"] = (
        1e3 * snap["host"]["frame/frame.launch"]["total_s"] / TRACE_FRAMES)
    out["readings"]["frame_graph_nodes"] = out["frame_graph_nodes"]
    out["counters_render"] = snap["counters"]
    return out


def nodes() -> dict:
    """The node counts of the step graphs and the frame graph, each graph
    kept for counting (``CUDAGraph(keep_graph=True)``, which replays as the
    default does)."""
    from nerfbench import harness
    from nerfbench.cells import render as rcell, train as tcell
    real = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda keep_graph=True: real(keep_graph=True)
    dev = harness.start("cuda")
    out = _card()
    import tinynerf_torch
    out["package"] = os.path.dirname(tinynerf_torch.__file__)
    cell = harness.load_cell("train-lego_occ")
    chunk, state, _ = tcell.build(cell, STEP_SEED, dev, 1)
    for _ in range(3):
        state, _ = chunk(state)
    g = chunk.graphs.graphs
    out["step_nodes"] = {"plain": _count_nodes(g[False].graph),
                         "refresh": _count_nodes(g[True].graph)}
    del chunk, state, g
    tcell.free(dev)
    rc = harness.load_cell("render-lego_occ")
    frame_fn, params, path, _ = rcell.build(rc, FRAME_SEED, dev)
    frame_fn(params, path[0])
    frame_fn(params, path[1])
    out["frame_nodes"] = _count_nodes(frame_fn.graph["graph"].graph)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase", choices=("quick", "measure", "nodes"))
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_spans: needs a CUDA card", file=sys.stderr)
        return 2
    result = {"quick": quick, "nodes": nodes,
              "measure": lambda: measure(args.window)}[args.phase]()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
