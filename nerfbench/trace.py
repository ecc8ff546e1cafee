"""The traced window: ``torch.profiler`` over a few calls, its Chrome trace
written under ``TMPDIR``, read back and deleted.

From the trace, inside the window (a ``nerfbench.window`` annotation that
ends after a ``synchronize``):

- busy: the union of the device's kernel, copy and fill intervals (not
  their sum, which counts twice what overlapping streams run at once);
- each kernel's device time by its bare name (``void ns::name<...>(...)``
  -> ``ns::name``);
- the host's API calls that queue work on the device (kernel and graph
  launches, asynchronous copies and fills);
- the idle gaps between device intervals, each named by the innermost host
  event under its midpoint;
- a check for lost kernel records: every replay of one graph must show the
  same number of kernels, NCCL's aside (a graphed trace has been seen to
  drop some); the caller traces again where it finds some lost.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync",
                "LaunchCooperative")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "nerfbench.window"
TOP = 10
# how far back a gap looks for the host event under it
MAX_HOST_EVENT_US = 5e6


@dataclass
class Span:
    wall_s: float                   # host clock, synchronised at both ends
    window_s: float                 # the annotation's length in the trace
    busy_s: float
    calls: int
    kernel_s: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    records_lost: bool = False

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels_named(self, names) -> float:
        return sum(s for n, s in self.kernel_s.items() if n in names)

    def kernels_containing(self, word: str) -> float:
        return sum(s for n, s in self.kernel_s.items() if word in n)


def bare_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        if stop in name:
            name = name[:name.index(stop)]
    return name.strip()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def summarise(events: list, wall_s: float, calls: int) -> Span:
    """A ``Span`` from a Chrome trace's events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    busy = _union(clipped)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        if e.get("cat") == "kernel":
            kernel_s[bare_name(e["name"])] += float(e["dur"]) * 1e-6
    ops: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        name = bare_name(e["name"]) if e.get("cat") == "kernel" else e["name"]
        ops[name[:120]] += float(e["dur"]) * 1e-6
    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
            and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    launches = sum(1 for e in host if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and any(k in e["name"] for k in LAUNCH_WORDS))
    gaps: Dict[str, float] = collections.defaultdict(float)
    host.sort(key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in host]
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "(host idle)"
        # the latest-starting host event that still runs at the midpoint
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if starts[j] + float(host[j]["dur"]) >= mid:
                name = host[j]["name"]
                break
            if mid - starts[j] > MAX_HOST_EVENT_US:
                break
        gaps[name[:120]] += (b - a) * 1e-6
    # kernels a graph launch ran, by the launch's correlation id
    graph_ids = {e["args"].get("correlation") for e in host
                 if "GraphLaunch" in e["name"] and "args" in e}
    # NCCL's kernels are left out of the count: their records are not
    # always tied to the launch that replays them
    per_launch = collections.Counter(e.get("args", {}).get("correlation") for e in dev
                                     if e.get("cat") == "kernel" and "nccl" not in e["name"]
                                     and e.get("args", {}).get("correlation") in graph_ids)
    counts = sorted(per_launch.values())
    lost = len(counts) > 1 and counts[0] != counts[-1]
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Span(wall_s=wall_s, window_s=(w1 - w0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6, calls=calls,
                kernel_s=dict(kernel_s), launches=launches, device_ops=top(ops),
                idle_gaps=top(gaps), records_lost=lost)


def traced(call: Callable[[], object], n: int, rank: int = 0, cuda: bool = True) -> Span:
    """``n`` calls of ``call`` under the profiler, on the current card (on
    the CPU, to rehearse: no device events, so no busy time)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            sync()
            wall = time.perf_counter() - t0
    path = os.path.join(tempfile.gettempdir(), f"nerfbench-trace-{os.getpid()}-{rank}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    span = summarise(events, wall, n)
    if span.records_lost:
        print(f"trace: rank {rank}: the replays of one graph show different kernel counts; "
              "the profiler lost kernel records, so no share is read from this trace",
              file=sys.stderr)
    return span
