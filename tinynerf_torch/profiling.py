"""The port's recorder: host spans, device sections and counters; traces and
throughput metering of the training loop.

Counterpart of ``tinynerf/profiling.py``, which reads its layers from XLA's
trace. Here a training step is one CUDA graph replay and a frame another,
whose kernels the profiler names but cannot place in a layer, so the
program records its own layers:

- **Host spans**, ``span(name)``: the host time of the chunk loop's and
  the frame's parts (``train.ChunkedStep``, ``graphs.StepGraphs``,
  ``eval``'s frame). A span's path is its parent's path, ``/``, its name.
  Totals by path (count, total, self time: the duration less what child
  spans cover), and a ``record_function("tinynerf.<name>")`` around each,
  so a ``torch.profiler`` trace shows the spans on the clock of its kernel
  and CUDA API records.
- **Device sections**, ``section(name)``: a stopwatch on the card. A step
  opens it (``section("step", device)``, with a mark charged to
  ``step.gap``: the device time since the previous step's last mark); every
  entry and exit of a section inside launches one mark
  (``csrc/span_mark.cu``), which charges the device time since the previous
  mark to the innermost section that was running. A slot's total is that
  section's own time, children excluded; slots are keyed by path, a step's
  section by its name (``step.render``), a nested one after its parent's
  path (``step.render/field.fwd``), so inclusive times are the sums over a
  path's prefix. Marks are plain launches on the current stream: a graph
  captured while spans are on holds them and replays them with the step, a
  graph captured while spans are off holds none. A section with no
  stopwatch running launches nothing (a frame's field calls). The stack is
  the process's, not the thread's: autograd runs the backward of a CUDA
  step on a thread of its own. On the CPU a mark only appends its slot's
  path to ``plan`` (the last ``PLAN_KEPT``), which the tests read.
- **Counters**, ``count(name, n)`` and ``gauge(name, v)``: what a capture
  measured (``graphs.capture``: captures, seconds and pool bytes; the step
  graphs' node counts and the nodes a frame's graphs launch). Counters are
  written only at a capture, never a step or a frame, and are kept whether
  or not spans are on.

Spans and sections are off by default (``spans_on``, the ``TRACE_SPANS``
key): off, ``span`` and ``section`` return one shared no-op context manager
after one bool check, and no mark is built or launched. The switch is read
when a span opens and when a section runs, so a graph holds marks only if
spans were on at its capture. ``reset`` zeroes the host totals and the
device slots (never inside a capture); ``snapshot`` synchronises and
returns ``{"host", "device", "counters"}``, a JSON-able dict. Nothing is
written to disk.

Besides: ``Trace`` (and the context manager ``trace``) records a
``torch.profiler`` trace of the steps it brackets (``PROFILE_STEPS``) and
writes it as a Chrome trace under ``<log_dir>/trace/``, viewable in
Perfetto or ``chrome://tracing``. CUDA activity is recorded only for a run
on the card: on the CPU it asks for CPU activity alone (the CPU build of
torch floods a profiler that asks for CUDA activity with warnings and takes
minutes). ``Throughput`` is a windowed rays/s meter over host-loop ticks
that synchronises its card before it reads the clock. ``device_rows``
traces a few calls of a function and returns the time by kernel and the
device's busy time, and ``print_profile`` prints them
(``tools/profile_step.py`` and ``chip_smoke.py``'s profiles).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

Rows = List[Tuple[str, int, float]]

MARK_SOURCE = "span_mark.cu"
# the most section paths a process records, and the marks the CPU's plan keeps
N_SLOTS = 128
PLAN_KEPT = 4096
# the Chrome trace's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# what a span or a section is while spans are off: one shared no-op
_NULL = contextlib.nullcontext()


class Recorder:
    """The process's spans, sections and counters (module docstring)."""

    def __init__(self):
        self.on = False
        self.clock = time.perf_counter_ns
        self.host_stack: List[_Span] = []
        # path -> [count, total ns, self ns]
        self.host: Dict[str, List[int]] = {}
        self.device_stack: List[_Section] = []
        self.slots: Dict[str, int] = {}
        self.buffers: Dict[torch.device, torch.Tensor] = {}
        self.plan = collections.deque(maxlen=PLAN_KEPT)   # on the CPU
        self.marks = 0        # marks launched on a card
        self.counters: Dict[str, float] = {}

    def slot(self, path: str) -> int:
        found = self.slots.get(path)
        if found is None:
            if len(self.slots) >= N_SLOTS:
                raise RuntimeError(f"more than {N_SLOTS} device section paths")
            found = self.slots[path] = len(self.slots)
        return found

    def mark(self, device: torch.device, path: str, closes: bool) -> None:
        """Charge the device time since the last mark to ``path``."""
        if device.type != "cuda":
            self.plan.append(path)
            return
        buf = self.buffers.get(device)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a device section's first mark on a card fell inside a "
                                   "graph capture: turn spans on before the warm-up")
            buf = self.buffers[device] = torch.zeros(1 + 2 * N_SLOTS, dtype=torch.int64,
                                                     device=device)
        with torch.cuda.device(device):
            err = _mark_library().span_mark(buf.data_ptr(), N_SLOTS, self.slot(path),
                                            int(closes),
                                            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"span_mark kernel launch failed: CUDA error {err}")
        self.marks += 1


_rec = Recorder()


@functools.lru_cache(maxsize=None)
def _mark_library() -> ctypes.CDLL:
    from tinynerf_torch.kernels.build import load_library
    lib = load_library(MARK_SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.span_mark.argtypes = [vp, i32, i32, i32, vp]
    lib.span_mark.restype = i32
    return lib


def spans_on(flag: bool = True) -> None:
    """Turn host spans and device sections on (or off) for the process."""
    _rec.on = bool(flag)


def spans_enabled() -> bool:
    return _rec.on


class _Span:
    __slots__ = ("name", "path", "t0", "child", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _rec.host_stack
        parent = stack[-1] if stack else None
        self.path = self.name if parent is None else f"{parent.path}/{self.name}"
        self.child = 0
        self.annotation = torch.profiler.record_function(f"tinynerf.{self.name}")
        self.annotation.__enter__()
        stack.append(self)
        self.t0 = _rec.clock()
        return self

    def __exit__(self, *exc):
        t1 = _rec.clock()
        stack = _rec.host_stack
        stack.pop()
        self.annotation.__exit__(*exc)
        took = t1 - self.t0
        total = _rec.host.setdefault(self.path, [0, 0, 0])
        total[0] += 1
        total[1] += took
        total[2] += took - self.child
        if stack:
            stack[-1].child += took
        return False


def span(name: str):
    """A host span (module docstring)."""
    if not _rec.on:
        return _NULL
    return _Span(name)


class _Section:
    __slots__ = ("path", "device", "root")

    def __init__(self, path: str, device: torch.device, root: bool):
        self.path, self.device, self.root = path, device, root

    def __enter__(self):
        stack = _rec.device_stack
        if self.root:
            _rec.mark(self.device, f"{self.path}.gap", True)
        else:
            _rec.mark(self.device, stack[-1].path, False)
        stack.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _rec.mark(self.device, self.path, True)
        _rec.device_stack.pop()
        return False


def section(name: str, device: Optional[torch.device] = None):
    """A device section (module docstring). With ``device`` it opens the
    stopwatch of a step on that device, unless one already runs (a graph's
    body around the step's own); without, it is a section inside the
    running stopwatch, and nothing where none runs."""
    if not _rec.on:
        return _NULL
    stack = _rec.device_stack
    if device is not None:
        return _NULL if stack else _Section(name, torch.device(device), True)
    if not stack:
        return _NULL
    parent = stack[-1]
    return _Section(name if parent.root else f"{parent.path}/{name}", parent.device, False)


def plan() -> List[str]:
    """The slot paths of the latest marks on the CPU (at most ``PLAN_KEPT``),
    oldest first."""
    return list(_rec.plan)


def marks_launched() -> int:
    """Marks launched on a card since the process started."""
    return _rec.marks


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _rec.counters[name] = _rec.counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set the counter ``name`` to ``value``."""
    _rec.counters[name] = value


def reset() -> None:
    """Zero the host totals, the plan and the device slots (one fill a
    card). Counters stay."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("profiling.reset inside a graph capture")
    _rec.host.clear()
    _rec.plan.clear()
    for buf in _rec.buffers.values():
        buf.zero_()


def snapshot() -> dict:
    """``{"host": {path: {count, total_s, self_s}}, "device": {path: {count,
    self_s}}, "counters": {...}}``, after one synchronise of each card that
    holds device slots. A device slot's ``count`` is the times its section
    closed."""
    paths = {s: p for p, s in _rec.slots.items()}
    device: Dict[str, dict] = {}
    for dev, buf in _rec.buffers.items():
        torch.cuda.synchronize(dev)
        words = buf.cpu().tolist()
        for s, p in paths.items():
            ns, n = words[1 + s], words[1 + N_SLOTS + s]
            if ns or n:
                got = device.setdefault(p, {"count": 0, "self_s": 0.0})
                got["count"] += n
                got["self_s"] += ns * 1e-9
    host = {p: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
            for p, (c, t, s) in _rec.host.items()}
    return {"host": host, "device": device, "counters": dict(_rec.counters)}


def spans_line(snap: dict, steps: int) -> str:
    """The ``[SPANS]`` line of ``snap`` over ``steps`` steps: each device
    section's own ms a step (``not measured`` without a card), then the
    chunk's host ms a step."""
    dev = snap["device"]
    parts = ([f"{p} {1e3 * v['self_s'] / steps:.3f}" for p, v in sorted(dev.items())]
             if dev else ["device sections not measured (no card)"])
    chunk = snap["host"].get("chunk")
    host = (f"chunk {1e3 * chunk['total_s'] / steps:.3f}" if chunk else "chunk not measured")
    return f"[SPANS] ms a step over {steps} steps: " + ", ".join(parts) + f" | host: {host}"


class Trace:
    """A ``torch.profiler`` trace between ``start()`` and ``stop()``, written
    to ``<log_dir>/<name>.pt.trace.json``; ``log_dir`` is the directory of the
    traces (the Runner's ``LOG_DIR/trace``)."""

    def __init__(self, log_dir: str, device: torch.device):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        """End the trace once the card has run what it traced; returns the
        file's path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, time.strftime("%m-%d-%H-%M-%S")
                            + f"_{os.getpid()}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device = torch.device("cuda")) -> Iterator[Trace]:
    """Trace the enclosed steps on ``device`` (``Trace``)."""
    tracer = Trace(log_dir, device)
    tracer.start()
    try:
        yield tracer
    finally:
        tracer.stop()


def busy_us(events: list) -> float:
    """The device's busy time in a Chrome trace's events: the union of its
    kernel, copy and fill intervals (microseconds), so that what two streams
    run at once counts once."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def device_rows(fn: Callable[[], object], n: int, device: torch.device = torch.device("cuda"),
                trace_path: Optional[str] = None) -> Tuple[float, Rows, Optional[float]]:
    """Trace ``n`` calls of ``fn`` with torch.profiler, after three more:
    ``(wall ms, [(name, launches, ms)], busy ms)``. On the card, the
    device-side events alone, since a CPU op (an autograd node, a ctypes
    launch) also carries the device time of the kernels it launched, and the
    device's busy time from the trace (``busy_us``); on the CPU, each op's
    self CPU time and no busy time (there is no device there).
    ``trace_path``: the Chrome trace is written there too."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(3):
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        prof.export_chrome_trace(trace_path)
    if not cuda:
        rows = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
                if e.self_cpu_time_total > 0]
        return wall_ms, rows, None
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    path = trace_path
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            busy_ms = busy_us(json.load(f)["traceEvents"]) / 1e3
    finally:
        if trace_path is None:
            os.remove(path)
    return wall_ms, rows, busy_ms


def print_profile(wall_ms: float, rows: Rows, n: int, what: str = "steps", top: int = 12,
                  on_device: bool = True, busy_ms: Optional[float] = None) -> Optional[dict]:
    """Print ``device_rows``' numbers for ``n`` calls: the device's busy share
    of the wall time (``busy_ms``, the union of its intervals; the sum of the
    rows where it is not given) and the ``top`` kernels by time a call (ms,
    launches, name). Returns ``{"wall_ms", "device_ms", "busy_share",
    "launches"}`` per call, or None where no device time was recorded (a
    CPU run, whose table is the ops' self CPU time, or a profiler that saw
    no device activity)."""
    one = what.rstrip("s")
    if not rows:
        print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time; the profiler "
              "recorded no device time (device busy share not measured)")
        return None
    total = sum(r[2] for r in rows) if busy_ms is None else busy_ms
    if on_device:
        print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time; device busy "
              f"{total:.2f} ms ({100 * total / wall_ms:.1f}%, idle "
              f"{100 * (1 - total / wall_ms):.1f}%); per {one} {total / n:.3f} ms "
              f"on the device in {sum(r[1] for r in rows) / n:.0f} launches")
    else:
        print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time on the CPU (no "
              f"device: busy share not measured); per {one} {total / n:.3f} ms of the "
              "ops' self CPU time")
    for name, calls, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        print(f"  {ms / n:9.3f} ms/{one}  {calls // n:5d}/{one}  {name[:90]}")
    if not on_device:
        return None
    return {"wall_ms": wall_ms / n, "device_ms": total / n, "busy_share": total / wall_ms,
            "launches": sum(r[1] for r in rows) / n}


class Throughput:
    """Windowed rays/s meter. On a card it synchronises before each reading
    of the clock, so a window counts steps the card finished, not steps the
    host queued."""

    def __init__(self, rays_per_step: int, device: Optional[torch.device] = None):
        self.rays_per_step = rays_per_step
        self.device = None if device is None else torch.device(device)
        self.reset()

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def reset(self) -> None:
        self._t0 = self._now()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def rays_per_sec(self) -> float:
        dt = self._now() - self._t0
        if dt <= 0:
            return 0.0
        return self._steps * self.rays_per_step / dt

    def window(self) -> float:
        """Read the meter and reset the window."""
        value = self.rays_per_sec
        self.reset()
        return value
