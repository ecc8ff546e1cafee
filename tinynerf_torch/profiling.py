"""Tracing and throughput metering of the training loop.

Counterpart of ``tinynerf/profiling.py``. ``Trace`` (and the context
manager ``trace``) records a ``torch.profiler`` trace of the steps it
brackets (``PROFILE_STEPS``) and writes it as a Chrome trace under
``<log_dir>/trace/``, viewable in Perfetto or ``chrome://tracing``. CUDA
activity is recorded only for a run on the card: on the CPU it asks for CPU
activity alone (the CPU build of torch floods a profiler that asks for CUDA
activity with warnings and takes minutes). ``Throughput`` is a windowed
rays/s meter over host-loop ticks. The loop does not synchronise with the card at
every step, so a window reads the rate at which steps are queued until the
queue fills, and the card's rate after that; a caller that needs the card's
rate exactly synchronises before reading. ``device_rows`` traces a few
calls of a function and returns the time by kernel, and ``print_profile``
prints it with the device's busy share (``tools/profile_step.py`` and
``chip_smoke.py``'s profiles).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List, Optional, Tuple

import torch

Rows = List[Tuple[str, int, float]]


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


def device_rows(fn: Callable[[], object], n: int, device: torch.device = torch.device("cuda"),
                trace_path: Optional[str] = None) -> Tuple[float, Rows]:
    """Trace ``n`` calls of ``fn`` with torch.profiler, after three more:
    ``(wall ms, [(name, launches, ms)])``. On the card, the device-side events
    alone, since a CPU op (an autograd node, a ctypes launch) also carries the
    device time of the kernels it launched; on the CPU, each op's self CPU
    time (there is no device there). ``trace_path``: the Chrome trace is
    written there too."""
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
    if cuda:
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    else:
        rows = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
                if e.self_cpu_time_total > 0]
    return wall_ms, rows


def print_profile(wall_ms: float, rows: Rows, n: int, what: str = "steps", top: int = 12,
                  on_device: bool = True) -> Optional[dict]:
    """Print ``device_rows``' numbers for ``n`` calls: the device's busy share
    of the wall time and the ``top`` kernels by time a call (ms, launches,
    name). Returns ``{"wall_ms", "device_ms", "busy_share", "launches"}`` per
    call, or None where no device time was recorded (a CPU run, whose table
    is the ops' self CPU time, or a profiler that saw no device activity)."""
    one = what.rstrip("s")
    if not rows:
        print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time; the profiler "
              "recorded no device time (device busy share not measured)")
        return None
    total = sum(r[2] for r in rows)
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
    """Windowed rays/s meter."""

    def __init__(self, rays_per_step: int):
        self.rays_per_step = rays_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def rays_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        if dt <= 0:
            return 0.0
        return self._steps * self.rays_per_step / dt

    def window(self) -> float:
        """Read the meter and reset the window."""
        value = self.rays_per_sec
        self.reset()
        return value
