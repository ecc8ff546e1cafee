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
rate exactly synchronises before reading.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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
