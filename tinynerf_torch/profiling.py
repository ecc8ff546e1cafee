"""Throughput metering of the training loop.

Counterpart of ``tinynerf/profiling.py::Throughput``: a windowed rays/s
meter over host-loop ticks. The loop does not synchronise with the card at
every step, so a window reads the rate at which steps are queued until the
queue fills, and the card's rate after that; a caller that needs the card's
rate exactly synchronises before reading.
"""

from __future__ import annotations

import time


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
