"""Torch's CPU threads for the port's test modules under pytest-xdist.

Each xdist worker is a process of its own, and torch gives each one an
intra-op pool as wide as the machine. With several workers the pools
oversubscribe the cores, and torch's OpenMP barriers then wait on threads
that are not running: a step that takes seconds alone took minutes beside
busy workers. ``torch_threads`` gives each module's tests the worker's
share of the cores (all of them outside xdist) and restores the pool after.
Values do not depend on it beyond the summation order of a reduction,
which every bound in these tests leaves room for.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
