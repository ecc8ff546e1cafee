"""CUDA graphs: the port's counterpart of the JAX package's compiled
multi-step and whole-frame programs.

The JAX package trains in scan-fused chunks (``tinynerf/train.py:481-533``)
and renders a view as one program (``tinynerf/eval.py:25-48``), so the host
dispatches once a chunk or a frame. Here a step's, or a group of frame
chunks', launches are captured into a CUDA graph once and replayed: one
call from the host for the whole sequence of launches.

- ``warm`` runs a body once eagerly on a side stream, as PyTorch's recipe
  for graphed training does before a capture: it builds and loads the
  kernel libraries the body launches (``kernels/build.py``) and fills the
  per-device caches (the frequency tables, the C entries' launch set-up),
  so that nothing of it happens inside the capture. The warm-up is real
  work, a step of the chunk or the first frame group, not a throw-away.
- ``capture`` records a body into a graph under ``capture_error_mode =
  "global"``, or ``"thread_local"`` where the body holds NCCL collectives:
  the process group's watchdog thread queries the events of earlier
  collectives while a capture runs, and under ``"global"`` that call from
  another thread invalidates the capture; ``"thread_local"`` checks only
  the capturing thread's calls. A capture error raises; nothing falls back
  to eager calls.
  The wrapper calls made while capturing launched nothing, so their counts
  are taken back, and each replay adds them (``Captured.replay``). The
  graph is kept past its capture (``torch.cuda.CUDAGraph(keep_graph=True)``)
  to count its nodes (``cuGraphGetNodes``; the device stopwatch's marks
  left out), then instantiated; the capture's counters go to
  ``profiling`` (captures, seconds, pool bytes).
- ``StepGraphs`` is a chunk of training steps on the card
  (``train.ChunkedStep``): the state's tensors are the graphs' static
  buffers, updated in place; Adam's scalars of the chunk are one table on
  the device and a device cursor picks each step's row; the losses land in
  a ``(unroll,)`` buffer and the last step's preview fields in static
  buffers. The occupancy refresh is decided on the host: a plain step graph
  and a refresh step graph, each captured at its first use. The state's
  generator is registered with each graph, so a replay draws what the
  eager step would have drawn and advances the generator as far. A call's
  host time is in ``profiling``'s spans ``chunk.load`` (the static buffers
  and the rate table's copy), ``chunk.replay`` (the replays, with any
  warm-up and capture) and ``chunk.metrics``; a step's body opens the
  device stopwatch (``profiling.section``) and writes the state back under
  ``step.writeback``, and its node count is the counter
  ``graph.nodes.step`` (``graph.nodes.step_refresh`` for the refresh
  step's graph).

Under a mesh over NCCL (``parallel/``) each rank captures its own graphs of
its share of the step: the gradient's all-reduce in each, the refresh's
gather in the refresh graph. Every rank decides the same refresh at the
same iteration, so the ranks capture, and then replay, the same sequence of
collectives; the warm-up step before each capture creates the
communicators. Under gloo the collectives copy through the host, which a
graph cannot hold: a chunk there is a host loop (``train.graphs_take``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional

import torch

from tinynerf_torch import optim, profiling
from tinynerf_torch.kernels import wrappers
from tinynerf_torch.parallel import distributed as dist


@dataclasses.dataclass
class Captured:
    """A captured graph and what its capture measured: the kernel launches a
    replay makes, by wrapper; the capture's seconds; the bytes its memory
    pool added to what the caching allocator holds; its nodes, the device
    stopwatch's marks left out."""
    graph: torch.cuda.CUDAGraph
    launches: Dict[str, int]
    seconds: float
    pool_bytes: int
    nodes: int
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        counted = wrappers()
        for name, n in self.launches.items():
            counted[name].launches += n
        self.replays += 1


def warm(body: Callable[[], object], device: torch.device):
    """``body()`` once, eagerly, on a side stream that waits for the current
    one and that the current one then waits for; returns what it returns."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = body()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _instantiated_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a kept graph, which is then instantiated."""
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    graph.instantiate()
    return n.value


def capture(body: Callable[[], object], device: torch.device, pool=None,
            generators: List[torch.Generator] = (), collectives: bool = False) -> Captured:
    """``body()`` captured into a CUDA graph (in ``pool``, another graph's
    memory pool, where given), with ``generators`` registered so that a
    replay advances them as the eager body would. ``collectives``: the body
    calls NCCL collectives, captured in ``"thread_local"`` mode (module
    docstring)."""
    counted = wrappers()
    before = {name: fn.launches for name, fn in counted.items()}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)    # kept to count its nodes
    for gen in generators:
        graph.register_generator_state(gen)
    marks = profiling.marks_launched()
    t0 = time.perf_counter()
    try:
        mode = "thread_local" if collectives else "global"
        with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
            body()
    finally:
        launches = {name: fn.launches - before[name] for name, fn in counted.items()}
        for name, fn in counted.items():
            fn.launches = before[name]
    nodes = _instantiated_nodes(graph) - (profiling.marks_launched() - marks)
    seconds = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    profiling.count("graph.captures")
    profiling.count("graph.capture_s", seconds)
    profiling.count("graph.pool_bytes", pool_bytes)
    return Captured(graph, {k: n for k, n in launches.items() if n}, seconds, pool_bytes,
                    nodes)


def _trained_tensors(state) -> List[torch.Tensor]:
    """What a step updates, in a fixed order: the params, Adam's moments."""
    return (optim.leaves(state.params) + optim.leaves(state.opt.mu)
            + optim.leaves(state.opt.nu))


def _state_tensors(state) -> List[torch.Tensor]:
    """A train state's tensors: ``_trained_tensors``, then the occupancy
    grid's."""
    return _trained_tensors(state) + ([] if state.occ is None else list(state.occ))


def _signature(state) -> list:
    return [(tuple(t.shape), t.dtype, t.device) for t in _state_tensors(state)]


class StepGraphs:
    """The card's form of ``train.ChunkedStep``: ``unroll`` steps of
    ``step_fn`` a call, each a graph replay (module docstring). Its
    ``stats`` count its captures, their seconds and pool bytes, the warm-up
    steps and the replays (``profiling``'s ``graph.*`` counters are the
    process's, over every capture, a frame's too)."""

    def __init__(self, step_fn: Callable, unroll: int):
        mesh = step_fn.mesh
        if mesh is not None and not dist.captures(mesh.data):
            raise ValueError(
                "a step under a mesh over gloo is not graphed: gloo's collectives copy "
                "through the host, which a CUDA graph cannot capture, so its chunks run "
                "as a host loop (train.graphs_take); several ranks on one card under gloo "
                "are a test set-up, a job graphs its steps over NCCL, one rank a card")
        # the step holds collectives where its data group has other ranks
        self.collectives = mesh is not None and dist.world_size(mesh.data) > 1
        self.step_fn, self.unroll, self.cfg = step_fn, unroll, step_fn.cfg
        self.static = None       # the TrainState whose tensors the graphs read and write
        self.graphs: Dict[bool, Captured] = {}   # by refresh step
        self.stats = {"captures": 0, "capture_s": 0.0, "pool_bytes": 0,
                      "warm_steps": 0, "replays": 0}

    def _adopt(self, state) -> None:
        """Take ``state``'s tensors as the static buffers (new graphs follow)."""
        import tinynerf_torch.train as trainlib
        device = state.generator.device
        self.static = trainlib.TrainState(
            params=state.params, opt=optim.AdamState(state.opt.count, state.opt.mu,
                                                     state.opt.nu),
            iteration=state.iteration, generator=state.generator, occ=state.occ)
        self.signature = _signature(state)
        self.graphs, self.pool = {}, None
        n = len(optim.leaves(state.params))
        self.rates = torch.zeros((self.unroll, n + 2), dtype=torch.float32, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.losses = torch.zeros(self.unroll, dtype=torch.float32, device=device)
        self.idx = (torch.zeros((self.unroll, self.cfg.batch_ray), dtype=torch.int64,
                                device=device) if self.step_fn.indexed else None)
        self.last = None

    def _load(self, state) -> None:
        """Make the static buffers hold ``state``: adopt it where the shapes
        changed (a ``GRID_UPSAMPLE`` milestone, a first call), else copy
        the tensors and the generator's state that are not already them."""
        if self.static is None or _signature(state) != self.signature:
            self._adopt(state)
            return
        for dst, src in zip(_state_tensors(self.static), _state_tensors(state)):
            if dst is not src:
                dst.copy_(src)
        if state.generator is not self.static.generator:
            self.static.generator.set_state(state.generator.get_state())

    def _body(self, refresh: bool) -> None:
        """One step from the static buffers back into them, at the cursor's
        row of the chunk; the cursor then moves on. The device stopwatch
        runs from the row's read to the cursor's move (``profiling``)."""
        st = self.static
        with profiling.section("step", st.generator.device):
            rates = self.rates.index_select(0, self.cursor)[0]
            if self.step_fn.indexed:
                new, metrics = self.step_fn(st, self.idx.index_select(0, self.cursor)[0],
                                            rates=rates, refresh=refresh)
            else:
                new, metrics = self.step_fn(st, rates=rates, refresh=refresh)
            with profiling.section("step.writeback"):
                torch._foreach_copy_(_trained_tensors(st), _trained_tensors(new))
                if refresh:
                    st.occ.raw.copy_(new.occ.raw)
                    st.occ.density.copy_(new.occ.density)
                self.losses.index_copy_(0, self.cursor, metrics["loss"].reshape(1))
                if self.last is None:
                    from tinynerf_torch.train import LAST_STEP_FIELDS
                    self.last = {f: torch.empty_like(metrics[f]) for f in LAST_STEP_FIELDS}
                for f, buf in self.last.items():
                    buf.copy_(metrics[f])
                self.cursor.add_(1)

    def __call__(self, state, rates: torch.Tensor, lrs: torch.Tensor,
                 idx: Optional[torch.Tensor] = None):
        import tinynerf_torch.train as trainlib
        with profiling.span("chunk.load"):
            self._load(state)
            self.rates.copy_(rates.pin_memory(), non_blocking=True)
            self.cursor.zero_()
            if idx is not None:
                self.idx.copy_(idx)
        st, device = self.static, state.generator.device
        every = self.cfg.occ_update_every
        with profiling.span("chunk.replay"):
            for k in range(self.unroll):
                refresh = st.occ is not None and (state.iteration + k) % every == 0
                graph = self.graphs.get(refresh)
                if graph is not None:
                    graph.replay()
                    self.stats["replays"] += 1
                    continue
                body = functools.partial(self._body, refresh)
                warm(body, device)
                graph = capture(body, device, self.pool, [st.generator], self.collectives)
                self.pool = self.pool or graph.graph.pool()
                self.graphs[refresh] = graph
                self.stats["warm_steps"] += 1
                self.stats["captures"] += 1
                self.stats["capture_s"] += graph.seconds
                self.stats["pool_bytes"] += graph.pool_bytes
                profiling.gauge("graph.nodes.step_refresh" if refresh else "graph.nodes.step",
                                graph.nodes)
        new = trainlib.TrainState(
            params=st.params, opt=optim.AdamState(state.opt.count + self.unroll,
                                                  st.opt.mu, st.opt.nu),
            iteration=state.iteration + self.unroll, generator=st.generator, occ=st.occ)
        with profiling.span("chunk.metrics"):
            metrics = {"loss": self.losses.clone(), "lr": lrs,
                       **{f: buf.clone() for f, buf in self.last.items()}}
        return new, metrics
