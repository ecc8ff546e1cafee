"""The ``train`` traffic: the program's training step on the benchmark's
seeded scene and weights, driven as ``Runner.train`` drives it
(``train.make_train_step`` in a ``train.ChunkedStep``; on the card each
step a CUDA graph replay), one rank or ``ranks`` data-parallel ranks of a
global batch (``MESH_SHAPE``, NCCL, one card each).

Set-up builds the one object and drives its first ``CHECK_STEPS`` steps,
one call a step, reading its state after each (the check's readings); the
same object then runs the window: steps until ``--seconds`` have passed,
at most ``INFLIGHT`` steps queued ahead of the card, then a synchronise.
The ranks agree on the window's last step over a host (gloo) group every
``stop_check_steps`` steps, without a device synchronise. A chunk of one
step is what lets the check read each step's state; its graph is the one
a chunk of any length replays. After the window the program's state is
freed and the plain reference follows the same first steps.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import multiprocessing
import queue
import socket
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as tdist

from nerfbench import check, harness, scene as scenelib, trace
from nerfbench.reference import precision, train as reftrain

CHECK_STEPS = 3
# steps queued ahead of the card in the window: enough that the host's work
# for a step hides behind the card's, few enough that the window's end
# waits for little
INFLIGHT = 4
B1 = 0.9
# traced spans a rank tries before it reports one whose records were lost
TRACE_ATTEMPTS = 3
RANK_TIMEOUT_S = 1500


def _host(tree) -> dict:
    return {p: t.detach().float().cpu().clone() for p, t in reftrain.leaves(tree)}


def _digest(values: dict) -> str:
    h = hashlib.sha256()
    for p in sorted(values):
        h.update(values[p].contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_inputs(cell: harness.Cell, seed: int, dev: torch.device) -> dict:
    """What the benchmark hands both sides: the scene, the weights (on the
    card, and a host copy) and the seed of the program's generator."""
    spec = cell.traffic["scene"]
    images, poses = scenelib.make(spec, harness.sub_seed(seed, 1))
    module = cell.reference()
    params0 = module.init_params(cell.ini, torch.Generator(device=dev).manual_seed(
        harness.sub_seed(seed, 3)), dev)
    return {"module": module, "params_tree": params0, "params0": _host(params0),
            "scene": reftrain.Scene(images, poses, spec["height"], spec["width"],
                                    scenelib.focal_of(spec)),
            "gen_seed": harness.sub_seed(seed, 2)}


def build(cell: harness.Cell, seed: int, dev: torch.device, ranks: int):
    """The program's chunked step and state on the benchmark's inputs:
    ``(chunk, state, inputs)``."""
    from tinynerf_torch import train as trainlib
    from tinynerf_torch.core.occupancy import derive_march_steps
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.data.poses import SceneData
    from tinynerf_torch.data.rays import RayTable
    from tinynerf_torch.parallel import mesh as meshlib
    cfg = harness.program_config(cell.ini, seed, ranks)
    inputs = make_inputs(cell, seed, dev)
    sc = inputs["scene"]
    mesh = meshlib.mesh_for_config(cfg)
    table = RayTable(SceneData(images=sc.images, poses_bounds=sc.poses, height=sc.height,
                               width=sc.width, focal=sc.focal), dev, cfg.pixel_dtype)
    kinv = make_k_inv(sc.height, sc.width, sc.focal, dev)
    if cfg.occ_grid and cfg.occ_march_steps is None:
        cfg.occ_march_steps = derive_march_steps(
            cfg.occ_res, cfg.occ_extent, float(np.max(sc.poses[:, 16] - sc.poses[:, 15])))
    state = trainlib.init_state(
        cfg, dev, params=inputs.pop("params_tree"),
        generator=torch.Generator(device=dev).manual_seed(inputs["gen_seed"]))
    if mesh is not None:
        meshlib.replicate_state(state)
    chunk = trainlib.make_chunked_step(trainlib.make_train_step(cfg, table, kinv, mesh=mesh), 1)
    inputs["every"] = cfg.occ_update_every if cfg.occ_grid else 0
    return chunk, state, inputs


def reference_readings(cell: harness.Cell, inputs: dict, dev, q=precision.fp32,
                       keep: Optional[int] = None, scale: float = 1.0) -> dict:
    """The plain reference's first steps from the benchmark's inputs."""
    params = reftrain.tree({p: t.to(dev) for p, t in inputs["params0"].items()})
    return reftrain.follow(inputs["module"], cell.ini, params, inputs["scene"],
                           inputs["gen_seed"], CHECK_STEPS, q=q, keep=keep, scale=scale,
                           device=dev)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def first_steps(chunk, state, inputs: dict):
    """``CHECK_STEPS`` calls of the window's object, one step each, with
    the program's readings: each step's loss, the first step's gradient
    from Adam's first moment, the change of each leaf after the last step,
    the occupancy grid after the first step."""
    losses, grad, occ = [], None, None
    for k in range(CHECK_STEPS):
        state, metrics = chunk(state)
        losses.append(float(metrics["loss"].reshape(-1)[0]))
        if k == 0:
            grad = {p: t / (1.0 - B1) for p, t in _host(state.opt.mu).items()}
            occ = None if state.occ is None else state.occ.raw.detach().float().cpu().clone()
    after = _host(state.params)
    step = {p: after[p] - inputs["params0"][p] for p in after}
    return state, {"loss": losses, "grad": grad, "step": step, "occ": occ,
                   "digest": _digest(after)}


def _agree(stop: bool, group) -> bool:
    flag = torch.tensor([1 if stop else 0])
    tdist.all_reduce(flag, op=tdist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def window(chunk, state, seconds: float, traffic: dict, dev, group):
    """Steps until ``seconds`` have passed: ``(state, steps, seconds, wall
    start, failed)``; ``failed`` counts steps whose loss is not finite."""
    every = traffic["stop_check_steps"] if group else 1
    losses, queued = [], collections.deque()
    steps = 0
    t0, wall0 = time.perf_counter(), time.time()
    while True:
        state, metrics = chunk(state)
        losses.append(metrics["loss"].reshape(-1))
        steps += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > INFLIGHT:
                queued.popleft().synchronize()
        if steps % every == 0:
            stop = time.perf_counter() - t0 >= seconds
            if group is not None:
                stop = _agree(stop, group)
            if stop:
                break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.cat(losses))).sum())
    return state, steps, elapsed, wall0, failed


def run_rank(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str,
             rank: int = 0, ranks: int = 1, patch: Optional[str] = None) -> dict:
    """One rank's run: set-up, the first steps, the window (or the traced
    span), then the reference and the check."""
    dev = harness.start(device, patch)
    # the host's group, on which the ranks agree when to stop
    group = tdist.new_group(backend="gloo") if ranks > 1 else None
    chunk, state, inputs = build(cell, seed, dev, ranks)
    state, prog = first_steps(chunk, state, inputs)
    if group is not None:
        _sync(dev)
        tdist.barrier(group=group)
    out = {"rank": rank, "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "span": None, "refreshes": 0}
    if traced:
        holder = [state]

        def call():
            holder[0] = chunk(holder[0])[0]

        out["setup_end_wall"] = time.time()
        n = cell.traffic["trace_steps"]
        for attempt in range(TRACE_ATTEMPTS):
            first = CHECK_STEPS + attempt * n
            out["span"] = trace.traced(call, n, rank, cuda=dev.type == "cuda")
            # the ranks trace again together while one has lost records
            lost = out["span"].records_lost
            if not (_agree(lost, group) if group is not None else lost):
                break
        every = inputs["every"]
        out["refreshes"] = sum(1 for it in range(first, first + n) if every and it % every == 0)
        state = holder[0]
        out.update(steps=cell.traffic["trace_steps"], elapsed=out["span"].wall_s, failed=0)
    else:
        state, steps, elapsed, wall0, failed = window(chunk, state, seconds, cell.traffic,
                                                      dev, group)
        out.update(steps=steps, elapsed=elapsed, failed=failed, setup_end_wall=wall0)
    out["mem_peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del chunk, state
    free(dev)
    out["numbers"] = check.train_numbers(prog, reference_readings(cell, inputs, dev),
                                         getattr(inputs["module"], "LEAF_GROUPS", None))
    out["digest"] = prog["digest"]
    out["forbidden"] = harness.forbidden_modules()
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, ranks: int, init: str, cell, seed, seconds, traced, device,
                patch, results) -> None:
    from tinynerf_torch.parallel import distributed as pdist
    try:
        pdist.maybe_initialize(init, ranks, rank, device=device)
        results.put(run_rank(cell, seed, seconds, traced, device, rank, ranks, patch))
    except Exception:
        results.put({"rank": rank, "error": traceback.format_exc()})
    finally:
        pdist.shutdown()


def spawn_ranks(cell, seed, seconds, traced, device, ranks, patch) -> List[dict]:
    """``ranks`` processes of one job over ``tcp://127.0.0.1``, one card each
    (NCCL; gloo on the CPU); their results in rank order. Every process is
    joined, or ended, before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry, args=(r, ranks, init, cell, seed, seconds, traced,
                                                   device, patch, results))
             for r in range(ranks)]
    for p in procs:
        p.start()
    got, deadline = {}, time.time() + RANK_TIMEOUT_S
    try:
        while len(got) < ranks and time.time() < deadline:
            try:
                r = results.get(timeout=2)
                got[r["rank"]] = r
                if "error" in r:
                    break
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(2)
                    while not results.empty():
                        r = results.get()
                        got[r["rank"]] = r
                    break
    finally:
        for p in procs:
            p.join(timeout=60 if len(got) == ranks else 5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
    errors = [r["error"] for r in got.values() if "error" in r]
    if errors or len(got) < ranks:
        raise RuntimeError("a rank failed:\n" + ("\n".join(errors) or
                                                 f"{ranks - len(got)} rank(s) gave no result"))
    return [got[r] for r in range(ranks)]


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, patch: Optional[str] = None):
    """The cell's run: ``(values, device, numbers, extra)`` for ``run.py``."""
    ranks = cell.traffic["ranks"]
    if ranks == 1:
        results = [run_rank(cell, seed, seconds, traced, device, patch=patch)]
    else:
        results = spawn_ranks(cell, seed, seconds, traced, device, ranks, patch)
    numbers = check.worst([r["numbers"] for r in results])
    if ranks > 1:
        numbers["rank_mismatch"] = float(sum(r["digest"] != results[0]["digest"]
                                             for r in results))
    steps = results[0]["steps"]
    elapsed = max(r["elapsed"] for r in results)
    values = {"train_rays_per_s": steps * cell.ini["BATCH_RAY"] / elapsed,
              "setup_s": max(r["setup_end_wall"] for r in results) - t_start}
    return {"values": values, "results": results, "numbers": numbers,
            "attempted": steps, "failed": max(r["failed"] for r in results),
            "calls": steps, "refreshes": results[0]["refreshes"],
            "forbidden": sorted(set().union(*[r["forbidden"] for r in results]))}
