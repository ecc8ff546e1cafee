"""The ``render`` traffic: whole frames along an orbit of the benchmark's
scene through the program's frame function (``eval.make_frame_fn``, as
``eval.render_path`` calls it; on the card one CUDA graph a view), from
the cell's seeded weights (``configs/<config>.py::init_params``: an opaque
field), and an occupancy grid with every cell occupied.

Set-up builds the frame function and renders the path's first frame (it
warms and captures); the window renders the next frames back to back until
``--seconds`` have passed, each on the host as the function returns it.
After the window the program is freed and the plain reference renders a
sample of the window's frames, drawn from the seed, for the check.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch

from nerfbench import check, harness, scene as scenelib, trace
from nerfbench.reference import precision, render as refrender, train as reftrain

# traced spans a run tries before it reports one whose records were lost
TRACE_ATTEMPTS = 2


def build(cell: harness.Cell, seed: int, dev: torch.device):
    from tinynerf_torch import eval as evallib
    from tinynerf_torch.core import occupancy
    from tinynerf_torch.core.rays import make_k_inv
    ini, spec = cell.ini, cell.traffic["scene"]
    cfg = harness.program_config(ini, seed)
    path = scenelib.orbit(spec, cell.traffic["path_views"])
    h, w, focal = spec["height"], spec["width"], scenelib.focal_of(spec)
    span = float(spec["far"] - spec["near"])
    occ = None
    if cfg.occ_grid:
        cfg.occ_march_steps = occupancy.derive_march_steps(cfg.occ_res, cfg.occ_extent, span)
        occ = occupancy.init_grid(cfg.occ_res, cfg.occ_extent, cfg.occ_thresh, dev)
    module = cell.reference()
    params = module.init_params(ini, torch.Generator(device=dev).manual_seed(
        harness.sub_seed(seed, 3)), dev)
    frame_fn = evallib.make_frame_fn(cfg, make_k_inv(h, w, focal, dev), h, w, occ_grid=occ)
    return frame_fn, params, path, module


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, patch: Optional[str] = None):
    dev = harness.start(device, patch)
    frame_fn, params, path, module = build(cell, seed, dev)
    frame_fn(params, path[0])
    frames = []
    span = None
    if traced:
        def call():
            i = len(frames) + 1
            frames.append((i, frame_fn(params, path[i % len(path)])))

        wall0 = time.time()
        for _ in range(TRACE_ATTEMPTS):
            span = trace.traced(call, cell.traffic["trace_frames"], cuda=dev.type == "cuda")
            if not span.records_lost:
                break
        frames = frames[-cell.traffic["trace_frames"]:]
        elapsed = span.wall_s
    else:
        t0, wall0 = time.perf_counter(), time.time()
        while time.perf_counter() - t0 < seconds:
            i = len(frames) + 1
            frames.append((i, frame_fn(params, path[i % len(path)])))
        elapsed = time.perf_counter() - t0
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rng = np.random.default_rng(harness.sub_seed(seed, 4))
    picks = sorted(rng.choice(len(frames), size=min(cell.traffic["check_frames"], len(frames)),
                              replace=False))
    n_frames = len(frames)
    failed = sum(1 for _, img in frames if not np.all(np.isfinite(img)))
    shown = [frames[k] for k in picks]
    host = {p: t.detach().cpu() for p, t in reftrain.leaves(params)}
    del frame_fn, frames
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    spec = cell.traffic["scene"]
    n_march = refrender.march_steps(cell.ini["OCC_RES"], cell.ini["OCC_EXTENT"],
                                    float(spec["far"] - spec["near"]))
    ref_params = reftrain.tree({p: t.to(dev) for p, t in host.items()})
    refs = [reftrain.render_frame(module, cell.ini, ref_params, path[i % len(path)],
                                  spec["height"], spec["width"], scenelib.focal_of(spec),
                                  n_march, q=precision.fp32, device=dev)
            for i, _ in shown]
    numbers = check.frame_numbers([img for _, img in shown], refs)
    result = {"rank": 0, "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu", "span": span, "mem_peak": mem_peak, "refreshes": 0,
              "forbidden": harness.forbidden_modules()}
    return {"values": {"frame_s": elapsed / max(1, n_frames), "setup_s": wall0 - t_start},
            "results": [result], "numbers": numbers, "attempted": n_frames,
            "failed": failed, "calls": n_frames, "refreshes": 0,
            "forbidden": result["forbidden"]}
