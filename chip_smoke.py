#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tinynerf_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It

1. prints the card (name, count, and ``nvidia-smi``'s name and power limit);
2. builds every CUDA kernel from ``tinynerf_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints each build's time and ``ptxas``'
   register/shared-memory report;
3. holds each kernel form against its plain PyTorch version on the card, on
   dyadic inputs at the main paths' shapes (tolerances below): the field
   forward (kernel 1) at the render chunk's B=4096, and the field's
   recompute backward (kernel 2) at the training step's B=400 and at
   B=4096, N=64 and 128, every gradient within 1e-4 of max|plain|; the flat
   field forward (kernel 3) at fp32 and bf16 at one grid refresh's R=32,768
   probes, at R=65,536 and at a ragged R; kernels 1 and 2 in their bf16 form
   at B=4096, N=64 and 128 (bf16 bounds below);
4. times each kernel form and its plain version with CUDA events, beside
   the kernel's bound (the least time the card could take for the same
   work: float32 FLOPs at the FMA rate, bf16 ones at the tensor cores'
   rate; the f32 FMA bound is printed for the bf16 forms too);
5. drives the training path: ``conf/lego.ini`` at full width from fresh
   seeded weights on an in-memory Blender-style scene of 4 views of
   800x800 (lego has 100 training views: cut to 4), ``Runner.train()`` for
   200 steps (below ``STEP``, so that no preview JPG is written and
   imageio is not needed). Checks 2 forward and 2 backward kernel launches
   per step, a finite loss on every step and a falling loss; times steps
   at ``BATCH_RAY`` 400 and 4096 (s/step, rays/s, the kernels' share);
   traces five steps at 400 with ``torch.profiler`` (device time by
   kernel, the device's busy share of the steps' wall time); holds one
   step's gradient through the kernels against the plain field's on a
   field with content (cosine >= 0.9999); saves the trained state with
   ``ckpt.save_checkpoint``;
6. drives the render path from that checkpoint: ``Runner`` resumes it and
   renders two 800x800 views at 64 + 128 samples through
   ``eval.render_test_set``; checks the forward kernel's launch count, that
   the frames are finite and in [0, 1], and that a chunk rendered through
   the kernel agrees with the same chunk through the plain field;
7. drives the ``conf/lego_occ.ini`` training path (bf16, 4096 rays, the
   occupancy grid with a partial refresh every 256 steps, white
   background) on the same kind of scene: ``Runner.train()`` for 300 steps
   (two calls, 256 + 44, so that the grid after each refresh is read).
   Checks exactly 2 flat-kernel launches (the refreshes at 0 and 256), 2
   forward and 2 backward field launches per step, a finite falling loss;
   prints the share of cells probed and occupied after each refresh,
   s/step and rays/s, the refresh's own time, a ``torch.profiler``
   breakdown of five steps; holds one step's gradient through the bf16
   kernels against the bf16 plain field's (cosine >= 0.999); saves the
   trained state with its grid;
8. drives the ``lego_occ`` render path from that checkpoint: ``Runner``
   resumes params and grid and renders two 800x800 views with the grid;
   checks the launch counts, the frames, and a real chunk rendered through
   the bf16 kernels against the bf16 plain field; times the grid's march
   (``tighten_bounds``) on one chunk;
9. drives ``conf/lego_occ.ini`` at ``PRECISION=fp32``, cut to 10 steps
   (one refresh, at iteration 0): the fp32 form of kernel 3 on a training
   path; checks the launch counts and a finite loss;
10. drives ``conf/lego_grid.ini`` with ``GRID_PALLAS`` (the CP grid field at
   R = 256, 64 + 64 components, decoder width 128; the proposal grid at R =
   64, 16 + 16, width 16; bf16, 4096 rays, 64 + 128 samples, the occupancy
   grid, WHITE_BKGD, GRID_LR_MULT 20, GRID_TV 0.1) from fresh seeded
   weights on the same kind of scene: ``Runner.train()`` for 300 steps (256
   + 44). Checks exactly 600 forward and 600 backward grid-kernel launches
   (one of each per grid per step), no MLP kernel launch (the refreshes at
   0 and 256 run the plain point field, as in the JAX package), a finite
   falling loss; prints s/step, rays/s and a profile of five steps; holds
   one step's gradient through kernels 5 and 6 against the plain versions
   (``grid_rays_reference``) on a grid with content, cosine >= 0.999 for
   each of the net's and the proposal's lines and decoder; saves the state;
11. renders two 800x800 views from that checkpoint with the grid: exactly
   2 x 157 x 2 forward launches, finite frames in [0, 1], a chunk through
   the kernels against the plain versions (1e-3 per pixel), s/frame and a
   profile of rendered chunks;
12. drives ``lego_grid`` at ``PRECISION=fp32`` for 10 steps (the fp32 forms
   of kernels 5 and 6 on a path) and ``conf/lego_fast.ini`` with
   ``GRID_PALLAS`` for 10 steps (the MLP fine field through kernels 1-2,
   the proposal grid through kernels 5-6, the refresh at 0 through kernel
   3), checking the launch counts and finite losses;
13. drives ``conf/lego_prop.ini`` with ``PROP_FIELD = mlp`` and
   ``PROP_PALLAS`` (the 8x256 MLP at bf16 with ``USE_PALLAS``; the proposal
   MLP, 128 x 4 at ``PROPOSAL_ENC_L`` 10, 57,932 params; 4096 rays, 64 + 128
   samples, no occupancy grid) from fresh seeded weights: ``Runner.train()``
   for 100 steps. Checks one launch of each of kernels 1, 2, 7 and 8 a step
   (and none of 3, 5, 6), a finite falling loss; prints s/step, rays/s and
   a profile of five steps; holds one step's gradient through the kernels
   against the plain versions (``field_flat_plain``, ``prop_rays_reference``)
   on fields with content, cosine >= 0.999 for the net and for the proposal;
   saves the state;
14. renders two 800x800 views from that checkpoint: one launch of kernel 7
   and one of kernel 1 a chunk, finite frames in [0, 1], a chunk through the
   kernels against the plain versions (1e-3 per pixel), s/frame and a
   profile of rendered chunks;
15. drives ``lego_prop`` at ``PRECISION=fp32`` for 10 steps (the fp32 forms
   of kernels 7 and 8 on a path), checking the launch counts and finite
   losses;
16. prints one ``{"kernels": [...]}`` line (every kernel form) and, last,
   one ``{"ok": true, "device": {...}}`` line.

Kernels 5 and 6 (``csrc/grid_rays_fwd.cu``, ``csrc/grid_rays_bwd.cu``) are
held against their plain versions in phase 3 (fp32 and bf16, at B = 4096
with the fine grid at N = 128 and the proposal grid at N = 64, at ragged
shapes and on grid nodes and the clip boundary; the backward bit-identical
across two launches) and timed in phase 4 beside both bounds (the gather
form's FLOPs and the bytes) and the TPU kernel's own hat-form FLOP count.
Kernels 7 and 8 (``csrc/prop_rays_fwd.cu``, ``csrc/prop_rays_bwd.cu``) are
held against their plain versions in phase 3 (fp32 and bf16, at 128 x 4 with
B = 4096, N = 64, at a ragged B = 1001 and at 64 x 3; fp32 forward within
1e-5, backward within 1e-4 of max|plain| with rows near a kink given no
cotangent; bf16 within 1e-2 and 3e-2 of max|plain| and cosine >= 0.999;
the backward bit-identical across two launches) and timed in phase 4 at
128 x 4, B = 4096, N = 64 beside both bounds.


Any failure raises, and the script exits non-zero without the last line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. It
imports nothing of JAX or of the ``tinynerf`` package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet; at the 700 W limit)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12        # HBM3
COLOR_ATOL = 1e-5
SIGMA_ATOL = 1e-4
SIGMA_RTOL = 1e-4
CHUNK_ATOL = 1e-4           # rendered pixels, kernel field vs plain field
BWD_RTOL = 1e-4             # kernel 2: every gradient, error / max|plain|
MARGIN = 2e-6               # rows this close to a ReLU's kink get no cotangent
GRAD_COS = 0.9999           # a training step's gradient, kernels vs plain field
# bf16 forms: kernel and plain version round at the same points and sum in
# other orders, which can move a rounded activation by one bf16 ulp (2^-8)
BF16_FWD_RTOL = 1e-2        # each output, error / max|plain|
BF16_BWD_RTOL = 3e-2        # each gradient, error / max|plain|
BF16_COS = 0.999            # each gradient tensor; and a bf16 step's gradient
BF16_CHUNK_ATOL = 1e-3      # rendered pixels, bf16 kernels vs bf16 plain field
TRAIN_STEPS = 200
TRAIN_VIEWS = 4
STEP_SHAPES = ((400, 64), (400, 128))    # the field calls of a lego step
OCC_STEPS = 300             # lego_occ: refreshes at iterations 0 and 256
OCC_FP32_STEPS = 10         # lego_occ at fp32: one refresh, at iteration 0
OCC_SHAPES = ((4096, 64), (4096, 128))   # the field calls of a lego_occ step
FLAT_ROWS = (32768, 65536, 32768 + 37)   # one refresh's probes; a chunk; ragged
GRID = {"fine": (256, 64, 64, 128),      # lego_grid's fine grid: R, Fd, Fa, width
        "prop": (64, 16, 16, 16)}        # its proposal grid (the config defaults)
GRID_SHAPES = (("fine", 4096, 128), ("prop", 4096, 64))   # a lego_grid step's calls
GRID_CHECKS = GRID_SHAPES + (("fine", 1001, 128), ("prop", 37, 5), ("fine", "nodes", 8))
GRID_MARGIN = 1e-5          # rows this close to a ReLU kink or sigma = 0: no cotangent
GRID_STEPS = 300            # lego_grid: refreshes at iterations 0 and 256
GRID_FP32_STEPS = 10        # lego_grid at fp32
FAST_STEPS = 10             # lego_fast with GRID_PALLAS
PROP_NETS = {"128x4": (128, 4),          # lego_prop's proposal MLP: width, depth
             "64x3": (64, 3)}            # a narrower one (the kernels take any such)
PROP_SHAPE = (4096, 64)                  # a lego_prop step's proposal call
PROP_CHECKS = (("128x4", 4096, 64), ("128x4", 1001, 64), ("64x3", 4096, 64))
PROP_STEPS = 100            # lego_prop with PROP_FIELD = mlp and PROP_PALLAS
PROP_FP32_STEPS = 10        # the same at fp32


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dyadic_rays(rng, n_rays: int, n_samples: int):
    """Coordinates quantized to 1/16, so o + t*d is exact in float32."""
    import numpy as np
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (n_rays, 3))).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (n_rays, n_samples))), axis=1)
    return origins, dirs, ts.astype(np.float32)


def field_errors(kernel_out, plain_out):
    """(max |color err|, max |sigma err|, sigma within atol + rtol|ref|,
    all |color err| and |sigma err| flattened)."""
    import torch
    (r, g, b), s = kernel_out
    (rp, gp, bp), sp = plain_out
    ce = torch.stack([r - rp, g - gp, b - bp]).abs().flatten()
    se = (s - sp).abs().flatten()
    sigma_ok = bool(torch.all(se <= SIGMA_ATOL + SIGMA_RTOL * sp.abs().flatten()))
    return float(ce.max()), float(se.max()), sigma_ok, ce, se


def bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|)} over every output of
    field_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        out[name] = (err, err / max(float(b.abs().max()), 1e-30))
    return out


def bwd_cosines(kernel, plain):
    """The smallest cosine, over every output of field_rays_bwd, between the
    kernel's tensor and the plain version's."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")] + list(zip(k_rest, p_rest))
    return min(float(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0)) for a, b in pairs)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def flat_grads(grads):
    import torch
    return torch.cat([grads[n][k].flatten() for n in grads for k in ("w", "b")])


def least_ms(flops: float, n_bytes: float, precision: str):
    """(bound ms, bound_by): the least time for ``flops`` at the peak rate of
    their type and ``n_bytes`` at the memory rate."""
    peak = PEAK_BF16_FLOPS if precision == "bf16" else PEAK_F32_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * n_bytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def grid_probes(rng, rows: int):
    """Points in the occupancy grid's cube [-1.5, 1.5]^3 with direction +z,
    as the grid refresh probes the field."""
    import numpy as np
    pts = rng.uniform(-1.5, 1.5, (rows, 3)).astype(np.float32)
    return pts, np.broadcast_to(np.float32([0, 0, 1]), (rows, 3)).copy()


def grid_shares(grid):
    """(share of cells probed at least once, share of cells occupied)."""
    import torch
    return (float(torch.isfinite(grid.raw).float().mean()),
            float((grid.density > grid.threshold).float().mean()))


def profile_steps(step, state, n: int = 5) -> None:
    """Trace ``n`` training steps with torch.profiler; print the device time
    by kernel (top 12) and the device's busy share of the steps' wall time."""
    def run():
        nonlocal state
        state, _ = step(state)
    profile_calls(run, n, "steps")


def profile_calls(fn, n: int, what: str) -> None:
    """Trace ``n`` calls of ``fn`` with torch.profiler (after three more to
    warm up); print the device time by kernel (top 12) and the device's busy
    share of the calls' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op (an autograd node, a ctypes launch)
    # also carries the device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time; the profiler "
              "recorded no device time (device busy share not measured)")
        return
    device_ms = sum(r[2] for r in rows)
    one = what.rstrip("s")
    print(f"profile: {n} {what} in {wall_ms:.2f} ms of wall time; device busy "
          f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - device_ms / wall_ms):.1f}%); per {one} {device_ms / n:.3f} ms "
          f"on the device in {sum(r[1] for r in rows) / n:.0f} launches")
    for name, calls, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {ms / n:9.3f} ms/{one}  {calls // n:5d}/{one}  {name[:90]}")


def grid_with_content(geometry: str, device, seed: int):
    """A grid field at ``GRID[geometry]`` from a seed, its density columns
    scaled by 3 (sigma by 27: a field with content)."""
    import torch
    from tinynerf_torch.core import gridfield
    res, nd, na, width = GRID[geometry]
    params = gridfield.init_grid_field(torch.Generator().manual_seed(seed), res=res,
                                       n_density=nd, n_app=na, decoder_width=width,
                                       device=device)
    return scale_density(params, nd)


def scale_density(params, n_density: int):
    """A copy of a grid field with its density columns scaled by 3."""
    import torch
    out = {"lines": {ax: t.clone() for ax, t in params["lines"].items()},
           "decoder": params["decoder"], "extent": params["extent"]}
    with torch.no_grad():
        for t in out["lines"].values():
            t[:, :n_density] *= 3.0
    return out


def grid_rays_at(rng, B, N):
    """Dyadic rays through the grid's cube [-1.5, 1.5]^3 and out of it
    (clipped points); ``B = "nodes"``: axis-aligned rays whose samples sit on
    the fine grid's nodes 85 and 170 (+-0.5), on the clip boundary and
    outside it."""
    import numpy as np
    if B == "nodes":
        o = np.float32([[-2.0, 0.5, 0.5], [0.5, -2.0, -0.5], [-0.5, 0.5, -2.0],
                        [-2.0, 1.5, -1.5]])
        d = np.float32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]])
        t = np.float32([0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.5, 3.75])[:N]
        return o, d, np.tile(t, (len(o), 1))
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(0.0, 2.5, (B, N))), axis=1)
    return origins, dirs, ts.astype(np.float32)


def grid_bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|, cosine)} over every
    output of grid_rays_bwd."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"lines.{ax}", kg["lines"][ax], pg["lines"][ax]) for ax in "xyz"]
    pairs += [(f"{n}.{k}", kg["decoder"][n][k], pg["decoder"][n][k])
              for n in ("hidden", "color") for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts", "d_de"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        out[name] = (err, err / max(float(b.abs().max()), 1e-30), cos)
    return out


def grid_part_cosines(grads_a, grads_b):
    """{part: cosine} for the lines and decoder of the net and the proposal."""
    import torch
    from tinynerf_torch import optim
    flat = lambda tree: torch.cat([t.flatten().double() for t in optim.leaves(tree)])
    out = {}
    for part in ("net", "prop"):
        for key in ("lines", "decoder"):
            a, b = flat(grads_a[part][key]), flat(grads_b[part][key])
            out[f"{part}.{key}"] = float(a @ b / (a.norm() * b.norm()))
    return out


def prop_bwd_errors(kernel, plain):
    """{output: (max |err|, max |err| / max |plain|, cosine)} over every
    output of prop_rays_bwd."""
    import torch
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    out = {}
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        out[name] = (err, err / max(float(b.abs().max()), 1e-30), cos)
    return out


def part_cosines(grads_a, grads_b):
    """{part: cosine} of the flattened gradients of the net and the proposal."""
    import torch
    from tinynerf_torch import optim
    flat = lambda tree: torch.cat([t.flatten().double() for t in optim.leaves(tree)])
    out = {}
    for part in ("net", "prop"):
        a, b = flat(grads_a[part]), flat(grads_b[part])
        out[part] = float(a @ b / (a.norm() * b.norm()))
    return out


def reference_prop_field(precision: str):
    """A proposal field whose ``eval_rays`` is ``prop_rays_reference`` (the
    plain versions both ways): what a step or a chunk through kernels 7 and
    8 is held against. The renderer calls only ``eval_rays``."""
    from tinynerf_torch.kernels import proposal_kernel as pk
    fn = functools.partial(pk.prop_flat, precision=precision)
    fn.eval_rays = functools.partial(pk.prop_rays_reference, precision=precision)
    return fn


def reference_grid_fields(cfg):
    """The net's and the proposal's grid fields with the plain versions
    (``grid_rays_reference``) as ``eval_rays``: what a step or a chunk
    through kernels 5 and 6 is held against."""
    from tinynerf_torch.core import gridfield
    from tinynerf_torch.kernels import grid_kernel as gk
    fields = []
    for nd in (cfg.grid_comp_density, cfg.prop_grid_comp_density):
        fn = functools.partial(gridfield.apply_grid_field, n_density=nd,
                               precision=cfg.precision)
        fn.eval_rays = functools.partial(gk.grid_rays_reference, n_density=nd,
                                         precision=cfg.precision)
        fields.append(fn)
    return fields


def run_config(conf: str, tmp: str, tag: str, steps: int, **overrides):
    """A Config from ``conf/<conf>.ini`` writing under ``tmp``, trained to
    ``steps`` below STEP (no preview JPG), with ``overrides``."""
    from tinynerf_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "conf", f"{conf}.ini"))
    cfg.ckpt_path = os.path.join(tmp, f"{tag}_ckpt")
    cfg.results_path = os.path.join(tmp, f"{tag}_results")
    cfg.log_dir = os.path.join(tmp, f"{tag}_runs")
    cfg.continue_ = False
    cfg.total_iter = steps
    cfg.step = 10 * steps
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def logged_losses(runner):
    with open(runner.logger.path) as f:
        return [json.loads(line)["loss/train"] for line in f]


def blender_scene(n_views: int, hw: int, seed: int):
    """An in-memory Blender-style scene: cameras on a radius-4 circle looking
    at the origin, lego's field of view, near/far 2/6, smooth random images."""
    import numpy as np
    from tinynerf_torch.data.poses import SceneData
    rng = np.random.default_rng(seed)
    focal = 0.5 * hw / np.tan(0.5 * 0.6911112070083618)
    rows = np.zeros((n_views, 17))
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views + 0.3
        pos = 4.0 * np.array([np.sin(theta), 0.5, np.cos(theta)])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.stack([right, up, back, pos], axis=1)
        hwf = np.array([[hw], [hw], [focal]])
        rows[i] = np.concatenate([np.concatenate([c2w, hwf], 1).ravel(), [2.0, 6.0]])
    base = rng.uniform(0.0, 1.0, (n_views, 8, 8, 3))
    images = np.kron(base, np.ones((1, hw // 8, hw // 8, 1))).astype(np.float32)
    return SceneData(images=images, poses_bounds=rows, height=hw, width=hw,
                     focal=float(focal))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from tinynerf_torch import ckpt, eval as evallib, optim, train
    from tinynerf_torch.config import load_config
    from tinynerf_torch.core import gridfield, mlp, occupancy, rays as raylib, render, sampling
    from tinynerf_torch.kernels import build
    from tinynerf_torch.core import proposal
    from tinynerf_torch.kernels import grid_kernel as gk
    from tinynerf_torch.kernels import mlp_kernel as mk
    from tinynerf_torch.kernels import proposal_kernel as pk
    from tinynerf_torch.runner import Runner

    # ---- 1. device ----
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {kind}; count {count}")
    print(smi)  # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mlp.check_no_tf32()
    dev = torch.device("cuda:0")

    # ---- 2. build ----
    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {', '.join(sorted(build.build_log))} in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    smem = {mk.FWD_SOURCE: mk._library(mk.FWD_SOURCE).field_rays_fwd_smem_bytes(),
            mk.BWD_SOURCE: mk._library(mk.BWD_SOURCE).field_rays_bwd_smem_bytes(),
            mk.FLAT_SOURCE: mk._library(mk.FLAT_SOURCE).field_flat_fwd_smem_bytes()}
    for geometry, dims in GRID.items():
        smem[f"{gk.FWD_SOURCE} {geometry}"] = gk._library(gk.FWD_SOURCE).grid_rays_fwd_smem_bytes(*dims)
        smem[f"{gk.BWD_SOURCE} {geometry}"] = gk._library(gk.BWD_SOURCE).grid_rays_bwd_smem_bytes(*dims)
    smem[pk.FWD_SOURCE] = pk._library(pk.FWD_SOURCE).prop_rays_fwd_smem_bytes()
    for net, (width, _) in PROP_NETS.items():
        smem[f"{pk.BWD_SOURCE} {net}"] = pk._library(pk.BWD_SOURCE).prop_rays_bwd_smem_bytes(width)
    for source in (mk.FWD_SOURCE, mk.BWD_SOURCE, mk.FLAT_SOURCE, gk.FWD_SOURCE, gk.BWD_SOURCE,
                   pk.FWD_SOURCE, pk.BWD_SOURCE):
        info = build.build_log[source]
        sizes = ", ".join(f"{k.split()[-1] if ' ' in k else 'main kernel'} {v} B"
                          for k, v in smem.items() if k.split()[0] == source)
        print(f"{source}: nvcc {info['seconds']:.1f} s; dynamic smem per block: {sizes}")
        for line in info["ptxas"]:
            print(f"  ptxas: {line}")

    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    rays = lambda B, N: tuple(torch.from_numpy(a).to(dev) for a in dyadic_rays(rng, B, N))

    # ---- 3a. kernel 1 vs plain version ----
    phase("kernel 1 (field forward) vs plain")
    fwd_shapes = [(4096, 64), (4096, 128), *STEP_SHAPES]
    fwd_inputs, fwd_err = {}, 0.0
    with torch.no_grad():
        for B, N in fwd_shapes:
            o, d, ts = fwd_inputs[B, N] = rays(B, N)
            k_out = mk.field_rays(params, o, d, ts)
            torch.cuda.synchronize()
            ce, se, sigma_ok, _, _ = field_errors(
                k_out, mk.field_rays_plain(params, o, d, ts))
            print(f"B={B} N={N}: max |color err| {ce:.3e} (atol {COLOR_ATOL}), "
                  f"max |sigma err| {se:.3e} (atol {SIGMA_ATOL} rtol {SIGMA_RTOL})")
            if not (ce <= COLOR_ATOL and sigma_ok):
                raise AssertionError(f"kernel 1 disagrees with field_rays_plain at B={B} N={N}")
            fwd_err = max(fwd_err, ce, se)

    # ---- 3b. kernel 2 vs plain version ----
    phase("kernel 2 (field recompute backward) vs plain")
    bwd_shapes = [*STEP_SHAPES, (4096, 64), (4096, 128)]
    bwd_inputs, bwd_abs, bwd_rel = {}, 0.0, 0.0
    for B, N in bwd_shapes:
        o, d, ts = rays(B, N)
        keep = (mk.preactivation_margin(params, o, d, ts) > MARGIN).float()
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        bwd_inputs[B, N] = (o, d, ts, *cots)
        kernel = mk.field_rays_bwd(params, *bwd_inputs[B, N])
        torch.cuda.synchronize()
        errs = bwd_errors(kernel, mk.field_rays_bwd_plain(params, *bwd_inputs[B, N]))
        worst = max(errs, key=lambda k: errs[k][1])
        print(f"B={B} N={N} ({100 * (1 - float(keep.mean())):.2f}% of rows within "
              f"{MARGIN} of a kink, zero cotangent): worst {worst} error / max|plain| "
              f"{errs[worst][1]:.3e} (limit {BWD_RTOL}); d_ts {errs['d_ts'][1]:.3e}, "
              f"d_origins {errs['d_origins'][1]:.3e}, d_dirs {errs['d_dirs'][1]:.3e}, "
              f"trunk_4.w {errs['trunk_4.w'][1]:.3e}, color.w {errs['color.w'][1]:.3e}")
        if errs[worst][1] > BWD_RTOL:
            raise AssertionError(f"kernel 2 disagrees with field_rays_bwd_plain at "
                                 f"B={B} N={N}: {errs}")
        bwd_abs = max(bwd_abs, max(e[0] for e in errs.values()))
        bwd_rel = max(bwd_rel, errs[worst][1])
        del kernel, errs
    torch.cuda.empty_cache()

    # ---- 3c. kernel 3 vs plain version, fp32 and bf16 ----
    phase("kernel 3 (flat field forward) vs plain, fp32 and bf16")
    flat_inputs, flat_err = {}, {"fp32": 0.0, "bf16": 0.0}
    with torch.no_grad():
        for R in FLAT_ROWS:
            pts, dirs = flat_inputs[R] = tuple(
                torch.from_numpy(a).to(dev) for a in grid_probes(rng, R))
            for precision in ("fp32", "bf16"):
                color, sigma = mk.field_flat(params, pts, dirs, precision)
                torch.cuda.synchronize()
                p_color, p_sigma = mk.field_flat_plain(params, pts, dirs, precision)
                ce = float((color - p_color).abs().max())
                se = float((sigma - p_sigma).abs().max())
                if precision == "fp32":
                    ok = ce <= COLOR_ATOL and bool(torch.all(
                        (sigma - p_sigma).abs() <= SIGMA_ATOL + SIGMA_RTOL * p_sigma.abs()))
                    limits = f"color atol {COLOR_ATOL}, sigma atol {SIGMA_ATOL} rtol {SIGMA_RTOL}"
                else:
                    rel = max(rel_err(color, p_color), rel_err(sigma, p_sigma))
                    ok = rel <= BF16_FWD_RTOL
                    limits = f"error / max|plain| {rel:.3e}, limit {BF16_FWD_RTOL}"
                print(f"R={R} {precision}: max |color err| {ce:.3e}, max |sigma err| "
                      f"{se:.3e} ({limits})")
                if not ok:
                    raise AssertionError(f"kernel 3 disagrees with field_flat_plain at "
                                         f"R={R} {precision}")
                flat_err[precision] = max(flat_err[precision], ce, se)

    # ---- 3d. kernels 1 and 2 in their bf16 form vs their bf16 plain versions ----
    phase("kernels 1 and 2, bf16 form, vs their bf16 plain versions")
    bf16_inputs, bf16_fwd_err, bf16_bwd_abs, bf16_bwd_rel = {}, 0.0, 0.0, 0.0
    for B, N in OCC_SHAPES:
        o, d, ts = rays(B, N)
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev)
                for _ in range(4)]
        bf16_inputs[B, N] = (o, d, ts, *cots)
        with torch.no_grad():
            (r, g, b), sigma = mk.field_rays(params, o, d, ts, "bf16")
            torch.cuda.synchronize()
            (pr, pg, pb), p_sigma = mk.field_rays_plain(params, o, d, ts, "bf16")
        fwd_rel = max(rel_err(x, y) for x, y in ((r, pr), (g, pg), (b, pb), (sigma, p_sigma)))
        kernel = mk.field_rays_bwd(params, *bf16_inputs[B, N], precision="bf16")
        torch.cuda.synchronize()
        plain = mk.field_rays_bwd_plain(params, *bf16_inputs[B, N], precision="bf16")
        errs = bwd_errors(kernel, plain)
        worst = max(errs, key=lambda k: errs[k][1])
        cos = bwd_cosines(kernel, plain)
        print(f"B={B} N={N}: kernel 1 bf16 error / max|plain| {fwd_rel:.3e} (limit "
              f"{BF16_FWD_RTOL}); kernel 2 bf16 worst {worst} {errs[worst][1]:.3e} (limit "
              f"{BF16_BWD_RTOL}), d_ts {errs['d_ts'][1]:.3e}, smallest cosine {cos:.7f} "
              f"(limit {BF16_COS})")
        if fwd_rel > BF16_FWD_RTOL:
            raise AssertionError(f"kernel 1 bf16 disagrees with its plain version at B={B} N={N}")
        if errs[worst][1] > BF16_BWD_RTOL or cos < BF16_COS:
            raise AssertionError(f"kernel 2 bf16 disagrees with its plain version at "
                                 f"B={B} N={N}: {errs}")
        bf16_fwd_err = max(bf16_fwd_err, max(float((x - y).abs().max()) for x, y in
                                             ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))))
        bf16_bwd_abs = max(bf16_bwd_abs, max(e[0] for e in errs.values()))
        bf16_bwd_rel = max(bf16_bwd_rel, errs[worst][1])
        del kernel, plain, errs
    torch.cuda.empty_cache()

    # ---- 3e. kernels 5 and 6 (the grid field), fp32 and bf16, vs plain ----
    phase("kernels 5 and 6 (grid field forward and recompute backward) vs plain, "
          "fp32 and bf16")
    grid_params = {g: grid_with_content(g, dev, seed=i) for i, g in enumerate(GRID)}
    grid_inputs = {}
    grid_err = {f: 0.0 for f in ("fwd fp32", "fwd bf16", "bwd fp32", "bwd bf16")}
    grid_rel = {"bwd fp32": 0.0, "bwd bf16": 0.0}
    for geometry, B, N in GRID_CHECKS:
        params_g, nd = grid_params[geometry], GRID[geometry][1]
        o, d, ts = (torch.from_numpy(a).to(dev) for a in grid_rays_at(rng, B, N))
        de = gk.encoding.encode_dirs(d)
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                k_out = gk.grid_rays(params_g, o, d, ts, nd, precision)
                torch.cuda.synchronize()
                p_out = gk.grid_rays_plain(params_g, o, d, ts, de, nd, precision)
            ce, se, sigma_ok, _, _ = field_errors(k_out, p_out)
            if precision == "fp32":
                fwd_ok = ce <= COLOR_ATOL and sigma_ok
                fwd_note = f"color atol {COLOR_ATOL}, sigma atol {SIGMA_ATOL} rtol {SIGMA_RTOL}"
            else:
                rel = max(rel_err(a, b) for a, b in zip((*k_out[0], k_out[1]),
                                                         (*p_out[0], p_out[1])))
                fwd_ok = rel <= BF16_FWD_RTOL
                fwd_note = f"error / max|plain| {rel:.3e}, limit {BF16_FWD_RTOL}"
            keep = (gk.preactivation_margin(params_g, o, d, ts, nd, precision)
                    > GRID_MARGIN).float()
            cots = [torch.from_numpy(rng.normal(size=tuple(ts.shape)).astype(np.float32)).to(dev)
                    * keep for _ in range(4)]
            kernel = gk.grid_rays_bwd(params_g, o, d, ts, de, *cots, n_density=nd,
                                      precision=precision)
            again = gk.grid_rays_bwd(params_g, o, d, ts, de, *cots, n_density=nd,
                                     precision=precision)
            torch.cuda.synchronize()
            plain = gk.grid_rays_bwd_plain(params_g, o, d, ts, de, *cots, n_density=nd,
                                           precision=precision)
            errs = grid_bwd_errors(kernel, plain)
            worst = max(errs, key=lambda k: errs[k][1])
            cos = min(e[2] for e in errs.values())
            same = all(e[0] == 0 for e in grid_bwd_errors(kernel, again).values())
            limit = BWD_RTOL if precision == "fp32" else BF16_BWD_RTOL
            bwd_ok = errs[worst][1] <= limit and (precision == "fp32" or cos >= BF16_COS)
            print(f"{geometry} B={B} N={N} {precision}: forward max |color err| {ce:.3e}, "
                  f"max |sigma err| {se:.3e} ({fwd_note}); backward ({100 * (1 - float(keep.mean())):.3f}% "
                  f"of rows within {GRID_MARGIN} of a kink, zero cotangent) worst {worst} "
                  f"{errs[worst][1]:.3e} of max|plain| (limit {limit}), d_ts "
                  f"{errs['d_ts'][1]:.3e}, lines.x {errs['lines.x'][1]:.3e}, smallest cosine "
                  f"{cos:.7f}; two launches bit-identical: {same}")
            if not (fwd_ok and bwd_ok and same):
                raise AssertionError(f"kernels 5/6 disagree with their plain versions at "
                                     f"{geometry} B={B} N={N} {precision}: {errs}")
            grid_err[f"fwd {precision}"] = max(grid_err[f"fwd {precision}"], ce, se)
            grid_err[f"bwd {precision}"] = max(grid_err[f"bwd {precision}"],
                                               max(e[0] for e in errs.values()))
            grid_rel[f"bwd {precision}"] = max(grid_rel[f"bwd {precision}"], errs[worst][1])
            del kernel, again, plain
        if (geometry, B, N) in GRID_SHAPES:
            grid_inputs[B, N] = (geometry, o, d, ts, de, cots)
    torch.cuda.empty_cache()

    # ---- 3f. kernels 7 and 8 (the proposal MLP), fp32 and bf16, vs plain ----
    phase("kernels 7 and 8 (proposal MLP forward and recompute backward) vs plain, "
          "fp32 and bf16")
    prop_params = {net: proposal.init_proposal(torch.Generator().manual_seed(i), width, depth,
                                               device=dev)
                   for i, (net, (width, depth)) in enumerate(PROP_NETS.items())}
    prop_inputs = {}
    prop_err = {f: 0.0 for f in ("fwd fp32", "fwd bf16", "bwd fp32", "bwd bf16")}
    prop_rel = {"bwd fp32": 0.0, "bwd bf16": 0.0}
    for net, B, N in PROP_CHECKS:
        params_p = prop_params[net]
        o, d, ts = rays(B, N)
        keep = (mk.preactivation_margin(params_p, o, d, ts) > MARGIN).float()
        cots = [torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32)).to(dev) * keep
                for _ in range(4)]
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                (r, g, b), sigma = pk.prop_rays(params_p, o, d, ts, precision)
                torch.cuda.synchronize()
                (pr, pg, pb), p_sigma = pk.prop_rays_plain(params_p, o, d, ts, precision)
            pairs = ((r, pr), (g, pg), (b, pb), (sigma, p_sigma))
            fwd_abs = max(float((x - y).abs().max()) for x, y in pairs)
            fwd_rel = max(rel_err(x, y) for x, y in pairs)
            fwd_ok = fwd_abs <= COLOR_ATOL if precision == "fp32" else fwd_rel <= BF16_FWD_RTOL
            kernel = pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision)
            again = pk.prop_rays_bwd(params_p, o, d, ts, *cots, precision=precision)
            torch.cuda.synchronize()
            plain = pk.prop_rays_bwd_plain(params_p, o, d, ts, *cots, precision=precision)
            errs = prop_bwd_errors(kernel, plain)
            worst = max(errs, key=lambda k: errs[k][1])
            cos = min(e[2] for e in errs.values())
            same = all(e[0] == 0 for e in prop_bwd_errors(kernel, again).values())
            limit = BWD_RTOL if precision == "fp32" else BF16_BWD_RTOL
            bwd_ok = errs[worst][1] <= limit and (precision == "fp32" or cos >= BF16_COS)
            print(f"{net} B={B} N={N} {precision}: forward max |err| {fwd_abs:.3e}, error / "
                  f"max|plain| {fwd_rel:.3e} (limit {COLOR_ATOL if precision == 'fp32' else BF16_FWD_RTOL}"
                  f"{' abs' if precision == 'fp32' else ''}); backward ({100 * (1 - float(keep.mean())):.3f}% "
                  f"of rows within {MARGIN} of a kink, zero cotangent) worst {worst} "
                  f"{errs[worst][1]:.3e} of max|plain| (limit {limit}), d_ts "
                  f"{errs['d_ts'][1]:.3e}, trunk_0.w {errs['trunk_0.w'][1]:.3e}, smallest cosine "
                  f"{cos:.7f}; two launches bit-identical: {same}")
            if not (fwd_ok and bwd_ok and same):
                raise AssertionError(f"kernels 7/8 disagree with their plain versions at "
                                     f"{net} B={B} N={N} {precision}: {errs}")
            prop_err[f"fwd {precision}"] = max(prop_err[f"fwd {precision}"], fwd_abs)
            prop_err[f"bwd {precision}"] = max(prop_err[f"bwd {precision}"],
                                               max(e[0] for e in errs.values()))
            prop_rel[f"bwd {precision}"] = max(prop_rel[f"bwd {precision}"], errs[worst][1])
            del kernel, again, plain
        if (net, B, N) == ("128x4", *PROP_SHAPE):
            prop_inputs[B, N] = (o, d, ts, *cots)
    torch.cuda.empty_cache()

    # ---- 4. timing ----
    phase("timing (per launch, CUDA events)")
    fwd_time, bwd_time = {}, {}
    n_params = mlp.num_params(params)
    with torch.no_grad():
        for (B, N), (o, d, ts) in fwd_inputs.items():
            k_ms = cuda_ms(lambda: mk.field_rays(params, o, d, ts), iters=20)
            p_ms = cuda_ms(lambda: mk.field_rays_plain(params, o, d, ts), iters=5)
            flops = mk.flops_per_row() * B * N
            n_bytes = 4 * (2 * 3 * B + 5 * B * N + n_params)
            bound = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
            fwd_time[B, N] = (k_ms, p_ms, bound)
            print(f"kernel 1 B={B} N={N}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} "
                  f"bound_ms {bound:.3f} (f32 FLOP bound, {flops / 1e9:.1f} GFLOP); "
                  f"{flops / k_ms / 1e9:.2f} TFLOP/s = {100 * bound / k_ms:.1f}% of peak")
    for (B, N), args in bwd_inputs.items():
        k_ms = cuda_ms(lambda: mk.field_rays_bwd(params, *args), iters=10)
        p_ms = cuda_ms(lambda: mk.field_rays_bwd_plain(params, *args), iters=3)
        flops = 3 * mk.flops_per_row() * B * N
        # in: rays, ts, 4 cotangents, params; out: d_o, d_d, d_ts, grads
        n_bytes = 4 * (2 * 3 * B + 5 * B * N + n_params + 2 * 3 * B + B * N + n_params)
        bound = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
        bwd_time[B, N] = (k_ms, p_ms, bound)
        print(f"kernel 2 B={B} N={N}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} "
              f"bound_ms {bound:.3f} (f32 FLOP bound, {flops / 1e9:.1f} GFLOP); "
              f"{flops / k_ms / 1e9:.2f} TFLOP/s = {100 * bound / k_ms:.1f}% of peak")
    del bwd_inputs
    torch.cuda.empty_cache()

    # the new forms: (ms, plain ms, bound ms, bound_by, f32 FMA bound ms)
    flat_time, bf16_fwd_time, bf16_bwd_time = {}, {}, {}

    def report(what, k_ms, p_ms, flops, n_bytes, precision):
        b_ms, b_by = least_ms(flops, n_bytes, precision)
        f32_ms = least_ms(flops, n_bytes, "fp32")[0]
        print(f"{what}: kernel_ms {k_ms:.3f} plain_ms {p_ms:.3f} bound_ms {b_ms:.4f} "
              f"({precision} {b_by} bound, {flops / 1e9:.1f} GFLOP; {100 * b_ms / k_ms:.2f}%); "
              f"f32 FMA bound {f32_ms:.3f} ms ({100 * f32_ms / k_ms:.1f}%); "
              f"{flops / k_ms / 1e9:.2f} TFLOP/s")
        return k_ms, p_ms, b_ms, b_by, f32_ms

    with torch.no_grad():
        for R in FLAT_ROWS[:2]:
            pts, dirs = flat_inputs[R]
            for precision in ("fp32", "bf16"):
                k_ms = cuda_ms(lambda: mk.field_flat(params, pts, dirs, precision), iters=20)
                p_ms = cuda_ms(lambda: mk.field_flat_plain(params, pts, dirs, precision), iters=5)
                # in: points, dirs, params; out: (R, 4)
                flat_time[R, precision] = report(
                    f"kernel 3 {precision} R={R}", k_ms, p_ms, mk.flops_per_row() * R,
                    4 * (6 * R + n_params + 4 * R), precision)
        for (B, N), (o, d, ts, *_) in bf16_inputs.items():
            k_ms = cuda_ms(lambda: mk.field_rays(params, o, d, ts, "bf16"), iters=20)
            p_ms = cuda_ms(lambda: mk.field_rays_plain(params, o, d, ts, "bf16"), iters=5)
            bf16_fwd_time[B, N] = report(
                f"kernel 1 bf16 B={B} N={N}", k_ms, p_ms, mk.flops_per_row() * B * N,
                4 * (2 * 3 * B + 5 * B * N + n_params), "bf16")
    for (B, N), args in bf16_inputs.items():
        k_ms = cuda_ms(lambda: mk.field_rays_bwd(params, *args, precision="bf16"), iters=10)
        p_ms = cuda_ms(lambda: mk.field_rays_bwd_plain(params, *args, precision="bf16"), iters=3)
        bf16_bwd_time[B, N] = report(
            f"kernel 2 bf16 B={B} N={N}", k_ms, p_ms, 3 * mk.flops_per_row() * B * N,
            4 * (2 * 3 * B + 5 * B * N + n_params + 2 * 3 * B + B * N + n_params), "bf16")
    del bf16_inputs, flat_inputs
    torch.cuda.empty_cache()

    # kernels 5 and 6: (ms, plain ms, bound ms, bound_by, f32 FMA bound ms)
    # per (precision, (B, N)); the bound counts the gather form's FLOPs
    grid_fwd_time = {"fp32": {}, "bf16": {}}
    grid_bwd_time = {"fp32": {}, "bf16": {}}
    for (B, N), (geometry, o, d, ts, de, cots) in grid_inputs.items():
        params_g, dims = grid_params[geometry], GRID[geometry]
        nd = dims[1]
        n_grid = gridfield.num_params(params_g)
        flops = gk.flops_per_row(*dims) * B * N
        hat = gk.hat_flops_per_row(*dims) * B * N
        # in: origins, dirs, ts, the encoding, params; out: four planes
        fwd_bytes = 4 * (6 * B + B * N + 24 * B + n_grid + 4 * B * N)
        # in: the same and four cotangent planes; out: d_o, d_d, d_ts, d_de, grads
        bwd_bytes = 4 * (6 * B + B * N + 24 * B + n_grid + 4 * B * N
                         + 6 * B + B * N + 24 * B + n_grid)
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                k_ms = cuda_ms(lambda: gk.grid_rays(params_g, o, d, ts, nd, precision), iters=20)
                p_ms = cuda_ms(lambda: gk.grid_rays_plain(params_g, o, d, ts, de, nd, precision),
                               iters=5)
            grid_fwd_time[precision][B, N] = report(
                f"kernel 5 {precision} {geometry} B={B} N={N}", k_ms, p_ms, flops, fwd_bytes,
                precision)
            k_ms = cuda_ms(lambda: gk.grid_rays_bwd(params_g, o, d, ts, de, *cots,
                                                     n_density=nd, precision=precision), iters=10)
            p_ms = cuda_ms(lambda: gk.grid_rays_bwd_plain(params_g, o, d, ts, de, *cots,
                                                          n_density=nd, precision=precision),
                           iters=3)
            grid_bwd_time[precision][B, N] = report(
                f"kernel 6 {precision} {geometry} B={B} N={N}", k_ms, p_ms, 3 * flops,
                bwd_bytes, precision)
        print(f"  {geometry}: the TPU kernel's own hat-form count {hat / 1e9:.2f} GFLOP "
              f"forward ({gk.hat_flops_per_row(*dims):,} a row) against the gather form's "
              f"{flops / 1e9:.3f} ({gk.flops_per_row(*dims):,} a row); bytes {fwd_bytes / 1e6:.2f} MB "
              f"forward, {bwd_bytes / 1e6:.2f} MB backward, bytes bound "
              f"{1e3 * fwd_bytes / PEAK_BYTES:.4f} / {1e3 * bwd_bytes / PEAK_BYTES:.4f} ms")
    del grid_inputs
    torch.cuda.empty_cache()

    # kernels 7 and 8 at lego_prop's proposal call: (ms, plain ms, bound ms,
    # bound_by, f32 FMA bound ms) per (precision, (B, N)); the FLOPs are the
    # TPU kernel's count (the encoding's sines and cosines not in it)
    prop_fwd_time = {"fp32": {}, "bf16": {}}
    prop_bwd_time = {"fp32": {}, "bf16": {}}
    params_p = prop_params["128x4"]
    n_prop = sum(t.numel() for layer in params_p.values() for t in layer.values())
    for (B, N), (o, d, ts, *cots) in prop_inputs.items():
        flops = pk.flops_per_row(*PROP_NETS["128x4"]) * B * N
        # in: origins, dirs, ts, params; out: four planes
        fwd_bytes = 4 * (6 * B + B * N + n_prop + 4 * B * N)
        # in: the same and four cotangent planes; out: d_o, d_d, d_ts, grads
        bwd_bytes = 4 * (6 * B + 5 * B * N + n_prop + 6 * B + B * N + n_prop)
        for precision in ("fp32", "bf16"):
            with torch.no_grad():
                k_ms = cuda_ms(lambda: pk.prop_rays(params_p, o, d, ts, precision), iters=20)
                p_ms = cuda_ms(lambda: pk.prop_rays_plain(params_p, o, d, ts, precision), iters=5)
            prop_fwd_time[precision][B, N] = report(
                f"kernel 7 {precision} 128x4 B={B} N={N}", k_ms, p_ms, flops, fwd_bytes,
                precision)
            k_ms = cuda_ms(lambda: pk.prop_rays_bwd(params_p, o, d, ts, *cots,
                                                     precision=precision), iters=10)
            p_ms = cuda_ms(lambda: pk.prop_rays_bwd_plain(params_p, o, d, ts, *cots,
                                                          precision=precision), iters=3)
            prop_bwd_time[precision][B, N] = report(
                f"kernel 8 {precision} 128x4 B={B} N={N}", k_ms, p_ms, 3 * flops, bwd_bytes,
                precision)
        print(f"  128x4: {pk.flops_per_row(*PROP_NETS['128x4']):,} FLOP a row, "
              f"{flops / 1e9:.2f} GFLOP forward; bytes {fwd_bytes / 1e6:.2f} MB forward, "
              f"{bwd_bytes / 1e6:.2f} MB backward")
    del prop_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(os.path.join(ROOT, "conf", "lego.ini"))
        cfg.ckpt_path = os.path.join(tmp, "ckpt")
        cfg.results_path = os.path.join(tmp, "results")
        cfg.log_dir = os.path.join(tmp, "runs")
        cfg.continue_ = False
        cfg.total_iter = TRAIN_STEPS
        cfg.step = 10 * TRAIN_STEPS  # no preview JPG: imageio is not needed

        # ---- 5. the training path ----
        phase("training path")
        scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=cfg.seed)
        runner = Runner(cfg, device="cuda", scene=scene)
        mk.field_rays.launches = mk.field_rays_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        train_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches)
        print(f"Runner.train(): {TRAIN_STEPS} steps of {cfg.batch_ray} rays at "
              f"{cfg.n_coarse}+{cfg.n_fine} samples in {seconds:.2f} s "
              f"({seconds / TRAIN_STEPS * 1e3:.2f} ms/step, first steps included); "
              f"launches: forward {train_launches[0]}, backward {train_launches[1]} "
              f"(expected {2 * TRAIN_STEPS} each)")
        if train_launches != (2 * TRAIN_STEPS, 2 * TRAIN_STEPS):
            raise AssertionError("a training step did not run both kernels on both field calls")
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 "
              f"{last:.4f} (step 0 {losses[0]:.4f}, step {TRAIN_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the loss did not fall")

        # seconds per step and rays/s at BATCH_RAY 400 (lego) and 4096
        step_time = {}
        for batch, iters in ((cfg.batch_ray, 20), (4096, 6)):
            scfg = dataclasses.replace(cfg, batch_ray=batch)
            step = train.make_train_step(scfg, runner.train_table, runner.k_inv)
            state = runner.state
            for _ in range(2):
                state, _ = step(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, _ = step(state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / iters * 1e3
            shapes = ((batch, cfg.n_coarse), (batch, cfg.n_fine))
            kern = sum(fwd_time[s][0] + bwd_time[s][0] for s in shapes)
            step_time[batch] = (ms, kern)
            print(f"BATCH_RAY {batch}: {ms / 1e3:.5f} s/step, {batch / ms * 1e3:,.0f} rays/s; "
                  f"kernels {kern:.3f} ms of it ({100 * kern / ms:.1f}%: 2 forward + 2 "
                  "backward launches at their timed per-launch ms)")

        profile_steps(train.make_train_step(cfg, runner.train_table, runner.k_inv),
                      runner.state)

        # one step on a field with content: the kernels vs the plain field
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(1),
                                          cfg.batch_ray)
        _, _, g_k = train.loss_and_grads(
            train.make_loss_fn(cfg, runner.k_inv), content, batch)
        _, _, g_p = train.loss_and_grads(
            train.make_loss_fn(cfg, runner.k_inv, render.field_plain), content, batch)
        a, b = flat_grads(g_k).double(), flat_grads(g_p).double()
        cos = float(a @ b / (a.norm() * b.norm()))
        print(f"one step, kernels vs plain field (sigma bias +1): gradient cosine "
              f"{cos:.7f} (limit {GRAD_COS}), norm ratio {float(a.norm() / b.norm()):.6f}")
        if not cos >= GRAD_COS:
            raise AssertionError("the kernels' training gradient disagrees with the plain field's")

        trained_iter = runner.state.iteration - 1
        path = ckpt.save_checkpoint(cfg.ckpt_path, "smoke", trained_iter, runner.params,
                                    runner.state.opt, generator=runner.state.generator)
        trained = runner.params
        print(f"saved the trained state (params, Adam moments, count "
              f"{runner.state.opt.count}) to {os.path.basename(path)}")
        del runner

        # ---- 6. the render path, from the trained checkpoint ----
        phase("render path")
        cfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=cfg.seed)
        runner = Runner(cfg, device="cuda", scene=scene)
        if runner.last_iter != trained_iter or not torch.equal(
                runner.params["trunk_3"]["w"], trained["trunk_3"]["w"]):
            raise AssertionError("Runner did not resume the trained checkpoint")
        num_pix = scene.height * scene.width
        n_chunks = math.ceil(num_pix / cfg.render_chunk)
        expected = 2 * n_chunks * scene.images.shape[0]

        mk.field_rays.launches = mk.field_rays_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            cfg, runner.params, runner.test_table, runner.k_inv,
            runner.start_time, runner.last_iter, save=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        render_launches = mk.field_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} "
              f"at {cfg.n_coarse}+{cfg.n_fine} samples from the iteration-{trained_iter} "
              f"checkpoint: {seconds / frames.shape[0]:.3f} s/frame; field_rays launches "
              f"{render_launches} (expected {expected} = 2 x {n_chunks} chunks x "
              f"{frames.shape[0]} views)")
        if render_launches != expected or mk.field_rays_bwd.launches != 0:
            raise AssertionError("the render path did not run the forward kernel (and "
                                 "only it) on every field call")
        if frames.shape != (2, scene.height, scene.width, 3):
            raise AssertionError(f"frames have shape {frames.shape}")
        if not (np.all(np.isfinite(frames)) and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("frames are not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")

        # one real chunk (the frame's middle), kernel field vs plain field
        with torch.no_grad():
            span = slice((n_chunks // 2) * cfg.render_chunk,
                         (n_chunks // 2 + 1) * cfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows = (idx // scene.width).float()
            cols = (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            o, d, near, far = raylib.pixels_to_rays(rows, cols, pose, runner.k_inv)
            ts = sampling.coarse_ts(near, far, cfg.n_coarse)
            _, _, _, ce, se = field_errors(mk.field_rays(runner.params, o, d, ts),
                                           mk.field_rays_plain(runner.params, o, d, ts))
            q = lambda e: float(torch.quantile(e, 0.999))
            print(f"real chunk (view 0, N={cfg.n_coarse}): |color err| max "
                  f"{float(ce.max()):.3e} p99.9 {q(ce):.3e}; |sigma err| max "
                  f"{float(se.max()):.3e} p99.9 {q(se):.3e}")
            args = (rows, cols, pose, runner.k_inv, cfg.n_coarse, cfg.n_fine)
            _, c_kernel = render.render_rays(runner.params, *args,
                                             field_fn=evallib.make_field_fn(cfg))
            _, c_plain = render.render_rays(runner.params, *args,
                                            field_fn=render.field_plain)
            pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk rendered through the kernel vs the plain field: "
                  f"max |pixel err| {pix_err:.3e} (atol {CHUNK_ATOL})")
            if not pix_err <= CHUNK_ATOL:
                raise AssertionError("kernel render disagrees with the plain render")
        del runner

        # ---- 7. the lego_occ training path ----
        phase("lego_occ training path (bf16, occupancy grid)")
        ocfg = load_config(os.path.join(ROOT, "conf", "lego_occ.ini"))
        ocfg.ckpt_path = os.path.join(tmp, "occ_ckpt")
        ocfg.results_path = os.path.join(tmp, "occ_results")
        ocfg.log_dir = os.path.join(tmp, "occ_runs")
        ocfg.continue_ = False
        ocfg.step = 10 * OCC_STEPS  # no preview JPG: imageio is not needed
        scene = blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=ocfg.seed)
        runner = Runner(ocfg, device="cuda", scene=scene)
        subset = int(ocfg.occ_res ** 3 * ocfg.occ_subset)
        print(f"{ocfg.precision}, BATCH_RAY {ocfg.batch_ray}, {ocfg.n_coarse}+{ocfg.n_fine} "
              f"samples, OCC_RES {ocfg.occ_res} (refresh every {ocfg.occ_update_every} steps, "
              f"{subset} cells), OCC_MARCH_STEPS {ocfg.occ_march_steps} (derived), WHITE_BKGD "
              f"{ocfg.white_bkgd}")
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shares = []
        for end in (ocfg.occ_update_every, OCC_STEPS):  # read the grid after each refresh
            ocfg.total_iter = end
            runner.train()
            shares.append(grid_shares(runner.state.occ))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        occ_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches,
                        mk.field_flat.launches)
        print(f"Runner.train(): {OCC_STEPS} steps of {ocfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / OCC_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"forward {occ_launches[0]}, backward {occ_launches[1]} (expected "
              f"{2 * OCC_STEPS} each), flat {occ_launches[2]} (expected 2)")
        if occ_launches != (2 * OCC_STEPS, 2 * OCC_STEPS, 2):
            raise AssertionError("the lego_occ path did not run the kernels as expected")
        for it, (probed, occupied) in zip((0, ocfg.occ_update_every), shares):
            print(f"grid after the refresh at iteration {it}: {100 * probed:.2f}% of cells "
                  f"probed, {100 * occupied:.2f}% occupied")
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        if len(losses) != OCC_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {OCC_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_occ loss did not fall")

        # s/step and rays/s (no refresh in these iterations), and the refresh alone
        step = train.make_train_step(ocfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        occ_ms = (time.perf_counter() - t0) / 6 * 1e3
        occ_kern = sum(bf16_fwd_time[s][0] + bf16_bwd_time[s][0] for s in OCC_SHAPES)
        print(f"BATCH_RAY {ocfg.batch_ray}: {occ_ms / 1e3:.5f} s/step, "
              f"{ocfg.batch_ray / occ_ms * 1e3:,.0f} rays/s; kernels {occ_kern:.3f} ms of it "
              f"({100 * occ_kern / occ_ms:.1f}%: 2 forward + 2 backward bf16 launches at "
              "their timed per-launch ms)")
        field_fn = evallib.make_field_fn(ocfg)
        refresh = lambda: train.refresh_occ(ocfg, dataclasses.replace(state, iteration=0),
                                            field_fn)
        refresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            refresh()
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"one grid refresh ({subset} probes through kernel 3, the EMA, the dilation): "
              f"{refresh_ms:.3f} ms, {refresh_ms / ocfg.occ_update_every:.4f} ms per step "
              f"averaged over {ocfg.occ_update_every} steps")
        profile_steps(step, state)

        # one step on a field with content: the bf16 kernels vs the bf16 plain field
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(2),
                                          ocfg.batch_ray)
        plain_bf16 = functools.partial(mk.field_flat_plain, precision="bf16")
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(ocfg, runner.k_inv), content,
                                         batch, None, runner.state.occ)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(ocfg, runner.k_inv, plain_bf16),
                                         content, batch, None, runner.state.occ)
        a, b = flat_grads(g_k).double(), flat_grads(g_p).double()
        cos = float(a @ b / (a.norm() * b.norm()))
        print(f"one bf16 step, kernels vs bf16 plain field (sigma bias +1): gradient cosine "
              f"{cos:.7f} (limit {BF16_COS}), norm ratio {float(a.norm() / b.norm()):.6f}")
        if not cos >= BF16_COS:
            raise AssertionError("the bf16 kernels' training gradient disagrees with the "
                                 "bf16 plain field's")
        occ_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(ocfg.ckpt_path, "smoke", occ_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator,
                             occ=runner.state.occ)
        trained_occ = runner.state.occ
        del runner, state, step

        # ---- 8. the lego_occ render path, from that checkpoint ----
        phase("lego_occ render path (bf16, occupancy grid)")
        ocfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=ocfg.seed)
        runner = Runner(ocfg, device="cuda", scene=scene)
        if runner.last_iter != occ_iter or not torch.equal(runner.state.occ.raw,
                                                          trained_occ.raw):
            raise AssertionError("Runner did not resume the lego_occ checkpoint and its grid")
        expected = 2 * n_chunks * scene.images.shape[0]
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            ocfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False, occ_grid=runner.state.occ)
        torch.cuda.synchronize()
        occ_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        occ_render_launches = mk.field_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} with the grid "
              f"from the iteration-{occ_iter} checkpoint: {occ_frame_s:.3f} s/frame; field_rays "
              f"launches {occ_render_launches} (expected {expected}), flat "
              f"{mk.field_flat.launches}, backward {mk.field_rays_bwd.launches}")
        if (occ_render_launches, mk.field_flat.launches,
                mk.field_rays_bwd.launches) != (expected, 0, 0):
            raise AssertionError("the lego_occ render path did not run the bf16 forward "
                                 "kernel (and only it) on every field call")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_occ frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * ocfg.render_chunk,
                         (n_chunks // 2 + 1) * ocfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, ocfg.n_coarse, ocfg.n_fine)
            occ_kw = dict(white_bkgd=True, occ_grid=runner.state.occ,
                          occ_march=ocfg.occ_march_steps)
            _, c_kernel = render.render_rays(runner.params, *args,
                                             field_fn=evallib.make_field_fn(ocfg), **occ_kw)
            _, c_plain = render.render_rays(runner.params, *args, field_fn=plain_bf16, **occ_kw)
            occ_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk with the grid, bf16 kernels vs bf16 plain field: max |pixel "
                  f"err| {occ_pix_err:.3e}, mean {float((c_kernel - c_plain).abs().mean()):.3e} "
                  f"(atol {BF16_CHUNK_ATOL})")
            if not occ_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the bf16 kernel render disagrees with the bf16 plain render")
            o, d, near, far = raylib.pixels_to_rays(rows, cols, pose, runner.k_inv)
            march_ms = cuda_ms(lambda: occupancy.tighten_bounds(
                runner.state.occ, o, d, near, far, n_steps=ocfg.occ_march_steps), iters=20)
            n_near, n_far = occupancy.tighten_bounds(runner.state.occ, o, d, near, far,
                                                     n_steps=ocfg.occ_march_steps)
            print(f"the grid's march on one chunk ({ocfg.render_chunk} rays x "
                  f"{ocfg.occ_march_steps} probes): {march_ms:.3f} ms; mean ray span "
                  f"{float((n_far - n_near).mean()):.3f} of {float((far - near).mean()):.3f}")
            kernel_field = evallib.make_field_fn(ocfg)
            profile_calls(lambda: render.render_rays(runner.params, *args, field_fn=kernel_field,
                                                     merge_impl="twolist", **occ_kw),
                          5, "chunks")
        del runner

        # ---- 9. lego_occ at fp32, cut to 10 steps ----
        phase("lego_occ at PRECISION=fp32, 10 steps (the fp32 form of kernel 3)")
        fcfg = load_config(os.path.join(ROOT, "conf", "lego_occ.ini"))
        fcfg.precision = "fp32"
        fcfg.ckpt_path = os.path.join(tmp, "fp32_ckpt")
        fcfg.results_path = os.path.join(tmp, "fp32_results")
        fcfg.log_dir = os.path.join(tmp, "fp32_runs")
        fcfg.continue_ = False
        fcfg.total_iter = OCC_FP32_STEPS
        fcfg.step = 10 * OCC_FP32_STEPS
        runner = Runner(fcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fcfg.seed))
        mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
        runner.train()
        torch.cuda.synchronize()
        fp32_launches = (mk.field_rays.launches, mk.field_rays_bwd.launches,
                         mk.field_flat.launches)
        with open(runner.logger.path) as f:
            losses = [json.loads(line)["loss/train"] for line in f]
        print(f"{OCC_FP32_STEPS} steps: launches forward {fp32_launches[0]}, backward "
              f"{fp32_launches[1]} (expected {2 * OCC_FP32_STEPS} each), flat "
              f"{fp32_launches[2]} (expected 1); losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if fp32_launches != (2 * OCC_FP32_STEPS, 2 * OCC_FP32_STEPS, 1):
            raise AssertionError("lego_occ at fp32 did not run the fp32 kernels as expected")
        if len(losses) != OCC_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_occ at fp32: not every loss is finite")
        del runner

        def reset_counts():
            mk.field_rays.launches = mk.field_rays_bwd.launches = mk.field_flat.launches = 0
            gk.grid_rays.launches = gk.grid_rays_bwd.launches = 0

        mlp_counts = lambda: (mk.field_rays.launches, mk.field_rays_bwd.launches,
                              mk.field_flat.launches)

        # ---- 10. the lego_grid training path, GRID_PALLAS ----
        phase("lego_grid training path (GRID_PALLAS: grid field and proposal grid, bf16, "
              "occupancy grid)")
        gcfg = run_config("lego_grid", tmp, "grid", GRID_STEPS, grid_pallas=True)
        runner = Runner(gcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=gcfg.seed))
        n_net, n_prop = (gridfield.num_params(runner.params[k]) for k in ("net", "prop"))
        print(f"{gcfg.precision}, BATCH_RAY {gcfg.batch_ray}, {gcfg.n_coarse}+{gcfg.n_fine} "
              f"samples; fine grid R={gcfg.grid_res}, {gcfg.grid_comp_density}+"
              f"{gcfg.grid_comp_app} components, decoder width {gcfg.grid_decoder_width} "
              f"({n_net:,} params); proposal grid R={gcfg.prop_grid_res}, "
              f"{gcfg.prop_grid_comp_density}+{gcfg.prop_grid_comp_app}, width "
              f"{gcfg.prop_grid_decoder_width} ({n_prop:,} params); GRID_LR_MULT "
              f"{gcfg.grid_lr_mult}, GRID_TV {gcfg.grid_tv}; OCC_RES {gcfg.occ_res}, "
              f"OCC_MARCH_STEPS {gcfg.occ_march_steps} (derived)")
        if (n_net, n_prop) != (110_084, 6_852):
            raise AssertionError("lego_grid's grids are not at full width")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid_shares_after = []
        for end in (gcfg.occ_update_every, GRID_STEPS):  # read the grid after each refresh
            gcfg.total_iter = end
            runner.train()
            grid_shares_after.append(grid_shares(runner.state.occ))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        grid_launches = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        print(f"Runner.train(): {GRID_STEPS} steps of {gcfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / GRID_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"grid forward {grid_launches[0]}, backward {grid_launches[1]} (expected "
              f"{2 * GRID_STEPS} each); MLP kernels (forward, backward, flat) {mlp_counts()} "
              "(expected none: the refreshes run the plain point field)")
        if grid_launches != (2 * GRID_STEPS, 2 * GRID_STEPS) or any(mlp_counts()):
            raise AssertionError("the lego_grid path did not run kernels 5 and 6 as expected")
        for it, (probed, occupied) in zip((0, gcfg.occ_update_every), grid_shares_after):
            print(f"grid after the refresh at iteration {it}: {100 * probed:.2f}% of cells "
                  f"probed, {100 * occupied:.2f}% occupied")
        losses = logged_losses(runner)
        if len(losses) != GRID_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {GRID_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_grid loss did not fall")

        step = train.make_train_step(gcfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        grid_ms = (time.perf_counter() - t0) / 6 * 1e3
        grid_kern = sum(grid_fwd_time["bf16"][s][0] + grid_bwd_time["bf16"][s][0]
                        for s in ((4096, 64), (4096, 128)))
        print(f"BATCH_RAY {gcfg.batch_ray}: {grid_ms / 1e3:.5f} s/step, "
              f"{gcfg.batch_ray / grid_ms * 1e3:,.0f} rays/s; kernels 5 and 6 {grid_kern:.3f} ms "
              f"of it ({100 * grid_kern / grid_ms:.1f}%: 2 forward + 2 backward bf16 launches at "
              "their timed per-launch ms)")
        profile_steps(step, state)

        # one step on grids with content: kernels 5 and 6 vs their plain versions
        content = {"net": scale_density(runner.params["net"], gcfg.grid_comp_density),
                   "prop": scale_density(runner.params["prop"], gcfg.prop_grid_comp_density)}
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(3),
                                          gcfg.batch_ray)
        ref_net, ref_prop = reference_grid_fields(gcfg)
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(gcfg, runner.k_inv), content,
                                         batch, None, runner.state.occ)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(gcfg, runner.k_inv, ref_net,
                                                            ref_prop),
                                         content, batch, None, runner.state.occ)
        grid_cos = grid_part_cosines(g_k, g_p)
        print("one bf16 step, kernels 5 and 6 vs their plain versions (density x3): gradient "
              "cosines " + ", ".join(f"{k} {v:.7f}" for k, v in grid_cos.items())
              + f" (limit {BF16_COS})")
        if min(grid_cos.values()) < BF16_COS:
            raise AssertionError("the grid kernels' training gradient disagrees with the "
                                 "plain versions'")
        grid_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(gcfg.ckpt_path, "smoke", grid_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator,
                             occ=runner.state.occ)
        trained_grid_occ = runner.state.occ
        del runner, state, step, g_k, g_p, content

        # ---- 11. the lego_grid render path, from that checkpoint ----
        phase("lego_grid render path (GRID_PALLAS, occupancy grid)")
        gcfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=gcfg.seed)
        runner = Runner(gcfg, device="cuda", scene=scene)
        if runner.last_iter != grid_iter or not torch.equal(runner.state.occ.raw,
                                                           trained_grid_occ.raw):
            raise AssertionError("Runner did not resume the lego_grid checkpoint and its grid")
        expected = 2 * n_chunks * scene.images.shape[0]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            gcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False, occ_grid=runner.state.occ)
        torch.cuda.synchronize()
        grid_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        grid_render_launches = gk.grid_rays.launches
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} with the grid "
              f"from the iteration-{grid_iter} checkpoint: {grid_frame_s:.3f} s/frame; grid "
              f"forward launches {grid_render_launches} (expected {expected} = 2 x {n_chunks} "
              f"chunks x {frames.shape[0]} views), backward {gk.grid_rays_bwd.launches}, MLP "
              f"{mlp_counts()}")
        if (grid_render_launches, gk.grid_rays_bwd.launches, *mlp_counts()) != (expected, 0, 0, 0, 0):
            raise AssertionError("the lego_grid render path did not run kernel 5 (and only it) "
                                 "on every field call")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_grid frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * gcfg.render_chunk,
                         (n_chunks // 2 + 1) * gcfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, gcfg.n_coarse, gcfg.n_fine)
            kw = dict(white_bkgd=True, occ_grid=runner.state.occ,
                      occ_march=gcfg.occ_march_steps, prop_params=runner.params["prop"])
            kern_net, kern_prop = evallib.make_field_fn(gcfg), evallib.make_prop_field_fn(gcfg)
            _, c_kernel = render.render_rays(runner.params["net"], *args, field_fn=kern_net,
                                             prop_field_fn=kern_prop, **kw)
            _, c_plain = render.render_rays(runner.params["net"], *args, field_fn=ref_net,
                                            prop_field_fn=ref_prop, **kw)
            grid_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk with the grid, kernels 5 and 6 vs their plain versions (bf16): "
                  f"max |pixel err| {grid_pix_err:.3e}, mean "
                  f"{float((c_kernel - c_plain).abs().mean()):.3e} (atol {BF16_CHUNK_ATOL})")
            if not grid_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the grid kernels' render disagrees with the plain render")
            profile_calls(lambda: render.render_rays(runner.params["net"], *args,
                                                     field_fn=kern_net, prop_field_fn=kern_prop,
                                                     merge_impl="twolist", **kw),
                          5, "chunks")
        del runner

        # ---- 12. lego_grid at fp32, and lego_fast with GRID_PALLAS ----
        phase("lego_grid at PRECISION=fp32, 10 steps (the fp32 forms of kernels 5 and 6)")
        fgcfg = run_config("lego_grid", tmp, "grid_fp32", GRID_FP32_STEPS, grid_pallas=True,
                           precision="fp32")
        runner = Runner(fgcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fgcfg.seed))
        reset_counts()
        runner.train()
        torch.cuda.synchronize()
        grid_fp32_launches = (gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        losses = logged_losses(runner)
        print(f"{GRID_FP32_STEPS} steps: grid launches forward {grid_fp32_launches[0]}, backward "
              f"{grid_fp32_launches[1]} (expected {2 * GRID_FP32_STEPS} each), MLP "
              f"{mlp_counts()}; losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if grid_fp32_launches != (2 * GRID_FP32_STEPS,) * 2 or any(mlp_counts()):
            raise AssertionError("lego_grid at fp32 did not run the fp32 grid kernels as expected")
        if len(losses) != GRID_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_grid at fp32: not every loss is finite")
        del runner

        phase("lego_fast with GRID_PALLAS, 10 steps (MLP fine field, proposal grid)")
        fast = run_config("lego_fast", tmp, "fast", FAST_STEPS, grid_pallas=True)
        runner = Runner(fast, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fast.seed))
        reset_counts()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        fast_launches = (*mlp_counts(), gk.grid_rays.launches, gk.grid_rays_bwd.launches)
        losses = logged_losses(runner)
        print(f"{fast.precision}, {fast.n_coarse}+{fast.n_fine} samples, {FAST_STEPS} steps in "
              f"{fast_s:.2f} s: launches MLP forward {fast_launches[0]}, backward "
              f"{fast_launches[1]}, flat {fast_launches[2]}; grid forward {fast_launches[3]}, "
              f"backward {fast_launches[4]} (expected {FAST_STEPS} each, 1 flat for the refresh "
              f"at 0); losses {losses[0]:.2f} .. {losses[-1]:.2f}")
        if fast_launches != (FAST_STEPS, FAST_STEPS, 1, FAST_STEPS, FAST_STEPS):
            raise AssertionError("lego_fast did not run kernels 1-3, 5 and 6 as expected")
        if len(losses) != FAST_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_fast: not every loss is finite")
        del runner

        prop_counts = lambda: (pk.prop_rays.launches, pk.prop_rays_bwd.launches)

        def reset_all():
            reset_counts()
            pk.prop_rays.launches = pk.prop_rays_bwd.launches = 0

        # ---- 13. the lego_prop training path, PROP_FIELD = mlp and PROP_PALLAS ----
        phase("lego_prop training path (PROP_FIELD = mlp, PROP_PALLAS, bf16)")
        pcfg = run_config("lego_prop", tmp, "prop", PROP_STEPS, prop_field="mlp",
                          prop_pallas=True)
        runner = Runner(pcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=pcfg.seed))
        n_net = mlp.num_params(runner.params["net"])
        n_prop_net = mlp.num_params(runner.params["prop"])
        print(f"{pcfg.precision}, BATCH_RAY {pcfg.batch_ray}, {pcfg.n_coarse}+{pcfg.n_fine} "
              f"samples, USE_PALLAS {pcfg.use_pallas}; net 8x256 ({n_net:,} params); proposal "
              f"MLP {pcfg.proposal_width}x{pcfg.proposal_depth}, PROPOSAL_ENC_L "
              f"{pcfg.proposal_enc_l} ({n_prop_net:,} params); OCC_GRID {pcfg.occ_grid}, "
              f"WHITE_BKGD {pcfg.white_bkgd}")
        if (n_net, n_prop_net) != (593_924, 57_932):
            raise AssertionError("lego_prop's fields are not at full width")
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prop_launches = prop_counts()
        prop_mlp_launches = mlp_counts()
        print(f"Runner.train(): {PROP_STEPS} steps of {pcfg.batch_ray} rays in {seconds:.2f} s "
              f"({seconds / PROP_STEPS * 1e3:.2f} ms/step, first steps included); launches: "
              f"proposal forward {prop_launches[0]}, backward {prop_launches[1]}; field forward "
              f"{prop_mlp_launches[0]}, backward {prop_mlp_launches[1]}, flat "
              f"{prop_mlp_launches[2]} (expected {PROP_STEPS} of each but flat, 0 flat); grid "
              f"{(gk.grid_rays.launches, gk.grid_rays_bwd.launches)}")
        if (prop_launches + prop_mlp_launches != (PROP_STEPS,) * 4 + (0,)
                or gk.grid_rays.launches or gk.grid_rays_bwd.launches):
            raise AssertionError("the lego_prop path did not run kernels 1, 2, 7 and 8 "
                                 "once each a step")
        losses = logged_losses(runner)
        if len(losses) != PROP_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{len(losses)} logged losses, not all finite")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss: mean of the first 10 steps {first:.4f}, of the last 10 {last:.4f} "
              f"(step 0 {losses[0]:.4f}, step {PROP_STEPS - 1} {losses[-1]:.4f})")
        if not last < first:
            raise AssertionError("the lego_prop loss did not fall")

        step = train.make_train_step(pcfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        prop_ms = (time.perf_counter() - t0) / 6 * 1e3
        prop_kern = (bf16_fwd_time[4096, pcfg.n_fine][0] + bf16_bwd_time[4096, pcfg.n_fine][0]
                     + prop_fwd_time["bf16"][PROP_SHAPE][0] + prop_bwd_time["bf16"][PROP_SHAPE][0])
        print(f"BATCH_RAY {pcfg.batch_ray}: {prop_ms / 1e3:.5f} s/step, "
              f"{pcfg.batch_ray / prop_ms * 1e3:,.0f} rays/s; kernels 1, 2, 7 and 8 "
              f"{prop_kern:.3f} ms of it ({100 * prop_kern / prop_ms:.1f}%: one launch of each "
              "at its timed bf16 per-launch ms)")
        profile_steps(step, state)

        # one step on fields with content: kernels 1, 2, 7, 8 vs their plain versions
        content = optim.tree_map(lambda t: t.clone(), runner.params)
        content["net"]["sigma"]["b"] += 1.0
        content["prop"]["sigma"]["b"] += 1.0
        batch = runner.train_table.sample(torch.Generator(device=dev).manual_seed(4),
                                          pcfg.batch_ray)
        plain_bf16 = functools.partial(mk.field_flat_plain, precision=pcfg.precision)
        ref_prop = reference_prop_field(pcfg.precision)
        _, _, g_k = train.loss_and_grads(train.make_loss_fn(pcfg, runner.k_inv), content, batch)
        _, _, g_p = train.loss_and_grads(train.make_loss_fn(pcfg, runner.k_inv, plain_bf16,
                                                            ref_prop), content, batch)
        prop_cos = part_cosines(g_k, g_p)
        print("one bf16 step, kernels 1, 2, 7 and 8 vs their plain versions (sigma biases +1): "
              "gradient cosines " + ", ".join(f"{k} {v:.7f}" for k, v in prop_cos.items())
              + f" (limit {BF16_COS})")
        if min(prop_cos.values()) < BF16_COS:
            raise AssertionError("the lego_prop kernels' training gradient disagrees with the "
                                 "plain versions'")
        prop_iter = runner.state.iteration - 1
        ckpt.save_checkpoint(pcfg.ckpt_path, "smoke", prop_iter, runner.params,
                             runner.state.opt, generator=runner.state.generator)
        trained_prop = runner.params["prop"]["trunk_1"]["w"]
        del runner, state, step, g_k, g_p, content

        # ---- 14. the lego_prop render path, from that checkpoint ----
        phase("lego_prop render path (PROP_FIELD = mlp, PROP_PALLAS)")
        pcfg.continue_ = True
        scene = blender_scene(n_views=2, hw=800, seed=pcfg.seed)
        runner = Runner(pcfg, device="cuda", scene=scene)
        if runner.last_iter != prop_iter or not torch.equal(
                runner.params["prop"]["trunk_1"]["w"], trained_prop):
            raise AssertionError("Runner did not resume the lego_prop checkpoint")
        expected = n_chunks * scene.images.shape[0]
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = evallib.render_test_set(
            pcfg, runner.params, runner.test_table, runner.k_inv, runner.start_time,
            runner.last_iter, save=False)
        torch.cuda.synchronize()
        prop_frame_s = (time.perf_counter() - t0) / frames.shape[0]
        prop_render_launches = prop_counts()[0]
        prop_render_field = mlp_counts()[0]
        print(f"rendered {frames.shape[0]} views of {scene.height}x{scene.width} from the "
              f"iteration-{prop_iter} checkpoint: {prop_frame_s:.3f} s/frame; proposal forward "
              f"launches {prop_render_launches}, field forward {prop_render_field} (expected "
              f"{expected} each = {n_chunks} chunks x {frames.shape[0]} views); backward "
              f"{prop_counts()[1]}, {mlp_counts()[1]}")
        if (prop_counts(), mlp_counts()) != ((expected, 0), (expected, 0, 0)):
            raise AssertionError("the lego_prop render path did not run kernels 7 and 1 (and "
                                 "only them) on every chunk")
        if not (frames.shape == (2, scene.height, scene.width, 3) and np.all(np.isfinite(frames))
                and frames.min() >= 0 and frames.max() <= 1):
            raise AssertionError("the lego_prop frame is not finite values in [0, 1]")
        print(f"frame mean {frames.mean():.4f}, std {frames.std():.4f}")
        with torch.no_grad():
            span = slice((n_chunks // 2) * pcfg.render_chunk,
                         (n_chunks // 2 + 1) * pcfg.render_chunk)
            idx = torch.arange(num_pix, device=dev)[span]
            rows, cols = (idx // scene.width).float(), (idx % scene.width).float()
            pose = runner.test_table.poses[0].expand(rows.shape[0], 17)
            args = (rows, cols, pose, runner.k_inv, pcfg.n_coarse, pcfg.n_fine)
            kw = dict(prop_params=runner.params["prop"])
            kern_net, kern_prop = evallib.make_field_fn(pcfg), evallib.make_prop_field_fn(pcfg)
            _, c_kernel = render.render_rays(runner.params["net"], *args, field_fn=kern_net,
                                             prop_field_fn=kern_prop, **kw)
            _, c_plain = render.render_rays(runner.params["net"], *args, field_fn=plain_bf16,
                                            prop_field_fn=ref_prop, **kw)
            prop_pix_err = float((c_kernel - c_plain).abs().max())
            print(f"real chunk, kernels 1 and 7 vs their plain versions (bf16): max |pixel err| "
                  f"{prop_pix_err:.3e}, mean {float((c_kernel - c_plain).abs().mean()):.3e} "
                  f"(atol {BF16_CHUNK_ATOL})")
            if not prop_pix_err <= BF16_CHUNK_ATOL:
                raise AssertionError("the lego_prop kernels' render disagrees with the plain "
                                     "render")
            profile_calls(lambda: render.render_rays(runner.params["net"], *args,
                                                     field_fn=kern_net, prop_field_fn=kern_prop,
                                                     **kw), 5, "chunks")
        del runner

        # ---- 15. lego_prop at fp32, 10 steps ----
        phase("lego_prop at PRECISION=fp32, 10 steps (the fp32 forms of kernels 7 and 8)")
        fpcfg = run_config("lego_prop", tmp, "prop_fp32", PROP_FP32_STEPS, prop_field="mlp",
                           prop_pallas=True, precision="fp32")
        runner = Runner(fpcfg, device="cuda",
                        scene=blender_scene(n_views=TRAIN_VIEWS, hw=800, seed=fpcfg.seed))
        reset_all()
        runner.train()
        torch.cuda.synchronize()
        prop_fp32_launches = prop_counts()
        prop_fp32_field = mlp_counts()
        losses = logged_losses(runner)
        print(f"{PROP_FP32_STEPS} steps: proposal launches forward {prop_fp32_launches[0]}, "
              f"backward {prop_fp32_launches[1]}; field forward {prop_fp32_field[0]}, backward "
              f"{prop_fp32_field[1]} (expected {PROP_FP32_STEPS} each); losses {losses[0]:.2f} "
              f".. {losses[-1]:.2f}")
        if prop_fp32_launches + prop_fp32_field != (PROP_FP32_STEPS,) * 4 + (0,):
            raise AssertionError("lego_prop at fp32 did not run the fp32 kernels as expected")
        if len(losses) != PROP_FP32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("lego_prop at fp32: not every loss is finite")
        del runner

    # ---- 16. results ----
    mean = lambda table, shapes, i: sum(table[s][i] for s in shapes) / len(shapes)
    shape_key = lambda s: f"B={s[0]},N={s[1]}" if len(s) == 2 else f"R={s[0]}"
    render_shapes = [(4096, 64), (4096, 128)]
    times = lambda table: {shape_key(s): dict(zip(("ms", "plain_ms", "bound_ms"), t[:3]))
                           for s, t in table.items()}

    def form(name, source, replaces, launches, by_path, err, table, shapes, extra=None):
        """One kernel form's entry: ms, plain_ms and bound_ms per launch,
        averaged over the main path's shapes, which it launches equally often."""
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "launches_by_path": by_path, "max_abs_err": err,
                 "ms": mean(table, shapes, 0), "plain_ms": mean(table, shapes, 1),
                 "bound_ms": mean(table, shapes, 2),
                 "bound_by": table[shapes[0]][3] if len(table[shapes[0]]) > 3 else "operations",
                 "library_ms": None}
        if len(table[shapes[0]]) > 4:
            entry["bound_f32_fma_ms"] = mean(table, shapes, 4)
        entry.update(extra or {})
        entry["shapes"] = times(table)
        return entry

    fwd_src, bwd_src = "tinynerf_torch/csrc/field_rays_fwd.cu", "tinynerf_torch/csrc/field_rays_bwd.cu"
    flat_src = "tinynerf_torch/csrc/field_flat_fwd.cu"
    flat = lambda precision: {(R,): flat_time[R, precision] for R in FLAT_ROWS[:2]}
    # no single PyTorch call computes any of these fused functions: library_ms is null
    kernels = [
        form("field_rays_fwd", fwd_src, "tinynerf/kernels/mlp_kernel.py:720",
             train_launches[0] + render_launches + fp32_launches[0] + prop_fp32_field[0],
             {"lego train": train_launches[0], "lego render": render_launches,
              "lego_occ fp32 train": fp32_launches[0],
              "lego_prop fp32 train": prop_fp32_field[0]},
             fwd_err, fwd_time, render_shapes),
        form("field_rays_fwd_bf16", fwd_src, "tinynerf/kernels/mlp_kernel.py:720",
             occ_launches[0] + occ_render_launches + fast_launches[0] + prop_mlp_launches[0]
             + prop_render_field,
             {"lego_occ train": occ_launches[0], "lego_occ render": occ_render_launches,
              "lego_fast train": fast_launches[0], "lego_prop train": prop_mlp_launches[0],
              "lego_prop render": prop_render_field},
             bf16_fwd_err, bf16_fwd_time, list(OCC_SHAPES)),
        form("field_rays_bwd", bwd_src, "tinynerf/kernels/mlp_kernel.py:751",
             train_launches[1] + fp32_launches[1] + prop_fp32_field[1],
             {"lego train": train_launches[1], "lego_occ fp32 train": fp32_launches[1],
              "lego_prop fp32 train": prop_fp32_field[1]},
             bwd_abs, bwd_time, STEP_SHAPES, {"max_rel_err": bwd_rel}),
        form("field_rays_bwd_bf16", bwd_src, "tinynerf/kernels/mlp_kernel.py:751",
             occ_launches[1] + fast_launches[1] + prop_mlp_launches[1],
             {"lego_occ train": occ_launches[1], "lego_fast train": fast_launches[1],
              "lego_prop train": prop_mlp_launches[1]},
             bf16_bwd_abs, bf16_bwd_time, list(OCC_SHAPES), {"max_rel_err": bf16_bwd_rel}),
        form("field_flat_fwd", flat_src, "tinynerf/kernels/mlp_kernel.py:269",
             fp32_launches[2], {"lego_occ fp32 train": fp32_launches[2]},
             flat_err["fp32"], flat("fp32"), [(FLAT_ROWS[0],)]),
        form("field_flat_fwd_bf16", flat_src, "tinynerf/kernels/mlp_kernel.py:269",
             occ_launches[2] + fast_launches[2],
             {"lego_occ train": occ_launches[2], "lego_fast train": fast_launches[2]},
             flat_err["bf16"], flat("bf16"), [(FLAT_ROWS[0],)]),
    ]
    gfwd_src, gbwd_src = ("tinynerf_torch/csrc/grid_rays_fwd.cu",
                          "tinynerf_torch/csrc/grid_rays_bwd.cu")
    grid_shapes = [(B, N) for _, B, N in GRID_SHAPES]
    rows = {"flops_per_row": {g: gk.flops_per_row(*dims) for g, dims in GRID.items()},
            "hat_flops_per_row": {g: gk.hat_flops_per_row(*dims) for g, dims in GRID.items()}}
    kernels += [
        form("grid_rays_fwd", gfwd_src, "tinynerf/kernels/grid_kernel.py:309",
             grid_fp32_launches[0], {"lego_grid fp32 train": grid_fp32_launches[0]},
             grid_err["fwd fp32"], grid_fwd_time["fp32"], grid_shapes, rows),
        form("grid_rays_fwd_bf16", gfwd_src, "tinynerf/kernels/grid_kernel.py:309",
             grid_launches[0] + grid_render_launches + fast_launches[3],
             {"lego_grid train": grid_launches[0], "lego_grid render": grid_render_launches,
              "lego_fast train": fast_launches[3]},
             grid_err["fwd bf16"], grid_fwd_time["bf16"], grid_shapes, rows),
        form("grid_rays_bwd", gbwd_src, "tinynerf/kernels/grid_kernel.py:344",
             grid_fp32_launches[1], {"lego_grid fp32 train": grid_fp32_launches[1]},
             grid_err["bwd fp32"], grid_bwd_time["fp32"], grid_shapes,
             {"max_rel_err": grid_rel["bwd fp32"]}),
        form("grid_rays_bwd_bf16", gbwd_src, "tinynerf/kernels/grid_kernel.py:344",
             grid_launches[1] + fast_launches[4],
             {"lego_grid train": grid_launches[1], "lego_fast train": fast_launches[4]},
             grid_err["bwd bf16"], grid_bwd_time["bf16"], grid_shapes,
             {"max_rel_err": grid_rel["bwd bf16"]}),
    ]
    pfwd_src, pbwd_src = ("tinynerf_torch/csrc/prop_rays_fwd.cu",
                          "tinynerf_torch/csrc/prop_rays_bwd.cu")
    prop_rows = {"flops_per_row": pk.flops_per_row(*PROP_NETS["128x4"])}
    kernels += [
        form("prop_rays_fwd", pfwd_src, "tinynerf/kernels/proposal_kernel.py:255",
             prop_fp32_launches[0], {"lego_prop fp32 train": prop_fp32_launches[0]},
             prop_err["fwd fp32"], prop_fwd_time["fp32"], [PROP_SHAPE], prop_rows),
        form("prop_rays_fwd_bf16", pfwd_src, "tinynerf/kernels/proposal_kernel.py:255",
             prop_launches[0] + prop_render_launches,
             {"lego_prop train": prop_launches[0], "lego_prop render": prop_render_launches},
             prop_err["fwd bf16"], prop_fwd_time["bf16"], [PROP_SHAPE], prop_rows),
        form("prop_rays_bwd", pbwd_src, "tinynerf/kernels/proposal_kernel.py:285",
             prop_fp32_launches[1], {"lego_prop fp32 train": prop_fp32_launches[1]},
             prop_err["bwd fp32"], prop_bwd_time["fp32"], [PROP_SHAPE],
             {**prop_rows, "max_rel_err": prop_rel["bwd fp32"]}),
        form("prop_rays_bwd_bf16", pbwd_src, "tinynerf/kernels/proposal_kernel.py:285",
             prop_launches[1], {"lego_prop train": prop_launches[1]},
             prop_err["bwd bf16"], prop_bwd_time["bf16"], [PROP_SHAPE],
             {**prop_rows, "max_rel_err": prop_rel["bwd bf16"]}),
    ]
    print(json.dumps({"train_step": {str(b): {"ms": t[0], "kernel_ms": t[1]}
                                     for b, t in step_time.items()},
                      "lego_occ": {"step_ms": occ_ms, "kernel_ms": occ_kern,
                                   "refresh_ms": refresh_ms, "frame_s": occ_frame_s,
                                   "march_ms_per_chunk": march_ms,
                                   "grid_shares": shares},
                      "lego_grid": {"step_ms": grid_ms, "kernel_ms": grid_kern,
                                    "frame_s": grid_frame_s, "grid_shares": grid_shares_after,
                                    "grad_cosines": grid_cos, "chunk_pix_err": grid_pix_err},
                      "lego_fast": {"seconds_10_steps": fast_s},
                      "lego_prop": {"step_ms": prop_ms, "kernel_ms": prop_kern,
                                    "frame_s": prop_frame_s, "grad_cosines": prop_cos,
                                    "chunk_pix_err": prop_pix_err}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
