#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tinynerf_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It

1. prints the card (name, count, and ``nvidia-smi``'s name and power limit);
2. builds every CUDA kernel from ``tinynerf_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints each build's time and ``ptxas``'
   register/shared-memory report;
3. holds each kernel against its plain PyTorch version on the card, on
   dyadic inputs at the main paths' shapes (tolerances below): the field
   forward (kernel 1) at the render chunk's B=4096, and the field's
   recompute backward (kernel 2) at the training step's B=400 and at
   B=4096, N=64 and 128, every gradient within 1e-4 of max|plain|;
4. times each kernel and its plain version with CUDA events, beside the
   kernel's bound (the least time the card could take for the same work);
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
7. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.


Any failure raises, and the script exits non-zero without the last line. It
exits non-zero at once where ``torch.cuda.is_available()`` is false. It
imports nothing of JAX or of the ``tinynerf`` package.
"""

from __future__ import annotations

import dataclasses
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
PEAK_BYTES = 3.35e12        # HBM3
COLOR_ATOL = 1e-5
SIGMA_ATOL = 1e-4
SIGMA_RTOL = 1e-4
CHUNK_ATOL = 1e-4           # rendered pixels, kernel field vs plain field
BWD_RTOL = 1e-4             # kernel 2: every gradient, error / max|plain|
MARGIN = 2e-6               # rows this close to a ReLU's kink get no cotangent
GRAD_COS = 0.9999           # a training step's gradient, kernels vs plain field
TRAIN_STEPS = 200
TRAIN_VIEWS = 4
STEP_SHAPES = ((400, 64), (400, 128))    # the field calls of a lego step


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


def flat_grads(grads):
    import torch
    return torch.cat([grads[n][k].flatten() for n in grads for k in ("w", "b")])


def profile_steps(step, state, n: int = 5) -> None:
    """Trace ``n`` training steps with torch.profiler; print the device time
    by kernel (top 12) and the device's busy share of the steps' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op (an autograd node, a ctypes launch)
    # also carries the device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print(f"profile: {n} steps in {wall_ms:.2f} ms of wall time; the profiler "
              "recorded no device time (device busy share not measured)")
        return
    device_ms = sum(r[2] for r in rows)
    print(f"profile: {n} steps in {wall_ms:.2f} ms of wall time; device busy "
          f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - device_ms / wall_ms):.1f}%); per step {device_ms / n:.3f} ms "
          f"on the device in {sum(r[1] for r in rows) / n:.0f} launches")
    for name, calls, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {ms / n:9.3f} ms/step  {calls // n:5d}/step  {name[:90]}")


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
    from tinynerf_torch.core import mlp, rays as raylib, render, sampling
    from tinynerf_torch.kernels import build
    from tinynerf_torch.kernels import mlp_kernel as mk
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
            mk.BWD_SOURCE: mk._library(mk.BWD_SOURCE).field_rays_bwd_smem_bytes()}
    for source in (mk.FWD_SOURCE, mk.BWD_SOURCE):
        info = build.build_log[source]
        print(f"{source}: nvcc {info['seconds']:.1f} s; dynamic smem of the "
              f"main kernel {smem[source]} B/block")
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

    # ---- 7. results ----
    mean = lambda table, shapes, i: sum(table[s][i] for s in shapes) / len(shapes)
    shape_key = lambda B, N: f"B={B},N={N}"
    render_shapes = [(4096, 64), (4096, 128)]
    kernels = [{
        "name": "field_rays_fwd",
        "route": "cuda",
        "source": "tinynerf_torch/csrc/field_rays_fwd.cu",
        "replaces": "tinynerf/kernels/mlp_kernel.py:720",
        "launches": train_launches[0] + render_launches,
        "launches_by_path": {"train": train_launches[0], "render": render_launches},
        "max_abs_err": fwd_err,
        # per launch, averaged over the render path's two shapes (B=4096,
        # N=64 and 128), which it launches equally often
        "ms": mean(fwd_time, render_shapes, 0),
        "plain_ms": mean(fwd_time, render_shapes, 1),
        "bound_ms": mean(fwd_time, render_shapes, 2),
        "bound_by": "operations",
        "library_ms": None,
        "shapes": {shape_key(*s): dict(zip(("ms", "plain_ms", "bound_ms"), t))
                   for s, t in fwd_time.items()},
    }, {
        "name": "field_rays_bwd",
        "route": "cuda",
        "source": "tinynerf_torch/csrc/field_rays_bwd.cu",
        "replaces": "tinynerf/kernels/mlp_kernel.py:751",
        "launches": train_launches[1],
        "launches_by_path": {"train": train_launches[1]},
        "max_abs_err": bwd_abs,
        "max_rel_err": bwd_rel,
        # per launch, averaged over a training step's two shapes (B=400,
        # N=64 and 128), which it launches once each per step
        "ms": mean(bwd_time, STEP_SHAPES, 0),
        "plain_ms": mean(bwd_time, STEP_SHAPES, 1),
        "bound_ms": mean(bwd_time, STEP_SHAPES, 2),
        "bound_by": "operations",
        "library_ms": None,
        "shapes": {shape_key(*s): dict(zip(("ms", "plain_ms", "bound_ms"), t))
                   for s, t in bwd_time.items()},
    }]
    print(json.dumps({"train_step": {str(b): {"ms": t[0], "kernel_ms": t[1]}
                                     for b, t in step_time.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
