#!/usr/bin/env python3
"""Times and output digests of one tree's kernel forms, on one CUDA card.

    cd <tree> && python3 <this checkout>/tests/kernel_times.py [label]

It imports ``tinynerf_torch`` from the current directory, so that one call
on one card can time a parent tree (unpacked with ``git archive``) and the
change in turns (parent, change, change, parent, ...). Each form is timed
as ``chip_smoke.py`` phase 4 times it (CUDA events around the wrapper's
call, at its shapes, on its seeded inputs), and a sha256 of its outputs is
printed beside the time, so that two trees' launches can be held bit for
bit. The forms: the proposal MLP's kernels 7 and 8 at conf/lego_prop.ini's
128 x 4, B = 4096, N = 64, in fp32 and bf16 (kernel 8 with and without the
rays' gradients); the fp32 forms that share their tiles, kernels 1 (B =
4096, N = 64 and 128), 3 (R = 524,288) and 9 (B = 4096, 64 + 128 samples)
on field_common.cuh's gemm_segment, kernels 2 (B = 400 and 4096, N = 128),
4 (R = 524,288) and 10 (from kernel 9's residuals) on fma_common.cuh's
gemm_f32; where the tree's ``proposal_kernel.bwd_phase_split`` takes the
form, kernel 8's phase split; and a step of ``lego_prop`` at fp32 with
``PROP_FIELD = mlp`` and ``PROP_PALLAS`` (chip_smoke.py phase 15's, s/step
over 6 steps after 2). The last line is one JSON object of it all, with
the label and the card's name and power limit. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def flat(grads):
    return [grads[n][k] for n in grads for k in ("w", "b")]


def planes(out):
    """((r, g, b), sigma) -> [r, g, b, sigma]"""
    return [*out[0], out[1]]


def grads_and(out):
    """(grads, *tensors) -> every gradient, then the tensors"""
    return flat(out[0]) + list(out[1:])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())   # the tree under test
    import importlib.util
    import numpy as np
    # chip_smoke.py's helpers and shapes, from this checkout
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tinynerf_torch import train
    from tinynerf_torch.core import mlp, proposal
    from tinynerf_torch.kernels import build
    from tinynerf_torch.kernels import mlp_kernel as mk
    from tinynerf_torch.kernels import proposal_kernel as pk
    from tinynerf_torch.kernels import render_kernel as rk
    from tinynerf_torch.runner import Runner

    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"{label}: tinynerf_torch from {os.path.dirname(mk.__file__)}; {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    build.build_all(variants=[(pk.BWD_SOURCE, pk.PHASE_DEFINES)])
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"label": label, "card": smi, "ms": {}, "digest": {}}

    def record(name, fn, iters, warmup=1):
        with torch.no_grad():
            res = fn()
            torch.cuda.synchronize()
            out["digest"][name] = digest(*res)
            out["ms"][name] = cs.cuda_ms(fn, iters=iters, warmup=warmup)
        print(f"{name}: {out['ms'][name]:.4f} ms, digest {out['digest'][name]}", flush=True)

    rng = np.random.default_rng(0)
    rays = lambda B, N: tuple(torch.from_numpy(a).to(dev) for a in cs.dyadic_rays(rng, B, N))
    cots = lambda shape: [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                          for _ in range(4)]

    # kernels 7 and 8 at lego_prop's proposal call
    width, depth = cs.PROP_NETS["128x4"]
    params_p = proposal.init_proposal(torch.Generator().manual_seed(0), width, depth, device=dev)
    o, d, ts = rays(*cs.PROP_SHAPE)
    g = cots(ts.shape)
    for precision in ("fp32", "bf16"):
        record(f"k7 {precision}", lambda: planes(pk.prop_rays(params_p, o, d, ts, precision)),
               20)
        for rays_on in (True, False):
            def bwd():
                grads, *ray_g = pk.prop_rays_bwd(params_p, o, d, ts, *g, precision=precision,
                                                 ray_grads=rays_on)
                return flat(grads) + ray_g
            record(f"k8 {precision}{'' if rays_on else ' no ray grads'}", bwd, 10)
        try:
            split = pk.bwd_phase_split(params_p, o, d, ts, *g, precision=precision)
        except ValueError as err:   # a tree whose variant has no clocks in this form
            split = str(err)
        out.setdefault("k8 phase split", {})[precision] = split
        print(f"k8 {precision} phase split: {split}", flush=True)

    # the fp32 forms on the field kernels' tiles
    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    for B, N in ((4096, 64), (4096, 128)):
        o1, d1, t1 = rays(B, N)
        record(f"k1 fp32 {B}x{N}", lambda: planes(mk.field_rays(params, o1, d1, t1)), 10)
    for B, N in ((400, 128), (4096, 128)):
        o2, d2, t2 = rays(B, N)
        g2 = cots(t2.shape)
        record(f"k2 fp32 {B}x{N}",
               lambda: grads_and(mk.field_rays_bwd(params, o2, d2, t2, *g2)), 5)
    R = cs.FLAT_BWD_ROWS[0]
    pts = torch.from_numpy(rng.uniform(-1, 1, (R, 3)).astype(np.float32)).to(dev)
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(R, 3)).astype(np.float32)).to(dev), dim=-1).contiguous()
    g4 = torch.from_numpy(rng.normal(size=(R, 4)).astype(np.float32)).to(dev)
    record("k3 fp32 R=524288", lambda: list(mk.field_flat(params, pts, dirs)), 10)
    record("k4 fp32 R=524288", lambda: grads_and(mk.field_flat_bwd(params, pts, dirs, g4)), 3)
    args = cs.fused_rays(dev, 4096, seed=5)
    n_f = cs.FUSED_SAMPLES[1]
    gf = [torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)).to(dev)
          for _ in range(2)]
    record("k9 fp32 4096 64+128", lambda: list(rk.render_fused(params, *args, n_f, False,
                                                               "fp32")), 5)
    res = rk.render_fused_residuals(params, *args, n_f, False, "fp32")[2]
    record("k10 fp32 4096 64+128", lambda: flat(rk.render_fused_bwd(
        params, *args, *gf, n_f, False, "fp32", residuals=res)), 3)
    del res, pts, dirs, g4
    torch.cuda.empty_cache()

    # a lego_prop step at fp32 (chip_smoke.py phase 15)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cs.run_config("lego_prop", tmp, "prop_fp32", cs.PROP_FP32_STEPS,
                            prop_field="mlp", prop_pallas=True, precision="fp32")
        runner = Runner(cfg, device="cuda",
                        scene=cs.blender_scene(n_views=cs.TRAIN_VIEWS, hw=800, seed=cfg.seed))
        step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
        state = runner.state
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state)
        torch.cuda.synchronize()
        out["lego_prop fp32 step ms"] = (time.perf_counter() - t0) / 6 * 1e3
    print(f"lego_prop fp32 step: {out['lego_prop fp32 step ms']:.3f} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
