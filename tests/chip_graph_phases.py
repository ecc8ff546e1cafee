"""``chip_smoke.py``'s phase 30 alone, on the card, for iterating on the CUDA
graphs (``tinynerf_torch/graphs.py``) without the whole smoke test.

    python3 tests/chip_graph_phases.py            # phase 30: paths, frames, the CLI run
    python3 tests/chip_graph_phases.py --sweep    # and every other config's chunk and frame

Builds the kernels, then runs ``chip_smoke.graph_phases`` and prints its
numbers. ``--sweep`` first takes two chunks of 3 steps, each step against
the eager tensor-rate step, and two frames (one graph a view) of 128x128
on every config that ``chip_smoke.py`` trains through ``Runner.train``
besides phase 30's paths, printing each one's result and going on after a
failure; it exits non-zero if any failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, conf, overrides, llff scene: None, "outward" or "forward")
SWEEP = (("lego_occ_fp32", "lego_occ", {"precision": "fp32"}, None),
         ("lego_grid_fp32", "lego_grid", {"grid_pallas": True, "precision": "fp32"}, None),
         ("lego_fast", "lego_fast", {"grid_pallas": True}, None),
         ("lego_prop_fp32", "lego_prop", {"prop_field": "mlp", "prop_pallas": True,
                                          "precision": "fp32"}, None),
         ("lego_levels", "lego_levels", {}, None),
         ("lego_fold", "lego_fold", {}, None),
         ("lego_coarse", "lego_coarse", {}, None),
         ("lego_fused", "lego", {"fused_render": True}, None),
         ("texture", "texture", {}, None),
         ("unbounded360", "unbounded360", {}, "outward"),
         ("synthetic360", "synthetic360", {}, "outward"),
         ("u360_mlp_occ", "unbounded360", {"fine_field": "mlp", "occ_grid": True, "occ_res": 64,
                                           "occ_march_res": 16, "occ_march_steps": 32,
                                           "occ_subset": 0.125}, "outward"),
         ("u360_mlp_prop", "unbounded360", {"fine_field": "mlp", "prop_field": "mlp",
                                            "prop_pallas": True}, "outward"),
         ("u360_mlp_fp32", "unbounded360", {"fine_field": "mlp", "precision": "fp32"},
          "outward"),
         ("fern_ndc", "fern_ndc", {}, "forward"),
         ("fern_ndc_fused", "fern_ndc", {"fused_render": True}, "forward"))


def sweep(tmp: str) -> bool:
    import numpy as np
    import torch
    import chip_smoke as cs
    from tinynerf_torch import eval as evallib, train
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.runner import Runner
    dev = torch.device("cuda:0")
    ok = True
    for name, conf, kw, llff in SWEEP:
        t0 = time.perf_counter()
        try:
            cfg = cs.run_config(conf, tmp, f"sweep_{name}", 6, **kw)
            if cfg.occ_grid:
                cfg.occ_update_every = 2
            scene = (cs.blender_scene(cs.TRAIN_VIEWS, 128, cfg.seed) if llff is None else
                     cs.llff_capture(4, cfg.seed, outward=llff == "outward", hw=(108, 144)))
            runner = Runner(cfg, device="cuda", scene=scene)
            step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
            s0 = cs.clone_state(runner.state)
            eager = cs.clone_state(s0)
            rates = train.chunk_rates(cfg, eager, 6)[0].to(dev)
            losses = []
            for k in range(6):
                eager, m = step(eager, rates=rates[k])
                losses.append(m["loss"])
            chunk = train.make_chunked_step(step, 3)
            g, m1 = chunk(cs.clone_state(s0))
            g, m2 = chunk(g)
            graphed = torch.cat([m1["loss"], m2["loss"]])
            bit = bool(torch.equal(graphed, torch.stack(losses)))
            rel = float(((graphed - torch.stack(losses)).abs() / torch.stack(losses).abs()).max())
            k_inv = make_k_inv(scene.height, scene.width, scene.focal, dev)
            fn = evallib.make_frame_fn(cfg, k_inv, scene.height, scene.width,
                                       occ_grid=g.occ, ndc_params=runner.ndc_params)
            pose = np.asarray(runner.train_table.poses[0].cpu().numpy())
            a, b = fn(g.params, pose), fn(g.params, pose)
            print(f"SWEEP {name}: OK in {time.perf_counter() - t0:.1f} s; losses "
                  f"{'bit-identical' if bit else f'max rel {rel:.2e}'}; "
                  f"stats {chunk.graphs.stats}; frame replay bit-identical "
                  f"{bool(np.array_equal(a, b))}", flush=True)
            if not (np.array_equal(a, b) and torch.isfinite(graphed).all() and rel < 1e-2):
                ok = False
        except Exception:
            ok = False
            print(f"SWEEP {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            print("".join(traceback.format_exc().splitlines(True)[-12:]), flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-phase", action="store_true", help="the sweep alone")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import subprocess
    import torch
    import chip_smoke as cs
    from tinynerf_torch.kernels import build
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        if args.sweep:
            ok = sweep(tmp)
        if not args.no_phase:
            out = cs.graph_phases(tmp)
            print(json.dumps({k: v for k, v in out.items()}, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
