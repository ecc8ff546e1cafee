"""Capture and summarize a profile of the port's training step.

The port's counterpart of ``tools/profile_step.py``: the same flags and the
same synthetic scene (4 views of 400x400 uniform noise, cameras at z = 4,
near/far 2/6), ``train.make_train_step`` warmed up, then ``--steps`` steps
under ``torch.profiler`` with CUDA activity on the card. It prints the
device time per step by kernel (the top 18: ms, launches, name) and the
device's busy share of the steps' wall time (``profiling.device_rows``,
``profiling.print_profile``), and leaves the Chrome trace (Perfetto,
``chrome://tracing``) under ``--out``. On the card unless ``--device cpu``,
where the table is the ops' self CPU time and no busy share is measured.

    python -m tinynerf_torch.tools.profile_step [--batch 4096] [--steps 5] [--occ]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Profile the port's training step.")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--coarse", type=int, default=64)
    ap.add_argument("--fine", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--occ", action="store_true")
    ap.add_argument("--proposal", action="store_true")
    ap.add_argument("--grid", action="store_true",
                    help="FINE_FIELD=grid (factorized CP feature grid)")
    ap.add_argument("--grid-pallas", action="store_true",
                    help="the CP grid's kernels (GRID_PALLAS)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="KEY=VALUE",
                    help="override any INI config key (repeatable)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "tinynerf_trace"))
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from tinynerf_torch import profiling, train as trainlib
    from tinynerf_torch.config import Config, apply_key
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.data.poses import SceneData
    from tinynerf_torch.data.rays import RayTable
    from tinynerf_torch.device import resolve_device

    device = resolve_device(args.device)
    seed = int.from_bytes(os.urandom(4), "little")
    rng = np.random.default_rng(1)
    n_pics, hw = 4, 400
    images = rng.uniform(0, 1, (n_pics, hw, hw, 3)).astype(np.float32)
    pose_rows = np.zeros((n_pics, 17), np.float32)
    focal = 0.5 * hw / np.tan(0.4)
    for i in range(n_pics):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0, 0, 4.0]
        hwf = np.array([[hw], [hw], [focal]], np.float32)
        pose_rows[i] = np.concatenate(
            [np.concatenate([c2w[:3, :4], hwf], 1).flatten(), [2.0, 6.0]])

    cfg = Config(batch_ray=args.batch, n_coarse=args.coarse,
                 n_fine=args.fine, precision=args.precision, seed=seed,
                 occ_grid=args.occ, white_bkgd=args.occ,
                 occ_update_every=10 ** 9, proposal=args.proposal,
                 fine_field="grid" if args.grid else "mlp",
                 grid_pallas=args.grid_pallas)
    for kv in args.overrides:
        key, _, raw = kv.partition("=")
        apply_key(cfg, key.strip(), raw.strip())
    table = RayTable(SceneData(images=images, poses_bounds=pose_rows,
                               height=hw, width=hw, focal=float(focal)), device, cfg.pixel_dtype)
    step = trainlib.make_train_step(cfg, table, make_k_inv(hw, hw, focal, device))
    state = trainlib.init_state(cfg, device)

    def run():
        nonlocal state
        state, _ = step(state)

    trace_path = os.path.join(args.out, f"profile_step_{os.getpid()}.pt.trace.json")
    wall_ms, rows = profiling.device_rows(run, args.steps, device, trace_path=trace_path)
    print(f"{args.precision}, BATCH_RAY {cfg.batch_ray}, {cfg.n_coarse}+{cfg.n_fine} samples, "
          f"OCC_GRID {cfg.occ_grid}, PROPOSAL {cfg.proposal}, FINE_FIELD {cfg.fine_field}, "
          f"GRID_PALLAS {cfg.grid_pallas} on {device.type}; time per step by "
          f"{'kernel' if device.type == 'cuda' else 'op'} (top 18, {args.steps} steps traced):")
    profiling.print_profile(wall_ms, rows, args.steps, "steps", top=18,
                            on_device=device.type == "cuda")
    print(f"trace: {trace_path}")


if __name__ == "__main__":
    main()
