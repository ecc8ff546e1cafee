"""Capture and summarize a profile of the port's training step.

The port's counterpart of ``tools/profile_step.py``: the same flags and the
same synthetic scene (4 views of 400x400 uniform noise, cameras at z = 4,
near/far 2/6), ``train.make_train_step`` chunked as the Runner chunks it
(``train.make_chunked_step``: on the card a CUDA graph's replay a step)
and warmed up, then one chunk of ``--steps`` steps under
``torch.profiler`` with CUDA activity on the card; ``--eager`` profiles
``--steps`` eager steps instead, one call each. It prints the
device time per step by kernel (the top 18: ms, launches, name) and the
device's busy share of the steps' wall time (``profiling.device_rows``,
``profiling.print_profile``), and leaves the Chrome trace (Perfetto,
``chrome://tracing``) under ``--out``, where the program's host spans show
as ``tinynerf.*`` annotations. Spans are on (``profiling.spans_on``), so
beside the kernels it prints the program's own split of a step: each device
section's ms a step (``step.render``, ``step.render/field.fwd``, ...), the
host spans' ms a call (``chunk``, ``chunk.load``, ...) and the counters of
the captures (the step graph's nodes, seconds, pool bytes). On the card
unless ``--device cpu``, where the table is the ops' self CPU time, no busy
share is measured and no device section is timed.

    python -m tinynerf_torch.tools.profile_step [--batch 4096] [--steps 5] [--occ] [--eager]
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
    ap.add_argument("--eager", action="store_true",
                    help="profile eager steps, one call each, not a chunk")
    args = ap.parse_args(argv)

    from tinynerf_torch import profiling, train as trainlib
    from tinynerf_torch.config import Config, apply_key
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.data.poses import SceneData
    from tinynerf_torch.data.rays import RayTable
    from tinynerf_torch.device import resolve_device

    device = resolve_device(args.device)
    profiling.spans_on()
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

    chunk = trainlib.make_chunked_step(step, args.steps) if args.steps > 1 else None

    def run():
        nonlocal state
        if args.eager or chunk is None:
            state, _ = step(state)
        else:
            state, _ = chunk(state)

    calls = args.steps if args.eager or chunk is None else 1
    trace_path = os.path.join(args.out, f"profile_step_{os.getpid()}.pt.trace.json")
    run()     # warms up and captures; the sections then count replays alone
    profiling.reset()
    wall_ms, rows, busy_ms = profiling.device_rows(run, calls, device, trace_path=trace_path)
    print(f"{args.precision}, BATCH_RAY {cfg.batch_ray}, {cfg.n_coarse}+{cfg.n_fine} samples, "
          f"OCC_GRID {cfg.occ_grid}, PROPOSAL {cfg.proposal}, FINE_FIELD {cfg.fine_field}, "
          f"GRID_PALLAS {cfg.grid_pallas} on {device.type}, "
          f"{'eager steps' if calls > 1 or args.steps == 1 else 'one chunk'}; time per step by "
          f"{'kernel' if device.type == 'cuda' else 'op'} (top 18, {args.steps} steps traced):")
    profiling.print_profile(wall_ms, rows, args.steps, "steps", top=18,
                            on_device=device.type == "cuda", busy_ms=busy_ms)
    print_spans(profiling.snapshot(), 3 + calls)
    print(f"trace: {trace_path}")


def print_spans(snap: dict, calls: int) -> None:
    """The program's own split of ``calls`` calls: device sections' ms a step
    (self, and with their nested sections; the steps are the times the
    stopwatch closed), host spans' ms a call, and the counters."""
    dev = snap["device"]
    if dev:
        steps = dev["step"]["count"]
        print(f"device sections (ms a step, self / with nested; {steps} steps):")
        for path in sorted(dev):
            nested = sum(v["self_s"] for p, v in dev.items()
                         if p == path or p.startswith(path + "/"))
            print(f"  {1e3 * dev[path]['self_s'] / steps:9.3f} / "
                  f"{1e3 * nested / steps:9.3f}  {path}")
    else:
        print("device sections: not measured (no card)")
    print(f"host spans (ms a call, total / self; {calls} calls):")
    for path, v in sorted(snap["host"].items()):
        print(f"  {1e3 * v['total_s'] / calls:9.3f} / {1e3 * v['self_s'] / calls:9.3f}  "
              f"{path} (x{v['count']})")
    print("counters: " + ", ".join(f"{k} {v:g}" for k, v in sorted(snap["counters"].items())))


if __name__ == "__main__":
    main()
