"""Command line: ``python -m tinynerf_torch --conf lego --mode display``.

The flags are ``main.py``'s, plus ``--device``. ``--mode train`` trains to
``TOTAL_ITER`` (resuming the latest checkpoint when the INI says
``CONTINUE``); ``--mode all``, the default, trains and then renders the test
split, as ``main.py`` does. Rendering modes (``display``, ``path``) resume
the latest checkpoint under ``CKPT_PATH`` whatever ``CONTINUE`` says, and
refuse to run without one.

Several ranks, one card each (``parallel/``): under ``torchrun
--nproc-per-node N -m tinynerf_torch``, or with the JAX package's
``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` and
``PROCESS_ID``, each process joins the job. Outside a job, ``MESH_SHAPE =
N`` (N > 1) starts N ranks itself, on N cards (fewer cards are refused by
name), or with ``--device cpu`` on the CPU under gloo. ``MESH_SHAPE``
unset or ``auto`` is the job's size: one process outside a job.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="tinynerf (PyTorch) argument parser.")
    parser.add_argument("--conf", type=str, default="lego",
                        help="scene name under ./conf/ or a path to an .ini")
    parser.add_argument("--mode", type=str, default="all",
                        choices=["all", "train", "display", "path"])
    parser.add_argument("--iters", type=int, default=None,
                        help="override TOTAL_ITER")
    parser.add_argument("--path-views", type=int, default=120,
                        help="number of frames for --mode=path")
    parser.add_argument("--path-scale", type=float, default=1.0,
                        help="resolution multiplier for --mode=path")
    parser.add_argument("--depth", action="store_true",
                        help="also write per-view depth + opacity maps")
    parser.add_argument("--host-chunks", nargs="?", const=1, default=0,
                        type=int, metavar="K",
                        help="render frames through a graph of K chunks "
                             "replayed along the view (K = 1 without a "
                             "value) instead of one graph of the whole "
                             "view; on the card only (main.py's flag)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from tinynerf_torch.config import load_config
    from tinynerf_torch.parallel import distributed as dist

    dist.maybe_initialize(device=args.device)
    try:
        mesh_shape = load_config(args.conf).mesh_shape or 1
        if dist.world_size() == 1 and mesh_shape > 1:
            dist.spawn("tinynerf_torch.__main__:run", mesh_shape, args.device, (args,))
        else:
            run(args)
    finally:
        dist.shutdown()


def run(args: argparse.Namespace) -> None:
    """The CLI's work in this process (one rank of a job, or the only one)."""
    from tinynerf_torch.config import load_config
    from tinynerf_torch.runner import NoCheckpointError, Runner

    cfg = load_config(args.conf)
    if args.iters is not None:
        cfg.total_iter = args.iters
    if args.mode in ("display", "path"):
        cfg.continue_ = True  # render-only modes need trained weights
    runner = Runner(cfg, device=args.device)
    try:
        if args.mode in ("all", "train"):
            runner.train("train")
        if args.mode in ("all", "display"):
            runner.display(depth=args.depth, host_chunks=args.host_chunks)
        if args.mode == "path":
            runner.render_path_video(n_views=args.path_views,
                                     res_scale=args.path_scale,
                                     host_chunks=args.host_chunks)
    except NoCheckpointError as e:
        raise SystemExit(f"--mode={args.mode}: {e}") from None


if __name__ == "__main__":
    main()
