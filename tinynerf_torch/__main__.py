"""Command line: ``python -m tinynerf_torch --conf lego --mode display``.

The flags are ``main.py``'s, plus ``--device``. ``--mode train`` trains to
``TOTAL_ITER`` (resuming the latest checkpoint when the INI says
``CONTINUE``); ``--mode all``, the default, trains and then renders the test
split, as ``main.py`` does. Rendering modes (``display``, ``path``) resume
the latest checkpoint under ``CKPT_PATH`` whatever ``CONTINUE`` says, and
refuse to run without one.
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
                        help="accepted for main.py compatibility: the port "
                             "always renders chunk by chunk from the host")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

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
            runner.display(depth=args.depth)
        if args.mode == "path":
            runner.render_path_video(n_views=args.path_views,
                                     res_scale=args.path_scale)
    except NoCheckpointError as e:
        raise SystemExit(f"--mode={args.mode}: {e}") from None


if __name__ == "__main__":
    main()
