"""``chip_smoke.py``'s phases 28 and 28b alone, on the card, for iterating
on ``parallel/`` without the whole smoke test's six minutes.

    python3 tests/chip_parallel_phases.py

Builds the kernels, trains ``conf/lego.ini`` for 50 steps on
``chip_smoke.blender_scene`` (phase 5's scene), saves its checkpoint,
renders its view 0 on one rank (phase 6's), then runs
``chip_smoke.parallel_phases`` against them and prints its numbers. About
two minutes on one H100 (the NCCL job runs too where there are two cards).
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from tinynerf_torch import ckpt, eval as evallib
    from tinynerf_torch.config import load_config
    from tinynerf_torch.kernels import build
    from tinynerf_torch.runner import Runner
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          torch.cuda.device_count())
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(os.path.join(REPO, "conf", "lego.ini"))
        cfg.ckpt_path, cfg.results_path = os.path.join(tmp, "ckpt"), os.path.join(tmp, "res")
        cfg.log_dir, cfg.total_iter, cfg.step = os.path.join(tmp, "runs"), 50, 1000
        runner = Runner(cfg, device="cuda", scene=cs.blender_scene(cs.TRAIN_VIEWS, 800, cfg.seed))
        runner.train()
        ckpt.save_checkpoint(cfg.ckpt_path, "smoke", 49, runner.params, runner.state.opt,
                             generator=runner.state.generator)
        cfg.continue_ = True
        runner = Runner(cfg, device="cuda", scene=cs.blender_scene(2, 800, cfg.seed))
        view0 = evallib.render_test_set(cfg, runner.params, runner.test_table, runner.k_inv,
                                        runner.start_time, runner.last_iter, save=False,
                                        max_views=1)[0]
        del runner
        out = cs.parallel_phases(tmp, cfg.ckpt_path, view0, "cuda")
        print({k: v for k, v in out.items() if k != "launches"})
        print(out["launches"])


if __name__ == "__main__":
    main()
