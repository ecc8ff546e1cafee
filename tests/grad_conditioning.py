"""How far one step's gradient moves when every param moves by about one
float32 ulp: the conditioning of ``chip_smoke.py`` phase 24's card-vs-CPU
check (``conf/unbounded360.ini`` as shipped), in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/grad_conditioning.py [--steps 30] [--trials 3]

Trains the config for ``--steps`` steps on the CPU from its seed (phase
24's scene: ``chip_smoke.llff_capture``), draws phase 24's batch, and
prints, for each trial, the cosine per part (``chip_smoke.grid_part_cosines``)
between the gradient at the trained params and at the params times
``1 + 2e-7 N(0, 1)``: the port at bf16 and at fp32, and the JAX package at
bf16 on the same params (its checkpoint) and rays. About 3 minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import chip_smoke as cs
    from tinynerf import ckpt as jckpt, train as jtrain
    from tinynerf.config import load_config as jload_config
    from tinynerf.core.rays import make_k_inv as jmake_k_inv
    from tinynerf.data.rays import RayBatch as JRayBatch
    from tinynerf_torch import ckpt, optim, train
    from tinynerf_torch.runner import Runner

    with tempfile.TemporaryDirectory() as tmp:
        cfg = cs.run_config("unbounded360", tmp, "u360", args.steps)
        scene = cs.llff_capture(cs.U360_VIEWS, cfg.seed, outward=True)
        runner = Runner(cfg, device="cpu", scene=scene)
        runner.train()
        params, k_inv = runner.params, runner.k_inv
        batch = runner.train_table.sample(torch.Generator().manual_seed(3), cfg.batch_ray)
        nudge = lambda seed: (lambda t: t * (1 + 2e-7 * torch.randn(
            t.shape, generator=torch.Generator().manual_seed(seed))))
        for precision in ("bf16", "fp32"):
            loss_fn = train.make_loss_fn(dataclasses.replace(cfg, precision=precision), k_inv)
            g0 = train.loss_and_grads(loss_fn, params, batch)[2]
            for trial in range(args.trials):
                g1 = train.loss_and_grads(loss_fn, optim.tree_map(nudge(100 + trial), params),
                                          batch)[2]
                print(f"port {precision}, trial {trial}: {cs.grid_part_cosines(g0, g1)}",
                      flush=True)

        path = ckpt.save_checkpoint(tmp, "conditioning", 0, params, optim.adam_init(params))
        jparams = jckpt.load_checkpoint_full(path)[1]
        jcfg = jload_config(os.path.join(REPO, "conf", "unbounded360.ini"))
        jloss = jtrain.make_loss_fn(jcfg, jmake_k_inv(scene.height, scene.width, scene.focal))
        jbatch = JRayBatch(*(jnp.asarray(t.numpy()) for t in batch))
        grad = jax.jit(jax.grad(lambda p: jloss(p, jbatch, None, None)[0]))
        lines = lambda g: np.concatenate([np.asarray(g["net"]["lines"][k], np.float64).ravel()
                                          for k in sorted(g["net"]["lines"])])
        j0 = lines(grad(jparams))
        rng = np.random.default_rng(0)
        for trial in range(args.trials):
            moved = jax.tree_util.tree_map(
                lambda x: (x * (1 + 2e-7 * rng.standard_normal(x.shape))).astype(x.dtype), jparams)
            j1 = lines(grad(moved))
            print(f"JAX bf16, trial {trial}: net.lines "
                  f"{float(j0 @ j1 / (np.linalg.norm(j0) * np.linalg.norm(j1)))}", flush=True)


if __name__ == "__main__":
    main()
