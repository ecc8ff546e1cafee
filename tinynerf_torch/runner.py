"""Training and rendering orchestration: the counterpart of
``tinynerf/runner.py`` for the configurations the port has
(``eval.check_supported``).

``Runner(cfg)`` loads the scene's splits onto the device, builds ``k_inv``,
starts fresh or resumes the latest checkpoint under ``CKPT_PATH`` with its
Adam state (and its occupancy grid, with ``OCC_GRID``; with ``PROPOSAL`` the
``{"net", "prop"}`` pair), and then trains (``train()``), renders the test split
(``display()``) or renders a camera path (``render_path_video()``). The
host loop only ticks: every per-iteration tensor stays on the device until
a ``STEP`` boundary, where the loop prints, writes the preview canvas and a
checkpoint. Rendering refuses fresh weights unless this Runner trained them.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from tinynerf_torch import ckpt, eval as evallib, train as trainlib
from tinynerf_torch.config import Config
from tinynerf_torch.core.occupancy import derive_march_steps
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import SceneData, load_scene
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.device import DeviceLike, resolve_device
from tinynerf_torch.logging import MetricLogger, PreviewCanvas
from tinynerf_torch.profiling import Throughput


class NoCheckpointError(RuntimeError):
    """Rendering was asked for, but no checkpoint was found to resume."""


class Runner:
    """``scene``: an in-memory scene used for every split instead of reading
    ``IMG_DIR`` (callers that build a scene themselves, such as the chip
    smoke test)."""

    def __init__(self, cfg: Config, device: DeviceLike = "cuda",
                 scene: Optional[SceneData] = None):
        evallib.check_supported(cfg)
        if cfg.occ_grid and cfg.data_type == "sync" and not cfg.white_bkgd:
            raise ValueError(
                "OCC_GRID on a white-composited (sync) scene requires "
                "WHITE_BKGD = True: rays that miss occupied space composite "
                "to the background and would train toward black against "
                "white ground truth.")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.start_time = time.strftime("%m-%d-%H-%M-%S", time.localtime())
        self._scene = scene

        self.train_table = RayTable(self._ingest("train"), self.device,
                                    cfg.pixel_dtype)
        # llff splits are identical (Q10): the same images serve all three
        if cfg.data_type == "llff":
            self.val_table = self.test_table = self.train_table
        else:
            self.val_table = RayTable(self._ingest("val"), self.device,
                                      cfg.pixel_dtype)
            self.test_table = RayTable(self._ingest("test"), self.device,
                                       cfg.pixel_dtype, device_pixels=False)
        self.k_inv = make_k_inv(self.train_table.height, self.train_table.width,
                                self.train_table.focal, self.device)

        self.last_iter = -1
        self.trained = False  # set by train(): rendering may then proceed
        params = opt_state = gen_state = occ = None
        if cfg.continue_:
            latest = ckpt.find_latest(cfg.ckpt_path)
            if latest is not None:
                (self.last_iter, params, opt_state,
                 gen_state) = ckpt.load_train_state(latest, self.device)
                if cfg.occ_grid:  # the weights co-adapted to the saved grid
                    occ = ckpt.load_occ_grid(latest, self.device)
                print(f"Resumed from {latest} (iter {self.last_iter})")
        if self.last_iter < 0:
            print("New run created.")
        self.state = trainlib.init_state(cfg, self.device, params=params,
                                         opt_state=opt_state,
                                         iteration=self.last_iter + 1, occ=occ)
        if gen_state is not None:  # continue the sample stream
            if gen_state.numel() == self.state.generator.get_state().numel():
                self.state.generator.set_state(gen_state)
            else:
                print("Note: the checkpoint's generator state is for another "
                      "device; the sample stream restarts from SEED")
        if cfg.occ_grid and cfg.occ_march_steps is None:
            # the probe count must out-resolve the grid's 3-cell dilation
            # margin over this scene's longest ray span
            pb = self.train_table.poses.cpu().numpy()
            cfg.occ_march_steps = derive_march_steps(
                cfg.occ_res, cfg.occ_extent, float(np.max(pb[:, 16] - pb[:, 15])))
        self.logger: Optional[MetricLogger] = None  # opened by train()

    @property
    def params(self):
        return self.state.params

    def _ingest(self, mode: str) -> SceneData:
        cfg = self.cfg
        scene = (self._scene if self._scene is not None
                 else load_scene(cfg.img_dir, cfg.data_type, mode, cfg.low_res))
        if cfg.near > 0 or cfg.far > 0:
            scene.poses_bounds = scene.poses_bounds.copy()
            if cfg.near > 0:
                scene.poses_bounds[:, 15] = cfg.near
            if cfg.far > 0:
                scene.poses_bounds[:, 16] = cfg.far
        return scene

    def train(self, mode: str = "train") -> None:
        """Run the training loop up to ``TOTAL_ITER`` (resuming mid-count).

        ``mode="val"`` runs ONE epoch over the val split: a shuffled
        without-replacement pass visiting every val pixel once, in batches of
        ``BATCH_RAY`` with the remainder dropped (the reference's
        ``trainer("val")``, ``nerf.py:498-499``), with the full step."""
        cfg = self.cfg
        if self.logger is None:
            self.logger = MetricLogger(os.path.join(cfg.log_dir, self.start_time))
        table = {"train": self.train_table, "val": self.val_table}[mode]
        canvas = PreviewCanvas(table.height, table.width)
        start = self.state.iteration
        epoch = None
        if mode == "val":
            n_batches = table.num_pix // cfg.batch_ray  # drop_last
            end = start + n_batches
            perm = torch.randperm(table.num_pix, generator=self.state.generator,
                                  device=self.device)
            epoch = perm[:n_batches * cfg.batch_ray].view(n_batches, cfg.batch_ray)
            step_fn = trainlib.make_indexed_train_step(cfg, table, self.k_inv)
        else:
            end = cfg.total_iter
            step_fn = trainlib.make_train_step(cfg, table, self.k_inv)
        print(f"[STEP] {mode}: iterations {start} -> {end}")

        meter = Throughput(rays_per_step=cfg.batch_ray)
        it = start
        while it < end:
            if epoch is not None:
                self.state, metrics = step_fn(self.state, epoch[it - start])
            else:
                self.state, metrics = step_fn(self.state)
            self.logger.log(it, {f"loss/{mode}": metrics["loss"],
                                 f"lr/{mode}": metrics["lr"]})
            it += 1
            meter.tick(1)
            if it % cfg.step == 0:
                loss = float(metrics["loss"])
                c_t = metrics["c_true0"].tolist()
                c_f = metrics["c_fine0"].tolist()
                print(f"[ITER] {it - 1} [LOSS] {loss:.4f} "
                      f"[T] ({c_t[0]:.4f} {c_t[1]:.4f} {c_t[2]:.4f}) "
                      f"[F] ({c_f[0]:.4f} {c_f[1]:.4f} {c_f[2]:.4f}) "
                      f"[RAYS/S] {meter.rays_per_sec:,.0f}")
                self.logger.flush()
                if mode == "train":
                    canvas.update(metrics["rows"], metrics["cols"],
                                  metrics["rgb"], metrics["pic"])
                    canvas.save(os.path.join(
                        cfg.results_path, f"{self.start_time}_{it - 1}.jpg"))
                    ckpt.save_checkpoint(cfg.ckpt_path, self.start_time, it - 1,
                                         self.state.params, self.state.opt,
                                         generator=self.state.generator,
                                         occ=self.state.occ)
                    self.last_iter = it - 1
                meter.reset()
        self.logger.flush()
        self.trained = True

    def _require_trained(self, what: str) -> None:
        if self.last_iter < 0 and not self.trained:
            raise NoCheckpointError(
                f"{what} needs trained weights but no checkpoint was found "
                f"under {self.cfg.ckpt_path!r}: refusing to render from fresh "
                "weights. Train first (--mode train) or point CKPT_PATH at an "
                "existing run.")

    def display(self, max_views: Optional[int] = None,
                depth: bool = False) -> float:
        """Render the test split -> JPGs + video; returns the mean PSNR."""
        self._require_trained("display")
        print("Start generating video...")
        frames = evallib.render_test_set(
            self.cfg, self.params, self.test_table, self.k_inv,
            self.start_time, self.last_iter, save=True, max_views=max_views,
            depth=depth, occ_grid=self.state.occ)
        score = evallib.test_psnr(frames, self.test_table)
        ssim_score = evallib.test_ssim(frames, self.test_table)
        print(f"Test PSNR: {score:.2f} dB over {frames.shape[0]} views "
              f"(SSIM {ssim_score:.4f})")
        return score

    def render_path_video(self, n_views: int = 120,
                          res_scale: float = 1.0) -> np.ndarray:
        """Free-viewpoint video along a scene-appropriate path around the
        training cameras (spiral for llff, orbit for sync)."""
        from tinynerf_torch.data.paths import make_path
        self._require_trained("path")
        pose_rows = make_path(self.train_table.poses.cpu().numpy(),
                              self.cfg.data_type, n_views=n_views,
                              res_scale=res_scale)
        hwf = pose_rows[0, :15].reshape(3, 5)[:, 4]
        k_inv = make_k_inv(float(hwf[0]), float(hwf[1]), float(hwf[2]),
                           self.device)
        out_base = os.path.join(self.cfg.results_path,
                                f"{self.start_time}_path_{self.last_iter}")
        print(f"Rendering {n_views}-view path at "
              f"{int(hwf[0])}x{int(hwf[1])} -> {out_base}")
        return evallib.render_path(self.cfg, self.params, pose_rows, k_inv,
                                   out_base, occ_grid=self.state.occ)
