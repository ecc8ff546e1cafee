"""Training and rendering orchestration: the counterpart of
``tinynerf/runner.py`` for the configurations the port has
(``eval.check_supported``).

``Runner(cfg)`` loads the scene's splits onto the device (under ``NDC`` on
an LLFF scene, with the poses recentred and rescaled, and ``ndc_params``
set; under ``HOST_FEED`` the pixels stay on the host), builds ``k_inv``,
starts fresh or resumes the latest checkpoint under ``CKPT_PATH`` with its
Adam state (and its occupancy grid, with ``OCC_GRID``; with ``PROPOSAL`` the
``{"net", "prop"}`` pair; a grid's tables at the checkpoint's resolution),
and then trains (``train()``), renders the test split (``display()``) or
renders a camera path (``render_path_video()``). The host loop only ticks:
every per-iteration tensor stays on the device until a ``STEP`` boundary,
where the loop prints, takes the val PSNR (``VAL_METRICS``), writes the
preview canvas and a checkpoint. Within the loop, as in
``tinynerf/runner.py``: a ``GRID_UPSAMPLE`` milestone resizes the fine grid
before its iteration, ``HOST_FEED`` takes each batch from the native host
ray store (``data/native.py``) and ``PROFILE_STEPS`` traces the first steps.
Rendering refuses fresh weights unless this Runner trained them.

In a job of several ranks (``parallel/``; ``MESH_SHAPE``), as
``tinynerf/runner.py:37-44, 122-156, 177-204, 379-393``: the mesh is made
before the tables; every rank loads the same scene and checkpoint, and rank
0's state is replicated; every rank runs every step on its rows of the
batch (the gradient summed over the ranks), the val pass on its rows, the
``GRID_UPSAMPLE`` milestones and the frames; rank 0 alone prints the
iteration lines, logs (the others hold a ``NullLogger``) and writes the
preview canvas (the batch gathered from every rank), the checkpoints and
the frames. At the end of training each rank prints its params' digest.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from tinynerf_torch import ckpt, eval as evallib, train as trainlib
from tinynerf_torch.config import Config, parse_grid_upsample
from tinynerf_torch.core import render
from tinynerf_torch.core.occupancy import derive_march_steps, derive_march_steps_contracted
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.data.poses import SceneData, load_scene, recenter_and_rescale
from tinynerf_torch.data.rays import RayBatch, RayTable
from tinynerf_torch.device import DeviceLike, resolve_device
from tinynerf_torch.logging import MetricLogger, NullLogger, PreviewCanvas
from tinynerf_torch.parallel import distributed as dist, mesh as meshlib
from tinynerf_torch.profiling import Throughput, Trace

# the val batch's generator is seeded SEED + 777, as the JAX package's
VAL_SEED_OFFSET = 777


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
        # the mesh before the tables (None on one rank)
        self.mesh = meshlib.mesh_for_config(cfg)
        self.is_main = dist.is_main_process()

        train_scene = self._ingest("train")
        if cfg.ndc and cfg.data_type == "llff":
            # NDC needs LLFF-standard recentred and rescaled poses (on a copy:
            # a caller's scene may serve another Runner)
            train_scene = dataclasses.replace(
                train_scene, poses_bounds=recenter_and_rescale(train_scene.poses_bounds))
        # HOST_FEED: the pixels stay on the host, for the native ray store
        self.train_table = RayTable(train_scene, self.device, cfg.pixel_dtype,
                                    device_pixels=not cfg.host_feed)
        # llff splits are identical (Q10): the same images serve all three
        if cfg.data_type == "llff":
            self.val_table = self.test_table = self.train_table
        else:
            self.val_table = RayTable(self._ingest("val"), self.device,
                                      cfg.pixel_dtype, device_pixels=not cfg.host_feed)
            self.test_table = RayTable(self._ingest("test"), self.device,
                                       cfg.pixel_dtype, device_pixels=False)
        self.k_inv = make_k_inv(self.train_table.height, self.train_table.width,
                                self.train_table.focal, self.device)
        # the NDC warp, for forward-facing scenes
        self.ndc_params = ((float(self.train_table.height), float(self.train_table.width),
                            float(self.train_table.focal))
                           if cfg.ndc and cfg.data_type == "llff" else None)
        if cfg.occ_grid and cfg.contract:
            # the contracted grid: cells in the radius-2 ball, a
            # disparity-spaced march (before init_state builds the grid)
            if not cfg.lindisp:
                raise ValueError(
                    "OCC_GRID with CONTRACT requires LINDISP: only a "
                    "disparity-spaced probe march keeps contracted-radial "
                    "probe spacing within the grid's dilation margin over "
                    "an unbounded depth range.")
            if float(cfg.occ_extent) != 2.0:
                print(f"NOTE: OCC_EXTENT={cfg.occ_extent} overridden to 2.0 "
                      "— under CONTRACT the occupancy grid spans the "
                      "contracted radius-2 ball")
                cfg.occ_extent = 2.0

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
        if self.mesh is not None:
            # every rank must resume the same checkpoint (rank 0 writes them)
            found = dist.all_gather(torch.tensor([self.last_iter]))
            if any(int(f) != self.last_iter for f in found):
                raise RuntimeError(
                    f"the ranks resumed different checkpoints (iterations "
                    f"{[int(f) for f in found]}): every rank needs rank 0's CKPT_PATH")
            meshlib.replicate_state(self.state)
        if cfg.occ_grid and cfg.occ_march_steps is None:
            # the probe count must out-resolve the grid's 3-cell dilation
            # margin over this scene's longest ray span
            pb = self.train_table.poses.cpu().numpy()
            if cfg.contract:
                cfg.occ_march_steps = derive_march_steps_contracted(
                    cfg.occ_res, float(np.min(pb[:, 15])), float(np.max(pb[:, 16])))
            else:
                cfg.occ_march_steps = derive_march_steps(
                    cfg.occ_res, cfg.occ_extent, float(np.max(pb[:, 16] - pb[:, 15])))
        self.logger: Optional[MetricLogger] = None  # opened by train()
        self._val_batch: Optional[RayBatch] = None   # built by val_psnr()
        dist.barrier()   # every rank's state is in place before any step

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

    def val_psnr(self) -> float:
        """``VAL_METRICS``' held-out metric (``tinynerf/runner.py:172-226``):
        the PSNR of the fine pass over a fixed val batch, the same rays at
        every call. The batch is drawn on the host from
        ``np.random.default_rng(SEED + 777)`` over the val split's host pixels
        (u8 dequantised), the JAX package's stream, so both packages evaluate
        the same rays. The pass runs without gradients, without noise and
        with the two-list merge, so that with ``FUSED_RENDER`` it is one
        launch of the fused renderer (on the card, kernel 9). Under a mesh
        every rank renders its rows of the batch (unfused, as frames) and
        the squared errors are summed over the ranks."""
        cfg = self.cfg
        if self._val_batch is None:
            table = self.val_table
            rng = np.random.default_rng(cfg.seed + VAL_SEED_OFFSET)
            idx = rng.integers(0, table.num_pix, cfg.batch_ray)
            pic = (idx // table.pic_size).astype(np.int32)
            in_pic = idx % table.pic_size
            flat = table.host_pixels[idx]
            if table.pixel_dtype == "u8":
                flat = flat.astype(np.float32) * (1.0 / 255.0)
            host = (
                (in_pic // table.width).astype(np.float32),
                (in_pic % table.width).astype(np.float32),
                flat.astype(np.float32), table.poses.cpu().numpy()[pic], pic)
            self._val_batch = RayBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in host))
        b, params = self._val_batch, self.state.params
        field_fn = evallib.make_field_fn(cfg)
        if self.mesh is not None:
            b, field_fn = self.mesh.local_rows(b), evallib.without_fused(field_fn)
        with torch.no_grad():
            _, c_fine = render.render_rays(
                evallib.net_params(cfg, params), b.rows, b.cols, b.pose17, self.k_inv,
                cfg.n_coarse, cfg.n_fine, field_fn=field_fn,
                compat_sort=cfg.compat_sort, ndc_params=self.ndc_params,
                merge_impl="twolist", white_bkgd=cfg.white_bkgd, occ_grid=self.state.occ,
                occ_march=cfg.occ_march_steps, occ_march_res=cfg.occ_march_res,
                occ_contract=cfg.contract, prop_params=evallib.prop_params(cfg, params),
                prop_field_fn=evallib.make_prop_field_fn(cfg), lindisp=cfg.lindisp)
            if self.mesh is None:
                mse = torch.mean(torch.square(c_fine - b.rgb))
            else:
                sse = self.mesh.sum_over_data(torch.sum(torch.square(c_fine - b.rgb)))
                mse = sse / (3 * cfg.batch_ray)
        return evallib.mse_to_db(float(mse))

    def _make_feeder(self, table: RayTable):
        """The native host ray store over ``table``'s host pixels, prefetching
        ``BATCH_RAY`` rays a batch (``HOST_FEED``); it raises where the store
        cannot be built."""
        from tinynerf_torch.data.native import make_ray_store
        store = make_ray_store(table.host_pixels, table.poses.cpu().numpy(),
                               table.height, table.width, seed=self.cfg.seed)
        store.start(self.cfg.batch_ray)
        return store

    def train(self, mode: str = "train") -> None:
        """Run the training loop up to ``TOTAL_ITER`` (resuming mid-count).

        ``mode="val"`` runs ONE epoch over the val split: a shuffled
        without-replacement pass visiting every val pixel once, in batches of
        ``BATCH_RAY`` with the remainder dropped (the reference's
        ``trainer("val")``, ``nerf.py:498-499``), with the full step. Under
        ``HOST_FEED`` the epoch keeps its length but its batches come from
        the host ray store, drawn with replacement, as in the JAX package.

        In train mode, ``GRID_UPSAMPLE``'s milestones at or after the first
        iteration run resize the fine grid before their iteration (a resumed
        checkpoint already holds the tables of the milestones before it),
        and ``PROFILE_STEPS`` traces the first steps (``profiling.Trace``,
        under ``LOG_DIR/trace``). A step holds no table, so a resize needs no
        new one."""
        cfg = self.cfg
        if self.logger is None:
            self.logger = (MetricLogger(os.path.join(cfg.log_dir, self.start_time))
                           if self.is_main else NullLogger())
        table = {"train": self.train_table, "val": self.val_table}[mode]
        canvas = PreviewCanvas(table.height, table.width)
        start = self.state.iteration
        epoch = None
        if mode == "val":
            n_batches = table.num_pix // cfg.batch_ray  # drop_last
            end = start + n_batches
        else:
            end = cfg.total_iter
        step_kw = dict(ndc_params=self.ndc_params, mesh=self.mesh)
        if cfg.host_feed:
            step_fn = trainlib.make_host_fed_train_step(cfg, self.k_inv, **step_kw)
        elif mode == "val":
            perm = torch.randperm(table.num_pix, generator=self.state.generator,
                                  device=self.device)
            epoch = perm[:n_batches * cfg.batch_ray].view(n_batches, cfg.batch_ray)
            step_fn = trainlib.make_indexed_train_step(cfg, table, self.k_inv, **step_kw)
        else:
            step_fn = trainlib.make_train_step(cfg, table, self.k_inv, **step_kw)
        upsample = []
        if mode == "train" and cfg.fine_field == "grid" and cfg.grid_upsample:
            upsample = [(i, r) for i, r in parse_grid_upsample(cfg.grid_upsample)
                        if i >= start]
        if self.is_main:
            print(f"[STEP] {mode}: iterations {start} -> {end}")
        # the rows of each rank, for the preview canvas
        data_group = None if self.mesh is None else self.mesh.data

        trace_dir = os.path.join(cfg.log_dir, "trace")
        profiling_until = (start + cfg.profile_steps
                           if cfg.profile_steps and mode == "train" else -1)
        feeder = tracer = None
        meter = Throughput(rays_per_step=cfg.batch_ray)
        it = start
        try:
            if cfg.host_feed:
                feeder = self._make_feeder(table)
            if profiling_until > 0:
                tracer = Trace(trace_dir, self.device)
                tracer.start()
            while it < end:
                if upsample and it == upsample[0][0]:
                    _, new_res = upsample.pop(0)
                    self.state = trainlib.upsample_grid_state(cfg, self.state, new_res)
                    if self.mesh is not None:
                        meshlib.replicate_state(self.state)
                    if self.is_main:
                        print(f"[GRID] upsampled line tables to R={new_res} before iter {it}")
                if it == profiling_until:
                    tracer.stop()
                    tracer = None
                    print(f"[PROFILE] trace of {cfg.profile_steps} steps -> {trace_dir}")
                    profiling_until = -1
                if feeder is not None:
                    host = feeder.next()
                    if self.mesh is not None:   # each rank uploads its rows
                        host = self.mesh.local_rows(host)
                    self.state, metrics = step_fn(self.state, table.upload(host))
                elif epoch is not None:
                    self.state, metrics = step_fn(self.state, epoch[it - start])
                else:
                    self.state, metrics = step_fn(self.state)
                self.logger.log(it, {f"loss/{mode}": metrics["loss"],
                                     f"lr/{mode}": metrics["lr"]})
                it += 1
                meter.tick(1)
                if it % cfg.step == 0:
                    if self.is_main:
                        loss = float(metrics["loss"])
                        c_t = metrics["c_true0"].tolist()
                        c_f = metrics["c_fine0"].tolist()
                        print(f"[ITER] {it - 1} [LOSS] {loss:.4f} "
                              f"[T] ({c_t[0]:.4f} {c_t[1]:.4f} {c_t[2]:.4f}) "
                              f"[F] ({c_f[0]:.4f} {c_f[1]:.4f} {c_f[2]:.4f}) "
                              f"[RAYS/S] {meter.rays_per_sec:,.0f}")
                    if mode == "train" and cfg.val_metrics:
                        val_psnr = self.val_psnr()   # every rank renders its rows
                        if self.is_main:
                            print(f"[VAL PSNR] {val_psnr:.2f} dB")
                        self.logger.log(it - 1, {"psnr/val": val_psnr})
                    self.logger.flush()
                    if mode == "train":
                        seen = [dist.to_host(metrics[k], data_group)
                                for k in ("rows", "cols", "rgb", "pic")]
                        if self.is_main:
                            canvas.update(*seen)
                            canvas.save(os.path.join(
                                cfg.results_path, f"{self.start_time}_{it - 1}.jpg"))
                            ckpt.save_checkpoint(cfg.ckpt_path, self.start_time, it - 1,
                                                 self.state.params, self.state.opt,
                                                 generator=self.state.generator,
                                                 occ=self.state.occ)
                        self.last_iter = it - 1
                    meter.reset()
        finally:
            if tracer is not None:   # the loop was shorter than the trace's window
                tracer.stop()
            if feeder is not None:
                feeder.close()
        self.logger.flush()
        self.trained = True
        if dist.is_multiprocess():
            print(f"[RANK {dist.rank()}/{dist.world_size()}] params sha256 "
                  f"{dist.params_digest(self.state.params)}")
            dist.barrier()   # rank 0's last checkpoint is on disk

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
            depth=depth, occ_grid=self.state.occ, ndc_params=self.ndc_params,
            mesh=self.mesh)
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
                                   out_base, occ_grid=self.state.occ,
                                   ndc_params=self.ndc_params, mesh=self.mesh)
