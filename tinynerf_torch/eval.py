"""Full-frame rendering, PSNR/SSIM, per-view JPG export and video.

Counterpart of ``tinynerf/eval.py``. A frame is rendered in
``RENDER_CHUNK``-ray chunks of the pixel grid; the last chunk is padded with
pixel (0, 0) and the padding dropped at assembly, as the JAX package pads
its chunk grid. On the CPU, and under a mesh over gloo, the chunks are a
host loop. On the card every chunk of a view is one CUDA graph, replayed
once a view, the counterpart of the JAX package's one program a frame
(under a mesh over NCCL each rank's graph holds its collectives); with
``host_chunks = K`` a graph of K chunks is replayed along the view, the JAX
package's host loop (``tinynerf/eval.py:137-180``). Results stay on the
device until the frame is complete. With spans on (``profiling``) a frame's
host time is the span ``frame``, with ``frame.pose`` (the pose's upload),
``frame.launch`` (each graph replay's launch) and ``frame.readback`` (the
copy to the host, which waits for the card); a frame launches no device
marks. The nodes a frame's graph replays launch (the graph's nodes times
its replays a view) are the counter ``graph.nodes.frame``.
JPGs and the ``.gif`` are written by the port's own encoders
(``data/imagefile.py``); a video is an ``.mp4`` only where imageio imports
and has a video backend.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from tinynerf_torch import optim, profiling
from tinynerf_torch.config import Config
from tinynerf_torch.core import contract, gridfield, proposal, render
from tinynerf_torch.core.encoding import L_POINT
from tinynerf_torch.data import imagefile
from tinynerf_torch.data.rays import RayTable
from tinynerf_torch.parallel import distributed as dist
from tinynerf_torch.parallel import mesh as meshlib


def _grid_pallas_conflicts(cfg: Config) -> None:
    """The JAX package's refusals of ``GRID_PALLAS`` with a grid form its
    kernels do not compute (``tinynerf/train.py:147-155, 231-235``)."""
    if not cfg.grid_pallas:
        return
    if cfg.fine_field == "grid" and cfg.grid_hybrid:
        raise ValueError("GRID_PALLAS computes the plain CP form and would silently "
                         "drop the GRID_HYBRID sigma net — unset one")
    if cfg.fine_field == "grid" and cfg.grid_levels > 1:
        raise ValueError("GRID_PALLAS reads only the level-0 line tables and would "
                         "silently drop the GRID_LEVELS pyramid — unset one")
    if cfg.proposal and cfg.prop_field == "grid" and cfg.prop_grid_hybrid:
        raise ValueError("GRID_PALLAS computes the plain CP form and would silently "
                         "drop the PROP_GRID_HYBRID sigma net — unset one")


def check_supported(cfg: Config) -> None:
    """Raise the JAX package's ``ValueError`` for a bad ``PRECISION``,
    ``FINE_FIELD`` or ``PROP_FIELD``, for ``GRID_PALLAS`` with a form its
    kernels do not compute, and for ``GRID_UPSAMPLE`` with a pyramid, on a
    fresh run and on a resume alike; and a ``ValueError`` naming a
    ``MESH_SHAPE`` other than this job's world size or a ``SAMPLE_SHARD``
    that does not divide it (``parallel.mesh.check_mesh``). Every other
    config the JAX package runs, the port runs: ``GRID_LOOKUP`` takes
    ``gather`` or, as there, any other string for the hat form."""
    if cfg.precision not in ("fp32", "bf16"):
        raise ValueError(f"PRECISION must be fp32 or bf16, got {cfg.precision!r}")
    if cfg.fine_field not in ("mlp", "grid"):
        raise ValueError(f"FINE_FIELD must be mlp or grid, got {cfg.fine_field!r}")
    if cfg.proposal and cfg.prop_field not in ("grid", "mlp"):
        raise ValueError(f"PROP_FIELD must be grid or mlp, got {cfg.prop_field!r}")
    _grid_pallas_conflicts(cfg)
    if cfg.fine_field == "grid" and cfg.grid_upsample and cfg.grid_levels > 1:
        # tinynerf/train.py:44-49: on every path, fresh or resumed
        raise ValueError("GRID_UPSAMPLE is incompatible with "
                         "GRID_LEVELS>1 (multi-resolution pyramid)")
    meshlib.check_mesh(cfg, dist.world_size())


def net_params(cfg: Config, params: Any) -> Any:
    """The main field's params: with ``PROPOSAL`` the state's params are a
    ``{"net", "prop"}`` pair (one Adam over both), else the tree itself."""
    return params["net"] if cfg.proposal else params


def prop_params(cfg: Config, params: Any) -> Optional[Any]:
    return params["prop"] if cfg.proposal else None


def _grid_field_fn(cfg: Config, n_density: int, fold: bool = False) -> render.FieldFn:
    """The grid field at ``PRECISION``: the plain point field
    (``gridfield.apply_grid_field`` by ``GRID_LOOKUP``, the occupancy
    refresh's probes and, as in the JAX package, the renderer's field
    without ``GRID_PALLAS``: so the hybrid grids and the pyramids, which
    ``GRID_PALLAS`` refuses); with ``GRID_PALLAS`` its ``eval_rays`` is
    ``grid_rays`` (on the card, TPU kernels 5 and 6, whose own function is
    the lerp, whatever ``GRID_LOOKUP`` says, as in
    ``tinynerf/train.py:135-163``). ``GRID_LEVEL_FOLD`` reaches the main
    grid alone: the JAX package builds the proposal grid without it
    (``tinynerf/train.py:225-228``)."""
    fn = gridfield.make_field_grid(n_density, cfg.grid_lookup, cfg.precision, fold)
    if cfg.grid_pallas:
        from tinynerf_torch.kernels.grid_kernel import grid_rays
        fn.eval_rays = functools.partial(grid_rays, n_density=n_density,
                                         precision=cfg.precision)
    return fn


def _maybe_contract(cfg: Config, fn: render.FieldFn) -> render.FieldFn:
    """With ``CONTRACT``, ``fn`` wrapped to evaluate at contracted points
    (``contract.wrap_field_contract``, which drops ``eval_rays`` and
    ``render_fused``); ``CONTRACT`` with ``NDC`` raises the JAX package's
    ``ValueError`` (``tinynerf/train.py:108-120``)."""
    if not cfg.contract:
        return fn
    if cfg.ndc:
        raise ValueError(
            "CONTRACT is incompatible with NDC: both are warps of the march "
            "domain (NDC for forward-facing, contraction for unbounded 360) "
            "and composing them distorts the scene twice.")
    return contract.wrap_field_contract(fn)


def make_field_fn(cfg: Config) -> render.FieldFn:
    """The main field at ``PRECISION`` (``_make_field_fn``), shared by
    training, rendering and the occupancy refresh, wrapped by
    ``_maybe_contract`` (``CONTRACT``: the MLP then runs ``field_flat``
    alone, on the card TPU kernels 3 and 4)."""
    check_supported(cfg)
    return _maybe_contract(cfg, _make_field_fn(cfg))


def _make_field_fn(cfg: Config) -> render.FieldFn:
    """The main field without the contraction. ``FINE_FIELD = grid``:
    ``_grid_field_fn``. The MLP
    with ``USE_PALLAS`` (``kernels/mlp_kernel``; on the card, the CUDA
    kernels): the point field is ``field_flat`` (the occupancy refresh's
    probes) and its ``eval_rays`` is ``field_rays`` (both passes of the
    renderer, forward and backward); with ``FUSED_RENDER`` it also carries
    ``render_fused`` (on the card, TPU kernels 9 and 10), which
    ``render.render_rays`` takes for frames, as ``tinynerf/train.py:172-179``
    attaches it. Without ``USE_PALLAS``, the plain field
    (``render.field_plain``, or ``render.field_plain_bf16``)."""
    if cfg.fine_field == "grid":
        return _grid_field_fn(cfg, cfg.grid_comp_density, cfg.grid_level_fold)
    if not cfg.use_pallas:
        return render.field_plain_bf16 if cfg.precision == "bf16" else render.field_plain
    from tinynerf_torch.kernels.mlp_kernel import field_flat, field_rays
    fn = functools.partial(field_flat, precision=cfg.precision)
    fn.eval_rays = functools.partial(field_rays, precision=cfg.precision)
    if cfg.fused_render:
        from tinynerf_torch.kernels.render_kernel import render_fused
        fn.render_fused = functools.partial(render_fused, precision=cfg.precision)
    return fn


def make_prop_field_fn(cfg: Config) -> Optional[render.FieldFn]:
    """The proposal field of the coarse pass (None unless ``PROPOSAL``),
    wrapped by ``_maybe_contract`` (``CONTRACT``): sample placement sees the
    scene the fine pass renders. ``_make_prop_field_fn``."""
    check_supported(cfg)
    if not cfg.proposal:
        return None
    return _maybe_contract(cfg, _make_prop_field_fn(cfg))


def _make_prop_field_fn(cfg: Config) -> render.FieldFn:
    """The proposal field without the contraction. The proposal grid
    (``PROP_FIELD = grid``): ``_grid_field_fn``. The proposal
    MLP (``PROP_FIELD = mlp``) with ``USE_PALLAS``, ``PROP_PALLAS`` and the
    full point encoding (``PROPOSAL_ENC_L`` 10), as ``tinynerf/train.py:
    247-249`` chooses: the point field is ``prop_flat`` and its ``eval_rays``
    is ``prop_rays`` (on the card, TPU kernels 7 and 8). Otherwise the plain
    field, ``proposal.make_field_proposal`` (at bf16 the JAX package's bf16
    network), as the JAX package runs it outside any kernel."""
    if cfg.prop_field == "grid":
        return _grid_field_fn(cfg, cfg.prop_grid_comp_density)
    if cfg.use_pallas and cfg.prop_pallas and cfg.proposal_enc_l == L_POINT:
        from tinynerf_torch.kernels.proposal_kernel import prop_flat, prop_rays
        fn = functools.partial(prop_flat, precision=cfg.precision)
        fn.eval_rays = functools.partial(prop_rays, precision=cfg.precision)
        return fn
    return proposal.make_field_proposal(cfg.proposal_enc_l, cfg.precision)


def without_fused(field_fn: render.FieldFn) -> render.FieldFn:
    """``field_fn`` without its ``render_fused`` (its ``eval_rays`` kept)."""
    if getattr(field_fn, "render_fused", None) is None:
        return field_fn
    fn = functools.partial(field_fn)
    if getattr(field_fn, "eval_rays", None) is not None:
        fn.eval_rays = field_fn.eval_rays
    return fn


def make_frame_fn(cfg: Config, k_inv: torch.Tensor, height: int, width: int,
                  field_fn: Optional[render.FieldFn] = None,
                  extras: bool = False, occ_grid=None, ndc_params=None,
                  mesh: Optional[meshlib.Mesh] = None, host_chunks: int = 0):
    """Whole-frame renderer on ``k_inv``'s device: ``frame(params, pose17_row)``
    -> (H, W, 3) numpy, or with ``extras`` (rgb, depth, acc). ``occ_grid``
    (the trained state's, with ``OCC_GRID``) tightens every ray's bounds.
    With ``PROPOSAL``, ``params`` is the ``{"net", "prop"}`` pair and the
    coarse pass runs the proposal field (``make_prop_field_fn``).
    ``ndc_params = (H, W, focal)`` marches the NDC cube (``NDC`` on a
    forward-facing scene; the Runner's). With
    ``FUSED_RENDER`` each chunk is one launch of the fused renderer; the JAX
    package renders such a frame in one call over every pixel, a TPU memory
    workaround (``tinynerf/eval.py:40-43``), and rays are independent, so
    the chunks change no value.

    Under a ``mesh`` (``parallel/mesh.py``; every rank calls ``frame``) each
    chunk, padded to a multiple of the mesh's ranks, is split over the data
    group and gathered back, so every rank returns the whole frame; the
    fused renderer is not taken, as the JAX package takes it only without a
    mesh (``tinynerf/eval.py:56-58``). With ``SAMPLE_SHARD`` and no
    occupancy grid, extras, ``COMPAT_SORT``, ``PROPOSAL``, NDC or
    ``LINDISP``, and a fine pass (``tinynerf/eval.py:103-107``), the fine
    samples are spread over the sample group too
    (``sample_shard.make_sample_sharded_render``).

    On the card the chunks are CUDA graphs (``_graphed``): one graph of
    every chunk of the view, or with ``host_chunks = K`` (an int; ``True``
    is 1) of K chunks, replayed along the view, the chunk list padded to
    whole groups with repeats of its last chunk, as the JAX package pads
    it; under a mesh over NCCL each rank its own graph of its share, with
    the collectives that split and gather the chunks (every rank calls
    ``frame`` together). The frame's pixels are the host loop's. On the CPU
    and under a mesh over gloo, whose collectives copy through the host,
    ``host_chunks`` changes nothing: the chunks are a host loop (under a
    mesh the JAX package's host loop refuses several processes; the port's
    keeps it, as it keeps the whole-frame path)."""
    if field_fn is None:
        field_fn = make_field_fn(cfg)
    if mesh is not None:
        field_fn = without_fused(field_fn)
    prop_fn = make_prop_field_fn(cfg)
    device = k_inv.device
    num_pix = height * width
    chunk = min(cfg.render_chunk, num_pix)
    if mesh is not None:
        chunk = -(-chunk // mesh.size) * mesh.size
    n_chunks = -(-num_pix // chunk)
    padded = n_chunks * chunk
    rr, cc = np.meshgrid(np.arange(height, dtype=np.float32),
                         np.arange(width, dtype=np.float32), indexing="ij")
    rows = torch.from_numpy(np.pad(rr.reshape(-1), (0, padded - num_pix))).to(device)
    cols = torch.from_numpy(np.pad(cc.reshape(-1), (0, padded - num_pix))).to(device)

    def march(params, r, c, pose):
        """The rays' C_fine (and depth, acc with ``extras``)."""
        out = render.render_rays(
            net_params(cfg, params), r, c, pose, k_inv,
            cfg.n_coarse, cfg.n_fine, field_fn=field_fn,
            compat_sort=cfg.compat_sort, ndc_params=ndc_params,
            merge_impl="twolist", white_bkgd=cfg.white_bkgd, occ_grid=occ_grid,
            occ_march=cfg.occ_march_steps, occ_contract=cfg.contract,
            occ_march_res=cfg.occ_march_res, extras=extras,
            prop_params=prop_params(cfg, params), prop_field_fn=prop_fn,
            lindisp=cfg.lindisp)
        return out[1:4] if extras else out[1:2]

    if (mesh is not None and mesh.n_sample > 1 and occ_grid is None and not extras
            and not cfg.compat_sort and not cfg.proposal and cfg.n_fine > 0
            and ndc_params is None and not cfg.lindisp):
        from tinynerf_torch.parallel.sample_shard import make_sample_sharded_render
        sh_render = make_sample_sharded_render(mesh, k_inv, cfg.n_coarse, cfg.n_fine,
                                               field_fn=field_fn, white_bkgd=cfg.white_bkgd)
        march = lambda params, r, c, pose: sh_render(params, r, c, pose)[1:]
    elif mesh is not None:
        march = meshlib.sharded_render_chunk(march, mesh)

    if device.type == "cuda" and (mesh is None or (dist.captures(mesh.data)
                                                   and dist.captures(mesh.sample))):
        group = n_chunks if not host_chunks else max(1, min(int(host_chunks), n_chunks))
        return _graphed(march, rows, cols, chunk, group, (height, width), extras,
                        collectives=mesh is not None and mesh.size > 1)

    @torch.no_grad()
    def frame(params, pose17_row):
        with profiling.span("frame"):
            with profiling.span("frame.pose"):
                pose_row = torch.as_tensor(pose17_row, dtype=torch.float32, device=device)
            pose = pose_row.expand(chunk, 17)
            rgb = torch.empty((padded, 3), dtype=torch.float32, device=device)
            depth = torch.empty((padded,), dtype=torch.float32, device=device)
            acc = torch.empty((padded,), dtype=torch.float32, device=device)
            for i in range(n_chunks):
                span = slice(i * chunk, (i + 1) * chunk)
                out = march(params, rows[span], cols[span], pose)
                rgb[span] = out[0]
                if extras:
                    depth[span], acc[span] = out[1], out[2]
            with profiling.span("frame.readback"):
                img = rgb[:num_pix].reshape(height, width, 3).cpu().numpy()
                if extras:
                    shp = (height, width)
                    return (img, depth[:num_pix].reshape(shp).cpu().numpy(),
                            acc[:num_pix].reshape(shp).cpu().numpy())
            return img

    return frame


def _graphed(march, rows: torch.Tensor, cols: torch.Tensor, chunk: int, group: int,
             shape, extras: bool, collectives: bool = False):
    """``make_frame_fn``'s frame on the card: ``group`` chunks of ``chunk``
    rays a CUDA graph (``graphs.capture``; ``collectives``: the march calls
    NCCL collectives), over static pixel, pose and output buffers, replayed
    for each group of the view. The first call renders its first group
    eagerly (``graphs.warm``: the libraries and caches the chunks need, and
    the communicators) and then captures; a call with params at other
    addresses than the captured ones captures again."""
    from tinynerf_torch import graphs
    device = rows.device
    n_chunks = rows.shape[0] // chunk
    n_groups = -(-n_chunks // group)
    span = group * chunk
    if n_groups * group > n_chunks:   # whole groups: repeat the last chunk
        extra = n_groups * group - n_chunks
        rows = torch.cat([rows, rows[-chunk:].repeat(extra)])
        cols = torch.cat([cols, cols[-chunk:].repeat(extra)])
    # the group's pixels: the whole view's where one group covers it
    g_rows, g_cols = ((rows, cols) if n_groups == 1 else
                      (torch.empty(span, device=device), torch.empty(span, device=device)))
    pose_buf = torch.empty(17, dtype=torch.float32, device=device)
    outs = [torch.empty((span, 3), device=device)] + (
        [torch.empty(span, device=device), torch.empty(span, device=device)] if extras else [])
    # the graph, the params' addresses it read, and the warm-up's seconds
    held = {"graph": None, "params": None, "warm_s": None}

    def body(params):
        pose = pose_buf.expand(chunk, 17)
        for j in range(group):
            sl = slice(j * chunk, (j + 1) * chunk)
            for buf, out in zip(outs, march(params, g_rows[sl], g_cols[sl], pose)):
                buf[sl] = out

    @torch.no_grad()
    def frame(params, pose17_row):
        with profiling.span("frame"):
            return _frame(params, pose17_row)

    def _frame(params, pose17_row):
        with profiling.span("frame.pose"):
            pose_buf.copy_(torch.as_tensor(pose17_row, dtype=torch.float32))
        at = [(t.data_ptr(), t.shape, t.dtype) for t in optim.leaves(params)]
        if held["params"] != at:
            held["graph"], held["params"] = None, at
        planes = (outs if n_groups == 1 else
                  [torch.empty((n_groups * span, *o.shape[1:]), device=device) for o in outs])
        for gi in range(n_groups):
            if n_groups > 1:
                g_rows.copy_(rows[gi * span:(gi + 1) * span])
                g_cols.copy_(cols[gi * span:(gi + 1) * span])
            if held["graph"] is None:
                t0 = time.perf_counter()
                graphs.warm(functools.partial(body, params), device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                held["warm_s"] = time.perf_counter() - t0
                held["graph"] = graphs.capture(functools.partial(body, params), device,
                                               collectives=collectives)
                profiling.gauge("graph.nodes.frame", held["graph"].nodes * n_groups)
            else:
                with profiling.span("frame.launch"):
                    held["graph"].replay()
            if n_groups > 1:
                for plane, out in zip(planes, outs):
                    plane[gi * span:(gi + 1) * span] = out
        height, width = shape
        num_pix = height * width
        with profiling.span("frame.readback"):
            img = planes[0][:num_pix].reshape(height, width, 3).cpu().numpy()
            if extras:
                return (img, planes[1][:num_pix].reshape(shape).cpu().numpy(),
                        planes[2][:num_pix].reshape(shape).cpu().numpy())
        return img

    frame.graph = held
    return frame


def mse_to_db(mse: float) -> float:
    """Mean-squared error ([0,1]-range signal) -> PSNR dB."""
    if mse == 0:
        return float("inf")
    return -10.0 * float(np.log10(mse))


def psnr(pred: np.ndarray, target: np.ndarray) -> float:
    return mse_to_db(float(np.mean((pred - target) ** 2)))


def ssim(pred: np.ndarray, target: np.ndarray, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity (Wang et al. 2004) with the standard NeRF-eval
    settings: 11x11 gaussian window (sigma 1.5), dynamic range 1.0,
    per-channel then averaged. pred/target (H, W, 3) in [0, 1]."""
    from scipy.ndimage import gaussian_filter

    c1, c2 = k1 ** 2, k2 ** 2
    blur = lambda x: np.stack(
        [gaussian_filter(x[..., c], sigma, truncate=10.0 / 3.0)
         for c in range(x.shape[-1])], axis=-1)
    mu_p, mu_t = blur(pred), blur(target)
    var_p = blur(pred * pred) - mu_p * mu_p
    var_t = blur(target * target) - mu_t * mu_t
    cov = blur(pred * target) - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return float(np.mean(num / den))


def _write_video(base: str, frames_u8: np.ndarray, fps: int) -> None:
    """``base.mp4`` where imageio imports and has a video backend, else
    ``base.gif`` (``imagefile.write_gif``)."""
    try:
        import imageio
        imageio.mimwrite(base + ".mp4", frames_u8, fps=fps)
        return
    except (ImportError, ValueError, IOError):
        pass
    imagefile.write_gif(base + ".gif", frames_u8, fps=fps)


def render_test_set(cfg: Config, params: Any, table: RayTable,
                    k_inv: torch.Tensor, start_time: str, last_iter: int,
                    field_fn=None, save: bool = True,
                    max_views: Optional[int] = None,
                    depth: bool = False, occ_grid=None,
                    ndc_params=None, mesh: Optional[meshlib.Mesh] = None,
                    host_chunks: int = 0) -> np.ndarray:
    """Render every view of ``table`` in order; with ``save`` write per-view
    JPGs under ``results_path/<start_time>/`` and a video. ``depth=True``
    also writes ``<pic>_depth.jpg`` and ``<pic>_acc.jpg`` (under NDC the
    depth is in NDC units, [0, 1] already). Returns the (N, H, W, 3) stack,
    clipped to [0, 1]. Under a ``mesh`` every rank renders and returns
    the frames (``make_frame_fn``) and only rank 0 writes them.
    ``host_chunks``: ``make_frame_fn``'s."""
    save = save and dist.is_main_process()
    frame_fn = make_frame_fn(cfg, k_inv, table.height, table.width,
                             field_fn=field_fn, extras=depth, occ_grid=occ_grid,
                             ndc_params=ndc_params, mesh=mesh, host_chunks=host_chunks)
    n_views = table.num_pics if max_views is None else min(max_views, table.num_pics)
    frames = np.empty((n_views, table.height, table.width, 3), np.float32)
    if depth:
        depths = np.empty((n_views, table.height, table.width), np.float32)
        accs = np.empty_like(depths)
    poses = table.poses.cpu().numpy()
    for pic in range(n_views):
        out = frame_fn(params, poses[pic])
        if depth:
            frames[pic], depths[pic], accs[pic] = out
        else:
            frames[pic] = out
    frames = np.clip(frames, 0.0, 1.0)

    if save:
        save_dir = os.path.join(cfg.results_path, start_time)
        os.makedirs(save_dir, exist_ok=True)
        for pic in range(n_views):
            imagefile.write_jpeg(os.path.join(save_dir, f"{pic}.jpg"),
                                 (frames[pic] * 255.0).astype(np.uint8))
            if depth:
                # under NDC the march runs t in [0, 1]: normalising by the
                # world near/far would clip the depth
                near, far = ((0.0, 1.0) if ndc_params is not None
                             else (poses[pic, 15], poses[pic, 16]))
                dn = np.clip((depths[pic] - near) / max(far - near, 1e-6),
                             0.0, 1.0)
                imagefile.write_jpeg(os.path.join(save_dir, f"{pic}_depth.jpg"),
                                     ((1.0 - dn) * 255.0).astype(np.uint8))
                imagefile.write_jpeg(os.path.join(save_dir, f"{pic}_acc.jpg"),
                                     (np.clip(accs[pic], 0, 1) * 255.0).astype(np.uint8))
        _write_video(os.path.join(cfg.results_path, f"{start_time}_{last_iter}"),
                     (frames * 255.0).astype(np.uint8), fps=30)
    return frames


def render_path(cfg: Config, params: Any, pose_rows: np.ndarray,
                k_inv: torch.Tensor, out_base: str, field_fn=None,
                fps: int = 30, save: bool = True, occ_grid=None,
                ndc_params=None, mesh: Optional[meshlib.Mesh] = None,
                host_chunks: int = 0) -> np.ndarray:
    """Render a camera path (``data/paths.py``) to a video. The frame size
    comes from the pose rows' h/w column; ``k_inv`` must match it. Under a
    ``mesh``, as ``render_test_set``: rank 0 writes the video.
    ``host_chunks``: ``make_frame_fn``'s."""
    save = save and dist.is_main_process()
    height = int(pose_rows[0, :15].reshape(3, 5)[0, 4])
    width = int(pose_rows[0, :15].reshape(3, 5)[1, 4])
    frame_fn = make_frame_fn(cfg, k_inv, height, width, field_fn=field_fn,
                             occ_grid=occ_grid, ndc_params=ndc_params, mesh=mesh,
                             host_chunks=host_chunks)
    frames = np.empty((pose_rows.shape[0], height, width, 3), np.float32)
    for i in range(pose_rows.shape[0]):
        frames[i] = frame_fn(params, pose_rows[i])
    frames = np.clip(frames, 0.0, 1.0)
    if save:
        os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
        _write_video(out_base, (frames * 255.0).astype(np.uint8), fps=fps)
    return frames


def test_psnr(frames: np.ndarray, table: RayTable) -> float:
    """Mean PSNR of rendered frames against the split's ground truth."""
    return float(np.mean([psnr(frames[i], table.image(i))
                          for i in range(frames.shape[0])]))


def test_ssim(frames: np.ndarray, table: RayTable) -> float:
    """Mean SSIM of rendered frames against the split's ground truth."""
    return float(np.mean([ssim(frames[i], table.image(i))
                          for i in range(frames.shape[0])]))
