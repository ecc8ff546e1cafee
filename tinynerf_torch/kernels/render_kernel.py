"""The fused renderer's hand-written CUDA kernels and their plain versions.

Counterpart of ``tinynerf/kernels/render_kernel.py`` (``FUSED_RENDER``):
``render_fused(params, origins, dirs, t_co, near, far, n_fine, white_bkgd,
precision) -> (C_coarse, C_fine)``, each (B, 3) float32, the whole
coarse -> fine renderer of a ray batch in one kernel: the 8x256 field at the
coarse t's, the coarse weights (delta ``(far - near) / N_c``, inclusive
cumsum, Q5) and composite, the inverse-CDF resample (slope ``(far - near) /
(N_c - 1) / (w + 1e-7)``, the coarse weights not detached, Q8), the field at
the fine t's and the merged composite of both sorted lists (a coarse sample
first at an equal t). ``white_bkgd`` adds ``1 - sum w`` to both colors.

- Its forward, ``render_fused_plain`` in plain PyTorch, is TPU kernel 9
  (``_fused_render_forward`` / ``_fwd_kernel``), ``csrc/render_fused_fwd.cu``
  on the card; its backward, ``render_fused_bwd_plain``, the VJP to the
  params alone, is TPU kernel 10 (``_fused_render_backward``),
  ``csrc/render_fused_bwd.cu``. ``render_fused`` is an ``autograd.Function``
  over the two; the ray inputs get no gradient (``None``), as the JAX VJP
  returns zeros: they are data.
- Kernel 10 starts from kernel 9's per-ray state, its residuals (the fine
  t's and both passes' sigma and color, ``split_residuals``), rather than
  running the forward again: under autograd ``render_fused`` asks kernel 9
  for them where a backward can follow (grad mode on, a param requiring
  grad) and saves them; ``render_fused_bwd`` without ``residuals=`` first
  launches kernel 9 for them. Its first launch, the merge's backward, is
  ``merge_bwd`` (plain version ``merge_bwd_plain``), a launch of its own
  for checks. On CPU tensors ``render_fused`` keeps the plain forward's
  autograd graph instead, so its backward runs no forward either.
- On CPU tensors each wrapper runs its plain version; on CUDA tensors it
  launches its kernel or raises. ``render_fused.launches``,
  ``render_fused_bwd.launches`` and ``merge_bwd.launches`` count the calls
  that launched each kernel.
- For checks, ``render_fused_ts`` also returns the forward's fine t's and
  ``render_fused_residuals`` all its residuals; ``grads_agree`` holds the
  backward kernel against the plain backward taken at kernel 9's t's
  (GRAD_COS, GRAD_NORM).
- On CUDA tensors the wrappers refuse by name the sample counts whose
  per-ray state does not fit in a block's shared memory (``_check_fits``);
  the plain versions take every shape.
- ``fwd_phase_split`` reads the forward's time by phase from a clock64
  variant build (a measurement, not a path); ``WEIGHT_PROBE_DEFINES`` names
  another variant, for a measurement too, whose bf16 products read a
  quarter of the weights (wrong colors; ``csrc/field_tc.cuh``).

Rounding at ``precision="bf16"``: the kernels run the field kernels' bf16
form (``mlp.apply_network(precision="bf16")``), and the backward is kernel
2's (``field_rays_bwd``) on both passes, so the color head's pre-activation
gradient stays float32 as TPU kernel 2 keeps it. The TPU's
``render_kernel._grad_chain`` rounds that one gradient to bf16 as well; the
port's plain backward, autograd of ``render_fused_plain``, follows kernel
2's convention, the difference one bf16 rounding of a head gradient.

Inside a step with spans on, the fused renderer runs as the device sections
``render_fused.fwd`` and ``render_fused.bwd``, the merge's backward alone as
``merge.bwd`` (``profiling.section``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from tinynerf_torch import profiling
from tinynerf_torch.core import mlp, render, sampling
from tinynerf_torch.kernels import mlp_kernel as mk

FWD_SOURCE = "render_fused_fwd.cu"
BWD_SOURCE = "render_fused_bwd.cu"

Colors = Tuple[torch.Tensor, torch.Tensor]


def flops_per_ray(n_coarse: int, n_fine: int) -> int:
    """FLOPs of the field at one ray's samples (the tail's few are not
    counted): 1,182,976 x (N_c + N_f). The backward does three times as
    many."""
    return mk.flops_per_row() * (n_coarse + n_fine)


def render_fused_plain(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                       t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                       n_fine: int, white_bkgd: bool = False,
                       precision: str = "fp32", fine_ts: torch.Tensor = None) -> Colors:
    """The same function as the forward kernel in plain PyTorch: origins,
    dirs (B, 3), t_co (B, N_c) sorted per ray, near, far (B,) -> (C_coarse,
    C_fine) (B, 3). Differentiable. With ``fine_ts`` (B, N_f) the fine
    samples sit at those t's (the kernel's own, from ``render_fused_ts``),
    differentiated as the resampler's."""
    return _plain(params, origins, dirs, t_co, near, far, n_fine, white_bkgd, precision,
                  fine_ts)[:2]


def _plain(params, origins, dirs, t_co, near, far, n_fine, white_bkgd, precision,
           fine_ts=None, residuals=False):
    """``render_fused_plain`` -> (C_coarse, C_fine, the fine t's), and with
    ``residuals`` the residual buffer (``split_residuals``) fourth."""
    n_coarse = t_co.shape[1]
    color_co, sigma_co = mk.field_rays_plain(params, origins, dirs, t_co, precision)
    delta_co = ((far - near) / n_coarse)[:, None].expand(t_co.shape)
    dense_co = render.get_density(delta_co, sigma_co)
    c_co = render.composite(dense_co, color_co)
    if white_bkgd:
        c_co = c_co + (1.0 - torch.sum(dense_co, dim=1))[:, None]
    t_fi = sampling.resample(t_co, dense_co, (far - near) / (n_coarse - 1), n_fine)
    if fine_ts is not None:
        t_fi = fine_ts.detach() + (t_fi - t_fi.detach())   # their value, its derivative
    color_fi, sigma_fi = mk.field_rays_plain(params, origins, dirs, t_fi, precision)
    c_fi = render.merged_composite(t_co, t_fi, sigma_co, sigma_fi, color_co, color_fi,
                                   white_bkgd=white_bkgd)
    if not residuals:
        return c_co, c_fi, t_fi
    planes = (t_fi, sigma_co, torch.stack(color_co), sigma_fi, torch.stack(color_fi))
    return c_co, c_fi, t_fi, torch.cat([x.detach().reshape(-1) for x in planes])


class Residuals(NamedTuple):
    """Kernel 9's per-ray state that kernel 10 starts from: views of one
    float32 buffer of B (4 N_c + 5 N_f) floats, in this order
    (``csrc/render_common.cuh``, ``Res``)."""
    t_fi: torch.Tensor     # (B, N_f) the fine t's
    sig_co: torch.Tensor   # (B, N_c) the coarse sigma
    col_co: torch.Tensor   # (3, B, N_c) the coarse color
    sig_fi: torch.Tensor   # (B, N_f)
    col_fi: torch.Tensor   # (3, B, N_f)


def split_residuals(res: torch.Tensor, n_rays: int, n_coarse: int, n_fine: int) -> Residuals:
    """The views of a residual buffer (``render_fused_residuals``)."""
    shapes = ((n_rays, n_fine), (n_rays, n_coarse), (3, n_rays, n_coarse), (n_rays, n_fine),
              (3, n_rays, n_fine))
    if res.shape != (n_rays * (4 * n_coarse + 5 * n_fine),):
        raise ValueError(f"render_fused: a residual buffer of {n_rays} rays at {n_coarse} + "
                         f"{n_fine} samples holds {n_rays * (4 * n_coarse + 5 * n_fine)} "
                         f"floats, not {tuple(res.shape)}")
    parts = torch.split(res, [math.prod(s) for s in shapes])
    return Residuals(*(x.view(s) for x, s in zip(parts, shapes)))


def render_fused_bwd_plain(params: mlp.Params, origins: torch.Tensor,
                           dirs: torch.Tensor, t_co: torch.Tensor, near: torch.Tensor,
                           far: torch.Tensor, g_cco: torch.Tensor, g_cfi: torch.Tensor,
                           n_fine: int, white_bkgd: bool = False,
                           precision: str = "fp32", fine_ts: torch.Tensor = None,
                           ) -> mlp.Params:
    """The same function as the backward kernel in plain PyTorch: the VJP of
    ``render_fused_plain`` (at ``fine_ts``, where given) with the (B, 3)
    cotangents of both colors, to the params only -> a gradient tree shaped
    like ``params``."""
    with torch.enable_grad():
        leaves = {name: {k: t.detach().requires_grad_(True) for k, t in layer.items()}
                  for name, layer in params.items()}
        rays = (x.detach() for x in (origins, dirs, t_co, near, far))
        c_co, c_fi = render_fused_plain(leaves, *rays, n_fine, white_bkgd, precision, fine_ts)
        flat = [leaves[name][k] for name, k in mk._PARAM_KEYS]
        out = torch.autograd.grad((c_co, c_fi), flat, (g_cco, g_cfi))
    return mk._unflatten(out)


class MergeGrads(NamedTuple):
    """What kernel 10's first launch, the merge's backward, hands on, and the
    C_fine of the merge it recomputed."""
    g_fi: torch.Tensor    # (4, B, N_f): the fine samples' (sigma, r, g, b) cotangents
    gt_fi: torch.Tensor   # (B, N_f): the fine t's cotangents, through the merge's deltas
    g_co: torch.Tensor    # (4, B, N_c): the coarse (sigma, r, g, b): sigma's from the
    #                       merge, the colors' from both composites
    gw_co: torch.Tensor   # (B, N_c): the coarse composite's cotangent of each coarse weight
    c_fi: torch.Tensor    # (B, 3): C_fine


def merge_bwd_plain(t_co: torch.Tensor, t_fi: torch.Tensor, sig_co: torch.Tensor,
                    sig_fi: torch.Tensor, col_co: torch.Tensor, col_fi: torch.Tensor,
                    near: torch.Tensor, far: torch.Tensor, g_cco: torch.Tensor,
                    g_cfi: torch.Tensor, white_bkgd: bool = False) -> MergeGrads:
    """The same function as kernel 10's merge launch in plain PyTorch: from
    the coarse t's (B, N_c), kernel 9's residuals (``Residuals``: the fine
    t's, each pass's sigma (B, N) and color (3, B, N)), the bounds (B,) and
    the (B, 3) cotangents of both colors, the VJP of ``render.merged_composite``
    (C_fine) and of the coarse composite (C_coarse, its weights a leaf: the
    resampler's launch takes their cotangent on) -> ``MergeGrads``."""
    n_coarse = t_co.shape[1]
    with torch.enable_grad():
        sig_co, sig_fi, col_co, col_fi, t_fi = (
            x.detach().requires_grad_(True) for x in (sig_co, sig_fi, col_co, col_fi, t_fi))
        delta = ((far - near) / n_coarse)[:, None].expand(t_co.shape)
        w_co = render.get_density(delta, sig_co.detach()).requires_grad_(True)
        c_co = render.composite(w_co, tuple(col_co))
        if white_bkgd:
            c_co = c_co + (1.0 - torch.sum(w_co, dim=1))[:, None]
        c_fi = render.merged_composite(t_co, t_fi, sig_co, sig_fi, tuple(col_co),
                                       tuple(col_fi), white_bkgd=white_bkgd)
        gs_co, gs_fi, gcol_co, gcol_fi, gt_fi, gw_co = torch.autograd.grad(
            (c_co, c_fi), (sig_co, sig_fi, col_co, col_fi, t_fi, w_co), (g_cco, g_cfi))
    return MergeGrads(torch.cat([gs_fi[None], gcol_fi]), gt_fi,
                      torch.cat([gs_co[None], gcol_co]), gw_co, c_fi.detach())

# the forward's phase-clock variant build (a measurement's; fwd_phase_split)
PHASE_DEFINES = ("RENDER_PHASE_CLOCKS",)
PHASES = ("coarse field", "coarse weights", "resample", "fine field", "merge")
TAIL_PHASES = ("coarse weights", "resample", "merge")
# the forward's weight probe build: each bf16 product reads its first two
# weight K-tiles alone (a measurement's, through _launch(defines=...))
WEIGHT_PROBE_DEFINES = ("FIELD_TC_WEIGHT_PROBE",)


@functools.lru_cache(maxsize=None)
def _library(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    from tinynerf_torch.kernels.build import load_library
    lib = load_library(source, defines)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if source == FWD_SOURCE:
        lib.render_fused_fwd.argtypes = [vp] * 10 + [i32] * 5 + [vp]
        lib.render_fused_fwd.restype = i32
        lib.field_packed_weights_elems.argtypes = []
        lib.field_packed_weights_elems.restype = i32
        lib.render_fused_residual_floats.argtypes = [i32] * 3
        lib.render_fused_residual_floats.restype = ctypes.c_longlong
        lib.render_fused_fwd_smem_bytes.argtypes = [i32] * 3
        lib.render_fused_fwd_smem_bytes.restype = i32
        lib.render_fused_fwd_rays_per_block.argtypes = [i32] * 3
        lib.render_fused_fwd_rays_per_block.restype = i32
        lib.render_fused_block_threads.argtypes = [i32]
        lib.render_fused_block_threads.restype = i32
        lib.render_fused_tile_rows.argtypes = [i32]
        lib.render_fused_tile_rows.restype = i32
        if defines == PHASE_DEFINES:
            lib.render_fused_fwd_phase_blocks.argtypes = []
            lib.render_fused_fwd_phase_blocks.restype = i32
            lib.render_fused_fwd_phase_clocks.argtypes = [vp, vp]
            lib.render_fused_fwd_phase_clocks.restype = i32
    else:
        lib.render_fused_bwd.argtypes = [vp] * 11 + [i32] * 5 + [vp]
        lib.render_fused_bwd.restype = i32
        lib.render_fused_merge_bwd.argtypes = [vp] * 15 + [i32] * 4 + [vp]
        lib.render_fused_merge_bwd.restype = i32
        lib.render_fused_bwd_smem_bytes.argtypes = [i32] * 2
        lib.render_fused_bwd_smem_bytes.restype = i32
        lib.render_fused_bwd_rays_per_block.argtypes = [i32] * 2
        lib.render_fused_bwd_rays_per_block.restype = i32
        lib.render_fused_bwd_workspace_floats.argtypes = [i32] * 3
        lib.render_fused_bwd_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check_fits(n_coarse: int, n_fine: int, precision: str, backward: bool = False) -> None:
    """Raise ValueError, before any launch, for sample counts that kernel 9
    (and, with ``backward``, kernel 10's merge launch as well) does not
    take: fewer than 2 coarse or 1 fine samples, or a ray whose per-sample
    state does not fit in a block's shared memory (the library's rays per
    block is 0)."""
    if n_coarse < 2 or n_fine < 1:
        raise ValueError(f"render_fused: the kernels take N_c >= 2 and N_f >= 1 samples a "
                         f"ray, not {n_coarse} + {n_fine}")
    fits = _library(FWD_SOURCE).render_fused_fwd_rays_per_block(
        n_coarse, n_fine, int(precision == "bf16")) > 0
    if backward:
        fits = fits and _library(BWD_SOURCE).render_fused_bwd_rays_per_block(n_coarse,
                                                                             n_fine) > 0
    if not fits:
        raise ValueError(f"render_fused: {n_coarse} coarse + {n_fine} fine samples a ray do "
                         f"not fit one block's shared memory in the {precision} "
                         f"{'backward' if backward else 'forward'} kernels; the plain "
                         "version (CPU tensors) takes them")


def _check_rays(origins, dirs, t_co, near, far) -> None:
    device, (B, _) = origins.device, t_co.shape
    mk._check("origins", origins, (B, 3), device)
    mk._check("dirs", dirs, (B, 3), device)
    mk._check("t_co", t_co, t_co.shape, device)
    mk._check("near", near, (B,), device)
    mk._check("far", far, (B,), device)


def _launch(params: mlp.Params, origins, dirs, t_co, near, far, n_fine: int,
            white_bkgd: bool, precision: str, residuals: bool = False,
            defines: Tuple[str, ...] = ()):
    """(C_coarse, C_fine), and with ``residuals`` the residual buffer
    (``split_residuals``) third; with ``defines``, through that variant
    build (counted apart: not a path's launch)."""
    device, (B, n_coarse) = origins.device, t_co.shape
    _check_rays(origins, dirs, t_co, near, far)
    ptrs = mk._param_ptrs(params, device)
    _check_fits(n_coarse, n_fine, precision)
    lib = _library(FWD_SOURCE, defines)
    c_co, c_fi = (torch.empty((B, 3), dtype=torch.float32, device=device) for _ in range(2))
    res = (torch.empty(lib.render_fused_residual_floats(B, n_coarse, n_fine),
                       dtype=torch.float32, device=device) if residuals else None)
    packed = mk.packed_weights(lib, precision, device)
    with torch.cuda.device(device):
        err = lib.render_fused_fwd(
            origins.data_ptr(), dirs.data_ptr(), t_co.data_ptr(), near.data_ptr(),
            far.data_ptr(), ptrs, c_co.data_ptr(), c_fi.data_ptr(), mk._ptr(res),
            mk._ptr(packed), B, n_coarse, n_fine, int(white_bkgd),
            int(precision == "bf16"), mk._stream(device))
    if err != 0:
        raise RuntimeError(f"render_fused_fwd kernel launch failed: CUDA error {err}")
    if not defines:
        render_fused.launches += 1
    return (c_co, c_fi) if res is None else (c_co, c_fi, res)


def _launch_bwd(params: mlp.Params, origins, dirs, t_co, near, far, g_cco, g_cfi,
                n_fine: int, white_bkgd: bool, precision: str, residuals: torch.Tensor):
    """The gradient tree from kernel 9's residual buffer for these rays."""
    device, (B, n_coarse) = origins.device, t_co.shape
    _check_rays(origins, dirs, t_co, near, far)
    mk._check("g_cco", g_cco, (B, 3), device)
    mk._check("g_cfi", g_cfi, (B, 3), device)
    split_residuals(residuals, B, n_coarse, n_fine)
    mk._check("residuals", residuals, residuals.shape, device)
    ptrs = mk._param_ptrs(params, device)
    _check_fits(n_coarse, n_fine, precision, backward=True)
    lib = _library(BWD_SOURCE)
    f32 = dict(dtype=torch.float32, device=device)
    workspace = torch.empty(lib.render_fused_bwd_workspace_floats(B, n_coarse, n_fine), **f32)
    flat = torch.empty(mlp.num_params(params), **f32)
    with torch.cuda.device(device):
        err = lib.render_fused_bwd(
            origins.data_ptr(), dirs.data_ptr(), t_co.data_ptr(), near.data_ptr(),
            far.data_ptr(), g_cco.data_ptr(), g_cfi.data_ptr(), ptrs, residuals.data_ptr(),
            flat.data_ptr(), workspace.data_ptr(), B, n_coarse, n_fine, int(white_bkgd),
            int(precision == "bf16"), mk._stream(device))
    if err != 0:
        raise RuntimeError(f"render_fused_bwd kernel launch failed: CUDA error {err}")
    render_fused_bwd.launches += 1
    return mk.grads_from_flat(flat)


def _param_tensors(params: mlp.Params):
    return [t for layer in params.values() for t in layer.values()]


def render_fused_bwd(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                     t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                     g_cco: torch.Tensor, g_cfi: torch.Tensor, n_fine: int,
                     white_bkgd: bool = False, precision: str = "fp32",
                     residuals: torch.Tensor = None) -> mlp.Params:
    """The fused renderer's backward to the params, from kernel 9's
    ``residuals`` for these rays (``render_fused_residuals``), or without
    them from a launch of kernel 9 that makes them (counted in
    ``render_fused.launches``): CUDA tensors launch the kernels; CPU tensors
    take ``render_fused_bwd_plain`` (at the residuals' fine t's, where
    given)."""
    return render_fused_bwd_ts(params, origins, dirs, t_co, near, far, g_cco, g_cfi, n_fine,
                               white_bkgd, precision, residuals)[0]


render_fused_bwd.launches = 0


def render_fused_bwd_ts(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                        t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                        g_cco: torch.Tensor, g_cfi: torch.Tensor, n_fine: int,
                        white_bkgd: bool = False, precision: str = "fp32",
                        residuals: torch.Tensor = None) -> Tuple[mlp.Params, torch.Tensor]:
    """``render_fused_bwd`` that also returns the fine t's (B, N_f) at which
    it took the fine field's backward: the residuals' (a view of the buffer
    given, or of the one kernel 9 made), or without residuals on CPU tensors
    the plain forward's."""
    mk._check_precision(precision)
    B, n_coarse = t_co.shape
    args = (params, origins, dirs, t_co, near, far, g_cco, g_cfi, n_fine, white_bkgd,
            precision)
    tensors = [origins, dirs, t_co, near, far, g_cco, g_cfi] + _param_tensors(params)
    if mk._on_one_device(tensors, "render_fused_bwd"):
        _check_fits(n_coarse, n_fine, precision, backward=True)
        if residuals is None:
            residuals = _launch(params, origins, dirs, t_co, near, far, n_fine, white_bkgd,
                                precision, residuals=True)[2]
        t_fi = split_residuals(residuals, B, n_coarse, n_fine).t_fi
        return _launch_bwd(*args, residuals), t_fi
    if residuals is None:
        with torch.no_grad():
            t_fi = _plain(params, origins, dirs, t_co, near, far, n_fine, white_bkgd,
                          precision)[2]
        return render_fused_bwd_plain(*args), t_fi
    t_fi = split_residuals(residuals, B, n_coarse, n_fine).t_fi
    return render_fused_bwd_plain(*args, t_fi), t_fi


def _launch_merge(t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi,
                  white_bkgd: bool) -> MergeGrads:
    """Kernel 10's merge launch alone."""
    t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi = (
        mk._kernel_ready(x) for x in (t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far,
                                      g_cco, g_cfi))
    device, (B, n_coarse), n_fine = t_co.device, t_co.shape, t_fi.shape[1]
    for name, x, shape in (("t_co", t_co, (B, n_coarse)), ("t_fi", t_fi, (B, n_fine)),
                           ("sig_co", sig_co, (B, n_coarse)), ("sig_fi", sig_fi, (B, n_fine)),
                           ("col_co", col_co, (3, B, n_coarse)),
                           ("col_fi", col_fi, (3, B, n_fine)), ("near", near, (B,)),
                           ("far", far, (B,)), ("g_cco", g_cco, (B, 3)),
                           ("g_cfi", g_cfi, (B, 3))):
        mk._check(name, x, shape, device)
    if n_coarse < 2 or n_fine < 1 or _library(BWD_SOURCE).render_fused_bwd_rays_per_block(
            n_coarse, n_fine) == 0:
        raise ValueError(f"render_fused: the merge's backward does not take {n_coarse} "
                         f"coarse + {n_fine} fine samples a ray")
    lib = _library(BWD_SOURCE)
    f32 = dict(dtype=torch.float32, device=device)
    out = MergeGrads(torch.empty((4, B, n_fine), **f32), torch.empty((B, n_fine), **f32),
                     torch.empty((4, B, n_coarse), **f32), torch.empty((B, n_coarse), **f32),
                     torch.empty((B, 3), **f32))
    with torch.cuda.device(device):
        err = lib.render_fused_merge_bwd(
            *(x.data_ptr() for x in (t_co, near, far, g_cco, g_cfi, t_fi, sig_co, col_co,
                                     sig_fi, col_fi)),
            *(x.data_ptr() for x in out), B, n_coarse, n_fine, int(white_bkgd),
            mk._stream(device))
    if err != 0:
        raise RuntimeError(f"render_fused_merge_bwd kernel launch failed: CUDA error {err}")
    merge_bwd.launches += 1
    return out


def merge_bwd(t_co: torch.Tensor, t_fi: torch.Tensor, sig_co: torch.Tensor,
              sig_fi: torch.Tensor, col_co: torch.Tensor, col_fi: torch.Tensor,
              near: torch.Tensor, far: torch.Tensor, g_cco: torch.Tensor, g_cfi: torch.Tensor,
              white_bkgd: bool = False) -> MergeGrads:
    """Kernel 10's first launch alone, the merge's backward from kernel 9's
    residuals (``merge_bwd_plain`` has the arguments): CUDA tensors launch
    it; CPU tensors take ``merge_bwd_plain``."""
    args = (t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi)
    with profiling.section("merge.bwd"):
        if mk._on_one_device(list(args), "merge_bwd"):
            return _launch_merge(*args, white_bkgd)
        return merge_bwd_plain(*args, white_bkgd)


merge_bwd.launches = 0


class _RenderFused(torch.autograd.Function):
    """``render_fused`` with ``render_fused_bwd`` as its backward, from the
    residuals that the forward kept where ``keep`` says a backward can
    follow: kernel 9's on the card, the plain forward's graph on the CPU."""

    @staticmethod
    def forward(ctx, origins, dirs, t_co, near, far, n_fine, white_bkgd, precision, keep,
                *flat):
        with profiling.section("render_fused.fwd"):
            return _RenderFused._forward(ctx, origins, dirs, t_co, near, far, n_fine,
                                         white_bkgd, precision, keep, *flat)

    @staticmethod
    def _forward(ctx, origins, dirs, t_co, near, far, n_fine, white_bkgd, precision, keep,
                 *flat):
        rays = (origins, dirs, t_co, near, far)
        ctx.config = (n_fine, white_bkgd, precision)
        if mk._on_one_device([*rays, *flat], "render_fused"):
            out = _launch(mk._unflatten(flat), *rays, n_fine, white_bkgd, precision,
                          residuals=keep)
            if keep:
                ctx.save_for_backward(*rays, out[2], *flat)
            return out[:2]
        if not keep:
            return render_fused_plain(mk._unflatten(flat), *rays, n_fine, white_bkgd,
                                      precision)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in flat]
            c_co, c_fi = render_fused_plain(mk._unflatten(leaves), *rays, n_fine,
                                            white_bkgd, precision)
        # saved so that a second backward needs the first to retain the
        # graph, as on the card (autograd frees saved tensors otherwise)
        ctx.save_for_backward(*flat)
        ctx.graph = (c_co, c_fi, leaves)
        return c_co.detach(), c_fi.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_cco, g_cfi):
        # the rays, t's and bounds are data: no gradient
        if not any(ctx.needs_input_grad[9:]):
            return (None,) * len(ctx.needs_input_grad)
        if hasattr(ctx, "graph"):
            ctx.saved_tensors   # raises on a backward through a freed graph
            c_co, c_fi, leaves = ctx.graph
            return (None,) * 9 + torch.autograd.grad((c_co, c_fi), leaves, (g_cco, g_cfi),
                                                     retain_graph=True)
        origins, dirs, t_co, near, far, res, *flat = ctx.saved_tensors
        with profiling.section("render_fused.bwd"):
            grads = _launch_bwd(mk._unflatten(flat), origins, dirs, t_co, near, far,
                                mk._kernel_ready(g_cco), mk._kernel_ready(g_cfi), *ctx.config,
                                res)
        return (None,) * 9 + tuple(grads[name][k] for name, k in mk._PARAM_KEYS)


def render_fused(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                 t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                 n_fine: int, white_bkgd: bool = False, precision: str = "fp32",
                 ) -> Colors:
    """Fused coarse + fine render of a ray batch: origins, dirs (B, 3), t_co
    (B, N_c) sorted per ray, near, far (B,) -> (C_coarse, C_fine), each (B,
    3) float32, differentiable in the params alone. CUDA tensors launch the
    kernels; CPU tensors take the plain versions. The forward keeps what
    the backward starts from only where one can follow: grad mode on and a
    param that requires grad."""
    mk._check_precision(precision)
    rays = [mk._kernel_ready(x.float()) for x in (origins, dirs, t_co, near, far)]
    flat = [params[name][k] for name, k in mk._PARAM_KEYS]
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in flat)
    return _RenderFused.apply(*rays, int(n_fine), bool(white_bkgd), precision, keep, *flat)


render_fused.launches = 0


def render_fused_residuals(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                           t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                           n_fine: int, white_bkgd: bool = False, precision: str = "fp32",
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``render_fused``'s forward, not differentiable, that also returns its
    residual buffer (``split_residuals``): CUDA tensors launch the forward
    kernel (counted in ``render_fused.launches``); CPU tensors take the plain
    version."""
    mk._check_precision(precision)
    rays = [mk._kernel_ready(x.detach().float()) for x in (origins, dirs, t_co, near, far)]
    if mk._on_one_device(rays + _param_tensors(params), "render_fused_residuals"):
        return _launch(params, *rays, n_fine, white_bkgd, precision, residuals=True)
    with torch.no_grad():
        c_co, c_fi, _, res = _plain(params, *rays, n_fine, white_bkgd, precision,
                                    residuals=True)
    return c_co, c_fi, res


def render_fused_ts(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                    t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                    n_fine: int, white_bkgd: bool = False, precision: str = "fp32",
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``render_fused_residuals`` with the fine t's (B, N_f) in place of the
    residual buffer."""
    c_co, c_fi, res = render_fused_residuals(params, origins, dirs, t_co, near, far, n_fine,
                                             white_bkgd, precision)
    return c_co, c_fi, split_residuals(res, *t_co.shape, n_fine).t_fi


def fwd_phase_split(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                    t_co: torch.Tensor, near: torch.Tensor, far: torch.Tensor, n_fine: int,
                    white_bkgd: bool = False, precision: str = "bf16") -> Dict[str, float]:
    """One launch of the forward's phase-clock variant (CUDA tensors): for
    each of ``PHASES``, its share of the blocks' summed clock cycles, and
    under "tail warps waiting" the share of the warp cycles of the tail
    phases (``TAIL_PHASES``) that the block's warps spent waiting at the
    phase's barrier. A measurement, not a path: the variant meets at a
    barrier at each phase's end, and ``render_fused.launches`` does not
    count it."""
    mk._check_precision(precision)
    rays = [mk._kernel_ready(x.detach().float()) for x in (origins, dirs, t_co, near, far)]
    lib = _library(FWD_SOURCE, PHASE_DEFINES)
    n = lib.render_fused_fwd_phase_blocks() * len(PHASES)
    clocks, busy = (ctypes.c_longlong * n)(), (ctypes.c_longlong * n)()

    def read_clocks():  # into `clocks` and `busy`, and zero them on the device
        with torch.cuda.device(origins.device):
            torch.cuda.synchronize()
            err = lib.render_fused_fwd_phase_clocks(ctypes.addressof(clocks),
                                                    ctypes.addressof(busy))
        if err != 0:
            raise RuntimeError(f"render_fused_fwd_phase_clocks failed: CUDA error {err}")

    read_clocks()
    _launch(params, *rays, n_fine, white_bkgd, precision, defines=PHASE_DEFINES)
    read_clocks()
    return phase_shares(clocks, busy,
                        lib.render_fused_block_threads(int(precision == "bf16")) // 32)


def phase_shares(clocks, busy, warps: int) -> Dict[str, float]:
    """``fwd_phase_split``'s dict from the variant's two (blocks,
    len(PHASES)) int64 arrays, flat, for blocks of ``warps`` warps."""
    k = len(PHASES)
    per_phase = [sum(clocks[i::k]) for i in range(k)]
    tail = [PHASES.index(p) for p in TAIL_PHASES]
    tail_busy = sum(sum(busy[i::k]) for i in tail)
    tail_cycles = warps * sum(per_phase[i] for i in tail)
    total = max(sum(per_phase), 1)
    split = {name: c / total for name, c in zip(PHASES, per_phase)}
    split["tail warps waiting"] = 1 - tail_busy / max(tail_cycles, 1)
    return split


# Kernel 10 against its plain version, each gradient tensor: the cosine, and
# at fp32 the norm ratio. The plain backward is taken at kernel 9's own fine
# t's (``render_fused_ts``): one ulp of a fine t moves the top encoding
# frequency's phase by 2^9 ulp(t) (2.4e-4 at t = 4), and two float32
# resamplers that sum their cdf in different orders differ by that ulp; at
# their own t's the two backwards miss these bounds (PERF.md, section 6).
GRAD_COS = {"fp32": 0.9999, "bf16": 0.999}
GRAD_NORM = 1e-2


def grad_agreement(got: mlp.Params, want: mlp.Params) -> dict:
    """{"layer.leaf": (cosine, norm ratio got / want, max |got - want|)} of
    two gradient trees of the MLP, in float64."""
    out = {}
    for name in want:
        for k in ("w", "b"):
            a, b = got[name][k].flatten().double(), want[name][k].flatten().double()
            out[f"{name}.{k}"] = (float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)),
                                  float(a.norm() / b.norm().clamp_min(1e-300)),
                                  float((a - b).abs().max()))
    return out


def grads_agree(got: mlp.Params, want: mlp.Params, precision: str):
    """Whether kernel 10's gradient tree ``got`` meets GRAD_COS (and, at
    fp32, GRAD_NORM) against the plain one ``want`` in every tensor ->
    (ok, the tensor of the smallest cosine, ``grad_agreement``'s rows)."""
    rows = grad_agreement(got, want)
    ok = all(c >= GRAD_COS[precision] and (precision == "bf16" or abs(r - 1) <= GRAD_NORM)
             for c, r, _ in rows.values())
    return ok, min(rows, key=lambda n: rows[n][0]), rows


# Kernel 10's merge launch against its plain version, each hand-off plane:
# its largest error against the float64 evaluation of ``merge_bwd_plain``
# on the same float32 inputs, relative to that plane's max, at most
# MERGE_RTOL more than the float32 plain version's own. The fine t's
# cotangents are differences of neighbouring samples' sigma x g_sd, and
# there the float32 plain version itself lies above 1e-5 of max from the
# float64 one (PERF.md, section 6), so no float32 evaluation meets a fixed
# 1e-5 against another.
MERGE_RTOL = 1e-5


def merge_agreement(got: MergeGrads, t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far,
                    g_cco, g_cfi, white_bkgd: bool = False):
    """Whether ``got`` (``merge_bwd``'s output on these inputs) meets
    MERGE_RTOL in every hand-off plane -> (ok, {plane: (got's error, the
    float32 plain version's error, got against the float32 plain)}), the
    errors against the float64 evaluation, each of that plane's max, and
    ``got``'s C_fine beside the plain's under "c_fi" (absolute)."""
    ins = (t_co, t_fi, sig_co, sig_fi, col_co, col_fi, near, far, g_cco, g_cfi)
    plain = merge_bwd_plain(*ins, white_bkgd)
    exact = merge_bwd_plain(*(x.double() for x in ins), white_bkgd)
    err = lambda a, b: float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-300))
    rows = {name: (err(g, e), err(p, e), err(g, p.double()))
            for name, g, p, e in zip(MergeGrads._fields[:4], got, plain, exact)}
    ok = all(g <= MERGE_RTOL + p for g, p, _ in rows.values())
    rows["c_fi"] = (float((got.c_fi.double() - exact.c_fi).abs().max()),
                    float((plain.c_fi.double() - exact.c_fi).abs().max()),
                    float((got.c_fi - plain.c_fi).abs().max()))
    return ok, rows

