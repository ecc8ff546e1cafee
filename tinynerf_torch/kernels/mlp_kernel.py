"""The field's hand-written CUDA kernels and their plain versions.

Counterpart of ``tinynerf/kernels/mlp_kernel.py``:

- ``field_rays(params, origins, dirs, ts)``, the counterpart of
  ``field_pallas_rays``: its forward (``_fused_ray_forward`` /
  ``_ray_fwd_kernel``, TPU kernel 1) and its recompute backward
  (``_fused_ray_backward`` / ``_ray_bwd_kernel``, TPU kernel 2). It
  evaluates the network at ``origin + t * dir`` for every (ray, sample)
  pair and returns ``((r, g, b), sigma)``, each a dense (B, N) float32
  plane. It is differentiable: an ``autograd.Function`` whose backward is
  ``field_rays_bwd``, which gives the gradients of every weight and bias,
  of ``origins``, ``dirs`` and ``ts``. Where a backward can follow a bf16
  call on the card (``saves_residuals``), the forward launches kernel 1's
  saving form, which keeps the ``Residuals`` of its tiles, and the backward
  starts from them instead of recomputing the forward.
- ``field_flat(params, points, dirs)``, the counterpart of
  ``field_pallas``: its forward (``_fused_forward`` / ``_fwd_kernel``, TPU
  kernel 3) over points and directions (..., 3) -> ``(color (..., 3),
  sigma (..., 1))``, and its recompute backward (``_fused_backward`` /
  ``_bwd_kernel``, TPU kernel 4). The occupancy grid's refresh calls it,
  and under ``CONTRACT`` (which warps the points outside any kernel) the
  renderer's every call. It is differentiable: an ``autograd.Function``
  whose backward is ``field_flat_bwd``, which gives the gradients of every
  weight and bias, of ``points`` and of ``dirs``.

Each takes ``precision``: ``"fp32"``, or ``"bf16"``, the TPU kernels'
``compute_dtype=bfloat16`` form (``mlp.apply_network``'s rounding: weights,
encodings and activations rounded to bfloat16, sums in float32), whose
kernels run their products on the tensor cores (``csrc/field_tc.cuh``).

- On CPU tensors each runs its plain PyTorch version (``field_rays_plain``,
  ``field_rays_bwd_plain``, ``field_flat_plain``, ``field_flat_bwd_plain``),
  which is what the CPU tests reach.
- On CUDA tensors each launches its kernel (``csrc/field_rays_fwd.cu``,
  ``csrc/field_rays_bwd.cu``, ``csrc/field_flat_fwd.cu``,
  ``csrc/field_flat_bwd.cu``) or raises; none falls back to a plain
  version. ``field_rays.launches``, ``field_rays_bwd.launches``,
  ``field_flat.launches`` and ``field_flat_bwd.launches`` count the calls
  that launched each kernel.

The TPU kernels' block-major encoding layout, permuted weight rows and
8-row tiles are TPU lane tricks, not semantics: the CUDA kernels read the
parameters in their ``(in, out)`` layout and mask the ragged end of the
rows.

Inside a step with spans on, each forward runs as the device section
``field.fwd`` and each backward as ``field.bwd`` (``profiling.section``).
The counters ``field.residual.saved`` and ``field.residual.recomputed``
count the ray form's bf16 forwards that kept residuals and its bf16
backwards that had none, so recomputed the forward (``profiling.count``;
under a CUDA graph, at its capture).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tinynerf_torch import profiling
from tinynerf_torch.core import encoding, mlp
from tinynerf_torch.core.encoding import (DIR_ENC_DIM, L_DIR, L_POINT,
                                          POINT_ENC_DIM, freq_bank)

FWD_SOURCE = "field_rays_fwd.cu"
BWD_SOURCE = "field_rays_bwd.cu"
FLAT_SOURCE = "field_flat_fwd.cu"
FLAT_BWD_SOURCE = "field_flat_bwd.cu"
WIDTH = mlp.WIDTH
PRECISIONS = ("fp32", "bf16")

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the parameters in the kernels' order: every weight, then every bias
_PARAM_KEYS = ([(name, "w") for name, _, _ in mlp.layer_dims()]
               + [(name, "b") for name, _, _ in mlp.layer_dims()])


def flops_per_row() -> int:
    """FLOPs of one sample row through the network (multiply-adds x 2):
    1,182,976. The backward does three times as many (recompute, input
    gradients, weight gradients)."""
    per_row = (POINT_ENC_DIM * WIDTH + 6 * WIDTH * WIDTH
               + (WIDTH + POINT_ENC_DIM) * WIDTH + WIDTH
               + WIDTH * WIDTH + (WIDTH + DIR_ENC_DIM) * (WIDTH // 2)
               + (WIDTH // 2) * 3)
    return 2 * per_row


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def field_flat_plain(params: mlp.Params, points: torch.Tensor,
                     dirs: torch.Tensor, precision: str = "fp32",
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the flat forward kernel in plain PyTorch: the
    float32 encoding, then ``mlp.apply_network`` at ``precision``. points,
    dirs (..., 3) -> (color (..., 3), sigma (..., 1)). Differentiable (its
    gradient rounds as the ray backward's does)."""
    return mlp.apply_network(params, encoding.encode_points(points),
                             encoding.encode_dirs(dirs), precision)


def field_flat_bwd_plain(params: mlp.Params, points: torch.Tensor,
                         dirs: torch.Tensor, g: torch.Tensor,
                         precision: str = "fp32",
                         ) -> Tuple[mlp.Params, torch.Tensor, torch.Tensor]:
    """The same function as the flat backward kernel in plain PyTorch: the
    VJP of ``field_flat_plain`` at points, dirs (R, 3) with the (R, 4)
    cotangent of ``[r, g, b, sigma]`` -> ``(grads, d_points (R, 3),
    d_dirs (R, 3))``, ``grads`` shaped like ``params``. At bf16 autograd
    rounds where ``_bwd_core`` casts: every pre-activation gradient, the
    heads' included (``mlp.apply_network(round_head_grads=True)``); the
    encoding's gradients and every weight gradient stay float32."""
    with torch.enable_grad():
        leaves = {name: {k: t.detach().requires_grad_(True)
                         for k, t in layer.items()}
                  for name, layer in params.items()}
        p, d = (x.detach().requires_grad_(True) for x in (points, dirs))
        color, sigma = mlp.apply_network(leaves, encoding.encode_points(p),
                                         encoding.encode_dirs(d), precision,
                                         round_head_grads=True)
        flat = [leaves[name][k] for name, k in _PARAM_KEYS]
        out = torch.autograd.grad((color, sigma), flat + [p, d],
                                  (g[:, :3], g[:, 3:]))
    grads = {name: {} for name in params}
    for (name, k), grad in zip(_PARAM_KEYS, out):
        grads[name][k] = grad
    return grads, out[-2], out[-1]


def field_rays_plain(params: mlp.Params, origins: torch.Tensor,
                     dirs: torch.Tensor, ts: torch.Tensor,
                     precision: str = "fp32") -> Tuple[Planes, torch.Tensor]:
    """The same function as the forward kernel in plain PyTorch:
    origins/dirs (B, 3), ts (B, N) -> ((r, g, b), sigma), each (B, N)."""
    points = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    color, sigma = field_flat_plain(params, points,
                                    dirs[:, None, :].expand(points.shape),
                                    precision)
    return (color[..., 0], color[..., 1], color[..., 2]), sigma[..., 0]


Grads = Tuple[mlp.Params, torch.Tensor, torch.Tensor, torch.Tensor]


def field_rays_bwd_plain(params: mlp.Params, origins: torch.Tensor,
                         dirs: torch.Tensor, ts: torch.Tensor,
                         g_sigma: torch.Tensor, g_r: torch.Tensor,
                         g_g: torch.Tensor, g_b: torch.Tensor,
                         precision: str = "fp32") -> Grads:
    """The same function as the backward kernel in plain PyTorch: the VJP of
    ``field_rays_plain`` with the (B, N) cotangents of (sigma, r, g, b) ->
    ``(grads, d_origins (B, 3), d_dirs (B, 3), d_ts (B, N))``, ``grads``
    shaped like ``params``. At bf16 autograd rounds where
    ``_ray_bwd_kernel`` casts: each pre-activation gradient of the trunk,
    ``point_info`` and the view branch; the heads' gradients, the
    encoding's and every weight gradient stay float32
    (``mlp.round_bf16`` / ``mlp.round_bf16_value``)."""
    with torch.enable_grad():
        leaves = {name: {k: t.detach().requires_grad_(True)
                         for k, t in layer.items()}
                  for name, layer in params.items()}
        o, d, t = (x.detach().requires_grad_(True) for x in (origins, dirs, ts))
        (r, g, b), sigma = field_rays_plain(leaves, o, d, t, precision)
        flat = [leaves[name][k] for name, k in _PARAM_KEYS]
        out = torch.autograd.grad((sigma, r, g, b), flat + [o, d, t],
                                  (g_sigma, g_r, g_g, g_b))
    grads = {name: {} for name in params}
    for (name, k), grad in zip(_PARAM_KEYS, out):
        grads[name][k] = grad
    return grads, out[-3], out[-2], out[-1]


def preactivation_margin(params: mlp.Params, origins: torch.Tensor,
                         dirs: torch.Tensor, ts: torch.Tensor,
                         precision: str = "fp32") -> torch.Tensor:
    """(B, N): each sample row's smallest |pre-activation| over every ReLU
    and the sigma head's ``abs``, for the reference MLP or the proposal MLP
    (a tree without ``point_info``: no skip, no view branch), in the form
    ``precision`` computes (at bf16 with ``mlp.apply_network``'s rounding).
    Two float32 implementations that sum in different orders can disagree
    on a mask (or a sign) only where this is within their rounding
    difference, so gradient comparisons weight such rows out of their
    cotangents."""
    value, act = mlp.rounding(precision)
    points = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    pe = value(encoding.encode_points(points))
    lin = lambda name, x: x @ value(params[name]["w"]) + params[name]["b"]
    reference = "point_info" in params
    skip = mlp.SKIP_LAYERS if reference else ()
    h, margin = pe, torch.full(ts.shape, float("inf"), device=ts.device)
    i = 0
    while f"trunk_{i}" in params:
        pre = lin(f"trunk_{i}", torch.cat([h, pe], -1) if i in skip else h)
        margin = torch.minimum(margin, pre.abs().amin(-1))
        h = act(torch.relu(pre))
        i += 1
    margin = torch.minimum(margin, lin("sigma", h).abs()[..., 0])
    if not reference:
        return margin
    de = value(encoding.encode_dirs(dirs[:, None, :].expand(points.shape)))
    pre = lin("dir_info", torch.cat([de, act(lin("point_info", h))], -1))
    return torch.minimum(margin, pre.abs().amin(-1))


_freqs: Dict[torch.device, torch.Tensor] = {}


def _freq_table(device: torch.device) -> torch.Tensor:
    """The 10 point and 4 direction frequencies, on ``device``."""
    if device not in _freqs:
        bank = np.concatenate([freq_bank(L_POINT), freq_bank(L_DIR)])
        _freqs[device] = torch.from_numpy(bank).to(device)
    return _freqs[device]


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    from tinynerf_torch.kernels.build import load_library
    lib = load_library(source)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if source in (FWD_SOURCE, FLAT_SOURCE):
        lib.field_packed_weights_elems.argtypes = []
        lib.field_packed_weights_elems.restype = i32
    if source == FWD_SOURCE:
        lib.field_rays_fwd.argtypes = [vp] * 9 + [i32, i32, i32, vp]
        lib.field_rays_fwd.restype = i32
        lib.field_rays_fwd_res.argtypes = [vp] * 11 + [i32, i32, vp]
        lib.field_rays_fwd_res.restype = i32
        for fn in (lib.field_residual_packed_elems, lib.field_residual_row_elems):
            fn.argtypes = []
            fn.restype = i32
        lib.field_rays_fwd_smem_bytes.argtypes = []
        lib.field_rays_fwd_smem_bytes.restype = i32
    elif source == FLAT_SOURCE:
        lib.field_flat_fwd.argtypes = [vp] * 5 + [i32, i32, vp]
        lib.field_flat_fwd.restype = i32
        lib.field_flat_fwd_smem_bytes.argtypes = []
        lib.field_flat_fwd_smem_bytes.restype = i32
    elif source == FLAT_BWD_SOURCE:
        lib.field_flat_bwd.argtypes = [vp] * 11 + [i32, i32, vp]
        lib.field_flat_bwd.restype = i32
        lib.field_flat_bwd_smem_bytes.argtypes = []
        lib.field_flat_bwd_smem_bytes.restype = i32
        lib.field_flat_bwd_workspace_floats.argtypes = [i32]
        lib.field_flat_bwd_workspace_floats.restype = ctypes.c_longlong
    else:
        lib.field_rays_bwd.argtypes = [vp] * 13 + [i32, i32, i32, vp]
        lib.field_rays_bwd.restype = i32
        lib.field_rays_bwd_smem_bytes.argtypes = []
        lib.field_rays_bwd_smem_bytes.restype = i32
        lib.field_rays_bwd_workspace_floats.argtypes = [i32, i32]
        lib.field_rays_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.field_rays_bwd_res.argtypes = [vp] * 19 + [i32, i32, vp]
        lib.field_rays_bwd_res.restype = i32
        lib.field_rays_bwd_res_workspace_floats.argtypes = [i32, i32]
        lib.field_rays_bwd_res_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check(name: str, t: torch.Tensor, shape, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _param_ptrs(params: mlp.Params, device: torch.device) -> ctypes.Array:
    """The 25 device pointers the kernels take: the 12 weights, the 12
    biases, then the frequency table."""
    shapes = {name: {"w": (fan_in, fan_out), "b": (fan_out,)}
              for name, fan_in, fan_out in mlp.layer_dims()}
    ptrs = []
    for name, k in _PARAM_KEYS:
        _check(f"{name}.{k}", params[name][k], shapes[name][k], device)
        ptrs.append(params[name][k].data_ptr())
    ptrs.append(_freq_table(device).data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def packed_weights(lib: ctypes.CDLL, precision: str, device: torch.device):
    """The bf16 forms' scratch for the weights, which the kernel packs into
    bf16 itself (``field_packed_weights_elems()`` elements); None at
    fp32."""
    if precision != "bf16":
        return None
    return torch.empty(lib.field_packed_weights_elems(), dtype=torch.bfloat16,
                       device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


class Residuals(NamedTuple):
    """What kernel 1's saving form keeps for the backward of its call:
    its packed weights (with the fix-up's transposed copy and norms), each
    layer's input at every sample row (``a``, (B * N, row) bf16), sign(sigma's
    pre-activation) and the colors it returned, each (B, N) float32."""
    packed: torch.Tensor
    a: torch.Tensor
    sign: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor


def saves_residuals(precision: str, grad: bool) -> bool:
    """Whether ``field_rays``'s forward on the card takes kernel 1's saving
    form: the bf16 form, and a backward that can follow (grad mode on and an
    input that requires grad). Frames, the refresh and the fp32 form keep the
    plain forward."""
    return precision == "bf16" and grad


def _launch(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
            ts: torch.Tensor, precision: str, save: bool = False,
            ) -> Tuple[Planes, torch.Tensor, Optional[Residuals]]:
    """Kernel 1: ``((r, g, b), sigma, residuals)``; with ``save`` (bf16
    only) its saving form, whose ``Residuals`` the backward reads, else
    ``None``."""
    device = origins.device
    B, N = ts.shape
    _check("origins", origins, (B, 3), device)
    _check("dirs", dirs, (B, 3), device)
    _check("ts", ts, (B, N), device)
    ptrs = _param_ptrs(params, device)
    lib = _library(FWD_SOURCE)
    outs = [torch.empty((B, N), dtype=torch.float32, device=device)
            for _ in range(4)]
    head = (origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), ptrs,
            *[o.data_ptr() for o in outs])
    res = None
    with torch.cuda.device(device):
        if save:
            bf = dict(dtype=torch.bfloat16, device=device)
            packed = torch.empty(lib.field_residual_packed_elems(), **bf)
            a = torch.empty((B * N, lib.field_residual_row_elems()), **bf)
            sign = torch.empty((B, N), dtype=torch.float32, device=device)
            err = lib.field_rays_fwd_res(*head, packed.data_ptr(), a.data_ptr(),
                                         sign.data_ptr(), B, N, _stream(device))
            res = Residuals(packed, a, sign, *outs[1:])
        else:
            packed = packed_weights(lib, precision, device)
            err = lib.field_rays_fwd(*head, _ptr(packed), B, N, int(precision == "bf16"),
                                     _stream(device))
    if err != 0:
        raise RuntimeError(f"field_rays_fwd kernel launch failed: CUDA error {err}")
    field_rays.launches += 1
    if save:
        profiling.count("field.residual.saved")
    sigma, r, g, b = outs
    return (r, g, b), sigma, res


def _launch_bwd(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
                ts: torch.Tensor, g_sigma: torch.Tensor, g_r: torch.Tensor,
                g_g: torch.Tensor, g_b: torch.Tensor, precision: str,
                residuals: Optional[Residuals] = None) -> Grads:
    device = origins.device
    B, N = ts.shape
    _check("origins", origins, (B, 3), device)
    _check("dirs", dirs, (B, 3), device)
    for name, t in (("ts", ts), ("g_sigma", g_sigma), ("g_r", g_r),
                    ("g_g", g_g), ("g_b", g_b)):
        _check(name, t, (B, N), device)
    ptrs = _param_ptrs(params, device)
    lib = _library(BWD_SOURCE)
    f32 = dict(dtype=torch.float32, device=device)
    flat = torch.empty(sum(n for layer in params.values()
                           for n in (layer["w"].numel(), layer["b"].numel())), **f32)
    d_o, d_d = torch.empty((B, 3), **f32), torch.empty((B, 3), **f32)
    d_ts = torch.empty((B, N), **f32)
    head = (origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), g_sigma.data_ptr(),
            g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(), ptrs)
    tail = (d_o.data_ptr(), d_d.data_ptr(), d_ts.data_ptr(), flat.data_ptr())
    with torch.cuda.device(device):
        if residuals is not None:
            _check_residuals(residuals, B, N, device)
            workspace = torch.empty(lib.field_rays_bwd_res_workspace_floats(B, N), **f32)
            err = lib.field_rays_bwd_res(
                *head, *[t.data_ptr() for t in residuals], *tail, workspace.data_ptr(),
                B, N, _stream(device))
        else:
            workspace = torch.empty(lib.field_rays_bwd_workspace_floats(B, N), **f32)
            err = lib.field_rays_bwd(*head, *tail, workspace.data_ptr(), B, N,
                                     int(precision == "bf16"), _stream(device))
    if err != 0:
        raise RuntimeError(f"field_rays_bwd kernel launch failed: CUDA error {err}")
    field_rays_bwd.launches += 1
    if residuals is None and precision == "bf16":
        profiling.count("field.residual.recomputed")
    return grads_from_flat(flat), d_o, d_d, d_ts


def _check_residuals(res: Residuals, B: int, N: int, device: torch.device) -> None:
    lib = _library(FWD_SOURCE)
    bf16 = torch.bfloat16
    _check("residual packed", res.packed, (lib.field_residual_packed_elems(),), device, bf16)
    _check("residual a", res.a, (B * N, lib.field_residual_row_elems()), device, bf16)
    for name in ("sign", "r", "g", "b"):
        _check(f"residual {name}", getattr(res, name), (B, N), device)


def grads_from_flat(flat: torch.Tensor) -> mlp.Params:
    """The gradient tree, as views of the flat buffer that the backward
    kernels write layer by layer, weight then bias."""
    grads, offset = {}, 0
    for name, fan_in, fan_out in mlp.layer_dims():
        w = flat[offset:offset + fan_in * fan_out].view(fan_in, fan_out)
        offset += fan_in * fan_out
        grads[name] = {"w": w, "b": flat[offset:offset + fan_out]}
        offset += fan_out
    return grads


def _on_one_device(tensors: List[torch.Tensor], what: str) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on a mix."""
    if tensors[0].is_cuda:
        return True
    if all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError(f"{what} takes tensors all on the CPU or all on one CUDA "
                     f"device; the first is on {tensors[0].device}")


def field_rays_bwd(params: mlp.Params, origins: torch.Tensor,
                   dirs: torch.Tensor, ts: torch.Tensor, g_sigma: torch.Tensor,
                   g_r: torch.Tensor, g_g: torch.Tensor,
                   g_b: torch.Tensor, precision: str = "fp32",
                   residuals: Optional[Residuals] = None) -> Grads:
    """The field's backward: the (B, N) cotangents of (sigma, r, g, b) ->
    ``(grads, d_origins, d_dirs, d_ts)``, all float32. CUDA tensors launch
    the kernel: with ``residuals`` (from kernel 1's saving form on the same
    rays and weights; bf16 only) it starts from them, else it recomputes the
    forward. CPU tensors take ``field_rays_bwd_plain``."""
    _check_precision(precision)
    args = (params, origins, dirs, ts, g_sigma, g_r, g_g, g_b, precision)
    tensors = [origins, dirs, ts, g_sigma, g_r, g_g, g_b] + [
        t for layer in params.values() for t in layer.values()]
    if _on_one_device(tensors, "field_rays_bwd"):
        if residuals is not None and precision != "bf16":
            raise ValueError("residuals are the bf16 form's")
        return _launch_bwd(*args, residuals)
    return field_rays_bwd_plain(*args)


field_rays_bwd.launches = 0


def _unflatten(flat) -> mlp.Params:
    params: mlp.Params = {}
    for (name, k), t in zip(_PARAM_KEYS, flat):
        params.setdefault(name, {})[k] = t
    return params


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, copying only where needed."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _FieldRays(torch.autograd.Function):
    """``field_rays`` with ``field_rays_bwd`` as its backward; ``grad``
    says whether a backward can follow (``field_rays`` reads the grad mode,
    which is off inside ``forward``)."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, precision, grad, *flat):
        params = _unflatten(flat)
        res = None
        with profiling.section("field.fwd"):
            if _on_one_device([origins, dirs, ts, *flat], "field_rays"):
                (r, g, b), sigma, res = _launch(params, origins, dirs, ts, precision,
                                                saves_residuals(precision, grad))
            else:
                (r, g, b), sigma = field_rays_plain(params, origins, dirs, ts, precision)
        ctx.save_for_backward(origins, dirs, ts, *flat, *(res or ()))
        ctx.precision = precision
        return r, g, b, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_r, g_g, g_b, g_sigma):
        origins, dirs, ts, *saved = ctx.saved_tensors
        flat, res = saved[:len(_PARAM_KEYS)], saved[len(_PARAM_KEYS):]
        with profiling.section("field.bwd"):
            cots = [_kernel_ready(g) for g in (g_sigma, g_r, g_g, g_b)]
            grads, d_o, d_d, d_ts = field_rays_bwd(
                _unflatten(flat), origins, dirs, ts, *cots, precision=ctx.precision,
                residuals=Residuals(*res) if res else None)
        return (d_o, d_d, d_ts, None, None, *[grads[name][k] for name, k in _PARAM_KEYS])


def field_rays(params: mlp.Params, origins: torch.Tensor, dirs: torch.Tensor,
               ts: torch.Tensor, precision: str = "fp32",
               ) -> Tuple[Planes, torch.Tensor]:
    """Ray-major fused field: origins/dirs (B, 3), ts (B, N) -> ((r, g, b),
    sigma), each (B, N) float32, differentiable in every input. CUDA tensors
    launch the kernels; CPU tensors take the plain versions."""
    _check_precision(precision)
    flat = [params[name][k] for name, k in _PARAM_KEYS]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (origins, dirs, ts, *flat))
    r, g, b, sigma = _FieldRays.apply(origins, dirs, ts, precision, grad, *flat)
    return (r, g, b), sigma


field_rays.launches = 0


def _launch_flat(params: mlp.Params, points: torch.Tensor, dirs: torch.Tensor,
                 precision: str) -> torch.Tensor:
    device = points.device
    R = points.shape[0]
    _check("points", points, (R, 3), device)
    _check("dirs", dirs, (R, 3), device)
    ptrs = _param_ptrs(params, device)
    lib = _library(FLAT_SOURCE)
    out = torch.empty((R, 4), dtype=torch.float32, device=device)
    packed = packed_weights(lib, precision, device)
    with torch.cuda.device(device):
        err = lib.field_flat_fwd(points.data_ptr(), dirs.data_ptr(), ptrs,
                                 out.data_ptr(), _ptr(packed), R,
                                 int(precision == "bf16"), _stream(device))
    if err != 0:
        raise RuntimeError(f"field_flat_fwd kernel launch failed: CUDA error {err}")
    field_flat.launches += 1
    return out


def _launch_flat_bwd(params: mlp.Params, points: torch.Tensor,
                     dirs: torch.Tensor, g: torch.Tensor, precision: str,
                     ) -> Tuple[mlp.Params, torch.Tensor, torch.Tensor]:
    device = points.device
    R = points.shape[0]
    _check("points", points, (R, 3), device)
    _check("dirs", dirs, (R, 3), device)
    _check("g", g, (R, 4), device)
    # the kernel takes the four cotangent planes, sigma first
    planes = [g[:, c].contiguous() for c in (3, 0, 1, 2)]
    ptrs = _param_ptrs(params, device)
    lib = _library(FLAT_BWD_SOURCE)
    f32 = dict(dtype=torch.float32, device=device)
    workspace = torch.empty(lib.field_flat_bwd_workspace_floats(R), **f32)
    flat = torch.empty(sum(n for layer in params.values()
                           for n in (layer["w"].numel(), layer["b"].numel())), **f32)
    d_p, d_d = torch.empty((R, 3), **f32), torch.empty((R, 3), **f32)
    with torch.cuda.device(device):
        err = lib.field_flat_bwd(
            points.data_ptr(), dirs.data_ptr(), *[t.data_ptr() for t in planes],
            ptrs, d_p.data_ptr(), d_d.data_ptr(), flat.data_ptr(),
            workspace.data_ptr(), R, int(precision == "bf16"), _stream(device))
    if err != 0:
        raise RuntimeError(f"field_flat_bwd kernel launch failed: CUDA error {err}")
    field_flat_bwd.launches += 1
    return grads_from_flat(flat), d_p, d_d


def field_flat_bwd(params: mlp.Params, points: torch.Tensor, dirs: torch.Tensor,
                   g: torch.Tensor, precision: str = "fp32",
                   ) -> Tuple[mlp.Params, torch.Tensor, torch.Tensor]:
    """The flat field's recompute backward: points, dirs (R, 3) and the (R, 4)
    cotangent of ``[r, g, b, sigma]`` -> ``(grads, d_points, d_dirs)``, all
    float32. CUDA tensors launch the kernel; CPU tensors take
    ``field_flat_bwd_plain``."""
    _check_precision(precision)
    tensors = [points, dirs, g] + [t for layer in params.values() for t in layer.values()]
    if _on_one_device(tensors, "field_flat_bwd"):
        return _launch_flat_bwd(params, points, dirs, g, precision)
    return field_flat_bwd_plain(params, points, dirs, g, precision)


field_flat_bwd.launches = 0


class _FieldFlat(torch.autograd.Function):
    """``field_flat`` over (R, 3) rows -> (R, 4) ``[r, g, b, sigma]``, with
    ``field_flat_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, points, dirs, precision, *flat):
        params = _unflatten(flat)
        with profiling.section("field.fwd"):
            if _on_one_device([points, dirs, *flat], "field_flat"):
                out = _launch_flat(params, points, dirs, precision)
            else:
                out = torch.cat(field_flat_plain(params, points, dirs, precision), dim=-1)
        ctx.save_for_backward(points, dirs, *flat)
        ctx.precision = precision
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        points, dirs, *flat = ctx.saved_tensors
        with profiling.section("field.bwd"):
            grads, d_p, d_d = field_flat_bwd(_unflatten(flat), points, dirs,
                                             _kernel_ready(g), precision=ctx.precision)
        return (d_p, d_d, None, *[grads[name][k] for name, k in _PARAM_KEYS])


def field_flat(params: mlp.Params, points: torch.Tensor, dirs: torch.Tensor,
               precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """The field at flat points: points, dirs (..., 3) -> (color (..., 3),
    sigma (..., 1)), float32, differentiable in every input. CUDA tensors
    launch the forward kernel (and, under autograd, the backward kernel);
    CPU tensors take the plain versions."""
    _check_precision(precision)
    lead = points.shape[:-1]
    out = _FieldFlat.apply(_kernel_ready(points.reshape(-1, 3)),
                           _kernel_ready(dirs.reshape(-1, 3)), precision,
                           *[params[name][k] for name, k in _PARAM_KEYS])
    return out[:, :3].reshape(*lead, 3), out[:, 3:].reshape(*lead, 1)


field_flat.launches = 0
