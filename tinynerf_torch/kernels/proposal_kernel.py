"""The proposal MLP's hand-written CUDA kernels and their plain versions.

Counterpart of ``tinynerf/kernels/proposal_kernel.py`` (``PROP_PALLAS``):

- ``prop_rays(params, origins, dirs, ts, precision)``, the counterpart of
  ``prop_field_pallas_rays``: the proposal MLP (``core/proposal.py``) at
  ``origin + t * dir`` for every (ray, sample) pair -> ``((r, g, b),
  sigma)``, each a dense (B, N) float32 plane. Its forward is TPU kernel 7
  (``_prop_ray_forward`` / ``_prop_ray_fwd_kernel``), its backward TPU
  kernel 8 (``_prop_ray_backward`` / ``_prop_ray_bwd_kernel``, a recompute
  VJP): an ``autograd.Function`` whose backward is ``prop_rays_bwd``, with
  the gradients of every weight and bias and of ``origins``, ``dirs`` and
  ``ts``.
- ``prop_flat(params, points, dirs, precision)``, the counterpart of
  ``prop_field_pallas``: the point form, which rides kernel 7 with one
  sample a ray at ``t = 0``, as the JAX package does.

``precision`` is ``"fp32"`` or ``"bf16"``, the TPU kernel's
``compute_dtype=bfloat16`` form (``proposal.apply_proposal``'s rounding:
the weights, the encodings and every ReLU output rounded to bfloat16, the
sums, biases, ``|sigma|`` and the sigmoid in float32; in the backward each
pre-activation gradient of the trunk is rounded before its products, every
weight gradient stays float32).

- On CPU tensors each runs its plain version (``prop_rays_plain``,
  ``prop_rays_bwd_plain``), which is what the CPU tests reach. The plain
  backward is written out with the TPU kernel's conventions: sigma's
  cotangent times ``sign(sigma_pre)`` (0 at exactly 0, where autodiff's
  ``abs'(0)`` is +1), the ReLU mask ``pre > 0`` and the sigmoid's
  derivative ``c * (1 - c)``.
- On CUDA tensors each launches its kernel (``csrc/prop_rays_fwd.cu``,
  ``csrc/prop_rays_bwd.cu``) or raises; neither falls back. The bf16 forms
  run every trunk product on the tensor cores (``csrc/prop_common.cuh``),
  the fp32 forms on float32 FMA. ``prop_rays.launches`` and
  ``prop_rays_bwd.launches`` count the calls that launched each kernel
  (``prop_flat``'s included).
- The backward computes ``d_origins``, ``d_dirs`` and ``d_ts`` only when
  asked (``ray_grads``): autograd asks when one of the rays' tensors needs a
  gradient (``ctx.needs_input_grad``), and otherwise gets ``None`` for them;
  the kernel then skips the layer-0 input-gradient product, the encoding's
  backward and the per-ray sums. The weight gradients do not change.
- ``prop_rays_reference`` is ``prop_rays`` through the plain versions on any
  device: what the card's checks hold a step or a rendered chunk through the
  kernels against.

The kernels take the full point encoding (``PROPOSAL_ENC_L`` 10, as the TPU
kernel), a width that is a multiple of 32 up to 256 and a depth from 1 to
``MAX_DEPTH``. The TPU kernel's permuted weight rows, 2,048-row ray tiles
and (RT, N) bridges are its compiler's and layouts' needs, not semantics:
the CUDA kernels read the weights in their ``(in, out)`` layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from tinynerf_torch.core import encoding, mlp, proposal
from tinynerf_torch.core.encoding import DIR_ENC_DIM, L_DIR, L_POINT, freq_bank
from tinynerf_torch.kernels.mlp_kernel import (_check, _check_precision, _freq_table,
                                               _kernel_ready, _on_one_device, _stream)

FWD_SOURCE = "prop_rays_fwd.cu"
BWD_SOURCE = "prop_rays_bwd.cu"
MAX_DEPTH = 64        # the kernels' parameter block holds this many trunk layers
MAX_WIDTH = 256       # NC = width / 32 columns a thread, up to 8

Params = proposal.Params
Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Grads = Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]


def _keys(depth: int) -> List[Tuple[str, str]]:
    """The parameters in the kernels' order: layer by layer, weight then
    bias (``proposal.layer_dims``' order)."""
    names = [f"trunk_{i}" for i in range(depth)] + ["sigma", "color"]
    return [(name, k) for name in names for k in ("w", "b")]


def flops_per_row(width: int = proposal.WIDTH, depth: int = proposal.DEPTH) -> int:
    """FLOPs of one sample row through the network (multiply-adds x 2), the
    TPU kernel's ``_prop_flops_per_row``: 114,832 at 128 x 4. The encoding's
    84 sines and cosines are not in it. The backward does three times as
    many."""
    return 2 * (encoding.POINT_ENC_DIM * width + (depth - 1) * width * width
                + width + (width + DIR_ENC_DIM) * 3)


def check_dims(params: Params) -> None:
    """Raise, naming what the kernels take, for a proposal tree they do not
    take."""
    width, depth, enc_l = proposal.dims(params)
    if width % 32 or not 32 <= width <= MAX_WIDTH or not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"the proposal kernels take a width in {{32, 64, ..., {MAX_WIDTH}}} "
                         f"and a depth in 1..{MAX_DEPTH}; got width {width}, depth {depth}")
    if enc_l != L_POINT:
        raise ValueError(f"the proposal kernels take PROPOSAL_ENC_L = {L_POINT} (the full "
                         f"point encoding); got {enc_l}")


def _forward(params: Params, origins, dirs, ts, precision: str) -> Dict[str, object]:
    """The kernels' forward, keeping what the backward needs (run without
    autograd: the plain versions are written out in both directions)."""
    rnd = mlp.round_bf16 if precision == "bf16" else (lambda x: x)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]       # (B, N, 3)
    pe, de = encoding.encode_points(pts), encoding.encode_dirs(dirs)   # float32
    h, pres = proposal.forward_trunk(params, pe, precision)
    wc = rnd(params["color"]["w"])
    sig_pre = (h @ rnd(params["sigma"]["w"]))[..., 0] + params["sigma"]["b"]
    # enc_dir . wce + h . wch + bc, the direction's share once a ray
    x = (rnd(de) @ wc[:DIR_ENC_DIM])[:, None, :] + h @ wc[DIR_ENC_DIM:] + params["color"]["b"]
    return dict(pe=pe, de=de, pres=pres, h=h, sig_pre=sig_pre, color=torch.sigmoid(x),
                rnd=rnd)


def prop_rays_plain(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                    ts: torch.Tensor, precision: str = "fp32") -> Tuple[Planes, torch.Tensor]:
    """The same function as the forward kernel in plain PyTorch:
    origins/dirs (B, 3), ts (B, N) -> ((r, g, b), sigma), each (B, N)."""
    with torch.no_grad():
        a = _forward(params, origins, dirs, ts, precision)
    color = a["color"]
    return (color[..., 0], color[..., 1], color[..., 2]), torch.abs(a["sig_pre"])


def _encoding_vjp(g_enc: torch.Tensor, enc: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(..., 3 * 2L) cotangents of an encoding and its float32 values ->
    (..., 3) of the coordinates: ``sum_l f_l (g_sin cos - g_cos sin)``."""
    freqs = torch.as_tensor(freq_bank(n_freqs), device=g_enc.device)
    g = g_enc.reshape(*g_enc.shape[:-1], 3, n_freqs, 2)
    e = enc.reshape(*enc.shape[:-1], 3, n_freqs, 2)
    return torch.sum((g[..., 0] * e[..., 1] - g[..., 1] * e[..., 0]) * freqs, dim=-1)


def prop_rays_bwd_plain(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                        ts: torch.Tensor, g_sigma: torch.Tensor, g_r: torch.Tensor,
                        g_g: torch.Tensor, g_b: torch.Tensor, precision: str = "fp32",
                        ray_grads: bool = True) -> Grads:
    """The same function as the backward kernel in plain PyTorch: the VJP of
    ``prop_rays_plain`` with the (B, N) cotangents of (sigma, r, g, b) ->
    ``(grads, d_origins (B, 3), d_dirs (B, 3), d_ts (B, N))``, ``grads``
    shaped like ``params``; without ``ray_grads`` the last three are None.
    Written out as ``_prop_ray_bwd_kernel`` chains it (module docstring),
    not autograd."""
    depth = proposal.dims(params)[1]
    flat = lambda x: x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        a = _forward(params, origins, dirs, ts, precision)
        rnd, h, color = a["rnd"], a["h"], a["color"]
        gs = g_sigma * torch.sign(a["sig_pre"])                              # (B, N)
        gp = torch.stack([g * color[..., c] * (1.0 - color[..., c])
                          for c, g in enumerate((g_r, g_g, g_b))], dim=-1)   # (B, N, 3)
        grads = {"sigma": {"w": flat(h).T @ gs.reshape(-1, 1), "b": gs.sum().reshape(1)},
                 "color": {"w": torch.cat([rnd(a["de"]).T @ gp.sum(1), flat(h).T @ flat(gp)]),
                           "b": flat(gp).sum(0)}}
        wsig = rnd(params["sigma"]["w"])[:, 0]
        wc = rnd(params["color"]["w"])
        g_h = gs[..., None] * wsig
        for c in range(3):
            g_h = g_h + gp[..., c:c + 1] * wc[DIR_ENC_DIM:, c]
        for i in range(depth - 1, -1, -1):
            g_pre = rnd(g_h * (a["pres"][i] > 0).float())
            x = rnd(torch.relu(a["pres"][i - 1])) if i else rnd(a["pe"])
            grads[f"trunk_{i}"] = {"w": flat(x).T @ flat(g_pre), "b": flat(g_pre).sum(0)}
            if i or ray_grads:
                g_h = g_pre @ rnd(params[f"trunk_{i}"]["w"]).T
        grads = {name: grads[name] for name, _, _ in proposal.layer_dims(depth=depth)}
        if not ray_grads:
            return grads, None, None, None
        g_de = gp[..., 0:1] * wc[:DIR_ENC_DIM, 0]
        for c in (1, 2):
            g_de = g_de + gp[..., c:c + 1] * wc[:DIR_ENC_DIM, c]
        d_pts = _encoding_vjp(g_h, a["pe"], L_POINT)                        # (B, N, 3)
        d_dir = _encoding_vjp(g_de, a["de"][:, None, :].expand(g_de.shape), L_DIR)
        d_ts = (d_pts[..., 0] * dirs[:, None, 0] + d_pts[..., 1] * dirs[:, None, 1]
                + d_pts[..., 2] * dirs[:, None, 2])
        d_o = d_pts.sum(1)
        d_d = (d_pts * ts[..., None] + d_dir).sum(1)
    return grads, d_o, d_d, d_ts


# the backward's phase-clock variant build (a measurement's; bwd_phase_split)
PHASE_DEFINES = ("PROP_PHASE_CLOCKS",)
# the bf16 backward without its fix-up (a measurement's: what it is for)
NO_FIXUP_DEFINES = ("PROP_NO_FIXUP",)
# the phases of each form, in the variant's slot order: the fp32 form has no
# fix-up, and counts the heads there (their forward, their weight gradients
# and the gradient into the last hidden layer)
PHASES = {"bf16": ("recompute", "fix-up", "input gradients", "weight gradients", "ray sums"),
          "fp32": ("recompute", "heads", "input gradients", "weight gradients", "ray sums")}
PHASE_BLOCKS = 1024   # blocks the variant counts (MAX_PHASE_BLOCKS, csrc/prop_rays_bwd.cu)


@functools.lru_cache(maxsize=None)
def _library(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    from tinynerf_torch.kernels.build import load_library
    lib = load_library(source, defines)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if source == FWD_SOURCE:
        lib.prop_rays_fwd.argtypes = [vp] * 9 + [i32] * 5 + [vp]
        lib.prop_rays_fwd.restype = i32
        lib.prop_rays_fwd_smem_bytes.argtypes = [i32]
        lib.prop_rays_fwd_smem_bytes.restype = i32
        lib.prop_packed_weights_elems.argtypes = [i32, i32]
        lib.prop_packed_weights_elems.restype = i64
    else:
        lib.prop_rays_bwd.argtypes = [vp] * 13 + [i32] * 7 + [vp]
        lib.prop_rays_bwd.restype = i32
        lib.prop_rays_bwd_smem_bytes.argtypes = [i32, i32]
        lib.prop_rays_bwd_smem_bytes.restype = i32
        lib.prop_rays_bwd_slices.argtypes = [i32]
        lib.prop_rays_bwd_slices.restype = i32
        lib.prop_rays_bwd_workspace_floats.argtypes = [i32, i32, i32]
        lib.prop_rays_bwd_workspace_floats.restype = i64
        if defines == PHASE_DEFINES:
            lib.prop_rays_bwd_phase_clocks.argtypes = [vp]
            lib.prop_rays_bwd_phase_clocks.restype = i32
    return lib


def _param_ptrs(params: Params, device: torch.device) -> ctypes.Array:
    """The 2 * depth + 5 device pointers the kernels take: every weight and
    bias in ``_keys`` order, then the 14 frequencies."""
    width, depth, enc_l = proposal.dims(params)
    shapes = {name: {"w": (fan_in, fan_out), "b": (fan_out,)}
              for name, fan_in, fan_out in proposal.layer_dims(width, depth)}
    ptrs = []
    for name, k in _keys(depth):
        _check(f"{name}.{k}", params[name][k], shapes[name][k], device)
        ptrs.append(params[name][k].data_ptr())
    ptrs.append(_freq_table(device).data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_rays(device, B: int, N: int, **tensors) -> None:
    for name, t in tensors.items():
        _check(name, t, (B, 3) if name in ("origins", "dirs") else (B, N), device)


def _launch(params: Params, origins, dirs, ts, precision: str) -> Tuple[Planes, torch.Tensor]:
    device = origins.device
    B, N = ts.shape
    _check_rays(device, B, N, origins=origins, dirs=dirs, ts=ts)
    width, depth, _ = proposal.dims(params)   # checked by the caller (check_dims)
    ptrs = _param_ptrs(params, device)
    lib = _library(FWD_SOURCE)
    outs = [torch.empty((B, N), dtype=torch.float32, device=device) for _ in range(4)]
    # the bf16 form packs the trunk's weights into bf16 here, once a call
    packed = (torch.empty(lib.prop_packed_weights_elems(width, depth), dtype=torch.bfloat16,
                          device=device) if precision == "bf16" else None)
    with torch.cuda.device(device):
        err = lib.prop_rays_fwd(
            origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), ptrs,
            *[o.data_ptr() for o in outs], None if packed is None else packed.data_ptr(), B, N,
            width, depth, int(precision == "bf16"), _stream(device))
    if err != 0:
        raise RuntimeError(f"prop_rays_fwd kernel launch failed: CUDA error {err}")
    prop_rays.launches += 1
    sigma, r, g, b = outs
    return (r, g, b), sigma


def _launch_bwd(params: Params, origins, dirs, ts, g_sigma, g_r, g_g, g_b,
                precision: str, ray_grads: bool = True, defines: Tuple[str, ...] = ()) -> Grads:
    device = origins.device
    B, N = ts.shape
    _check_rays(device, B, N, origins=origins, dirs=dirs, ts=ts, g_sigma=g_sigma, g_r=g_r,
                g_g=g_g, g_b=g_b)
    width, depth, _ = proposal.dims(params)   # checked by the caller (check_dims)
    ptrs = _param_ptrs(params, device)
    lib = _library(BWD_SOURCE, defines)
    f32 = dict(dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        slices = lib.prop_rays_bwd_slices(B)
        workspace = torch.empty(lib.prop_rays_bwd_workspace_floats(width, depth, slices), **f32)
        flat = torch.empty(sum(t.numel() for layer in params.values() for t in layer.values()),
                           **f32)
        d_o, d_d, d_ts = ((torch.empty((B, 3), **f32), torch.empty((B, 3), **f32),
                           torch.empty((B, N), **f32)) if ray_grads else (None, None, None))
        err = lib.prop_rays_bwd(
            origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), g_sigma.data_ptr(),
            g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(), ptrs,
            *[None if t is None else t.data_ptr() for t in (d_o, d_d, d_ts)], flat.data_ptr(),
            workspace.data_ptr(), B, N, width, depth, slices, int(precision == "bf16"),
            int(ray_grads), _stream(device))
    if err != 0:
        raise RuntimeError(f"prop_rays_bwd kernel launch failed: CUDA error {err}")
    if not defines:
        prop_rays_bwd.launches += 1
    # the kernel writes the gradients layer by layer, weight then bias
    grads, offset = {}, 0
    for name, fan_in, fan_out in proposal.layer_dims(width, depth):
        w = flat[offset:offset + fan_in * fan_out].view(fan_in, fan_out)
        offset += fan_in * fan_out
        grads[name] = {"w": w, "b": flat[offset:offset + fan_out]}
        offset += fan_out
    return grads, d_o, d_d, d_ts


def _tensors(params: Params) -> List[torch.Tensor]:
    return [params[name][k] for name, k in _keys(proposal.dims(params)[1])]


def _unflatten(flat) -> Params:
    params: Params = {}
    for (name, k), t in zip(_keys(len(flat) // 2 - 2), flat):
        params.setdefault(name, {})[k] = t
    return params


def prop_rays_bwd(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                  ts: torch.Tensor, g_sigma: torch.Tensor, g_r: torch.Tensor,
                  g_g: torch.Tensor, g_b: torch.Tensor, precision: str = "fp32",
                  ray_grads: bool = True) -> Grads:
    """The proposal MLP's recompute backward: the (B, N) cotangents of
    (sigma, r, g, b) -> ``(grads, d_origins, d_dirs, d_ts)``, all float32;
    without ``ray_grads`` the last three are None and are not computed.
    CUDA tensors launch the kernel; CPU tensors take
    ``prop_rays_bwd_plain``."""
    _check_precision(precision)
    check_dims(params)
    args = (params, origins, dirs, ts, g_sigma, g_r, g_g, g_b, precision, ray_grads)
    if _on_one_device([origins, dirs, ts, g_sigma, g_r, g_g, g_b] + _tensors(params),
                      "prop_rays_bwd"):
        return _launch_bwd(*args)
    return prop_rays_bwd_plain(*args)


prop_rays_bwd.launches = 0


def bwd_phase_split(params: Params, origins, dirs, ts, g_sigma, g_r, g_g, g_b,
                    precision: str = "bf16", ray_grads: bool = True) -> Dict[str, float]:
    """One launch of the backward's phase-clock variant (CUDA tensors), either
    form: for each of ``PHASES[precision]``, its share of the recompute
    kernel's summed block clock cycles in that launch. A measurement, not a
    path: the variant meets at a barrier at each phase's end, and
    ``prop_rays_bwd.launches`` does not count it."""
    _check_precision(precision)
    check_dims(params)
    phases = PHASES[precision]
    lib = _library(BWD_SOURCE, PHASE_DEFINES)
    clocks = (ctypes.c_longlong * (PHASE_BLOCKS * len(phases)))()

    def read_clocks():  # into `clocks`, and zero them on the device
        with torch.cuda.device(origins.device):
            torch.cuda.synchronize()
            err = lib.prop_rays_bwd_phase_clocks(ctypes.addressof(clocks))
        if err != 0:
            raise RuntimeError(f"prop_rays_bwd_phase_clocks failed: CUDA error {err}")

    read_clocks()
    _launch_bwd(params, origins, dirs, ts, g_sigma, g_r, g_g, g_b, precision, ray_grads,
                PHASE_DEFINES)
    read_clocks()
    per_phase = [sum(clocks[b * len(phases) + i] for b in range(PHASE_BLOCKS))
                 for i in range(len(phases))]
    total = max(sum(per_phase), 1)
    return {name: c / total for name, c in zip(phases, per_phase)}


class _PropRays(torch.autograd.Function):
    """``prop_rays`` with ``prop_rays_bwd`` as its backward; with ``plain``,
    ``prop_rays_reference``: the plain versions both ways, on any device."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, precision, plain, *flat):
        params = _unflatten(flat)
        if not plain and _on_one_device([origins, dirs, ts, *flat], "prop_rays"):
            (r, g, b), sigma = _launch(params, origins, dirs, ts, precision)
        else:
            (r, g, b), sigma = prop_rays_plain(params, origins, dirs, ts, precision)
        ctx.save_for_backward(origins, dirs, ts, *flat)
        ctx.precision, ctx.plain = precision, plain
        return r, g, b, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_r, g_g, g_b, g_sigma):
        origins, dirs, ts, *flat = ctx.saved_tensors
        cots = [_kernel_ready(g) for g in (g_sigma, g_r, g_g, g_b)]
        bwd = prop_rays_bwd_plain if ctx.plain else prop_rays_bwd
        # the rays' gradients only where autograd asks for one of them
        grads, d_o, d_d, d_ts = bwd(_unflatten(flat), origins, dirs, ts, *cots,
                                    precision=ctx.precision,
                                    ray_grads=any(ctx.needs_input_grad[:3]))
        return (d_o, d_d, d_ts, None, None, *_tensors(grads))


def _apply(params, origins, dirs, ts, precision, plain):
    _check_precision(precision)
    check_dims(params)
    if origins.is_cuda:
        mlp.check_no_tf32()
    r, g, b, sigma = _PropRays.apply(_kernel_ready(origins), _kernel_ready(dirs),
                                     _kernel_ready(ts), precision, plain, *_tensors(params))
    return (r, g, b), sigma


def prop_rays(params: Params, origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor,
              precision: str = "fp32") -> Tuple[Planes, torch.Tensor]:
    """Ray-major fused proposal MLP: origins/dirs (B, 3), ts (B, N) ->
    ((r, g, b), sigma), each (B, N) float32, differentiable in every input.
    CUDA tensors launch the kernels; CPU tensors take the plain versions."""
    return _apply(params, origins, dirs, ts, precision, plain=False)


prop_rays.launches = 0


def prop_rays_reference(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                        ts: torch.Tensor, precision: str = "fp32") -> Tuple[Planes, torch.Tensor]:
    """``prop_rays`` through the plain versions on any device, differentiable
    the same way: what a check on the card holds a training step or a
    rendered chunk through the kernels against. The port's paths never call
    it."""
    return _apply(params, origins, dirs, ts, precision, plain=True)


def prop_flat(params: Params, points: torch.Tensor, dirs: torch.Tensor,
              precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposal MLP at flat points: points, dirs (..., 3) -> (color (...,
    3), sigma (..., 1)), through ``prop_rays`` with one sample a ray at t = 0
    (the origin is the point), so its gradient to the points and directions
    is the ray chain rule's."""
    lead = points.shape[:-1]
    pts, drs = points.reshape(-1, 3), dirs.reshape(-1, 3)
    (r, g, b), sigma = prop_rays(params, pts, drs, pts.new_zeros((pts.shape[0], 1)), precision)
    return torch.stack([r, g, b], dim=-1).reshape(*lead, 3), sigma.reshape(*lead, 1)
