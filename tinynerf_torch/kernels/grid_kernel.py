"""The CP grid field's hand-written CUDA kernels and their plain versions.

Counterpart of ``tinynerf/kernels/grid_kernel.py``: ``grid_rays(params,
origins, dirs, ts, n_density, precision)``, the counterpart of
``grid_field_pallas_rays`` (``GRID_PALLAS``). It evaluates the factorized
field (``core/gridfield.py``) at ``origin + t * dir`` for every (ray,
sample) pair and returns ``((r, g, b), sigma)``, each a dense (B, N) float32
plane. Its forward is TPU kernel 5 (``_fused_ray_forward`` / ``_fwd_kernel``),
its backward TPU kernel 6 (``_fused_ray_backward`` / ``_bwd_kernel``, a
recompute VJP): an ``autograd.Function`` whose backward is ``grid_rays_bwd``,
with gradients for the line tables, the decoder, ``origins``, ``dirs`` and
``ts``; ``extent`` gets zeros (frozen geometry).

The direction encoding stays outside the kernels, as on the TPU: it is per
ray, ``encoding.encode_dirs(dirs)`` at (B, 24) in PyTorch; the kernels take
it and the backward returns its cotangent (B, 24), which autograd chains
through the encoding into ``d_dirs``.

``precision`` is ``"fp32"`` or ``"bf16"``, the TPU kernel's
``compute_dtype=bfloat16`` form: hat weights, tables, line features, CP
products, the encoding and ``W1`` as they enter the hidden layer, ``h`` and
``W2`` as they enter the color head rounded to bfloat16; the sigma sum and
the decoder's sums in float32; in the backward ``g_h``, ``g_app``, the sigma
cotangent, each pair product and each ``d f_a`` rounded, every weight and
table gradient accumulated in float32. That is another function than the
point field's bf16 (``gridfield.apply_grid_field``), which rounds the sigma
sum and the decoder too; the port has both, as the JAX package does.

- On CPU tensors ``grid_rays`` runs the plain versions (``grid_rays_plain``,
  ``grid_rays_bwd_plain``), which repeat the kernels' arithmetic with the
  same rounding points and JAX's sub-gradient conventions (``abs'(0) = +1``
  and ``relu'(0) = 0`` in the hat weights, ``sign(0) = 0`` for sigma,
  ``clip``'s 0.5 at an exact boundary). The CPU tests reach them.
- On CUDA tensors each launches its kernel (``csrc/grid_rays_fwd.cu``,
  ``csrc/grid_rays_bwd.cu``) or raises; neither falls back.
  ``grid_rays.launches`` and ``grid_rays_bwd.launches`` count the calls
  that launched each kernel.
- ``grid_rays_reference`` is ``grid_rays`` through the plain versions on
  any device: what the card's checks hold a step or a rendered chunk
  through the kernels against.

The TPU kernel's hat-basis matmuls, outer-product bridges and 8-row ray
tiles are its MXU's and layouts' needs, not semantics: the CUDA kernels
read two table rows per axis and mask the ragged end of the rows.
Their bf16 forms run the decoder's products on the tensor cores
(``csrc/grid_common.cuh``). Every path takes a decoder width dividing 256;
on CUDA tensors the wrappers also refuse by name more than 256 table
columns and a tile that does not fit a block's shared memory (the
library's ``grid_rays_*_smem_bytes``, ``_check_fits``), which the plain
versions take. No grid of ``conf/`` is refused.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from tinynerf_torch.core import encoding, gridfield, mlp
from tinynerf_torch.core.encoding import DIR_ENC_DIM
from tinynerf_torch.kernels.mlp_kernel import (_check, _check_precision, _kernel_ready,
                                               _on_one_device, _stream)

FWD_SOURCE = "grid_rays_fwd.cu"
BWD_SOURCE = "grid_rays_bwd.cu"
# the backward's phase-clock variant (a measurement's library, never the main path's)
PHASE_DEFINES = ("GRID_PHASE_CLOCKS",)
PHASES = ("recompute", "decoder gradients", "g_in", "table gradient", "coordinates",
          "per-ray sums")
PHASE_BLOCKS = 1024   # blocks the variant counts (MAX_PHASE_BLOCKS, csrc/grid_common.cuh)
MAX_WIDTH = 256   # the decoder width must divide it
MAX_F = 256     # table columns the kernels take
MAX_SMEM = 232_448   # dynamic shared memory a block may take

Params = Dict[str, object]
Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the parameters in the kernels' order (the extent last)
_PARAM_KEYS = (("lines", "x"), ("lines", "y"), ("lines", "z"),
               ("decoder", "hidden", "w"), ("decoder", "hidden", "b"),
               ("decoder", "color", "w"), ("decoder", "color", "b"), ("extent",))


def _get(params: Params, key) -> torch.Tensor:
    for k in key:
        params = params[k]
    return params


def dims(params: Params, n_density: int) -> Tuple[int, int, int, int]:
    """``(res, n_density, n_app, width)`` of a grid field."""
    res, n_comp = params["lines"]["x"].shape
    return res, n_density, n_comp - n_density, params["decoder"]["hidden"]["w"].shape[1]


def flops_per_row(res: int, n_density: int, n_app: int, width: int) -> int:
    """FLOPs of one sample row in the gather form (multiply-adds x 2): the
    three two-tap lerps over F = Fd + Fa columns, the decoder, the CP
    product (two multiplies a column) and the sigma sum. 25,152 at the fine
    geometry (R 256, 64 + 64, width 128), 1,840 for the proposal grid (R 64,
    16 + 16, width 16). The backward does three times as many."""
    F = n_density + n_app
    macs = 3 * 2 * F + (DIR_ENC_DIM + n_app) * width + width * 3
    return 2 * macs + 2 * F + n_density


def flops_split_per_row(res: int, n_density: int, n_app: int,
                        width: int) -> Tuple[int, int]:
    """``flops_per_row`` split as (decoder products, elementwise): the hidden
    layer's product, 2 (24 + Fa) W, which the bf16 forms run on the tensor
    cores, and the rest (the lerps, the CP products, the sigma sum and the
    3-wide color head), which no form can put there. (22,528, 2,624) at the
    fine geometry, (1,280, 560) for the proposal grid; the backward does
    three times each (its dW1 and g_in products beside the recompute's)."""
    decoder = 2 * (DIR_ENC_DIM + n_app) * width
    return decoder, flops_per_row(res, n_density, n_app, width) - decoder


def hat_flops_per_row(res: int, n_density: int, n_app: int, width: int) -> int:
    """The TPU kernel's own cost estimate (``_flops_per_row``, called with
    the table width F): the dense hat-basis matmuls over all R rows and the
    decoder, whose input it counts as 24 + F wide (the decoder reads 24 +
    Fa). 236,288 at the fine geometry, 14,176 for the proposal grid. For
    reference only: the gather form does not do this work."""
    F = n_density + n_app
    return 2 * (3 * res * F + (DIR_ENC_DIM + F) * width + width * 3)


class _Taps:
    """The two interpolation taps of each point along one axis
    (``gridfield.lerp_taps``), and what the backward needs of them: where
    each hat's ``1 - |xg - idx|`` is positive (``relu'(0) = 0``), and the
    clip's gradient (1 inside, 0.5 at an exact boundary, 0 outside)."""

    def __init__(self, coord: torch.Tensor, ext: torch.Tensor, res: int):
        xg, raw = gridfield.grid_coords(coord, ext, res)
        self.i0, self.i1, self.w0, self.w1 = gridfield.lerp_taps(xg, res)
        self.m0, self.m1 = (self.w0 > 0).float(), (self.w1 > 0).float()
        self.clip_grad = (0.5 * ((raw >= 0) & (raw <= 1)).float()
                          + 0.5 * ((raw > 0) & (raw < 1)).float())


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])


def _forward(params: Params, origins, dirs, ts, de, n_density: int, precision: str):
    """The kernels' forward, keeping what the backward needs (run without
    autograd: the plain versions are written out in both directions)."""
    rnd = gridfield.rounding(precision)
    ext = params["extent"].detach()
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]       # (B, N, 3)
    tables = [rnd(params["lines"][ax]) for ax in gridfield.AXES]
    taps, feats = [], []
    for a, table in enumerate(tables):
        tap = _Taps(pts[..., a], ext, table.shape[0])
        feats.append(rnd(rnd(tap.w0)[..., None] * _rows(table, tap.i0)
                         + rnd(tap.w1)[..., None] * _rows(table, tap.i1)))
        taps.append(tap)
    prod = rnd(rnd(feats[0] * feats[1]) * feats[2])                     # (B, N, F)
    sig_pre = torch.sum(prod[..., :n_density], dim=-1)                  # float32
    de_b = rnd(de)[:, None, :].expand(*ts.shape, DIR_ENC_DIM)
    hin = torch.cat([de_b, prod[..., n_density:]], dim=-1)
    dec = params["decoder"]
    h_pre = hin @ rnd(dec["hidden"]["w"]) + dec["hidden"]["b"]
    h = torch.relu(h_pre)
    color = torch.sigmoid(rnd(h) @ rnd(dec["color"]["w"]) + dec["color"]["b"])
    return dict(pts=pts, tables=tables, taps=taps, feats=feats, sig_pre=sig_pre,
                hin=hin, h_pre=h_pre, h=h, color=color)


def _check_dims(params: Params, n_density: int) -> None:
    gridfield.check_params(params)
    res, nd, na, width = dims(params, n_density)
    if not 0 < nd <= nd + na or width > MAX_WIDTH or MAX_WIDTH % width:
        raise ValueError(f"the grid kernels take 0 < n_density <= F and a decoder width "
                         f"dividing {MAX_WIDTH}; got n_density {nd}, F {nd + na}, width {width}")


def _check_fits(smem_bytes, dm: Tuple[int, int, int, int], precision: str) -> None:
    """Refuse by name, before a launch, what the kernels do not take: more
    than ``MAX_F`` table columns, or a tile whose shared memory (the
    library's ``grid_rays_*_smem_bytes``) is over a block's ``MAX_SMEM``.
    The plain versions take both."""
    res, nd, na, width = dm
    if nd + na > MAX_F:
        raise ValueError(f"the grid kernels take F <= {MAX_F} table columns; got F {nd + na}")
    need = smem_bytes(*dm, int(precision == "bf16"))
    if need > MAX_SMEM:
        raise ValueError(f"the grid kernels' {precision} tile takes {need} bytes of shared "
                         f"memory at F {nd + na}, n_app {na}, width {width}, over a block's "
                         f"{MAX_SMEM}")


def grid_rays_plain(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                    ts: torch.Tensor, de: torch.Tensor, n_density: int,
                    precision: str = "fp32") -> Tuple[Planes, torch.Tensor]:
    """The same function as the forward kernel in plain PyTorch: origins,
    dirs (B, 3), ts (B, N), de = encode_dirs(dirs) (B, 24) -> ((r, g, b),
    sigma), each (B, N)."""
    with torch.no_grad():
        acts = _forward(params, origins, dirs, ts, de, n_density, precision)
    color = acts["color"]
    return (color[..., 0], color[..., 1], color[..., 2]), torch.abs(acts["sig_pre"])


def preactivation_margin(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                         ts: torch.Tensor, n_density: int,
                         precision: str = "fp32") -> torch.Tensor:
    """(B, N): each sample row's smallest |pre-activation| over the hidden
    layer's ReLUs and sigma's ``abs``. Two float32 implementations that sum
    in different orders can disagree on a mask (or a sign) only where this
    is within their rounding difference, so gradient comparisons weight such
    rows out of their cotangents."""
    with torch.no_grad():
        acts = _forward(params, origins, dirs, ts, encoding.encode_dirs(dirs), n_density,
                        precision)
    return torch.minimum(acts["h_pre"].abs().amin(-1), acts["sig_pre"].abs())


Grads = Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def grid_rays_bwd_plain(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                        ts: torch.Tensor, de: torch.Tensor, g_sigma: torch.Tensor,
                        g_r: torch.Tensor, g_g: torch.Tensor, g_b: torch.Tensor,
                        n_density: int, precision: str = "fp32") -> Grads:
    """The same function as the backward kernel in plain PyTorch: the VJP of
    ``grid_rays_plain`` with the (B, N) cotangents of (sigma, r, g, b) ->
    ``(grads, d_origins (B, 3), d_dirs (B, 3), d_ts (B, N), d_de (B, 24))``,
    ``grads`` shaped like ``params`` (``extent``: zero). ``d_dirs`` is the
    direction's share through the points only; the encoding's is ``d_de``.
    Written out (``_bwd_kernel``'s chain), not autograd: at bf16 the TPU
    kernel rounds where no autograd of a rounded forward would."""
    rnd = gridfield.rounding(precision)
    with torch.no_grad():
        acts = _forward(params, origins, dirs, ts, de, n_density, precision)
        dec = params["decoder"]
        flat = lambda x: x.reshape(-1, x.shape[-1])
        color, h, hin = acts["color"], acts["h"], acts["hin"]
        gp = torch.stack([g * color[..., c] * (1.0 - color[..., c])
                          for c, g in enumerate((g_r, g_g, g_b))], dim=-1)   # (B, N, 3)
        d_w2 = flat(h).T @ flat(gp)
        d_b2 = flat(gp).sum(0)
        w2 = rnd(dec["color"]["w"])
        g_h = gp[..., 0:1] * w2[:, 0] + gp[..., 1:2] * w2[:, 1]
        g_h = rnd((g_h + gp[..., 2:3] * w2[:, 2]) * (acts["h_pre"] > 0).float())
        d_w1 = flat(hin).T @ flat(g_h)
        d_b1 = flat(g_h).sum(0)
        g_in = g_h @ rnd(dec["hidden"]["w"]).T                            # (B, N, K)
        d_de = g_in[..., :DIR_ENC_DIM].sum(1)
        g_sig = g_sigma * torch.sign(acts["sig_pre"])
        dprod = torch.cat([rnd(g_sig)[..., None].expand(*ts.shape, n_density),
                           rnd(g_in[..., DIR_ENC_DIM:])], dim=-1)
        f0, f1, f2 = acts["feats"]
        pairs = (rnd(f1 * f2), rnd(f0 * f2), rnd(f0 * f1))
        ext = params["extent"].detach()
        d_tables, d_pts = {}, []
        for a, ax in enumerate(gridfield.AXES):
            tap, table = acts["taps"][a], acts["tables"][a]
            dfa = rnd(dprod * pairs[a])
            d_t = torch.zeros_like(table)
            d_t.index_add_(0, tap.i0.reshape(-1), flat(rnd(tap.w0)[..., None] * dfa))
            d_t.index_add_(0, tap.i1.reshape(-1), flat(rnd(tap.w1)[..., None] * dfa))
            d_tables[ax] = d_t
            du0 = torch.sum(dfa * _rows(table, tap.i0), dim=-1)
            du1 = torch.sum(dfa * _rows(table, tap.i1), dim=-1)
            dxg = -du0 * tap.m0 + du1 * tap.m1
            d_pts.append(dxg * tap.clip_grad * ((table.shape[0] - 1) / (2.0 * ext)))
        d_pts = torch.stack(d_pts, dim=-1)                                # (B, N, 3)
        d_ts = (d_pts[..., 0] * dirs[:, None, 0] + d_pts[..., 1] * dirs[:, None, 1]
                + d_pts[..., 2] * dirs[:, None, 2])
        d_o = d_pts.sum(1)
        d_d = (d_pts * ts[..., None]).sum(1)
    grads = {"lines": d_tables,
             "decoder": {"hidden": {"w": d_w1, "b": d_b1},
                         "color": {"w": d_w2, "b": d_b2}},
             "extent": torch.zeros_like(params["extent"])}
    return grads, d_o, d_d, d_ts, d_de


@functools.lru_cache(maxsize=None)
def _library(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    from tinynerf_torch.kernels.build import load_library
    lib = load_library(source, defines)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if source == FWD_SOURCE:
        lib.grid_rays_fwd.argtypes = [vp] * 10 + [i32] * 7 + [vp]
        lib.grid_rays_fwd.restype = i32
        lib.grid_rays_fwd_smem_bytes.argtypes = [i32] * 5
        lib.grid_rays_fwd_smem_bytes.restype = i32
        lib.grid_rays_fwd_workspace_floats.argtypes = [i32] * 4
        lib.grid_rays_fwd_workspace_floats.restype = i64
    else:
        lib.grid_rays_bwd.argtypes = [vp] * 15 + [i32] * 7 + [vp]
        lib.grid_rays_bwd.restype = i32
        lib.grid_rays_bwd_smem_bytes.argtypes = [i32] * 5
        lib.grid_rays_bwd_smem_bytes.restype = i32
        lib.grid_rays_bwd_grad_floats.argtypes = [i32] * 4
        lib.grid_rays_bwd_grad_floats.restype = i64
        lib.grid_rays_bwd_workspace_floats.argtypes = [i32] * 7
        lib.grid_rays_bwd_workspace_floats.restype = i64
        if defines == PHASE_DEFINES:
            lib.grid_rays_bwd_phase_clocks.argtypes = [vp]
            lib.grid_rays_bwd_phase_clocks.restype = i32
    return lib


def _param_ptrs(params: Params, n_density: int, device: torch.device) -> ctypes.Array:
    """The 8 device pointers the kernels take: tx, ty, tz, W1, b1, W2, b2 and
    the extent (read on the device: no synchronisation)."""
    res, nd, na, width = dims(params, n_density)
    shapes = [(res, nd + na)] * 3 + [(DIR_ENC_DIM + na, width), (width,), (width, 3),
                                     (3,), ()]
    ptrs = []
    for key, shape in zip(_PARAM_KEYS, shapes):
        t = _get(params, key)
        _check("::".join(key), t, shape, device)
        ptrs.append(t.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch(params: Params, origins, dirs, ts, de, n_density: int,
            precision: str) -> Tuple[Planes, torch.Tensor]:
    device = origins.device
    B, N = ts.shape
    for name, t, shape in (("origins", origins, (B, 3)), ("dirs", dirs, (B, 3)),
                           ("ts", ts, (B, N)), ("de", de, (B, DIR_ENC_DIM))):
        _check(name, t, shape, device)
    lib, dm, bf16 = _library(FWD_SOURCE), dims(params, n_density), int(precision == "bf16")
    _check_fits(lib.grid_rays_fwd_smem_bytes, dm, precision)
    ptrs = _param_ptrs(params, n_density, device)
    outs = [torch.empty((B, N), dtype=torch.float32, device=device) for _ in range(4)]
    workspace = torch.empty(max(lib.grid_rays_fwd_workspace_floats(*dm[:3], bf16), 1),
                            dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.grid_rays_fwd(
            origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), de.data_ptr(), ptrs,
            *[o.data_ptr() for o in outs], workspace.data_ptr(), B, N, *dm, bf16,
            _stream(device))
    if err != 0:
        raise RuntimeError(f"grid_rays_fwd kernel launch failed: CUDA error {err}")
    grid_rays.launches += 1
    sigma, r, g, b = outs
    return (r, g, b), sigma


def _launch_bwd(params: Params, origins, dirs, ts, de, g_sigma, g_r, g_g, g_b,
                n_density: int, precision: str, defines: Tuple[str, ...] = ()) -> Grads:
    device = origins.device
    B, N = ts.shape
    for name, t, shape in (("origins", origins, (B, 3)), ("dirs", dirs, (B, 3)),
                           ("ts", ts, (B, N)), ("de", de, (B, DIR_ENC_DIM)),
                           ("g_sigma", g_sigma, (B, N)), ("g_r", g_r, (B, N)),
                           ("g_g", g_g, (B, N)), ("g_b", g_b, (B, N))):
        _check(name, t, shape, device)
    lib = _library(BWD_SOURCE, defines)
    dm, bf16 = dims(params, n_density), int(precision == "bf16")
    _check_fits(lib.grid_rays_bwd_smem_bytes, dm, precision)
    ptrs = _param_ptrs(params, n_density, device)
    f32 = dict(dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        n_work = lib.grid_rays_bwd_workspace_floats(B, N, *dm, bf16)
    if n_work < 0:
        raise RuntimeError(f"grid_rays_bwd_workspace_floats failed at B={B} N={N} dims {dm}")
    workspace = torch.empty(max(n_work, 1), **f32)
    flat = torch.empty(lib.grid_rays_bwd_grad_floats(*dm), **f32)
    d_o, d_d = torch.empty((B, 3), **f32), torch.empty((B, 3), **f32)
    d_ts, d_de = torch.empty((B, N), **f32), torch.empty((B, DIR_ENC_DIM), **f32)
    with torch.cuda.device(device):
        err = lib.grid_rays_bwd(
            origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), de.data_ptr(),
            g_sigma.data_ptr(), g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(), ptrs,
            d_o.data_ptr(), d_d.data_ptr(), d_ts.data_ptr(), d_de.data_ptr(),
            flat.data_ptr(), workspace.data_ptr(), B, N, *dm, bf16, _stream(device))
    if err != 0:
        raise RuntimeError(f"grid_rays_bwd kernel launch failed: CUDA error {err}")
    if not defines:
        grid_rays_bwd.launches += 1
    # the kernel writes tx, ty, tz, W1, b1, W2, b2 in turn
    res, nd, na, width = dm
    sizes = [res * (nd + na)] * 3 + [(DIR_ENC_DIM + na) * width, width, width * 3, 3]
    tx, ty, tz, w1, b1, w2, b2 = torch.split(flat, sizes)
    F = nd + na
    grads = {"lines": {"x": tx.view(res, F), "y": ty.view(res, F), "z": tz.view(res, F)},
             "decoder": {"hidden": {"w": w1.view(DIR_ENC_DIM + na, width), "b": b1},
                         "color": {"w": w2.view(width, 3), "b": b2}},
             "extent": torch.zeros_like(params["extent"])}
    return grads, d_o, d_d, d_ts, d_de


def bwd_phase_split(params: Params, origins, dirs, ts, de, g_sigma, g_r, g_g, g_b,
                    n_density: int, precision: str = "fp32") -> Dict[str, float]:
    """One launch of the backward's phase-clock variant (CUDA tensors): for
    each of ``PHASES``, its share of the blocks' summed clock cycles in that
    launch. A measurement, not a path: the variant meets at a barrier
    at each phase's end, and ``grid_rays_bwd.launches`` does not count it."""
    _check_precision(precision)
    _check_dims(params, n_density)
    lib = _library(BWD_SOURCE, PHASE_DEFINES)
    clocks = (ctypes.c_longlong * (PHASE_BLOCKS * len(PHASES)))()

    def read_clocks():  # into `clocks`, and zero them on the device
        with torch.cuda.device(origins.device):
            torch.cuda.synchronize()
            err = lib.grid_rays_bwd_phase_clocks(ctypes.addressof(clocks))
        if err != 0:
            raise RuntimeError(f"grid_rays_bwd_phase_clocks failed: CUDA error {err}")

    read_clocks()
    _launch_bwd(params, origins, dirs, ts, de, g_sigma, g_r, g_g, g_b, n_density, precision,
                PHASE_DEFINES)
    read_clocks()
    per_phase = [sum(clocks[b * len(PHASES) + i] for b in range(PHASE_BLOCKS))
                 for i in range(len(PHASES))]
    total = max(sum(per_phase), 1)
    return {name: c / total for name, c in zip(PHASES, per_phase)}


def _tensors(params: Params) -> List[torch.Tensor]:
    return [_get(params, key) for key in _PARAM_KEYS]


def grid_rays_bwd(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                  ts: torch.Tensor, de: torch.Tensor, g_sigma: torch.Tensor,
                  g_r: torch.Tensor, g_g: torch.Tensor, g_b: torch.Tensor,
                  n_density: int, precision: str = "fp32") -> Grads:
    """The grid field's recompute backward: the (B, N) cotangents of (sigma,
    r, g, b) -> ``(grads, d_origins, d_dirs, d_ts, d_de)``, all float32.
    CUDA tensors launch the kernel; CPU tensors take
    ``grid_rays_bwd_plain``."""
    _check_precision(precision)
    _check_dims(params, n_density)
    args = (params, origins, dirs, ts, de, g_sigma, g_r, g_g, g_b, n_density, precision)
    tensors = [origins, dirs, ts, de, g_sigma, g_r, g_g, g_b] + _tensors(params)
    if _on_one_device(tensors, "grid_rays_bwd"):
        return _launch_bwd(*args)
    return grid_rays_bwd_plain(*args)


grid_rays_bwd.launches = 0


def _unflatten(flat) -> Params:
    params: Params = {}
    for key, t in zip(_PARAM_KEYS, flat):
        node = params
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = t
    return params


class _GridRays(torch.autograd.Function):
    """``grid_rays`` with ``grid_rays_bwd`` as its backward; with ``plain``,
    ``grid_rays_reference``: the plain versions both ways, on any device."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, de, n_density, precision, plain, *flat):
        params = _unflatten(flat)
        if not plain and _on_one_device([origins, dirs, ts, de, *flat], "grid_rays"):
            (r, g, b), sigma = _launch(params, origins, dirs, ts, de, n_density, precision)
        else:
            (r, g, b), sigma = grid_rays_plain(params, origins, dirs, ts, de, n_density,
                                               precision)
        ctx.save_for_backward(origins, dirs, ts, de, *flat)
        ctx.n_density, ctx.precision, ctx.plain = n_density, precision, plain
        return r, g, b, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_r, g_g, g_b, g_sigma):
        origins, dirs, ts, de, *flat = ctx.saved_tensors
        cots = [_kernel_ready(g) for g in (g_sigma, g_r, g_g, g_b)]
        bwd = grid_rays_bwd_plain if ctx.plain else grid_rays_bwd
        grads, d_o, d_d, d_ts, d_de = bwd(
            _unflatten(flat), origins, dirs, ts, de, *cots,
            n_density=ctx.n_density, precision=ctx.precision)
        return (d_o, d_d, d_ts, d_de, None, None, None, *_tensors(grads))


def _apply(params, origins, dirs, ts, n_density, precision, plain):
    _check_precision(precision)
    _check_dims(params, n_density)
    if origins.is_cuda:
        mlp.check_no_tf32()
    de = _kernel_ready(encoding.encode_dirs(dirs))
    r, g, b, sigma = _GridRays.apply(
        _kernel_ready(origins), _kernel_ready(dirs), _kernel_ready(ts), de, n_density,
        precision, plain, *_tensors(params))
    return (r, g, b), sigma


def grid_rays(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
              ts: torch.Tensor, n_density: int, precision: str = "fp32",
              ) -> Tuple[Planes, torch.Tensor]:
    """Ray-major fused CP grid field: origins/dirs (B, 3), ts (B, N) ->
    ((r, g, b), sigma), each (B, N) float32, differentiable in the params,
    origins, dirs (through the points and the encoding) and ts. CUDA tensors
    launch the kernels; CPU tensors take the plain versions."""
    return _apply(params, origins, dirs, ts, n_density, precision, plain=False)


grid_rays.launches = 0


def grid_rays_reference(params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                        ts: torch.Tensor, n_density: int, precision: str = "fp32",
                        ) -> Tuple[Planes, torch.Tensor]:
    """``grid_rays`` through the plain versions on any device, differentiable
    the same way: what a check on the card holds a training step or a
    rendered chunk through the kernels against. The port's paths never call
    it."""
    return _apply(params, origins, dirs, ts, n_density, precision, plain=True)
