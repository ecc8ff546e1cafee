"""Plain PyTorch volume rendering of a NeRF ray batch, written from the
published method and the semantics the configurations state, for the
benchmark's check. It imports nothing of the program.

A field is ``field(points (M, 3), dirs (M, 3)) -> (rgb (M, 3), sigma
(M,))``. One batch of rays:

- rays from pixels: ``(row, col, 1) @ K_inv`` with ``K_inv = [[1, 0, 0],
  [0, -1, 0], [-W/2, H/2, -f]]`` (row and column feed x and y), unit
  directions turned by the camera's rotation; ``t`` is the distance along
  the unit direction;
- the occupancy grid (R^3 cells over ``[-E, E]^3``) tightens each ray's
  ``[near, far]`` to its first and last occupied probe, widened by the
  larger of the probe spacing and a cell diagonal; a ray that meets none
  collapses to ``[far - 1e-3, far]``;
- ``n_coarse`` samples at ``near + (far - near) * k / (n_coarse - 1)``,
  composited with the constant delta ``(far - near) / n_coarse`` and the
  inclusive transmittance ``exp(-sum_{j<=i} sigma_j delta_j)``;
- ``n_fine`` samples by inverting the coarse weights' CDF at evenly spaced
  levels strictly between its least and largest value, with the linspace
  spacing ``(far - near) / (n_coarse - 1)`` as the slope's run;
- the fine pass: with a proposal field, its own samples alone; else the
  coarse and fine samples merged by ``t`` (coarse first on ties), deltas
  to the next sample and ``1e-4`` after the last;
- a white background adds ``1 - sum w`` to each color.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TAIL_DELTA = 1e-4
CDF_EPS = 1e-7
EMA = 0.8

Field = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def k_inv(height: int, width: int, focal: float, device) -> torch.Tensor:
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                         [-0.5 * width, 0.5 * height, -focal]],
                        dtype=torch.float32, device=device)


def pixel_rays(rows, cols, pose17, kinv):
    """(B,) rows and columns, (B, 17) pose rows -> origins, unit dirs (B, 3),
    near, far (B,)."""
    c2w = pose17[:, :15].reshape(-1, 3, 5)[:, :, :4]
    xy1 = torch.stack([rows, cols, torch.ones_like(rows)], dim=-1)
    d_cam = (xy1[:, :, None] * kinv[None]).sum(dim=1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    dirs = (c2w[:, :, :3] * d_cam[:, None, :]).sum(dim=-1)
    return c2w[:, :, 3].contiguous(), dirs, pose17[:, 15], pose17[:, 16]


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF's positional encoding as the configurations state it: the
    frequencies ``2 ** linspace(0, L, L) * pi`` (exponent in float64, then
    float32), no identity term, ``[sin f0 x, cos f0 x, sin f1 x, ...]`` for
    x, then y, then z."""
    f = np.exp2(np.linspace(0.0, n_freqs, n_freqs)).astype(np.float32) * np.float32(np.pi)
    scaled = x[..., :, None] * torch.as_tensor(f, device=x.device)
    return torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-1).reshape(
        *x.shape[:-1], 6 * n_freqs)


# ---- the occupancy grid: (raw, density) tensors of R^3 cells ----

def occ_init(res: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every cell unprobed (``inf``), which counts as occupied."""
    full = torch.full((res, res, res), float("inf"), device=device)
    return full, full.clone()


def occ_refresh(raw: torch.Tensor, field: Field, generator: torch.Generator,
                subset: int, extent: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``subset`` cells drawn with replacement (``randint``), one probe each at
    the cell center plus ``(rand(3) - 0.5)`` of a cell, looking along +z; an
    unprobed cell takes the probe's sigma, a probed one ``0.8 old + 0.2
    new``; a cell drawn twice keeps its last draw's value. The density grid
    is the raw grid's 3x3x3 maximum."""
    res = raw.shape[0]
    n_total = res ** 3
    device = raw.device
    idx = torch.randint(0, n_total, (subset,), generator=generator, device=device)
    u = torch.rand((subset, 3), generator=generator, device=device)
    cell = 2.0 * extent / res
    ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], -1).float()
    pts = ((ijk + 0.5) / res * 2.0 - 1.0) * extent + (u - 0.5) * cell
    dirs = torch.zeros_like(pts)
    dirs[:, 2] = 1.0
    with torch.no_grad():
        sigma = torch.cat([field(p, d)[1] for p, d in zip(pts.split(65536), dirs.split(65536))])
    flat = raw.reshape(-1)
    old = flat[idx]
    new = torch.where(torch.isinf(old), sigma, EMA * old + (1.0 - EMA) * sigma)
    # the last draw of each cell: the highest position among its draws
    pos = torch.arange(subset, device=device)
    last = torch.full((n_total,), -1, dtype=torch.int64, device=device)
    last.scatter_reduce_(0, idx, pos, reduce="amax")
    hit = last >= 0
    out = flat.clone()
    out[hit] = new[last[hit]]
    raw = out.reshape(raw.shape)
    return raw, F.max_pool3d(raw[None, None], 3, stride=1, padding=1)[0, 0]


def occ_bounds(density: torch.Tensor, extent: float, thresh: float, origins, dirs,
               near, far, n_steps: int):
    res = density.shape[0]
    frac = (torch.arange(n_steps, dtype=torch.float32, device=near.device) + 0.5) / n_steps
    ts = near[:, None] + (far - near)[:, None] * frac[None, :]
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    ijk = torch.floor((pts / extent * 0.5 + 0.5) * res).long()
    inside = ((ijk >= 0) & (ijk < res)).all(dim=-1)
    ijk = ijk.clamp(0, res - 1)
    occ = (density > thresh)[ijk[..., 0], ijk[..., 1], ijk[..., 2]] & inside
    step = torch.clamp((far - near) / n_steps, min=2.0 * extent / res * math.sqrt(3.0))
    t_in = torch.where(occ, ts, torch.full_like(ts, 3.4e38)).amin(dim=1) - step
    t_out = torch.where(occ, ts, torch.full_like(ts, -3.4e38)).amax(dim=1) + step
    hit = occ.any(dim=1)
    return (torch.where(hit, torch.maximum(t_in, near), far - 1e-3),
            torch.where(hit, torch.minimum(t_out, far), far))


def march_steps(res: int, extent: float, max_span: float) -> int:
    """Probes a ray: at least 64, and enough that the probe spacing stays
    under 0.8 of the dilated grid's 3-cell margin over the longest span."""
    return max(64, math.ceil(max_span * 1.25 / (6.0 * extent / res)))


# ---- sampling and compositing ----

def weights(delta: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    sd = delta * sigma
    return torch.exp(-torch.cumsum(sd, dim=1)) * (1.0 - torch.exp(-sd))


def _eval(field: Field, origins, dirs, ts):
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    rgb, sigma = field(pts.reshape(-1, 3), dirs[:, None, :].expand(pts.shape).reshape(-1, 3))
    return rgb.reshape(*ts.shape, 3), sigma.reshape(ts.shape)


def _composite(w, rgb, white: bool):
    c = (w[..., None] * rgb).sum(dim=1)
    return c + (1.0 - w.sum(dim=1))[:, None] if white else c


def resample(t_co, dense, spacing, n_fine: int):
    cdf = torch.cumsum(dense, dim=1)
    lo, hi = cdf.min(dim=1).values.detach(), cdf.max(dim=1).values.detach()
    frac = torch.arange(1, n_fine + 1, dtype=torch.float32, device=cdf.device) / (n_fine + 1)
    levels = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
    idx = (torch.searchsorted(cdf.detach().contiguous(), levels.contiguous(), side="left")
           - 1).clamp(0, cdf.shape[1] - 1)
    slope = spacing[:, None] / (dense[:, 1:] + CDF_EPS)
    slope = torch.cat([slope, torch.zeros_like(slope[:, :1])], dim=1)
    take = lambda a: torch.gather(a, 1, idx)
    return take(t_co) + (levels - take(cdf)) * take(slope)


def render_rays(field: Field, prop_field: Optional[Field], rows, cols, pose17, kinv,
                ini: dict, occ_density: Optional[torch.Tensor], n_steps: int):
    """(C_coarse, C_fine), each (B, 3), of a batch of pixels."""
    n_co, n_fi, white = ini["N_COARSE"], ini["N_FINE"], ini["WHITE_BKGD"]
    origins, dirs, near, far = pixel_rays(rows, cols, pose17, kinv)
    if occ_density is not None:
        near, far = occ_bounds(occ_density, ini["OCC_EXTENT"], ini["OCC_THRESH"],
                               origins, dirs, near, far, n_steps)
    frac = torch.arange(n_co, dtype=torch.float32, device=near.device) * (1.0 / (n_co - 1))
    t_co = near[:, None] + (far - near)[:, None] * frac[None, :]
    rgb_co, sig_co = _eval(prop_field or field, origins, dirs, t_co)
    w_co = weights(((far - near) / n_co)[:, None].expand(t_co.shape), sig_co)
    c_co = _composite(w_co, rgb_co, white)
    cdf_w = w_co.detach() if prop_field is not None else w_co
    t_fi = resample(t_co, cdf_w, (far - near) / (n_co - 1), n_fi)
    rgb_fi, sig_fi = _eval(field, origins, dirs, t_fi)
    if prop_field is not None:
        t, rgb, sig = t_fi, rgb_fi, sig_fi
    else:
        t_all = torch.cat([t_co, t_fi], dim=1)
        order = torch.sort(t_all, dim=1, stable=True).indices
        t = torch.gather(t_all, 1, order)
        sig = torch.gather(torch.cat([sig_co, sig_fi], dim=1), 1, order)
        rgb = torch.gather(torch.cat([rgb_co, rgb_fi], dim=1), 1,
                           order[..., None].expand(*order.shape, 3))
    delta = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], TAIL_DELTA)], dim=1)
    return c_co, _composite(weights(delta, sig), rgb, white)
