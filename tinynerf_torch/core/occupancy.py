"""Occupancy-grid empty-space skipping (``OCC_GRID``).

Counterpart of ``tinynerf/core/occupancy.py``. A coarse R^3 grid of density
at cell centers (an EMA over refreshes, then a 3x3x3 max dilation) tightens
each ray's [near, far] to the span of occupied cells it crosses; sample
counts stay fixed, so the same 64 + 128 samples concentrate on occupied
space. Rays that hit nothing collapse to a tiny interval at ``far`` and
composite to the background, which is why a white-composited (sync) scene
needs ``WHITE_BKGD`` (the Runner refuses it otherwise).

- ``update_grid`` probes one jittered point per cell, all cells or a random
  subset (``OCC_SUBSET``), through the point field; on the card that is the
  flat field kernel (``kernels/mlp_kernel.field_flat``). The cell indices
  and the jitter come from a generator, or the caller gives them
  (``draws``), so tests can feed the JAX package's draws.
- ``tighten_bounds`` marches a fixed number of probes per ray. The JAX
  package reads the pooled grid (``OCC_MARCH_RES``) through a one-hot
  matmul because that suits a TPU; here it is a gather, the same values.
- Under ``CONTRACT`` the cells live in the contracted radius-2 ball: the
  refresh probes the field (the contracting wrapper) at ``inv_contract`` of
  each jittered cell point, and the march contracts its probes. Under
  ``LINDISP`` the probes are disparity-spaced and each occupied probe is
  widened by its local spacing.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tinynerf_torch.core.contract import contract_mip360, inv_contract_mip360


class OccGrid(NamedTuple):
    density: torch.Tensor      # (R, R, R) dilated query grid (what rays test)
    raw: torch.Tensor          # (R, R, R) undilated EMA of sigma at cell centers
    half_extent: torch.Tensor  # scalar: the grid spans [-h, h]^3
    threshold: torch.Tensor    # scalar occupancy cutoff on sigma


def init_grid(resolution: int = 64, half_extent: float = 1.5,
              threshold: float = 0.01,
              device: torch.device = torch.device("cpu")) -> OccGrid:
    """Every cell ``inf``: "assume occupied", so ``tighten_bounds`` changes
    nothing until cells are probed, and a partly refreshed grid stays
    conservative."""
    full = torch.full((resolution,) * 3, float("inf"), dtype=torch.float32,
                      device=device)
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return OccGrid(density=full, raw=full.clone(), half_extent=scalar(half_extent),
                   threshold=scalar(threshold))


def cell_centers(resolution: int, half_extent: torch.Tensor) -> torch.Tensor:
    """(R^3, 3) cell-center coordinates, x-major."""
    lin = (torch.arange(resolution, dtype=torch.float32,
                        device=half_extent.device) + 0.5) / resolution
    lin = lin * 2.0 - 1.0
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * half_extent


def _dilate(raw: torch.Tensor) -> torch.Tensor:
    """3x3x3 max dilation, padding with -inf (``reduce_window``'s init):
    thin geometry at a cell boundary keeps its neighbours occupied.
    Never-probed (``inf``) cells stay ``inf`` and spread."""
    return F.max_pool3d(raw[None, None], 3, stride=1, padding=1)[0, 0]


def _set_last_wins(flat: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """``flat[idx] = values`` where, for an index drawn more than once, the
    last occurrence wins on every device (``index_put_`` with duplicates
    leaves the winner to the device; JAX's ``.at[].set`` leaves it
    undefined)."""
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    last = torch.ones_like(sorted_idx, dtype=torch.bool)
    last[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    keep = order[last]
    out = flat.clone()
    out[idx[keep]] = values[keep]
    return out


@torch.no_grad()
def update_grid(grid: OccGrid, params, field_fn,
                generator: Optional[torch.Generator] = None,
                ema: float = 0.8, chunk: int = 65536,
                subset: Optional[int] = None, contract: bool = False,
                draws: Optional[Tuple[Optional[torch.Tensor], torch.Tensor]] = None,
                cell_split=None) -> OccGrid:
    """EMA-update the grid from the field (one jittered probe per cell), then
    re-derive the dilated query grid.

    ``subset=None`` probes every cell (R^3 probes); ``subset=K`` probes K
    cells drawn uniformly with replacement, and the others keep their value
    (``inf`` until first probed). A cell drawn twice takes the last draw's
    update. Probes go through ``field_fn(params, points, dirs)`` (direction
    +z) in chunks of ``chunk`` rows, without autograd.

    ``draws = (flat_idx (K,) or None, uniform (K or R^3, 3) in [0, 1))``
    replaces the draws from ``generator``: the cells and the jitter,
    ``(uniform - 0.5) * cell``.

    ``contract=True`` (``CONTRACT``; ``half_extent`` 2): the cells live in
    the contracted ball and ``field_fn`` is the contracting wrapper, which
    takes world points, so each probe goes through ``inv_contract_mip360``
    first and the wrapper's warp lands it back on its cell.

    ``cell_split`` (``parallel.mesh.Mesh``, the counterpart of the JAX
    package's ``cell_sharding``) partitions the probes over the ranks of a
    job: every rank draws every probe, evaluates its own contiguous rows
    (``local_rows``) and gathers every rank's sigma back (``gather_rows``),
    so the grids stay identical and equal the one-rank refresh.
    """
    res = grid.density.shape[0]
    n_total = res ** 3
    device = grid.raw.device
    cell = 2.0 * grid.half_extent / res
    partial = subset is not None and subset < n_total
    if draws is None:
        n = subset if partial else n_total
        flat_idx = (torch.randint(0, n_total, (n,), generator=generator,
                                  device=device) if partial else None)
        uniform = torch.rand((n, 3), generator=generator, device=device)
    else:
        flat_idx, uniform = draws

    def sigma_at(points: torch.Tensor) -> torch.Tensor:
        out = []
        n = points.shape[0]
        if cell_split is not None:
            points = cell_split.local_rows(points)
        if contract:
            points = inv_contract_mip360(points)
        for p in torch.split(points, chunk):
            up = torch.zeros_like(p)
            up[:, 2] = 1.0
            out.append(field_fn(params, p, up)[1][:, 0])
        sigma = torch.cat(out) if out else points.new_zeros((0,))
        return sigma if cell_split is None else cell_split.gather_rows(sigma, n)

    if not partial:
        centers = cell_centers(res, grid.half_extent)
        new = sigma_at(centers + (uniform - 0.5) * cell).reshape(grid.raw.shape)
        old = torch.where(torch.isinf(grid.raw), new, grid.raw)
        raw = ema * old + (1.0 - ema) * new
    else:
        ix = flat_idx // (res * res)
        iy = (flat_idx // res) % res
        iz = flat_idx % res
        idx3 = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
        ctr = ((idx3 + 0.5) / res * 2.0 - 1.0) * grid.half_extent
        sig = sigma_at(ctr + (uniform - 0.5) * cell)
        old = grid.raw.reshape(-1)[flat_idx]
        # ema * inf is inf, never nan: the unused branch stays harmless
        upd = torch.where(torch.isinf(old), sig, ema * old + (1.0 - ema) * sig)
        raw = _set_last_wins(grid.raw.reshape(-1), flat_idx, upd).reshape(grid.raw.shape)
    return grid._replace(raw=raw, density=_dilate(raw))


def derive_march_steps(resolution: int, half_extent: float, ray_span: float,
                       safety: float = 1.25) -> int:
    """Probe count for ``tighten_bounds`` that cannot skip occupied space for
    rays marching up to ``ray_span = max(far - near)``: the dilated grid
    makes every occupied run at least 3 cells (``6 * half_extent /
    resolution``) long, and the probe spacing must stay below that with a
    safety factor."""
    margin = 6.0 * half_extent / resolution
    needed = int(-(-ray_span * safety // margin))  # ceil
    return max(64, needed)


def derive_march_steps_contracted(resolution: int, near: float, far: float,
                                  safety: float = 1.25) -> int:
    """Probe count for the contracted grid's disparity-spaced march.
    Disparity-uniform probes have uniform contracted-radial spacing
    ``(1/near - 1/far) / n`` (for ``t > 1``, ``r_c = 2 - 1/t``), so the
    3-cell dilation margin ``6 * 2 / resolution`` bounds ``n`` as in
    ``derive_march_steps``."""
    span = 1.0 / max(near, 1e-6) - 1.0 / max(far, 1e-6)
    margin = 6.0 * 2.0 / resolution
    return max(64, int(-(-span * safety // margin)))


@torch.no_grad()
def tighten_bounds(grid: OccGrid, origins: torch.Tensor, dirs: torch.Tensor,
                   near: torch.Tensor, far: torch.Tensor,
                   n_steps: Optional[int] = None,
                   contract: bool = False, lindisp: bool = False,
                   march_res: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray [near, far] (B,) -> the sub-interval covering occupied cells.

    ``n_steps`` probes per ray (default ``max(64, R)``; the Runner passes
    ``derive_march_steps``), each looked up in the dilated grid; the bounds
    are the first and last occupied probe, widened by the larger of the
    probe spacing and one cell diagonal. Rays that hit nothing get
    ``[far - 1e-3, far]``. ``march_res=M`` looks the probes up in the grid
    max-pooled to M^3 (R % M == 0), a superset of the full grid's occupancy.
    No gradient flows through the bounds.

    ``lindisp`` spaces the probes in disparity (needs ``near > 0``) and
    widens each occupied probe by its local spacing (one-sided
    differences), floored at the cell diagonal unless ``contract``;
    ``contract`` looks the probes up at their contracted positions.
    """
    res = grid.density.shape[0]
    if n_steps is None:
        n_steps = max(64, res)
    frac = (torch.arange(n_steps, dtype=torch.float32, device=near.device)
            + 0.5) / n_steps
    if lindisp:
        ts = 1.0 / (1.0 / near[:, None]
                    + (1.0 / far - 1.0 / near)[:, None] * frac[None, :])
    else:
        ts = near[:, None] + (far - near)[:, None] * frac[None, :]    # (B, S)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]      # (B, S, 3)
    if contract:
        pts = contract_mip360(pts)

    lookup, lres = grid.density, res
    if march_res is not None and march_res != res:
        if res % march_res != 0:
            raise ValueError(f"OCC_MARCH_RES {march_res} must divide the "
                             f"grid resolution {res}")
        f = res // march_res
        lookup = F.max_pool3d(grid.density[None, None], f, stride=f)[0, 0]
        lres = march_res

    idx = torch.floor((pts / grid.half_extent * 0.5 + 0.5) * lres).to(torch.int32)
    inside = torch.all((idx >= 0) & (idx < lres), dim=-1)
    idx = idx.clamp(0, lres - 1).to(torch.int64)
    flat = (idx[..., 0] * lres + idx[..., 1]) * lres + idx[..., 2]
    # compare before any product: never-probed cells hold inf
    occ = (lookup.reshape(-1) > grid.threshold)[flat] & inside

    # Python scalars, not tensors made on the device: such a tensor is a
    # copy from pageable host memory, which waits for the stream to drain
    cell_diag = 2.0 * grid.half_extent / res * math.sqrt(3.0)
    if lindisp:
        # the probe spacing varies along a disparity march: each occupied
        # probe's own; under contract the world cell size varies too, so
        # the local spacing alone bounds it
        dt = ts[:, 1:] - ts[:, :-1]
        dt_left = torch.cat([dt[:, :1], dt], dim=1)
        dt_right = torch.cat([dt, dt[:, -1:]], dim=1)
        if not contract:
            dt_left = torch.maximum(dt_left, cell_diag)
            dt_right = torch.maximum(dt_right, cell_diag)
        t_enter = torch.where(occ, ts - dt_left, 3.4e38).amin(dim=1)
        t_exit = torch.where(occ, ts + dt_right, -3.4e38).amax(dim=1)
    else:
        step = torch.maximum((far - near) / n_steps, cell_diag)
        t_enter = torch.where(occ, ts, 3.4e38).amin(dim=1) - step
        t_exit = torch.where(occ, ts, -3.4e38).amax(dim=1) + step
    hit = occ.any(dim=1)
    new_near = torch.where(hit, torch.maximum(t_enter, near), far - 1e-3)
    new_far = torch.where(hit, torch.minimum(t_exit, far), far)
    return new_near, new_far
