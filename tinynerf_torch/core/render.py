"""Volume rendering: coarse + hierarchical fine march, compositing and loss.

Counterpart of ``tinynerf/core/render.py`` for the reference-semantics
march, the occupancy grid and the proposal field (no NDC or LINDISP).
Semantics kept:

- Q5: **inclusive** cumsum in the transmittance exponent,
  ``w_i = exp(-sum_{j<=i} sigma_j delta_j) * (1 - exp(-sigma_i delta_i))``;
- coarse deltas are the constant per-ray ``(far - near) / N_c``; the merged
  pass uses ``diff(t)`` with a constant ``1e-4`` tail;
- the merged pass orders coarse and fine samples by t, coarse first on ties,
  and carries rgb and sigma with the same permutation (the Q4 fix);
  ``compat_sort=True`` reproduces the reference's Q4 defect instead, sorting
  t, each color channel and sigma independently;
- the coarse weights are not detached before the resampler (Q8), so the
  fine pass's gradient reaches the coarse sigma through ``d_ts``;
- ``ray_loss`` is the sum of squares over rays and channels of both passes;
- with an occupancy grid (``OCC_GRID``), each ray's [near, far] is first
  tightened to the occupied cells it crosses (``occupancy.tighten_bounds``);
- with a proposal field (``PROPOSAL``: ``prop_params``, and
  ``prop_field_fn``, by default the proposal MLP's plain
  ``proposal.field_proposal``) the coarse pass runs on it, the resampler's
  CDF is fed the detached coarse weights, and the fine pass is composited on its own
  over the ``n_fine`` samples (the last with the constant tail delta): the
  proposal places samples and never enters C_fine.

The JAX package composites the merged set without sorting, through compare
masks (``merge_impl="twolist"``) or one-hot rank products (``"permute"``,
its training default), which suit a TPU; both give the values and gradients
of a stable sort of the concatenated t's, which is what the port does for
either name.

The field is pluggable: ``field_fn(params, points, dirs) -> (color, sigma)``
on flat points, optionally with an ``eval_rays(params, origins, dirs, ts) ->
((r, g, b), sigma)`` attribute that takes rays directly (the CUDA kernels do).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tinynerf_torch.core import encoding, mlp, occupancy, proposal, rays as raylib, sampling

TAIL_DELTA = 1e-4

FieldFn = Callable[[mlp.Params, torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]
Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def field_plain(params: mlp.Params, points: torch.Tensor, dirs: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positional-encode then MLP: points, dirs (..., 3) ->
    (color (..., 3), sigma (..., 1)). Counterpart of ``field_jnp``."""
    return mlp.apply_network(params, encoding.encode_points(points),
                             encoding.encode_dirs(dirs))


def field_plain_bf16(params: mlp.Params, points: torch.Tensor,
                     dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The field at ``PRECISION=bf16`` without the kernels (``USE_PALLAS``
    off), the counterpart of the JAX package's ``bf16_field``
    (``tinynerf/train.py:184-191``): the encoding at float32, then the whole
    network in bfloat16 tensors (weights, biases, every product's output),
    the outputs cast back to float32. A different function from the
    kernels' bf16 form (``mlp.apply_network(..., precision="bf16")``), which
    sums in float32."""
    cast = {name: {k: t.to(torch.bfloat16) for k, t in layer.items()}
            for name, layer in params.items()}
    color, sigma = mlp.apply_network(
        cast, encoding.encode_points(points).to(torch.bfloat16),
        encoding.encode_dirs(dirs).to(torch.bfloat16))
    return color.float(), sigma.float()


def get_density(delta: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Compositing weights with the inclusive-cumsum transmittance.
    delta, sigma: (B, N) -> weights (B, N)."""
    sigma_delta = delta * sigma
    transmittance = torch.exp(-torch.cumsum(sigma_delta, dim=1))
    return transmittance * (1.0 - torch.exp(-sigma_delta))


def _as_channels(color) -> Planes:
    """A (B, N, 3) color or a tuple of three (B, N) planes -> the tuple."""
    if isinstance(color, (tuple, list)):
        return tuple(color)
    return tuple(color[..., c] for c in range(3))


def composite(weights: torch.Tensor, color) -> torch.Tensor:
    """Sum_i w_i * rgb_i: (B, N) weights x color -> (B, 3)."""
    return torch.stack([torch.sum(weights * c, dim=1)
                        for c in _as_channels(color)], dim=-1)


def merged_composite(t_co: torch.Tensor, t_fi: torch.Tensor,
                     sigma_co: torch.Tensor, sigma_fi: torch.Tensor,
                     color_co, color_fi,
                     tail: float = TAIL_DELTA,
                     white_bkgd: bool = False,
                     return_extras: bool = False):
    """Composite the merged coarse + fine sample set.

    Both lists are sorted per ray; a stable sort of ``concat([coarse, fine])``
    puts an equal-t coarse sample before the fine one. The globally last
    sample gets the constant ``tail`` delta. With ``return_extras`` also
    returns the expected termination distance ``sum w t / sum w`` and the
    opacity ``sum w``.
    """
    t_all = torch.cat([t_co, t_fi], dim=1)
    order = torch.sort(t_all, dim=1, stable=True).indices
    take = lambda a, b: torch.gather(torch.cat([a, b], dim=1), 1, order)
    t_s = torch.gather(t_all, 1, order)
    sigma_s = take(sigma_co, sigma_fi)
    color_s = tuple(take(c, f) for c, f in zip(_as_channels(color_co),
                                               _as_channels(color_fi)))
    delta = torch.cat([t_s[:, 1:] - t_s[:, :-1],
                       torch.full_like(t_s[:, :1], tail)], dim=1)
    weights = get_density(delta, sigma_s)
    out = composite(weights, color_s)
    acc = torch.sum(weights, dim=1)
    if white_bkgd:
        out = out + (1.0 - acc)[:, None]
    if return_extras:
        depth = torch.sum(weights * t_s, dim=1) / torch.clamp(acc, min=1e-10)
        return out, depth, acc
    return out


def compat_sorted_composite(t_co: torch.Tensor, t_fi: torch.Tensor,
                            sigma_co: torch.Tensor, sigma_fi: torch.Tensor,
                            color_co, color_fi,
                            tail: float = TAIL_DELTA) -> torch.Tensor:
    """The reference's merged pass with its Q4 defect (``nerf.py:308``): t,
    each color channel and sigma are sorted independently, decoupling every
    sample from its own values. No white-background term, as in the JAX
    package's ``compat_sort`` branch."""
    cat = lambda a, b: torch.cat([a, b], dim=1)
    t_s = torch.sort(cat(t_co, t_fi), dim=1, stable=True).values
    sigma_s = torch.sort(cat(sigma_co, sigma_fi), dim=1, stable=True).values
    color_s = tuple(torch.sort(cat(c, f), dim=1, stable=True).values
                    for c, f in zip(_as_channels(color_co), _as_channels(color_fi)))
    delta = torch.cat([t_s[:, 1:] - t_s[:, :-1],
                       torch.full_like(t_s[:, :1], tail)], dim=1)
    return composite(get_density(delta, sigma_s), color_s)


def ray_loss(c_coarse: torch.Tensor, c_fine: torch.Tensor,
             c_true: torch.Tensor) -> torch.Tensor:
    """Sum of squares over rays and RGB of both passes (``nerf.py:325-331``)."""
    return (torch.sum(torch.square(c_coarse - c_true))
            + torch.sum(torch.square(c_fine - c_true)))


def _eval_field(field_fn: FieldFn, params: mlp.Params, origins: torch.Tensor,
                dirs: torch.Tensor, ts: torch.Tensor,
                ) -> Tuple[Planes, torch.Tensor]:
    """Evaluate the field at ``origin + t * dir`` for each (ray, sample):
    ((r, g, b), sigma), each (B, N). A field with ``eval_rays`` expands the
    points itself."""
    ray_eval = getattr(field_fn, "eval_rays", None)
    if ray_eval is not None:
        return ray_eval(params, origins, dirs, ts)
    points = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    dirs_b = dirs[:, None, :].expand(points.shape)
    color, sigma = field_fn(params, points, dirs_b)
    return _as_channels(color), sigma.squeeze(-1)


def _standalone_composite(t_fi: torch.Tensor, sigma_fi: torch.Tensor, color_fi,
                          white_bkgd: bool, extras: bool):
    """The proposal mode's fine pass alone: (C_fine,) or, with ``extras``,
    (C_fine, depth, acc) over the fine samples."""
    delta = torch.cat([t_fi[:, 1:] - t_fi[:, :-1],
                       torch.full_like(t_fi[:, :1], TAIL_DELTA)], dim=1)
    weights = get_density(delta, sigma_fi)
    c_fine = composite(weights, color_fi)
    acc = torch.sum(weights, dim=1)
    if white_bkgd:
        c_fine = c_fine + (1.0 - acc)[:, None]
    if extras:
        return c_fine, torch.sum(weights * t_fi, dim=1) / torch.clamp(acc, min=1e-10), acc
    return (c_fine,)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {where})")


def render_rays(params: mlp.Params,
                rows: torch.Tensor, cols: torch.Tensor, pose17: torch.Tensor,
                k_inv: torch.Tensor,
                n_coarse: int, n_fine: int,
                field_fn: FieldFn = field_plain,
                generator: Optional[torch.Generator] = None,
                compat_sort: bool = False,
                ndc_params: Optional[Tuple[float, float, float]] = None,
                merge_impl: str = "twolist",
                white_bkgd: bool = False,
                occ_grid: Optional[occupancy.OccGrid] = None,
                occ_march: Optional[int] = None,
                occ_contract: bool = False,
                occ_march_res: Optional[int] = None,
                extras: bool = False,
                prop_params=None,
                prop_field_fn: Optional[FieldFn] = None,
                lindisp: bool = False):
    """Coarse + fine march for a ray batch -> (C_coarse, C_fine), each (B, 3).

    With ``extras=True`` returns ``(C_coarse, C_fine, depth, acc)``, depth
    and acc (B,) over the merged sample set (with a proposal field: over the
    fine samples). ``generator`` jitters the coarse samples (stratified).
    ``merge_impl`` is accepted as ``"twolist"`` or ``"permute"``: both are
    the same stable-sort merge here. ``occ_grid`` tightens each ray's bounds
    first, with ``occ_march`` probes per ray (``occupancy.tighten_bounds``).
    ``prop_params`` runs the coarse pass on the proposal field
    ``prop_field_fn`` (``PROPOSAL``; module docstring).
    """
    if merge_impl not in ("twolist", "permute"):
        raise ValueError(f"unknown merge_impl {merge_impl!r}")
    if compat_sort and extras:
        raise ValueError("extras needs the coupled merge; COMPAT_SORT "
                         "sorts every channel on its own")
    if prop_params is not None:
        if n_fine == 0:
            raise ValueError(
                "PROPOSAL with N_FINE=0 would train/render ONLY the narrow "
                "proposal net (the main network never evaluates) — use "
                "PROPOSAL=False for coarse-only runs.")
        if compat_sort:
            raise ValueError(
                "PROPOSAL is incompatible with COMPAT_SORT: the proposal mode "
                "composites the fine pass standalone, so the reference's Q4 "
                "per-channel sort defect cannot be reproduced under it. Use "
                "PROPOSAL=False for parity experiments.")
        if prop_field_fn is None:
            prop_field_fn = proposal.field_proposal
    if ndc_params is not None:
        raise _not_ported("NDC", "slice 7: contraction/LINDISP/NDC")

    origins, dirs, near, far = raylib.pixels_to_rays(rows, cols, pose17, k_inv)
    if occ_grid is not None:
        near, far = occupancy.tighten_bounds(
            occ_grid, origins, dirs, near, far, n_steps=occ_march,
            contract=occ_contract, lindisp=lindisp, march_res=occ_march_res)

    # ---- coarse pass ----
    t_co = sampling.coarse_ts(near, far, n_coarse, generator=generator,
                              lindisp=lindisp)
    if prop_params is not None:
        color_co, sigma_co = _eval_field(prop_field_fn, prop_params, origins, dirs, t_co)
    else:
        color_co, sigma_co = _eval_field(field_fn, params, origins, dirs, t_co)
    delta_co = ((far - near) / n_coarse)[:, None].expand(t_co.shape)
    dense_co = get_density(delta_co, sigma_co)
    c_coarse = composite(dense_co, color_co)
    if white_bkgd:
        c_coarse = c_coarse + (1.0 - torch.sum(dense_co, dim=1))[:, None]

    if n_fine == 0:
        return c_coarse, c_coarse

    # ---- hierarchical fine pass: the CDF slope uses the linspace spacing
    # (far - near) / (N_c - 1), unlike the density delta above (a reference
    # inconsistency kept for parity) ----
    # ---- a proposal field trains only on its own coarse loss: the CDF is
    # fed the detached weights ----
    dense_for_cdf = dense_co.detach() if prop_params is not None else dense_co
    t_fi = sampling.resample(t_co, dense_for_cdf, (far - near) / (n_coarse - 1),
                             n_fine)
    color_fi, sigma_fi = _eval_field(field_fn, params, origins, dirs, t_fi)
    if prop_params is not None:
        return (c_coarse, *_standalone_composite(t_fi, sigma_fi, color_fi,
                                                 white_bkgd, extras))
    if compat_sort:
        return c_coarse, compat_sorted_composite(
            t_co, t_fi, sigma_co, sigma_fi, color_co, color_fi)
    out = merged_composite(t_co, t_fi, sigma_co, sigma_fi, color_co, color_fi,
                           white_bkgd=white_bkgd, return_extras=extras)
    if extras:
        c_fine, depth, acc = out
        return c_coarse, c_fine, depth, acc
    return c_coarse, out
