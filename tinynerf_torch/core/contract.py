"""The mip-NeRF-360 scene contraction (``CONTRACT``), for unbounded scenes.

Counterpart of ``tinynerf/core/contract.py``. World space warps into the
radius-2 ball before the field evaluates (Barron et al. 2022, Eq. 10):

    contract(x) = x                          if ||x|| <= 1
                  (2 - 1/||x||) * x/||x||    otherwise

The warp sits at the field: ``wrap_field_contract`` wraps a point-interface
field, so the renderer, the resampler and the compositor are untouched. The
wrapper carries no ``eval_rays`` or ``render_fused``: the ray kernels form
``o + t * d`` inside, where the warp cannot reach, so under ``CONTRACT``
every field runs its point interface (the MLP: ``mlp_kernel.field_flat``,
TPU kernels 3 and 4 on the card).
"""

from __future__ import annotations

import torch


def contract_mip360(points: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points -> (..., 3) points in the radius-2 ball, in
    float32 whatever the input's type. ``max(n^2, 1e-12)`` keeps the
    gradient of the norm finite at the origin, where both branches are
    differentiated."""
    pts = points.float()
    n2 = torch.sum(pts * pts, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-12))
    scale = torch.where(n <= 1.0, torch.ones_like(n), (2.0 - 1.0 / n) / n)
    return (pts * scale).to(points.dtype)


def inv_contract_mip360(c: torch.Tensor, max_norm: float = 1.99) -> torch.Tensor:
    """The inverse of ``contract_mip360``: contracted points -> world points.
    Outside the unit ball ``|x| = 1 / (2 - |c|)`` along the same ray, with
    ``|c|`` clamped to ``max_norm`` (1.99: world radius 100), so points on or
    past the radius-2 boundary map to a far but finite radius. The
    contracted occupancy grid probes the field at ``inv_contract`` of its
    cells."""
    c = c.float()
    n = torch.sqrt(torch.clamp(torch.sum(c * c, dim=-1, keepdim=True), min=1e-12))
    n_cl = torch.clamp(n, max=max_norm)
    scale = torch.where(n <= 1.0, torch.ones_like(n), 1.0 / ((2.0 - n_cl) * n_cl))
    return c * scale


def wrap_field_contract(field_fn):
    """A point-interface field that evaluates ``field_fn`` at contracted
    points. The wrapper has no ``eval_rays`` or ``render_fused`` attribute
    (module docstring)."""
    def field(params, points, dirs):
        return field_fn(params, contract_mip360(points), dirs)

    return field
