"""Sample placement along rays: coarse uniform t's + hierarchical inverse-CDF.

Counterpart of ``tinynerf/core/sampling.py``. The JAX package writes its
cumsum as a triangular matmul and its gathers as one-hot products because
those suit a TPU; here they are ``torch.cumsum``, ``torch.searchsorted`` and
``torch.gather``, which give the same values.

Semantics kept:
- coarse t's are an inclusive linspace(near, far, N_c) per ray, optionally
  jittered within the linspace spacing (stratified);
  the fraction is ``arange(n) * (1 / (n - 1))`` in float32, which is what
  ``jnp.linspace`` computes (``torch.linspace`` rounds differently);
- fine levels are N_f uniform points strictly between the per-ray CDF min and
  max (``arange(1, N_f + 1) / (N_f + 1)``), not random, and not
  differentiated (Q8): gradients reach the coarse weights only through the
  gathered cdf and slope;
- the bin below each level is ``searchsorted(cdf, level, side='left') - 1``,
  clamped to the valid range;
- ``slope_inv = delta / (dense[:, 1:] + 1e-7)`` with a zero last column.
"""

from __future__ import annotations

from typing import Optional

import torch

EPSILON = 1e-7


def linspace_frac(n: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n, float32)``, bit for bit."""
    return torch.arange(n, dtype=torch.float32, device=device) * (1.0 / (n - 1))


def coarse_ts(near: torch.Tensor, far: torch.Tensor, n_coarse: int,
              generator: Optional[torch.Generator] = None,
              lindisp: bool = False,
              jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) near/far -> (B, N_c) sample distances: an inclusive linspace per
    ray. With ``generator`` (or an injected (B, N_c) ``jitter`` in [0, 1))
    each t moves up by ``jitter * (far - near) / (N_c - 1)``, clamped at
    ``far`` (stratified sampling, the JAX package's opt-in). LINDISP is not
    ported yet (ROADMAP queue 1, slice 7)."""
    if lindisp:
        raise NotImplementedError(
            "LINDISP is not ported yet (ROADMAP queue 1, slice 7: "
            "contraction/LINDISP/NDC)")
    frac = linspace_frac(n_coarse, near.device).to(near.dtype)
    ts = near[:, None] + (far - near)[:, None] * frac[None, :]
    if generator is not None and jitter is None:
        jitter = torch.rand(ts.shape, generator=generator, dtype=ts.dtype,
                            device=ts.device)
    if jitter is not None:
        spacing = ((far - near) / (n_coarse - 1))[:, None]
        ts = torch.minimum(ts + jitter * spacing, far[:, None])
    return ts


def fine_levels(cdf: torch.Tensor, n_fine: int) -> torch.Tensor:
    """N_f uniform CDF levels strictly between each ray's CDF min and max,
    (B, N_c) -> (B, N_f). The levels are not differentiated."""
    high = cdf.max(dim=1).values.detach()
    low = cdf.min(dim=1).values.detach()
    frac = (torch.arange(1, n_fine + 1, dtype=cdf.dtype, device=cdf.device)
            / (n_fine + 1))
    return low[:, None] + (high - low)[:, None] * frac[None, :]


def bin_indices(cdf: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Index of the CDF bin below each level: searchsorted-left - 1, clamped
    to ``[0, N_c - 1]``. (B, N_c), (B, N_f) -> (B, N_f) int64."""
    idx = torch.searchsorted(cdf.contiguous(), levels.contiguous(),
                             side="left") - 1
    return idx.clamp(0, cdf.shape[1] - 1)


def resample(t_coarse: torch.Tensor, dense_coarse: torch.Tensor,
             delta_coarse: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Inverse-CDF hierarchical resampling.

    t_coarse (B, N_c) sorted per ray; dense_coarse (B, N_c) compositing
    weights; delta_coarse (B,) the per-ray coarse linspace spacing
    ``(far - near) / (N_c - 1)``. Returns (B, N_f) fine distances, sorted per
    ray by construction.
    """
    cdf = torch.cumsum(dense_coarse, dim=1)               # nondecreasing
    t_inv = fine_levels(cdf, n_fine)
    idx = bin_indices(cdf, t_inv)

    if delta_coarse.ndim == 1:
        delta_coarse = delta_coarse[:, None]
    slope_inv = delta_coarse / (dense_coarse[:, 1:] + EPSILON)
    slope_inv = torch.cat([slope_inv, torch.zeros_like(slope_inv[:, :1])], dim=1)

    lower_t = torch.gather(t_coarse, 1, idx)
    lower_cdf = torch.gather(cdf, 1, idx)
    lower_slope = torch.gather(slope_inv, 1, idx)
    return lower_t + (t_inv - lower_cdf) * lower_slope
