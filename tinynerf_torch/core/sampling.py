"""Sample placement along rays: coarse uniform t's + hierarchical inverse-CDF.

Counterpart of ``tinynerf/core/sampling.py``. The JAX package writes its
cumsum as a triangular matmul and its gathers as one-hot products because
those suit a TPU; here they are ``torch.cumsum``, ``torch.searchsorted`` and
``torch.gather``, which give the same values.

Semantics kept:
- coarse t's are an inclusive linspace(near, far, N_c) per ray, optionally
  jittered within the linspace spacing (stratified);
  the fraction is ``arange(n) * (1 / (n - 1))`` in float32, which is what
  ``jnp.linspace`` computes (``torch.linspace`` rounds differently); with
  ``LINDISP`` the linspace is in disparity (1/t), jittered on the fraction;
- fine levels are N_f uniform points strictly between the per-ray CDF min and
  max (``arange(1, N_f + 1) / (N_f + 1)``), not random, and not
  differentiated (Q8): gradients reach the coarse weights only through the
  gathered cdf and slope;
- the bin below each level is ``searchsorted(cdf, level, side='left') - 1``,
  clamped to the valid range;
- ``slope_inv = delta / (dense[:, 1:] + 1e-7)`` with a zero last column;
  ``delta`` is the per-ray linspace spacing, or (LINDISP) a per-bin
  spacing whose bin i pairs with ``dense[:, i + 1]``.

The three gathers at the bins are one ``_BinGather``, whose backward sums
each bin's cotangents in an order fixed by the shapes (``run_sums``), where
``torch.gather``'s scatter-add would add them with atomics in whatever order
the card runs them: two steps from one state then give the same gradient
bit for bit.
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
    ``far`` (stratified sampling, the JAX package's opt-in).

    ``lindisp=True`` (``LINDISP``; needs ``near > 0``) spaces the samples
    linearly in disparity: ``1 / (1/near + (1/far - 1/near) * frac)``. The
    jitter then moves the fraction, ``min(frac + jitter / (N_c - 1), 1)``,
    which keeps each ray's t's sorted."""
    frac = linspace_frac(n_coarse, near.device).to(near.dtype)
    if generator is not None and jitter is None:
        jitter = torch.rand((near.shape[0], n_coarse), generator=generator,
                            dtype=near.dtype, device=near.device)
    if lindisp:
        if jitter is not None:
            frac = torch.clamp(frac[None, :] + jitter / (n_coarse - 1), max=1.0)
        else:
            frac = frac[None, :].expand(near.shape[0], n_coarse)
        inv_near = 1.0 / near[:, None]
        inv_far = 1.0 / far[:, None]
        return 1.0 / (inv_near + (inv_far - inv_near) * frac)
    ts = near[:, None] + (far - near)[:, None] * frac[None, :]
    if jitter is not None:
        spacing = ((far - near) / (n_coarse - 1))[:, None]
        ts = torch.minimum(ts + jitter * spacing, far[:, None])
    return ts


def fine_levels(cdf: torch.Tensor, n_fine: int, level_start: int = 0,
                level_count: Optional[int] = None) -> torch.Tensor:
    """N_f uniform CDF levels strictly between each ray's CDF min and max,
    (B, N_c) -> (B, N_f); with ``level_start`` / ``level_count`` only levels
    ``[level_start, level_start + level_count)`` of them, computed as
    ``(arange(1, count + 1) + start) / (N_f + 1)``, in that order, so that a
    slice equals the matching columns of the whole set bit for bit. The
    levels are not differentiated."""
    high = cdf.max(dim=1).values.detach()
    low = cdf.min(dim=1).values.detach()
    count = n_fine if level_count is None else level_count
    frac = ((torch.arange(1, count + 1, dtype=cdf.dtype, device=cdf.device) + level_start)
            / (n_fine + 1))
    return low[:, None] + (high - low)[:, None] * frac[None, :]


def bin_indices(cdf: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Index of the CDF bin below each level: searchsorted-left - 1, clamped
    to ``[0, N_c - 1]``. (B, N_c), (B, N_f) -> (B, N_f) int64."""
    idx = torch.searchsorted(cdf.contiguous(), levels.contiguous(),
                             side="left") - 1
    return idx.clamp(0, cdf.shape[1] - 1)


def run_sums(values: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(B, N, C) values, (B, N) keys nondecreasing along each row -> (B, N,
    C): at each position the sum of its run of equal keys up to it. A
    segmented scan of log2(N) doubling steps, so each sum is a tree over
    the run whose order the shapes fix."""
    n = values.shape[1]
    step = 1
    while step < n:
        same = (keys[:, step:] == keys[:, :-step])[..., None]
        values = torch.cat([values[:, :step],
                            values[:, step:] + torch.where(same, values[:, :-step], 0.0)],
                           dim=1)
        step *= 2
    return values


class _BinGather(torch.autograd.Function):
    """``torch.gather(source, 1, idx)`` of each (B, N_c) source at a (B, N_f)
    index that is nondecreasing along each ray (the resampler's bins). The
    backward gives each source the sum of the cotangents of its bin's run
    (``run_sums``, the run's last position holding it), written once into
    each bin: no two writes meet, so the result does not depend on the
    order the card runs them in."""

    @staticmethod
    def forward(ctx, idx: torch.Tensor, *sources: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.n_bins = sources[0].shape[1]
        return tuple(torch.gather(s, 1, idx) for s in sources)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        (idx,) = ctx.saved_tensors
        n_rays, n_levels = idx.shape
        sums = run_sums(torch.stack(grads, dim=-1), idx)
        last = torch.cat([idx[:, 1:] != idx[:, :-1],
                          torch.ones_like(idx[:, :1], dtype=torch.bool)], dim=1)
        # a run's last level writes its bin; every other level a column of its own
        spare = ctx.n_bins + torch.arange(n_levels, device=idx.device)
        dest = torch.where(last, idx, spare)
        out = sums.new_zeros((n_rays, ctx.n_bins + n_levels, len(grads)))
        out.scatter_(1, dest[..., None].expand_as(sums), sums)
        return (None, *(out[:, :ctx.n_bins, k].to(g.dtype) for k, g in enumerate(grads)))


def resample(t_coarse: torch.Tensor, dense_coarse: torch.Tensor,
             delta_coarse: torch.Tensor, n_fine: int, level_start: int = 0,
             level_count: Optional[int] = None) -> torch.Tensor:
    """Inverse-CDF hierarchical resampling.

    t_coarse (B, N_c) sorted per ray; dense_coarse (B, N_c) compositing
    weights; delta_coarse (B,) the per-ray coarse linspace spacing
    ``(far - near) / (N_c - 1)``, or (B, N_c - 1) per-bin spacings (LINDISP,
    whose bins are not uniform in t), bin i's pairing with
    ``dense_coarse[:, i + 1]`` in the slope. Returns (B, N_f) fine
    distances, sorted per ray by construction. ``level_start`` /
    ``level_count`` place only that slice of the N_f levels (a rank's share
    of a sample-sharded march, ``parallel/sample_shard.py``), the matching
    columns of the whole march.
    """
    cdf = torch.cumsum(dense_coarse, dim=1)               # nondecreasing
    t_inv = fine_levels(cdf, n_fine, level_start, level_count)
    idx = bin_indices(cdf, t_inv)

    if delta_coarse.ndim == 1:
        delta_coarse = delta_coarse[:, None]
    slope_inv = delta_coarse / (dense_coarse[:, 1:] + EPSILON)
    slope_inv = torch.cat([slope_inv, torch.zeros_like(slope_inv[:, :1])], dim=1)

    lower_t, lower_cdf, lower_slope = _BinGather.apply(idx, t_coarse, cdf, slope_inv)
    return lower_t + (t_inv - lower_cdf) * lower_slope
