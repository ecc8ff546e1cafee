"""A frame's fine samples spread over ranks: the deep-march path
(``SAMPLE_SHARD``).

Counterpart of ``tinynerf/parallel/sample_shard.py``. Transmittance is a
prefix product, ``T_i = exp(-sum_{j<=i} sigma_j delta_j)``, so a rank that
holds a contiguous span of a ray's samples needs one number from the ranks
before it: the sum of their ``sigma * delta``. The JAX package passes it
down a chain of ``ppermute`` hops; here every rank of the sample group
gathers each rank's total (``all_gather``) and adds those before its own
in rank order, the same values. ``pmin`` is ``all_reduce(MIN)``, ``psum``
``all_reduce(SUM)``, on the sample group; collectives only, so that one
code runs under NCCL and gloo.

``make_sample_sharded_render`` renders a ray batch with its rays split over
the data group and its N_f fine samples over the sample group: each rank
evaluates the field at all N_c coarse samples of its rays and at its
``N_f / n_sample`` fine ones, and the merged composite's compare masks are
(B, N_c, N_f / n_sample) a rank. The result is single-rank ``render_rays``'
(the two-list merge) within float32 rounding.
"""

from __future__ import annotations

import torch

from tinynerf_torch.core import rays as raylib, render, sampling
from tinynerf_torch.parallel import distributed as dist
from tinynerf_torch.parallel.mesh import sharded_render_chunk


def _exclusive_device_prefix_sum(x: torch.Tensor, group: dist.Group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` before this one (0 on the
    first), elementwise."""
    n = dist.world_size(group)
    if n == 1:
        return torch.zeros_like(x)
    totals = torch.stack(dist.all_gather(x, group))        # (n, ...)
    r = dist.rank(group)
    if r == 0:
        return torch.zeros_like(x)
    return torch.cumsum(totals, dim=0)[r - 1]


def sharded_get_density(delta: torch.Tensor, sigma: torch.Tensor,
                        group: dist.Group = None) -> torch.Tensor:
    """Compositing weights of this rank's contiguous (B, N_local) span of
    the samples: ``render.get_density`` of the whole row, at these
    columns."""
    sigma_delta = delta * sigma
    local_cumsum = torch.cumsum(sigma_delta, dim=1)
    carry = _exclusive_device_prefix_sum(local_cumsum[:, -1], group)
    transmittance = torch.exp(-(carry[:, None] + local_cumsum))
    return transmittance * (1.0 - torch.exp(-sigma_delta))


def sharded_composite(weights: torch.Tensor, color: torch.Tensor,
                      group: dist.Group = None) -> torch.Tensor:
    """``sum_i w_i rgb_i`` over every rank's span: (B, N_local), (B,
    N_local, 3) -> (B, 3) on every rank."""
    partial = torch.sum(weights[..., None] * color, dim=1)
    return dist.all_reduce(partial, "sum", group)


def _neighbor_first(t_first: torch.Tensor, group: dist.Group) -> torch.Tensor:
    """The next rank's first column (B, 1), for the successor of this span's
    last sample; the last rank gets float32's largest value."""
    n = dist.world_size(group)
    r = dist.rank(group)
    firsts = dist.all_gather(t_first, group) if n > 1 else None
    if r == n - 1:
        return torch.full_like(t_first, torch.finfo(t_first.dtype).max)
    return firsts[r + 1]


def sharded_merged_fine(t_co, t_fi_local, sigma_co, sigma_fi_local,
                        color_co, color_fi_local, tail: float = 1e-4,
                        white_bkgd: bool = False,
                        group: dist.Group = None) -> torch.Tensor:
    """The merged coarse + fine composite (``render.merged_composite``: a
    coarse sample first on ties, the globally last sample's delta
    ``tail``) with the fine samples spread over ``group``: each rank holds
    all coarse samples and its contiguous sorted span of the fine ones.
    Colors are (r, g, b) tuples of (B, N) planes. Returns (B, 3) on every
    rank.

    Each sample's successor is the nearest of its own list's next and the
    other list's first later one (a coarse sample's among every rank's
    fine samples: a MIN over the group); a fine sample's transmittance
    exponent is its own list's prefix (the group carry plus the local
    cumsum) plus the mass of the coarse samples before it, a coarse
    sample's the coarse prefix plus the fine mass before it (a SUM)."""
    big = torch.finfo(t_co.dtype).max
    # fewer[b, i, j]: local fine sample j lies strictly before coarse sample i
    fewer = t_fi_local[:, None, :] < t_co[:, :, None]          # (B, N_c, N_f_loc)
    inf_col = torch.full_like(t_co[:, :1], big)
    next_own_co = torch.cat([t_co[:, 1:], inf_col], dim=1)
    neighbor = _neighbor_first(t_fi_local[:, :1].contiguous(), group)
    next_own_fi = torch.cat([t_fi_local[:, 1:], neighbor], dim=1)

    cand_co = torch.where(fewer, big, t_fi_local[:, None, :]).amin(dim=2)
    dist.all_reduce(cand_co, "min", group)
    cand_fi = torch.where(fewer, t_co[:, :, None], big).amin(dim=1)
    next_co = torch.minimum(next_own_co, cand_co)
    next_fi = torch.minimum(next_own_fi, cand_fi)
    delta_co = torch.where(next_co >= big, tail, next_co - t_co)
    delta_fi = torch.where(next_fi >= big, tail, next_fi - t_fi_local)

    sd_co = sigma_co * delta_co
    sd_fi = sigma_fi_local * delta_fi
    own_co = torch.cumsum(sd_co, dim=1)
    local_cumsum_fi = torch.cumsum(sd_fi, dim=1)
    own_fi = _exclusive_device_prefix_sum(local_cumsum_fi[:, -1], group)[:, None] + local_cumsum_fi

    mask = fewer.to(sd_fi.dtype)
    cross_co = torch.sum(mask * sd_fi[:, None, :], dim=2)      # (B, N_c)
    dist.all_reduce(cross_co, "sum", group)
    cross_fi = torch.sum((1.0 - mask) * sd_co[:, :, None], dim=1)   # (B, N_f_loc)

    w_co = torch.exp(-(own_co + cross_co)) * (1.0 - torch.exp(-sd_co))
    w_fi = torch.exp(-(own_fi + cross_fi)) * (1.0 - torch.exp(-sd_fi))
    comp = lambda w, chans: torch.stack([torch.sum(w * c, dim=1) for c in chans], dim=-1)
    # the fine part and its opacity summed over the group, the coarse part once
    fine = torch.cat([comp(w_fi, color_fi_local), torch.sum(w_fi, dim=1)[:, None]], dim=1)
    dist.all_reduce(fine, "sum", group)
    out = comp(w_co, color_co) + fine[:, :3]
    if white_bkgd:
        out = out + (1.0 - (torch.sum(w_co, dim=1) + fine[:, 3]))[:, None]
    return out


def make_sample_sharded_render(mesh, k_inv: torch.Tensor, n_coarse: int, n_fine: int,
                               field_fn=None, white_bkgd: bool = False):
    """``(params, rows, cols, pose17) -> (C_coarse, C_fine)`` over a whole
    ray batch, on every rank of ``mesh`` (``parallel.mesh.Mesh``): the
    rays split over its data group and the N_f fine samples over its sample
    group, then gathered. Equal to single-rank ``render_rays`` with the
    two-list merge within float32 rounding; every rank's fine t's are the
    matching columns of the whole march bit for bit
    (``sampling.resample``'s level slice). ``field_fn`` is the main field
    (``render.field_plain`` by default; with ``eval_rays``, on the card,
    kernel 1: twice a call on each rank, at N_c and at N_f / n_sample)."""
    field_fn = field_fn or render.field_plain
    n_shards = mesh.n_sample
    if n_fine % n_shards != 0:
        raise ValueError(f"N_FINE={n_fine} must be a multiple of SAMPLE_SHARD={n_shards}")
    n_local = n_fine // n_shards

    def local_fn(params, rows, cols, pose17):
        origins, dirs, near, far = raylib.pixels_to_rays(rows, cols, pose17, k_inv)
        t_co = sampling.coarse_ts(near, far, n_coarse)
        color_co, sigma_co = render._eval_field(field_fn, params, origins, dirs, t_co)
        delta = ((far - near) / n_coarse)[:, None].expand(t_co.shape)
        dense_co = render.get_density(delta, sigma_co)
        c_coarse = render.composite(dense_co, color_co)
        if white_bkgd:
            c_coarse = c_coarse + (1.0 - torch.sum(dense_co, dim=1))[:, None]
        # this rank's contiguous slice of the N_f inverse-CDF levels
        t_fi = sampling.resample(t_co, dense_co, (far - near) / (n_coarse - 1), n_fine,
                                 level_start=mesh.sample_index * n_local,
                                 level_count=n_local)
        color_fi, sigma_fi = render._eval_field(field_fn, params, origins, dirs, t_fi)
        c_fine = sharded_merged_fine(t_co, t_fi, sigma_co, sigma_fi, color_co, color_fi,
                                     tail=render.TAIL_DELTA, white_bkgd=white_bkgd,
                                     group=mesh.sample)
        return c_coarse, c_fine

    return torch.no_grad()(sharded_render_chunk(local_fn, mesh))
