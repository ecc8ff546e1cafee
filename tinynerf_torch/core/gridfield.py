"""Factorized feature-grid radiance field (CP decomposition): the point field.

Counterpart of ``tinynerf/core/gridfield.py`` (``FINE_FIELD = grid``, and the
proposal grid of ``PROP_FIELD = grid``). Three per-axis line tables, each
(R, Fd + Fa) with the density components first, are interpolated linearly at
a point's grid coordinate; the per-component product of the three gives
``sigma = |sum prod[:Fd]|`` and, with the encoded direction, the input of a
small decoder ``sigmoid(Linear(relu(Linear([dir_enc, prod[Fd:]]))))``.

The JAX package writes the interpolation as a hat-basis matmul, ``U @ T``
with ``U[b, i] = relu(1 - |xg_b - i|)``, because a TPU has no fast gather;
that is a free formulation (ROADMAP, "Same values"). Here it is the two-row
gather of the same values: the weights are ``relu(1 - |xg - idx|)`` in
float32 for ``idx = floor(xg)`` and ``floor(xg) + 1``, the upper row clamped
at ``R - 1``, where its weight is 0. The gradient keeps JAX's conventions:
``abs'(0) = +1``, ``relu'(0) = 0`` (an exact grid-node hit gives
``d xg = -dF . T[k]``), and ``clip = min(max(x, 0), 1)`` passes 1 inside,
0.5 at an exact boundary and 0 outside.

``precision="bf16"`` is the JAX package's ``compute_dtype=bfloat16`` jnp
function: the hat weights and the table rounded to bfloat16, the two-term
sum rounded, each CP product rounded, and the sigma sum, the decoder's
products and bias adds rounded as ``_linear`` rounds with bf16 operands; the
sigmoid is ``1 / (1 + exp(-x))`` with each step rounded, as XLA lowers it,
and its gradient JAX's rule for ``lax.logistic``, ``g * (ans * (1 - ans))``
with each product rounded (``sigmoid_bf16``), which stays finite where
``exp(-x)`` overflows. The fused kernels' bf16 form (``kernels/grid_kernel.py``) is
another function: it sums sigma and the decoder in float32.

``GRID_HYBRID`` (a ``sigma_net`` in the tree) computes sigma with a tiny
density MLP on the density product, ``sigma = |Linear(relu(Linear(prod[:Fd])))|``,
whose hidden features join the decoder's input after the appearance
product. ``GRID_LEVELS > 1`` adds zero-initialised level tables
``lines["{x,y,z}{l}"]`` of ``((R - 1) >> l) + 1`` rows, each interpolated at
its own resolution and summed into the axis feature; ``GRID_LEVEL_FOLD``
instead folds each level into the level-0 table in float32
(``table + upsample_matrix @ level``) and interpolates once.

``lookup="gather"`` (``GRID_LOOKUP = gather``) is the JAX package's other
lookup, a function of its own: ``f0 * (1 - frac) + f1 * frac`` with the same
taps, ``frac = xg - floor(xg)``. At bf16, XLA on the CPU rounds each step to
bfloat16 (``frac``, ``1 - frac``, both products and their sum; the table is
rounded first), and so does the port. ``floor`` is constant, so ``frac``'s
gradient reaches ``xg`` with slope 1, at an exact node too (there ``d xg =
dF . (T[k + 1] - T[k])``, and 0 at ``R - 1``, whose two taps are one row);
no hat convention enters. Each product's cotangent to a tap row and to its
weight is rounded to bfloat16, as JAX's transpose of the bf16 product rounds
it, so the two weights' cotangents cancel exactly at ``R - 1``, as JAX's do.
Any other ``lookup`` is the hat form, as in the JAX package.

``upsample_lines`` resamples the level-0 tables onto a finer lattice
(``GRID_UPSAMPLE``) with ``upsample_matrix`` in true float32.

The two taps' gathers are one ``_TapRows``, whose backward sums each table
row's cotangents in an order fixed by the data (``segment_sums`` over the
taps sorted stably by row), where ``index_select``'s ``index_add_`` would
add them with atomics in whatever order the card runs them: two steps from
one state then give the same gradient bit for bit, on the card and on the
CPU alike. The sums are float32, rounded once to bfloat16 at bf16 (the
table's rounding). Both lookups take that order. JAX's transpose of
``jnp.take`` is a bf16 scatter-add whose order XLA leaves open; on the CPU
it adds the taps one after another in bfloat16, rounding after each, so a
row that takes many taps stalls (1,000 taps of 1.0 sum to 256 there, to
1,000 here), while with few taps a row the two orders nearly agree.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from tinynerf_torch import optim
from tinynerf_torch.core import encoding, mlp
from tinynerf_torch.core.encoding import DIR_ENC_DIM

RES = 256             # line resolution R (cells per axis)
N_COMP_DENSITY = 32   # CP components for density
N_COMP_APP = 48       # CP components for appearance
DECODER_WIDTH = 64
EXTENT = 1.5          # grid half-extent in world units
INIT_SCALE = 0.2      # line init stddev

AXES = ("x", "y", "z")
PRECISIONS = ("fp32", "bf16")

Params = Dict[str, Any]


def level_res(res: int, level: int) -> int:
    """Rows of a pyramid level's table: the intervals halved ``level``
    times, ``((res - 1) >> level) + 1`` (at least 2), so that an odd ``res``
    nests exactly (385 -> 193)."""
    return max(2, ((res - 1) >> level) + 1)


def init_grid_field(generator: torch.Generator, res: int = RES,
                    n_density: int = N_COMP_DENSITY, n_app: int = N_COMP_APP,
                    decoder_width: int = DECODER_WIDTH, extent: float = EXTENT,
                    init_scale: float = INIT_SCALE, hybrid: bool = False,
                    sigma_width: int = 0, levels: int = 1,
                    device: torch.device = torch.device("cpu")) -> Params:
    """``{"lines": {x, y, z: (res, n_density + n_app)}, "decoder": {"hidden":
    (24 + n_app, width), "color": (width, 3)}, "extent": 0-d}``: lines
    ``init_scale * N(0, 1)``, the decoder ``nn.Linear``'s uniform, drawn on
    the CPU from ``generator`` and moved to ``device``. The numbers differ
    from the JAX package's for the same seed; tests carry JAX weights across
    with ``ckpt.params_from_numpy``. ``extent`` is frozen geometry: it gets a
    zero gradient, so Adam leaves it as it is.

    ``levels > 1`` adds the zero tables ``lines["{x,y,z}{l}"]``
    (``level_res`` rows). ``hybrid`` adds ``sigma_net = {"hidden":
    (n_density, sw), "sigma": (sw, 1)}``, ``sw = sigma_width or
    decoder_width``, and widens the decoder's input to ``24 + n_app + sw``."""
    n_comp = n_density + n_app
    lines = {ax: init_scale * torch.randn((res, n_comp), generator=generator)
             for ax in AXES}
    for lvl in range(1, levels):
        for ax in AXES:
            lines[f"{ax}{lvl}"] = torch.zeros((level_res(res, lvl), n_comp))
    sw = sigma_width or decoder_width
    dec_in = DIR_ENC_DIM + n_app + (sw if hybrid else 0)
    decoder = {"hidden": mlp.linear_init(generator, dec_in, decoder_width),
               "color": mlp.linear_init(generator, decoder_width, 3)}
    params = {"lines": lines, "decoder": decoder,
              "extent": torch.tensor(extent, dtype=torch.float32)}
    if hybrid:
        params["sigma_net"] = {"hidden": mlp.linear_init(generator, n_density, sw),
                               "sigma": mlp.linear_init(generator, sw, 1)}
    return optim.tree_map(lambda t: t.to(device), params)


def num_params(params: Params) -> int:
    return sum(int(t.numel()) for t in optim.leaves(params))


def num_levels(lines: Dict[str, Any]) -> int:
    """The pyramid's level count from the table names, as the JAX package
    reads it on resume: one more than the highest level index."""
    return 1 + max((int(k[1:]) for k in lines if len(k) > 1), default=0)


def check_params(params: Params) -> int:
    """The level count of a grid field's tree (of tensors or, from a
    checkpoint, of arrays); ``ValueError`` unless its tables are exactly
    ``x, y, z`` and ``{x,y,z}{l}`` for every level ``l`` below it."""
    n_levels = num_levels(params["lines"])
    want = {f"{ax}{lvl or ''}" for lvl in range(n_levels) for ax in AXES}
    if set(params["lines"]) != want:
        raise ValueError(f"grid line tables {sorted(params['lines'])} are not "
                         f"{sorted(want)}")
    return n_levels


def _identity(x):
    return x


class _SigmoidBF16(torch.autograd.Function):
    """``jax.nn.sigmoid`` of bf16 values: the forward ``1 / (1 + exp(-x))``
    with each step rounded to bf16, as XLA lowers ``lax.logistic``; the
    backward JAX's rule for it, ``g * (ans * (1 - ans))``, each operation
    rounded to bf16. Autograd through the forward's steps instead multiplies
    ``1 / (1 + e)^2 = 0`` by ``e = exp(-x) = inf`` where ``x < -88.7``:
    a NaN gradient."""

    @staticmethod
    def forward(ctx, x):
        rnd = mlp.round_bf16
        ans = rnd(1.0 / rnd(1.0 + rnd(torch.exp(-x))))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        rnd = mlp.round_bf16
        return rnd(rnd(g) * rnd(ans * rnd(1.0 - ans)))


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """The bf16 sigmoid of the grid's decoder (``_SigmoidBF16``)."""
    return _SigmoidBF16.apply(x)


def rounding(precision: str):
    """The identity at fp32; ``mlp.round_bf16`` (value and gradient) at bf16."""
    if precision == "fp32":
        return _identity
    if precision == "bf16":
        return mlp.round_bf16
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def unit_coords(points: torch.Tensor, extent: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> ``(clip(raw, 0, 1), raw)``, ``raw = (p + E) / 2E`` (a
    true division), float32. The clip is ``min(max(raw, 0), 1)``, whose
    gradient is 0.5 at an exact boundary, as ``jnp.clip``'s. ``extent`` is
    detached (frozen geometry)."""
    ext = extent.detach()
    raw = (points + ext) / (2.0 * ext)
    return torch.minimum(torch.maximum(raw, raw.new_zeros(())), raw.new_ones(())), raw


def grid_coords(points: torch.Tensor, extent: torch.Tensor, res: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> ``(xg, raw)``: ``xg = clip(raw, 0, 1) * (res - 1)``
    (``unit_coords``)."""
    clipped, raw = unit_coords(points, extent)
    return clipped * (res - 1), raw


def _hat(xg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``relu(1 - |xg - idx|)`` with ``abs'(0) = +1`` (``lax.abs``'s JVP) and
    ``relu'(0) = 0``."""
    diff = xg - idx
    return torch.relu(1.0 - torch.where(diff >= 0, diff, -diff))


def lerp_taps(xg: torch.Tensor, res: int):
    """The two interpolation taps of grid coordinates ``xg`` in [0, res - 1]:
    ``(i0, i1, w0, w1)``, ``i0 = floor(xg)``, ``i1 = min(i0 + 1, res - 1)``
    (int64), and the hat weights at ``i0`` and ``i0 + 1`` (float32; 0 for
    the clamped upper tap, whose hat is ``relu(1 - 1)``)."""
    lower = torch.floor(xg).detach()
    i0 = lower.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=res - 1)
    return i0, i1, _hat(xg, lower), _hat(xg, lower + 1.0)


def upsample_matrix(old_res: int, new_res: int,
                    device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(new_res, old_res) float32: row ``j`` holds the hat weights
    ``relu(1 - |x_j - i|)`` of new node ``j`` at ``x_j`` on the old lattice,
    ``jnp.linspace(0, old_res - 1, new_res)`` bit for bit. XLA folds that
    linspace's constants into ``j * f32(stop * f32(1 / (new_res - 1)))``,
    with the last node ``stop`` itself, so the nodes are computed so here."""
    stop = np.float32(old_res - 1)
    step = np.float32(stop * (np.float32(1.0) / np.float32(new_res - 1)))
    nodes = torch.arange(new_res, dtype=torch.float32, device=device) * float(step)
    # a fill, not a store from host memory, so that a CUDA graph captures it
    nodes = torch.cat([nodes[:-1], torch.full((1,), float(stop), device=device)])
    idx = torch.arange(old_res, dtype=torch.float32, device=device)
    return torch.relu(1.0 - torch.abs(nodes[:, None] - idx[None, :]))


# rows a block of ``segment_sums``' pyramid
SUM_BLOCK = 32


def segment_sums(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                 block: int = SUM_BLOCK) -> torch.Tensor:
    """(K, F): segment k's sum of the rows ``x[order[p]]`` over positions
    ``starts[k] <= p < starts[k + 1]`` (``starts`` nondecreasing, from 0 to
    M, K + 1 of them; ``x`` (M, F), ``order`` (M,)).

    Each sum has an order fixed by the positions, whatever the card's
    schedule: the rows in order are summed in blocks of ``block``, the
    block sums in blocks, and so on up to a level of at most ``block``
    entries (a pyramid); a segment then adds, at each level, the part
    blocks at its two ends whose next level holds no whole block of it,
    and at the top what is left. Every sum is short, so no running total
    over the whole array loses the small segments' precision, and no shape
    depends on the data, so that a CUDA graph can hold it."""
    m, width = x.shape
    n_seg = starts.shape[0] - 1
    if m == 0:
        return x.new_zeros((n_seg, width))
    device = x.device
    lengths = [m]
    while lengths[-1] > block:
        lengths.append(-(-lengths[-1] // block))
    top = len(lengths) - 1
    # the pyramid's levels 1..top, one after another in one buffer
    levels = []
    if top:
        levels.append(torch.nn.functional.embedding_bag(
            order, x, torch.arange(0, m, block, device=device), mode="sum"))
        for n in lengths[2:]:
            below = levels[-1]
            pad = n * block - below.shape[0]
            if pad:
                below = torch.cat([below, below.new_zeros((pad, width))])
            levels.append(below.view(n, block, width).sum(dim=1))
    # the levels' block sizes S^l and lengths ceil(M / S^l), made on the
    # device (a capture takes no copy from host memory)
    level = torch.arange(top + 1, device=device)
    scale = torch.full_like(level, block).pow(level)[:, None]
    length = (m + scale - 1) // scale
    # each level's window starts and ends, (levels, 2 ends, K): the
    # segment's span at level l is [ceil(a / S^l), max(floor(b / S^l), that))
    a, b = starts[None, :-1], starts[None, 1:]
    lo = (a + scale - 1) // scale
    hi = torch.maximum(b // scale, lo)
    lo_up = (lo + block - 1) // block * block
    hi_dn = hi // block * block
    is_top = (level == top)[:, None]
    head_hi = torch.where(is_top, hi, torch.minimum(lo_up, hi))
    tail_lo = torch.where(is_top, hi, torch.maximum(hi_dn, lo_up))
    starts_w = torch.stack([lo, tail_lo], dim=1)
    ends_w = torch.stack([head_hi, hi], dim=1)
    span = torch.arange(block, device=device)
    pos = starts_w[..., None] + span                                  # (L, 2, K, S)
    inside = (pos < ends_w[..., None])[..., None]
    pos = torch.minimum(pos, length[..., None, None] - 1)
    vals = [x.index_select(0, order.index_select(0, pos[0].reshape(-1)))]
    if top:
        # level l's rows start at the lengths of levels 1..l-1 in the buffer
        above = length[1:]
        offset = (torch.cumsum(above, dim=0) - above)[..., None, None]
        vals.append(torch.cat(levels).index_select(0, (pos[1:] + offset).reshape(-1)))
    vals = torch.cat(vals).view(*pos.shape, width)
    return torch.where(inside, vals, 0.0).sum(dim=3).sum(dim=(0, 1))


class _TapRows(torch.autograd.Function):
    """The rows ``table[i0]`` and ``table[i1]``, ``i1 = min(i0 + 1, R - 1)``,
    of a (R, F) table at flat (M,) tap indices ``i0``. The backward sorts
    ``i0`` stably once and sums each row's cotangents with
    ``segment_sums``: the upper tap's by ``i0`` too, moved up a row (``i1``
    is ``i0 + 1`` but at ``R - 1``, whose row takes both)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, i0: torch.Tensor):
        res = table.shape[0]
        i1 = torch.clamp(i0 + 1, max=res - 1)
        ctx.save_for_backward(i0)
        ctx.res = res
        return table.index_select(0, i0), table.index_select(0, i1)

    @staticmethod
    def backward(ctx, g0: torch.Tensor, g1: torch.Tensor):
        (i0,) = ctx.saved_tensors
        res = ctx.res
        sorted_i0, order = torch.sort(i0, stable=True)
        starts = torch.searchsorted(sorted_i0, torch.arange(res + 1, device=i0.device))
        lower = segment_sums(g0, order, starts)
        upper = segment_sums(g1, order, starts)
        d_table = lower.clone()
        d_table[1:] += upper[:-1]
        d_table[-1] += upper[-1]
        return d_table, None


def _tap_rows(table: torch.Tensor, i0: torch.Tensor):
    """``_TapRows`` of the table (R, F) at tap indices ``i0`` (...): the rows
    at ``i0`` and ``min(i0 + 1, R - 1)``, each (..., F)."""
    return tuple(r.reshape(*i0.shape, table.shape[1])
                 for r in _TapRows.apply(table, i0.reshape(-1)))


def _interp(table: torch.Tensor, coord: torch.Tensor, rnd,
            lookup: str = "onehot") -> torch.Tensor:
    """The table (R, F) interpolated at clipped coordinates ``coord`` in
    [0, 1] (...): the two taps at ``xg = coord * (R - 1)``, (..., F); with
    ``lookup="gather"`` the JAX package's gather form, else the hat form."""
    table = rnd(table)
    res = table.shape[0]
    xg = coord * (res - 1)
    if lookup == "gather":
        lower = torch.floor(xg).detach()
        frac = rnd(xg - lower)[..., None]
        rows0, rows1 = _tap_rows(table, lower.to(torch.int64))
        return rnd(rnd(rnd(rows0) * rnd(1.0 - frac)) + rnd(rnd(rows1) * rnd(frac)))
    i0, _, w0, w1 = lerp_taps(xg, res)
    rows0, rows1 = _tap_rows(table, i0)
    return rnd(rnd(w0)[..., None] * rows0 + rnd(w1)[..., None] * rows1)


def _line_features(lines: Dict[str, torch.Tensor], points: torch.Tensor,
                   extent: torch.Tensor, rnd, fold: bool = False,
                   lookup: str = "onehot") -> Tuple[torch.Tensor, ...]:
    """points (..., 3) -> the three interpolated line features (..., F), by
    ``lookup`` (``_interp``).
    Level tables (``GRID_LEVELS``) are interpolated at their own resolution
    and summed into the axis feature, each sum rounded at bf16; with
    ``fold`` they are first folded into the level-0 table in float32
    (``table + upsample_matrix @ level``), which is interpolated once."""
    n_levels = num_levels(lines)
    feats = []
    for a, ax in enumerate(AXES):
        coord, _ = unit_coords(points[..., a], extent)
        levels = [lines[f"{ax}{lvl or ''}"] for lvl in range(n_levels)]
        if fold:
            table = levels[0]
            for tl in levels[1:]:
                table = table + upsample_matrix(tl.shape[0], table.shape[0],
                                                tl.device) @ tl
            feats.append(_interp(table, coord, rnd, lookup))
            continue
        f = _interp(levels[0], coord, rnd, lookup)
        for tl in levels[1:]:
            f = rnd(f + _interp(tl, coord, rnd, lookup))
        feats.append(f)
    return tuple(feats)


def apply_grid_field(params: Params, points: torch.Tensor, dirs: torch.Tensor,
                     n_density: int = N_COMP_DENSITY, precision: str = "fp32",
                     fold: bool = False, lookup: str = "onehot",
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The point field: points, dirs (..., 3) -> (color (..., 3), sigma
    (..., 1)), float32. Counterpart of ``apply_grid_field``, ``lookup``
    ``"gather"`` or the hat form, differentiable in every table, the
    decoder, the sigma net and the points. With a ``sigma_net``
    (``GRID_HYBRID``) sigma is the density MLP's and the decoder reads
    ``[dir_enc, app, hs]``."""
    rnd = rounding(precision)
    if points.is_cuda:
        mlp.check_no_tf32()
    fx, fy, fz = _line_features(params["lines"], points, params["extent"], rnd, fold,
                                lookup)
    prod = rnd(rnd(fx * fy) * fz)
    dens, app = prod[..., :n_density], prod[..., n_density:]
    de = rnd(encoding.encode_dirs(dirs))
    linear = lambda p, x: rnd(rnd(x @ rnd(p["w"])) + rnd(p["b"]))
    if "sigma_net" in params:
        hs = torch.relu(linear(params["sigma_net"]["hidden"], dens))
        sigma = torch.abs(linear(params["sigma_net"]["sigma"], hs))
        color_in = torch.cat([de, app, hs], dim=-1)
    else:
        sigma = torch.abs(rnd(torch.sum(dens, dim=-1, keepdim=True)))
        color_in = torch.cat([de, app], dim=-1)
    dec = params["decoder"]
    h = torch.relu(linear(dec["hidden"], color_in))
    x = linear(dec["color"], h)
    color = torch.sigmoid(x) if precision == "fp32" else sigmoid_bf16(x)
    return color, sigma


def make_field_grid(n_density: int = N_COMP_DENSITY, lookup: str = "onehot",
                    precision: str = "fp32", fold: bool = False):
    """FieldFn factory (``field(params, points, dirs)``), the counterpart of
    ``make_field_grid``: ``lookup="gather"`` the gather form, any other
    string the hat form, as the JAX package reads it."""
    rounding(precision)

    def field(params: Params, points: torch.Tensor, dirs: torch.Tensor):
        return apply_grid_field(params, points, dirs, n_density=n_density,
                                precision=precision, fold=fold, lookup=lookup)

    return field


def upsample_lines(params: Params, new_res: int) -> Params:
    """The counterpart of ``upsample_lines``: each level-0 table (R, F)
    resampled to (``new_res``, F) by ``upsample_matrix`` in true float32; the
    decoder, the extent and any other leaf passed through as they are. Works
    on any tree of the grid field's layout, Adam's moment trees included.
    A pyramid (``GRID_LEVELS > 1``) raises the JAX package's ``ValueError``:
    resampling each level would change their relative bandwidths."""
    if any(k not in AXES for k in params["lines"]):
        raise ValueError("GRID_UPSAMPLE is incompatible with GRID_LEVELS>1 "
                         "(multi-resolution pyramid)")
    old_res = params["lines"][AXES[0]].shape[0]
    if new_res == old_res:
        return params
    out = dict(params)
    out["lines"] = {}
    for ax in AXES:
        table = params["lines"][ax]
        w = upsample_matrix(old_res, new_res, table.device)
        if table.is_cuda:
            mlp.check_no_tf32()
        out["lines"][ax] = w @ table
    return out


def tv_loss(params: Params) -> torch.Tensor:
    """Total variation of the line tables: the mean squared difference of
    adjacent rows, summed over the tables in sorted name order."""
    total = None
    for name in sorted(params["lines"]):
        t = params["lines"][name]
        term = torch.mean(torch.square(t[1:] - t[:-1]))
        total = term if total is None else total + term
    return total
