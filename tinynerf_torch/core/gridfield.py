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
sigmoid is ``1 / (1 + exp(-x))`` with each step rounded, as XLA lowers it. The fused kernels' bf16 form (``kernels/grid_kernel.py``) is
another function: it sums sigma and the decoder in float32.

Not ported yet, refused by name: ``GRID_HYBRID`` (the ``sigma_net``),
``GRID_LEVELS > 1`` and ``GRID_LEVEL_FOLD`` (ROADMAP queue 1, the flagship),
``GRID_LOOKUP = gather`` and ``upsample_lines`` (queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {where})")


def init_grid_field(generator: torch.Generator, res: int = RES,
                    n_density: int = N_COMP_DENSITY, n_app: int = N_COMP_APP,
                    decoder_width: int = DECODER_WIDTH, extent: float = EXTENT,
                    init_scale: float = INIT_SCALE, hybrid: bool = False,
                    levels: int = 1,
                    device: torch.device = torch.device("cpu")) -> Params:
    """``{"lines": {x, y, z: (res, n_density + n_app)}, "decoder": {"hidden":
    (24 + n_app, width), "color": (width, 3)}, "extent": 0-d}``: lines
    ``init_scale * N(0, 1)``, the decoder ``nn.Linear``'s uniform, drawn on
    the CPU from ``generator`` and moved to ``device``. The numbers differ
    from the JAX package's for the same seed; tests carry JAX weights across
    with ``ckpt.params_from_numpy``. ``extent`` is frozen geometry: it gets a
    zero gradient, so Adam leaves it as it is."""
    if hybrid:
        raise not_ported("GRID_HYBRID (the sigma net)", "queue 1, items 3-4: the flagship")
    if levels > 1:
        raise not_ported(f"GRID_LEVELS={levels}", "queue 1, items 3-4: the flagship")
    n_comp = n_density + n_app
    lines = {ax: init_scale * torch.randn((res, n_comp), generator=generator)
             for ax in AXES}
    decoder = {"hidden": mlp.linear_init(generator, DIR_ENC_DIM + n_app, decoder_width),
               "color": mlp.linear_init(generator, decoder_width, 3)}
    params = {"lines": lines, "decoder": decoder,
              "extent": torch.tensor(extent, dtype=torch.float32)}
    return optim.tree_map(lambda t: t.to(device), params)


def num_params(params: Params) -> int:
    return sum(int(t.numel()) for t in optim.leaves(params))


def check_params(params: Params) -> None:
    """Refuse, by name, the grid forms the port has no field for yet (on a
    tree of tensors or, from a checkpoint, of arrays)."""
    if "sigma_net" in params:
        raise not_ported("GRID_HYBRID (the sigma net)", "queue 1, items 3-4: the flagship")
    extra = sorted(set(params["lines"]) - set(AXES))
    if extra:
        raise not_ported(f"GRID_LEVELS > 1 (level tables {extra})",
                         "queue 1, items 3-4: the flagship")


def _identity(x):
    return x


def rounding(precision: str):
    """The identity at fp32; ``mlp.round_bf16`` (value and gradient) at bf16."""
    if precision == "fp32":
        return _identity
    if precision == "bf16":
        return mlp.round_bf16
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def grid_coords(points: torch.Tensor, extent: torch.Tensor, res: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> ``(xg, raw)``: ``raw = (p + E) / 2E`` (a true division)
    and ``xg = clip(raw, 0, 1) * (res - 1)``, float32. The clip is
    ``min(max(raw, 0), 1)``, whose gradient is 0.5 at an exact boundary, as
    ``jnp.clip``'s. ``extent`` is detached (frozen geometry)."""
    ext = extent.detach()
    raw = (points + ext) / (2.0 * ext)
    clipped = torch.minimum(torch.maximum(raw, raw.new_zeros(())), raw.new_ones(()))
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


def _line_features(lines: Dict[str, torch.Tensor], points: torch.Tensor,
                   extent: torch.Tensor, rnd) -> Tuple[torch.Tensor, ...]:
    """points (..., 3) -> the three interpolated line features (..., F)."""
    feats = []
    for a, ax in enumerate(AXES):
        table = rnd(lines[ax])
        res = table.shape[0]
        xg, _ = grid_coords(points[..., a], extent, res)
        i0, i1, w0, w1 = lerp_taps(xg, res)
        rows = lambda i: torch.index_select(table, 0, i.reshape(-1)).reshape(
            *i.shape, table.shape[1])
        feats.append(rnd(rnd(w0)[..., None] * rows(i0) + rnd(w1)[..., None] * rows(i1)))
    return tuple(feats)


def apply_grid_field(params: Params, points: torch.Tensor, dirs: torch.Tensor,
                     n_density: int = N_COMP_DENSITY, precision: str = "fp32",
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The point field: points, dirs (..., 3) -> (color (..., 3), sigma
    (..., 1)), float32. Counterpart of ``apply_grid_field`` with
    ``lookup="onehot"``, differentiable in the lines, the decoder and the
    points."""
    check_params(params)
    rnd = rounding(precision)
    if points.is_cuda:
        mlp.check_no_tf32()
    fx, fy, fz = _line_features(params["lines"], points, params["extent"], rnd)
    prod = rnd(rnd(fx * fy) * fz)
    sigma = torch.abs(rnd(torch.sum(prod[..., :n_density], dim=-1, keepdim=True)))
    de = rnd(encoding.encode_dirs(dirs))
    linear = lambda p, x: rnd(rnd(x @ rnd(p["w"])) + rnd(p["b"]))
    dec = params["decoder"]
    h = torch.relu(linear(dec["hidden"], torch.cat([de, prod[..., n_density:]], dim=-1)))
    x = linear(dec["color"], h)
    # bf16: jax.nn.sigmoid lowers to 1 / (1 + exp(-x)), each step in bf16
    color = torch.sigmoid(x) if precision == "fp32" else rnd(1.0 / rnd(1.0 + rnd(torch.exp(-x))))
    return color, sigma


def make_field_grid(n_density: int = N_COMP_DENSITY, lookup: str = "onehot",
                    precision: str = "fp32", fold: bool = False):
    """FieldFn factory (``field(params, points, dirs)``), the counterpart of
    ``make_field_grid``."""
    if lookup != "onehot":
        raise not_ported(f"GRID_LOOKUP={lookup}", "queue 1, item 14: GRID_LOOKUP = gather")
    if fold:
        raise not_ported("GRID_LEVEL_FOLD", "queue 1, items 3-4: the flagship")
    rounding(precision)

    def field(params: Params, points: torch.Tensor, dirs: torch.Tensor):
        return apply_grid_field(params, points, dirs, n_density=n_density,
                                precision=precision)

    return field


def tv_loss(params: Params) -> torch.Tensor:
    """Total variation of the line tables: the mean squared difference of
    adjacent rows, summed over the tables in sorted name order."""
    total = None
    for name in sorted(params["lines"]):
        t = params["lines"][name]
        term = torch.mean(torch.square(t[1:] - t[:-1]))
        total = term if total is None else total + term
    return total
