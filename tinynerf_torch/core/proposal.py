"""The proposal MLP: a narrow network for the coarse pass only.

Counterpart of ``tinynerf/core/proposal.py`` (``PROPOSAL`` with ``PROP_FIELD
= mlp``): a ``depth`` x ``width`` ReLU trunk over the point encoding (no
skip), ``sigma = |Linear(width, 1)|`` and ``color = sigmoid(Linear(24 +
width, 3))`` over ``concat(dir_enc, h)``, the direction first. At the
defaults (width 128, depth 4, ``PROPOSAL_ENC_L`` 10) it has 57,932
parameters. ``PROPOSAL_ENC_L < 10`` keeps only the lowest point-encoding
bands (``3 * 2 * enc_l`` inputs); the direction encoding stays at 24.

Parameters are ``{layer: {"w": (fan_in, fan_out), "b": (fan_out,)}}`` with
layers ``trunk_0 .. trunk_{depth-1}``, ``sigma`` and ``color``, the JAX
package's layout: checkpoints and tests hand arrays across unchanged. A
proposal tree has ``sigma`` and ``color`` and no ``point_info``; its width,
depth and ``enc_l`` follow from its shapes (``dims``).

Two functions are called bf16 here, as for the main field:

- ``apply_proposal(..., precision="bf16")`` is the function the proposal
  kernels compute in their bf16 form (``PROP_PALLAS``,
  ``proposal_kernel.py:75-95``): the weights, the encodings and every ReLU
  output rounded to bfloat16; the sums, the biases, ``|sigma|`` and the
  sigmoid in float32;
- ``make_field_proposal(enc_l, "bf16")`` is the JAX package's bf16 network
  without the kernels (``make_field_proposal(compute_dtype=bfloat16)``): the
  float32 encodings cast to bfloat16, then the whole network in bfloat16
  tensors (weights, biases, every product's output), the outputs cast back.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from tinynerf_torch.core import encoding, mlp
from tinynerf_torch.core.encoding import DIR_ENC_DIM, L_POINT, POINT_ENC_DIM

WIDTH = 128
DEPTH = 4

Params = Dict[str, Dict[str, torch.Tensor]]


def layer_dims(width: int = WIDTH, depth: int = DEPTH,
               point_dim: int = POINT_ENC_DIM, dir_dim: int = DIR_ENC_DIM,
               ) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) for every linear layer, in forward order."""
    dims: List[Tuple[str, int, int]] = [("trunk_0", point_dim, width)]
    dims += [(f"trunk_{i}", width, width) for i in range(1, depth)]
    dims += [("sigma", width, 1), ("color", width + dir_dim, 3)]
    return dims


def init_proposal(generator: torch.Generator, width: int = WIDTH, depth: int = DEPTH,
                  enc_l: int = L_POINT,
                  device: torch.device = torch.device("cpu")) -> Params:
    """``nn.Linear``'s default init (``mlp.linear_init``) for every layer,
    drawn from ``generator``. The numbers differ from the JAX package's for
    the same seed; tests carry JAX weights across with
    ``ckpt.params_from_numpy``."""
    return {name: mlp.linear_init(generator, fan_in, fan_out, device)
            for name, fan_in, fan_out in layer_dims(width, depth, point_dim=3 * 2 * enc_l)}


def is_proposal(tree) -> bool:
    """True for a proposal MLP's tree (of tensors or arrays)."""
    return "sigma" in tree and "color" in tree and "point_info" not in tree


def dims(params) -> Tuple[int, int, int]:
    """``(width, depth, enc_l)`` from a proposal tree's shapes."""
    depth = sum(1 for k in params if k.startswith("trunk_"))
    fan_in, width = params["trunk_0"]["w"].shape
    return int(width), depth, int(fan_in) // 6


def check_config(params, width: int, depth: int, enc_l: int) -> None:
    """Refuse a proposal tree whose shapes disagree with ``PROPOSAL_WIDTH``,
    ``PROPOSAL_DEPTH`` or ``PROPOSAL_ENC_L``, naming the key."""
    got = dims(params)
    for key, have, want in zip(("PROPOSAL_WIDTH", "PROPOSAL_DEPTH", "PROPOSAL_ENC_L"),
                               got, (width, depth, enc_l)):
        if have != want:
            raise ValueError(f"the proposal MLP's shapes give {key} = {have}, the config "
                             f"sets {key} = {want}")


def forward_trunk(params: Params, point_enc: torch.Tensor, precision: str = "fp32",
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The trunk: ``(h, pre-activations of every layer)``, at ``precision``
    (``mlp.rounding``)."""
    value, act = mlp.rounding(precision)
    h, pres = value(point_enc), []
    for i in range(dims(params)[1]):
        pres.append(h @ value(params[f"trunk_{i}"]["w"]) + params[f"trunk_{i}"]["b"])
        h = act(torch.relu(pres[-1]))
    return h, pres


def apply_proposal(params: Params, point_enc: torch.Tensor, dir_enc: torch.Tensor,
                   precision: str = "fp32") -> Tuple[torch.Tensor, torch.Tensor]:
    """``point_enc (..., 6 enc_l)``, ``dir_enc (..., 24)`` -> ``(color (...,
    3), sigma (..., 1))``. ``precision="bf16"`` rounds as the kernels do
    (module docstring)."""
    if point_enc.is_cuda:
        mlp.check_no_tf32()
    value, _ = mlp.rounding(precision)
    h, _ = forward_trunk(params, point_enc, precision)
    linear = lambda name, x: x @ value(params[name]["w"]) + params[name]["b"]
    pre = linear("sigma", h)
    sigma = torch.where(pre >= 0, pre, -pre)   # |pre| with JAX's abs'(0) = +1
    color = torch.sigmoid(linear("color", torch.cat([value(dir_enc), h], dim=-1)))
    return color, sigma


def field_proposal(params: Params, points: torch.Tensor, dirs: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain field: points, dirs (..., 3) -> (color (..., 3), sigma (...,
    1)) at float32, with the full point encoding. Counterpart of
    ``field_proposal``."""
    return apply_proposal(params, encoding.encode_points(points), encoding.encode_dirs(dirs))


def make_field_proposal(enc_l: int = L_POINT, precision: str = "fp32"):
    """The plain field with ``enc_l`` point bands: ``field(params, points,
    dirs)``. At ``precision="bf16"`` it is the JAX package's bf16 network
    (module docstring), not the kernels' bf16 form."""
    mlp.rounding(precision)  # refuses an unknown precision

    def field(params: Params, points: torch.Tensor, dirs: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        pe = encoding.positional_encode(points, enc_l)
        de = encoding.encode_dirs(dirs)
        if precision == "fp32":
            return apply_proposal(params, pe, de)
        cast = {name: {k: t.to(torch.bfloat16) for k, t in layer.items()}
                for name, layer in params.items()}
        color, sigma = apply_proposal(cast, pe.to(torch.bfloat16), de.to(torch.bfloat16))
        return color.float(), sigma.float()

    return field
