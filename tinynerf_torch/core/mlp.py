"""The radiance-field MLP: init and apply over a dict of parameter tensors.

Counterpart of ``tinynerf/core/mlp.py``: an 8-layer, width-256 trunk with an
input re-concat skip at layer 4 (hidden first, ``Linear(316, 256)``), a sigma
head ``Linear(256, 1)`` with **abs** activation, an unactivated
``point_info = Linear(256, 256)``, a view branch ``Linear(280, 128) + ReLU``
over ``concat(dir_enc, point_info)`` (dir first) and
``color = Linear(128, 3) + Sigmoid``. One network serves both passes.

Parameters are ``{layer: {"w": (fan_in, fan_out), "b": (fan_out,)}}``: the
JAX package's ``(in, out)`` layout, so checkpoints and the tests hand arrays
across unchanged. 593,924 parameters in all.

Matrix products run in true float32: ``apply_network`` refuses to run on the
card while TF32 is allowed (``check_no_tf32``). ``precision="bf16"`` gives the
function the field kernels compute in their bf16 form (the JAX package's
``PRECISION=bf16`` with ``USE_PALLAS``): float32 products of values rounded to
bfloat16 where the TPU kernel casts them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from tinynerf_torch.core.encoding import DIR_ENC_DIM, POINT_ENC_DIM

DEPTH = 8
WIDTH = 256
SKIP_LAYERS = (4,)

Params = Dict[str, Dict[str, torch.Tensor]]


def layer_dims(point_dim: int = POINT_ENC_DIM, dir_dim: int = DIR_ENC_DIM,
               depth: int = DEPTH, width: int = WIDTH,
               skip_layers: Tuple[int, ...] = SKIP_LAYERS,
               ) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) for every linear layer, in forward order."""
    dims: List[Tuple[str, int, int]] = [("trunk_0", point_dim, width)]
    for i in range(1, depth):
        fan_in = width + point_dim if i in skip_layers else width
        dims.append((f"trunk_{i}", fan_in, width))
    dims += [
        ("sigma", width, 1),
        ("point_info", width, width),
        ("dir_info", width + dir_dim, width // 2),
        ("color", width // 2, 3),
    ]
    return dims


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """``nn.Linear``'s default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
    and bias, in the ``(in, out)`` layout, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device), then
    moved to ``device``."""
    bound = 1.0 / float(fan_in) ** 0.5
    w = (torch.rand((fan_in, fan_out), generator=generator) * 2 - 1) * bound
    b = (torch.rand((fan_out,), generator=generator) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def init_network(generator: torch.Generator,
                 device: torch.device = torch.device("cpu")) -> Params:
    """PyTorch ``nn.Linear`` default init (``linear_init``) for every layer.
    The numbers differ from the JAX package's init for the same seed; tests
    carry JAX weights across with ``ckpt.params_from_numpy``."""
    return {name: linear_init(generator, fan_in, fan_out, device)
            for name, fan_in, fan_out in layer_dims()}


def num_params(params: Params) -> int:
    return sum(int(t.numel()) for layer in params.values() for t in layer.values())


def check_no_tf32() -> None:
    """Raise if a float32 product on the card could run in TF32 (about three
    decimal digits): the field must be true f32, as the JAX package pins it."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); the field needs true float32")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16 (ties to even), kept float32;
    its gradient is rounded the same way (an activation's cast)."""
    return x.to(torch.bfloat16).float()


def round_bf16_value(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16, kept float32; its gradient
    passes unrounded (a weight's or an encoding's cast: their gradients stay
    float32 in the TPU kernels)."""
    return x + (round_bf16(x) - x).detach()


def rounding(precision: str):
    """(value rounding, activation rounding) for ``precision``: the
    identity at fp32, ``round_bf16_value`` and ``round_bf16`` at bf16."""
    if precision == "fp32":
        return (lambda x: x), (lambda x: x)
    if precision == "bf16":
        return round_bf16_value, round_bf16
    raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")


def apply_network(params: Params, point_enc: torch.Tensor,
                  dir_enc: torch.Tensor, precision: str = "fp32",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``point_enc (..., 60)``, ``dir_enc (..., 24)`` ->
    ``(color (..., 3), sigma (..., 1))``. With ``precision="bf16"`` the
    weights and the encodings are rounded to bfloat16, and so is every
    ReLU output and ``point_info`` (``mlp_kernel.py::_forward_tile``);
    biases, sums, ``|sigma|`` and the sigmoid stay float32."""
    if point_enc.is_cuda:
        check_no_tf32()
    value, act = rounding(precision)
    linear = lambda name, x: x @ value(params[name]["w"]) + params[name]["b"]
    point_enc, dir_enc = value(point_enc), value(dir_enc)
    h = point_enc
    for i in range(DEPTH):
        if i in SKIP_LAYERS:
            h = torch.cat([h, point_enc], dim=-1)          # hidden first
        h = act(torch.relu(linear(f"trunk_{i}", h)))
    sigma = torch.abs(linear("sigma", h))
    point_info = act(linear("point_info", h))              # no activation
    color_in = torch.cat([dir_enc, point_info], dim=-1)    # dir first
    h_dir = act(torch.relu(linear("dir_info", color_in)))
    color = torch.sigmoid(linear("color", h_dir))
    return color, sigma


class _Linear(nn.Module):
    """One layer's weight ``(fan_in, fan_out)`` and bias, the JAX layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class RadianceField(nn.Module):
    """The network as an ``nn.Module``: ``forward(point_enc, dir_enc)``.
    ``params()`` gives the plain dict that ``apply_network`` and the field
    kernel take."""

    def __init__(self, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("RadianceField needs params or a generator")
            params = init_network(generator)
        self.layers = nn.ModuleDict(
            {name: _Linear(params[name]["w"], params[name]["b"])
             for name, _, _ in layer_dims()})

    def params(self) -> Params:
        return {name: {"w": layer.w, "b": layer.b}
                for name, layer in self.layers.items()}

    def forward(self, point_enc: torch.Tensor, dir_enc: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply_network(self.params(), point_enc, dir_enc)
