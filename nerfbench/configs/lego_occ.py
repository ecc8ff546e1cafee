"""Plain reference of the ``lego_occ`` configuration's field: the NeRF MLP
(Mildenhall et al., ECCV 2020, section 5.3 and appendix A), and the
seeded weights the benchmark hands to the program and to this reference.

An 8-layer, 256-wide ReLU trunk over the encoded point (L = 10, 60 inputs)
whose fifth layer also takes the encoding again (hidden first); sigma =
``|Linear(256, 1)|``; an unactivated ``Linear(256, 256)`` feature, joined
after the encoded direction (L = 4, 24 inputs, direction first), into
``ReLU(Linear(280, 128))`` and ``sigmoid(Linear(128, 3))``. 593,924
weights and biases, each layer's weight ``(fan_in, fan_out)``. ``q``
rounds each product's operands and each activation (``precision.py``).
The configuration's operation counts, which the ``mfu`` readers take,
are ``forward_flops_per_ray`` and ``refresh_flops``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from nerfbench import counts
from nerfbench.reference.render import encode

WIDTH, DEPTH, SKIP = 256, 8, 4
L_POINT, L_DIR = 10, 4
# the view branch: leaves whose gradient does not pass through sigma, and so
# not through the resampler's slope ``delta / (w + 1e-7)``, which turns a
# rounding of a coarse weight near zero into a large change of the trunk's
# and the sigma head's gradients (the check's ``grad_diff.view``)
LEAF_GROUPS = {"view": ("point_info/", "dir_info/", "color/")}
# added to the density output's bias: the field starts opaque inside the
# box, as one that has begun to fit a scene is. A fresh init's near-zero
# densities turn rounding into gradient errors that swing 10x from seed to
# seed, and render almost empty white frames whose pixels carry no signal
# for the check; the work of a step or a frame does not change.
SIGMA_BIAS = 2.0


def layer_dims() -> List[Tuple[str, int, int]]:
    p, d = 6 * L_POINT, 6 * L_DIR
    dims = [("trunk_0", p, WIDTH)]
    dims += [(f"trunk_{i}", WIDTH + (p if i == SKIP else 0), WIDTH) for i in range(1, DEPTH)]
    return dims + [("sigma", WIDTH, 1), ("point_info", WIDTH, WIDTH),
                   ("dir_info", WIDTH + d, WIDTH // 2), ("color", WIDTH // 2, 3)]


def init_mlp(generator: torch.Generator, dims, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``nn.Linear``'s default, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for
    every weight and bias, from one uniform draw on the device."""
    total = sum(i * o + o for _, i, o in dims)
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, fan_in, fan_out in dims:
        bound = fan_in ** -0.5
        w = u[at:at + fan_in * fan_out].view(fan_in, fan_out) * bound
        at += fan_in * fan_out
        b = u[at:at + fan_out] * bound
        at += fan_out
        out[name] = {"w": w.contiguous(), "b": b.contiguous()}
    return out


def init_params(ini: dict, generator: torch.Generator, device):
    """``init_mlp`` of the layers, the density output's bias raised by
    ``SIGMA_BIAS``."""
    params = init_mlp(generator, layer_dims(), device)
    params["sigma"]["b"] += SIGMA_BIAS
    return params


def forward_flops_per_ray(ini: dict) -> int:
    """A ray's forward products: one MLP for the coarse and the fine pass,
    each of the N_COARSE + N_FINE samples evaluated once (the fine pass
    reuses the coarse samples' outputs), ``counts.mlp_flops_per_sample``
    each."""
    return counts.mlp_flops_per_sample() * (ini["N_COARSE"] + ini["N_FINE"])


def refresh_flops(ini: dict) -> int:
    """One occupancy refresh: a forward probe of the MLP per drawn cell,
    ``OCC_RES**3 * OCC_SUBSET`` cells."""
    return max(1, int(ini["OCC_RES"] ** 3 * ini["OCC_SUBSET"])) * counts.mlp_flops_per_sample()


def mlp_field(params, q):
    def linear(name, x):
        return x @ q(params[name]["w"]) + params[name]["b"]

    def field(points, dirs):
        pe, de = q(encode(points, L_POINT)), q(encode(dirs, L_DIR))
        h = pe
        for i in range(DEPTH):
            if i == SKIP:
                h = torch.cat([h, pe], dim=-1)
            h = q(torch.relu(linear(f"trunk_{i}", h)))
        sigma = torch.abs(linear("sigma", h))[:, 0]
        feat = q(linear("point_info", h))
        h = q(torch.relu(linear("dir_info", torch.cat([de, feat], dim=-1))))
        return torch.sigmoid(linear("color", h)), sigma

    return field


def fields(params, ini: dict, q):
    """(the main field, the proposal field or None)."""
    return mlp_field(params, q), None


def param_loss(params, ini: dict):
    return None


def lr_scale(path: str, ini: dict) -> float:
    return 1.0
