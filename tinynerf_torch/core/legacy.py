"""The retired field of the reference's shipped checkpoints, and their loader.

Counterpart of ``tinynerf/core/legacy.py``. The reference ships seven trained
artifacts (``checkpoint/0-6``, 543,052 params each) from an older revision
of its model class: a 9-linear trunk with no skip and the color head on the
trunk's output. Neither the reference's current class nor the 593,924-param
network (``core/mlp.py``) loads them, so this module keeps that
architecture:

- trunk: ``Linear(60, 256) + ReLU``, seven ``Linear(256, 256) + ReLU``, and
  ``Linear(256, 256)`` with no activation after it;
- sigma head: ``Linear(256, 1) + Sigmoid``;
- color head: ``Linear(24 + 256, 3) + Sigmoid`` on ``concat(enc_dir,
  trunk)``, direction first;
- the port's own positional encoding (``core/encoding.py``).

Parameters are ``{"trunk_0".."trunk_8", "sigma", "color": {"w": (fan_in,
fan_out), "b": (fan_out,)}}``, the ``(in, out)`` layout of ``core/mlp.py``.
``field_legacy`` is a point-interface field, so ``render.render_rays(...,
field_fn=field_legacy)`` and ``eval.make_frame_fn(..., field_fn=...)`` run
the whole hierarchical renderer on it. The JAX package runs this field in
XLA with no Pallas kernel, so it is plain PyTorch on the card too.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import torch
from torch import nn

from tinynerf_torch.core import encoding
from tinynerf_torch.core.mlp import Params, check_no_tf32, linear_init, num_params

TRUNK_DEPTH = 9          # 60 -> 256, then 8 x 256 -> 256 (the last without ReLU)
WIDTH = 256
N_PARAMS = 543_052       # the shipped artifacts' size


def layer_dims() -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) of every linear layer, in forward order."""
    dims = [("trunk_0", encoding.POINT_ENC_DIM, WIDTH)]
    dims += [(f"trunk_{i}", WIDTH, WIDTH) for i in range(1, TRUNK_DEPTH)]
    return dims + [("sigma", WIDTH, 1), ("color", encoding.DIR_ENC_DIM + WIDTH, 3)]


def init_legacy(generator: torch.Generator,
                device: torch.device = torch.device("cpu")) -> Params:
    """Seeded params of the full-width field (``nn.Linear``'s default init,
    drawn on the CPU from ``generator``, then moved to ``device``)."""
    return {name: linear_init(generator, fan_in, fan_out, device)
            for name, fan_in, fan_out in layer_dims()}


def field_legacy(params: Params, points: torch.Tensor,
                 dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """points, dirs (..., 3) -> (color (..., 3), sigma (..., 1)), in true
    float32."""
    if points.is_cuda:
        check_no_tf32()
    linear = lambda name, x: x @ params[name]["w"] + params[name]["b"]
    h = encoding.encode_points(points)
    for i in range(TRUNK_DEPTH - 1):
        h = torch.relu(linear(f"trunk_{i}", h))
    h = linear(f"trunk_{TRUNK_DEPTH - 1}", h)          # no activation
    sigma = torch.sigmoid(linear("sigma", h))
    color_in = torch.cat([encoding.encode_dirs(dirs), h], dim=-1)
    return torch.sigmoid(linear("color", color_in)), sigma


n_params = num_params    # the JAX module's name for the count


# The module classes a genuine artifact's pickle references: the three
# retired classes of the training script's ``__main__`` (stubbed below) and
# these four of ``torch.nn``. Nothing else may appear in the stream.
_TORCH_CLASSES = (nn.Sequential, nn.Linear, nn.ReLU, nn.Sigmoid)
_MAIN_CLASSES = ("NeRFModel", "Encoder", "Network")


def _stub(name: str) -> type:
    """An empty ``nn.Module`` subclass named ``__main__.<name>``: the
    unpickler restores submodules and parameters through ``__dict__``
    without calling ``__init__``."""
    cls = type(name, (nn.Module,), {})
    cls.__module__, cls.__qualname__ = "__main__", name
    return cls


def load_shipped_checkpoint(path: str) -> Params:
    """A reference ``checkpoint/<N>`` artifact -> the legacy field's params.

    The artifacts pickle the whole ``nn.Module``, whose classes
    ``NeRFModel``, ``Encoder`` and ``Network`` lived in the retired training
    script's ``__main__``. They come from an untrusted repository, so this
    never runs the full pickle machine: it uses torch's weights-only
    unpickler (``torch.load(..., weights_only=True)``) with an allowlist of
    exactly the classes a genuine artifact names, the three ``__main__``
    stubs and ``Sequential``, ``Linear``, ``ReLU`` and ``Sigmoid``. Any other
    callable in the stream (a ``__reduce__`` to ``os.system``, say) raises
    before it runs. ``__main__`` is restored afterwards. A file with another
    trunk depth or parameter count is refused by name."""
    stubs = [_stub(name) for name in _MAIN_CLASSES]
    main = sys.modules["__main__"]
    missing = object()
    saved = {cls.__name__: getattr(main, cls.__name__, missing) for cls in stubs}
    try:
        for cls in stubs:
            setattr(main, cls.__name__, cls)
        with torch.serialization.safe_globals([*stubs, *_TORCH_CLASSES]):
            model = torch.load(path, map_location="cpu", weights_only=True)
    finally:
        for name, old in saved.items():
            if old is missing:
                delattr(main, name)
            else:
                setattr(main, name, old)

    sd = model.state_dict()
    # the state dict lists the nested Sequentials' linears in the order they
    # run: the innermost, first-run one first
    trunk = [k[: -len("weight")] for k in sd
             if k.startswith("network.point_layer") and k.endswith("weight")]
    if len(trunk) != TRUNK_DEPTH:
        raise ValueError(f"{path}: expected {TRUNK_DEPTH} trunk linears, found "
                         f"{len(trunk)} — not a shipped legacy checkpoint")

    def lin(prefix: str) -> Dict[str, torch.Tensor]:
        # torch's Linear keeps (out, in); the field takes (in, out)
        return {"w": sd[prefix + "weight"].detach().float().t().contiguous(),
                "b": sd[prefix + "bias"].detach().float().clone()}

    params = {f"trunk_{i}": lin(prefix) for i, prefix in enumerate(trunk)}
    params["sigma"] = lin("network.sigma_layer.0.")
    params["color"] = lin("network.color_layer.0.")
    if n_params(params) != N_PARAMS:
        raise ValueError(f"{path}: got {n_params(params)} params, expected {N_PARAMS}")
    return params
