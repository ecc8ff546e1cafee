"""Checkpoints: the JAX package's flat-npz layout, so one file loads in both.

Keys are ``params::<layer>::w`` (``(in, out)``) and ``params::<layer>::b``
for the MLP and the proposal MLP; ``params::lines::{x,y,z}`` (and
``{x,y,z}{l}`` for a pyramid level), ``params::decoder::{hidden,color}::{w,b}``,
a 0-d ``params::extent`` and, with ``GRID_HYBRID``,
``params::sigma_net::{hidden,sigma}::{w,b}`` for the grid field; under
``PROPOSAL`` the same under ``params::net::`` and ``params::prop::``; plus ``iteration``; a training checkpoint also holds the Adam state,
``mu::``/``nu::`` moments and ``adam_count``, and with ``OCC_GRID`` the
occupancy grid, ``occ::raw``, ``occ::density``, ``occ::half_extent`` and
``occ::threshold`` (training state: the weights co-adapt to the grid's
tightened samples, so resuming and rendering reuse it). Files are named
``<start_time>_<iter>.npz``; resume takes the highest iteration.

The sample streams cannot cross: a JAX Threefry ``prng_key`` cannot seed a
torch generator. The port writes its generator's state under a key of its
own, ``torch_generator``, which the JAX package ignores; resuming a JAX
checkpoint, it ignores ``prng_key`` and says so.

``import_torch_state_dict`` and ``export_torch_state_dict`` bridge the
reference's own PyTorch ``Network`` (the 593,924-param 8x256 MLP) and the
port's MLP tree, as the JAX package's do (``tools.import_torch_ckpt`` and
``tools.export_torch_ckpt`` are their tools).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tinynerf_torch.core import gridfield, mlp, occupancy, proposal
from tinynerf_torch.core.encoding import DIR_ENC_DIM

_SEP = "::"
GENERATOR_KEY = "torch_generator"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, torch.Tensor):
        flat[prefix.rstrip(_SEP)] = tree.detach().cpu().numpy()
    else:
        flat[prefix.rstrip(_SEP)] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _f32(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor on ``device``, row-major whatever the array's order
    (an npz may hold Fortran-ordered arrays; the kernels take contiguous
    weights)."""
    return torch.tensor(np.asarray(x, dtype=np.float32, order="C"), device=device)


def _grid_from_numpy(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A grid field's tree: the x, y, z line tables (one shape, (R, F)), any
    pyramid level's ``{x,y,z}{l}`` ((``level_res(R, l)``, F)), the decoder
    (``hidden`` (24 + Fa [+ sw], W), ``color`` (W, 3)), a 0-d ``extent``
    and, with ``GRID_HYBRID``, the ``sigma_net`` (``hidden`` (Fd, sw),
    ``sigma`` (sw, 1)), Fd + Fa = F."""
    n_levels = gridfield.check_params(tree)
    linear = lambda p: {k: _f32(p[k], device) for k in ("w", "b")}
    out = {"lines": {name: _f32(t, device) for name, t in tree["lines"].items()},
           "decoder": {name: linear(tree["decoder"][name]) for name in ("hidden", "color")},
           "extent": _f32(tree["extent"], device)}
    if "sigma_net" in tree:
        out["sigma_net"] = {name: linear(tree["sigma_net"][name])
                            for name in ("hidden", "sigma")}
    lines, dec = out["lines"], out["decoder"]
    res, n_comp = lines["x"].shape
    width = dec["hidden"]["w"].shape[1]
    tables_ok = all(lines[f"{ax}{lvl or ''}"].shape == (gridfield.level_res(res, lvl), n_comp)
                    for ax in gridfield.AXES for lvl in range(n_levels))
    n_in = dec["hidden"]["w"].shape[0] - DIR_ENC_DIM   # Fa, or Fa + sw with the sigma net
    sigma_ok = True
    if "sigma_net" in out:
        hidden, sig = out["sigma_net"]["hidden"], out["sigma_net"]["sigma"]
        n_density, sw = hidden["w"].shape
        n_in -= sw
        sigma_ok = (n_density == n_comp - n_in and hidden["b"].shape == (sw,)
                    and sig["w"].shape == (sw, 1) and sig["b"].shape == (1,))
    if (not tables_ok or not sigma_ok or n_in not in range(0, n_comp)
            or dec["hidden"]["b"].shape != (width,) or dec["color"]["w"].shape != (width, 3)
            or dec["color"]["b"].shape != (3,) or out["extent"].shape != ()):
        raise ValueError("grid field shapes do not agree: "
                         f"{ {k: tuple(v.shape) for k, v in _flatten(out).items()} }")
    return out


def params_from_numpy(tree: Dict[str, Any],
                      device: torch.device = torch.device("cpu"),
                      ) -> Any:
    """The JAX package's parameters, as a nested dict of numpy arrays (or
    anything ``np.asarray`` takes), -> the port's parameters: the same
    nesting, float32 tensors on ``device``. Layouts agree, so nothing is
    transposed or permuted. Takes the MLP's tree, a grid field's, the
    proposal MLP's (``sigma`` and ``color``, no ``point_info``; its width,
    depth and point bands from its shapes), or the ``{"net", "prop"}`` pair
    of a main and a proposal field (``PROPOSAL``). A grid field's tree may
    hold a ``sigma_net`` (``GRID_HYBRID``) and pyramid level tables
    (``GRID_LEVELS``)."""
    if set(tree) == {"net", "prop"}:
        return {k: params_from_numpy(tree[k], device) for k in ("net", "prop")}
    if "lines" in tree:
        return _grid_from_numpy(tree, device)
    if "trunk_0" not in tree:
        raise ValueError(
            "expected the reference MLP's parameters (trunk_0 ... color), the proposal "
            "MLP's (trunk_0 ... sigma, color), a grid field's (lines, decoder, extent) or "
            f"a net/prop pair, got {sorted(tree)}")
    if proposal.is_proposal(tree):
        width, depth, enc_l = proposal.dims(tree)
        dims = proposal.layer_dims(width, depth, point_dim=6 * enc_l)
        if set(tree) != {name for name, _, _ in dims}:
            raise ValueError(f"the proposal MLP's layers {sorted(tree)} are not "
                             f"{[name for name, _, _ in dims]}")
    else:
        dims = mlp.layer_dims()
    params: mlp.Params = {}
    for name, fan_in, fan_out in dims:
        w = np.asarray(tree[name]["w"], dtype=np.float32)
        b = np.asarray(tree[name]["b"], dtype=np.float32)
        if w.shape != (fan_in, fan_out) or b.shape != (fan_out,):
            raise ValueError(f"{name}: shapes {w.shape}, {b.shape} do not match "
                             f"({fan_in}, {fan_out})")
        params[name] = {"w": _f32(w, device), "b": _f32(b, device)}
    return params


def save_checkpoint(path_dir: str, start_time: str, iteration: int,
                    params: Any, opt_state=None,
                    generator: Optional[torch.Generator] = None,
                    occ: Optional[occupancy.OccGrid] = None) -> str:
    """Write ``<path_dir>/<start_time>_<iteration>.npz``; returns the path.
    ``opt_state`` is an ``optim.AdamState``."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"{start_time}_{iteration}.npz")
    blobs = {"iteration": np.asarray(iteration, np.int64)}
    for k, v in _flatten(params).items():
        blobs[f"params{_SEP}{k}"] = v
    if opt_state is not None:
        blobs["adam_count"] = np.asarray(opt_state.count, np.int32)
        for k, v in _flatten(opt_state.mu).items():
            blobs[f"mu{_SEP}{k}"] = v
        for k, v in _flatten(opt_state.nu).items():
            blobs[f"nu{_SEP}{k}"] = v
    if generator is not None:
        blobs[GENERATOR_KEY] = generator.get_state().numpy()
    if occ is not None:
        for k, v in occ._asdict().items():
            blobs[f"occ{_SEP}{k}"] = v.detach().cpu().numpy()
    np.savez(path, **blobs)
    return path


def _tree(archive, prefix: str) -> Dict[str, Any]:
    return _unflatten({k[len(prefix):]: archive[k]
                       for k in archive.files if k.startswith(prefix)})


def load_checkpoint_full(path: str, device: torch.device = torch.device("cpu"),
                         ) -> Tuple[int, Any]:
    """Returns ``(iteration, params)``: what rendering needs."""
    with np.load(path) as archive:
        iteration = int(archive["iteration"])
        tree = _tree(archive, f"params{_SEP}")
    return iteration, params_from_numpy(tree, device)


def load_train_state(path: str, device: torch.device = torch.device("cpu")):
    """Returns ``(iteration, params, adam_state or None, generator state (a
    uint8 tensor) or None)``, from a checkpoint of either package."""
    from tinynerf_torch.optim import AdamState
    iteration, params = load_checkpoint_full(path, device)
    opt_state = gen_state = None
    with np.load(path) as archive:
        if "adam_count" in archive.files:
            opt_state = AdamState(
                count=int(archive["adam_count"]),
                mu=params_from_numpy(_tree(archive, f"mu{_SEP}"), device),
                nu=params_from_numpy(_tree(archive, f"nu{_SEP}"), device))
        if GENERATOR_KEY in archive.files:
            gen_state = torch.from_numpy(archive[GENERATOR_KEY].copy())
        has_key = "prng_key" in archive.files
    if has_key:
        print(f"Note: {os.path.basename(path)} holds prng_key from the JAX "
              "package; the port ignores it (a JAX PRNG key cannot seed a "
              "torch generator: the sample stream restarts from SEED)")
    return iteration, params, opt_state, gen_state


def load_occ_grid(path: str, device: torch.device = torch.device("cpu"),
                  ) -> Optional[occupancy.OccGrid]:
    """The checkpoint's occupancy grid (written by either package), or None."""
    with np.load(path) as archive:
        if f"occ{_SEP}raw" not in archive.files:
            return None
        return occupancy.OccGrid(**{
            k: torch.tensor(np.asarray(archive[f"occ{_SEP}{k}"], np.float32),
                            device=device)
            for k in occupancy.OccGrid._fields})


_ITER_RE = re.compile(r"_(\d+)\.npz$")


def find_latest(ckpt_dir: str) -> Optional[str]:
    """Latest-by-iteration checkpoint path under ``ckpt_dir``, or None."""
    best_iter, best_path = -1, None
    for path in glob.glob(os.path.join(ckpt_dir, "*.npz")):
        m = _ITER_RE.search(path)
        if m and int(m.group(1)) > best_iter:
            best_iter, best_path = int(m.group(1)), path
    return best_path


# the port's MLP layers -> the reference ``Network``'s ``nn.Linear`` names
REFERENCE_LAYERS = {**{f"trunk_{i}": f"point_layer.{i}.0" for i in range(8)},
                    "sigma": "sigma_layer.0", "point_info": "point_info",
                    "dir_info": "dir_info.0", "color": "color_layer.0"}


def _array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float32)


def import_torch_state_dict(state_dict: Dict[str, Any],
                            device: torch.device = torch.device("cpu")) -> mlp.Params:
    """A reference ``Network`` state dict (its current 8x256 architecture:
    ``point_layer.{0..7}.0``, ``sigma_layer.0``, ``point_info``,
    ``dir_info.0``, ``color_layer.0``; torch's ``(out, in)`` weights, as
    tensors or arrays) -> the port's MLP tree, ``(in, out)``, on ``device``
    (through ``params_from_numpy``, which checks the shapes)."""
    tree = {name: {"w": _array(state_dict[f"{ref}.weight"]).T,
                   "b": _array(state_dict[f"{ref}.bias"])}
            for name, ref in REFERENCE_LAYERS.items()}
    return params_from_numpy(tree, device)


def export_torch_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """The inverse of ``import_torch_state_dict``: the MLP tree's weights
    under the reference ``Network``'s names, transposed back to ``(out,
    in)``, as numpy float32 arrays (the caller makes tensors of them). A
    ``PROPOSAL`` tree exports its net; a grid field has no reference
    counterpart and raises the JAX package's ``ValueError``."""
    if "net" in params and isinstance(params["net"], dict):
        params = params["net"]
    if "trunk_0" not in params:
        raise ValueError(
            "only the MLP family maps onto the reference Network "
            "(FINE_FIELD=grid checkpoints have no torch counterpart)")
    sd: Dict[str, np.ndarray] = {}
    for name, ref in REFERENCE_LAYERS.items():
        sd[f"{ref}.weight"] = _array(params[name]["w"]).T.copy()
        sd[f"{ref}.bias"] = _array(params[name]["b"]).copy()
    return sd
