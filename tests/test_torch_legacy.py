"""The retired field of the reference's shipped checkpoints in the port
(``tinynerf_torch/core/legacy.py``) against the JAX package's
(``tinynerf/core/legacy.py``), on the CPU: the field on seeded params, a
hierarchical render through it, and the weights-only loader on pickles the
test writes with the retired module structure (the artifacts themselves are
not in the repository).

Tolerances: the field's color 1e-6 and sigma 1e-5 (float32 in other
orders), pixels 1e-4 (the frame tolerance, ``tests/test_torch_slice.py``)."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from tinynerf.core import legacy as jlegacy, render as jrender
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf_torch.core import legacy, render
from tinynerf_torch.core.rays import make_k_inv
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

MAIN_CLASSES = ("NeRFModel", "Encoder", "Network")


def _jax_tree(params):
    """The port's params -> the JAX loader's pytree (lists of (w, b))."""
    pair = lambda name: (jnp.asarray(params[name]["w"].numpy()),
                         jnp.asarray(params[name]["b"].numpy()))
    return {"trunk": [pair(f"trunk_{i}") for i in range(legacy.TRUNK_DEPTH)],
            "sigma": pair("sigma"), "color": pair("color")}


def _seeded(seed, sigma_bias=0.0):
    params = legacy.init_legacy(torch.Generator().manual_seed(seed))
    params["sigma"]["b"] += sigma_bias
    return params


def test_field_matches_jax_on_seeded_params():
    params = _seeded(0)
    assert legacy.n_params(params) == legacy.N_PARAMS == 543_052
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    color, sigma = legacy.field_legacy(params, torch.from_numpy(pts), torch.from_numpy(dirs))
    ref_color, ref_sigma = jlegacy.field_legacy(_jax_tree(params), jnp.asarray(pts),
                                                jnp.asarray(dirs))
    assert color.shape == (64, 3) and sigma.shape == (64, 1)
    np.testing.assert_allclose(color.numpy(), np.asarray(ref_color), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma), atol=1e-5, rtol=0)


def test_render_rays_through_the_legacy_field_matches_jax():
    """Coarse, fine and merge on the legacy field with content (the sigma
    bias +1): both passes' pixels within 1e-4 of JAX's ``render_rays``."""
    from tests.test_torch_render import _pose_rows
    params = _seeded(2, sigma_bias=1.0)
    rng = np.random.default_rng(3)
    B = 24
    rows_px = rng.integers(0, 16, B).astype(np.float32)
    cols_px = rng.integers(0, 16, B).astype(np.float32)
    pose = _pose_rows(rng, B)
    ref = jrender.render_rays(_jax_tree(params), jnp.asarray(rows_px), jnp.asarray(cols_px),
                              jnp.asarray(pose), jmake_k_inv(16, 16, 20.0), 16, 32,
                              field_fn=jlegacy.field_legacy)
    with torch.no_grad():
        got = render.render_rays(params, torch.from_numpy(rows_px), torch.from_numpy(cols_px),
                                 torch.from_numpy(pose), make_k_inv(16, 16, 20.0), 16, 32,
                                 field_fn=legacy.field_legacy)
    for a, b in zip(got, ref):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


# ---------------------------------------------------------------- the loader


class _MainClasses:
    """Module classes named ``__main__.NeRFModel``, ``Encoder`` and
    ``Network``, registered in ``__main__`` while a pickle is written (the
    retired training script's classes), and removed after."""

    def __enter__(self):
        main = sys.modules["__main__"]
        self.saved = {n: main.__dict__.get(n) for n in MAIN_CLASSES}
        self.classes = {}
        for name in MAIN_CLASSES:
            cls = type(name, (nn.Module,), {})
            cls.__module__, cls.__qualname__ = "__main__", name
            setattr(main, name, cls)
            self.classes[name] = cls
        return self.classes

    def __exit__(self, *exc):
        main = sys.modules["__main__"]
        for name, old in self.saved.items():
            if old is None:
                delattr(main, name)
            else:
                setattr(main, name, old)


def _write_artifact(path, params, depth=legacy.TRUNK_DEPTH):
    """A whole-module pickle with the retired structure: ``NeRFModel`` holds
    an ``Encoder`` (L_point 10, L_dir 4) and a ``Network`` whose
    ``point_layer`` nests its Sequentials so that the first linear sits
    innermost, the last outermost without an activation."""
    def linear(name):
        w, b = params[name]["w"], params[name]["b"]
        lin = nn.Linear(w.shape[0], w.shape[1])
        with torch.no_grad():
            lin.weight.copy_(w.t())
            lin.bias.copy_(b)
        return lin

    with _MainClasses() as cls:
        layers = nn.Sequential(linear("trunk_0"), nn.ReLU())
        for i in range(1, depth - 1):
            layers = nn.Sequential(layers, linear(f"trunk_{i}"), nn.ReLU())
        network = cls["Network"]()
        network.point_layer = nn.Sequential(layers, nn.Sequential(
            linear(f"trunk_{legacy.TRUNK_DEPTH - 1}")))
        network.sigma_layer = nn.Sequential(linear("sigma"), nn.Sigmoid())
        network.color_layer = nn.Sequential(linear("color"), nn.Sigmoid())
        encoder = cls["Encoder"]()
        encoder.L_point, encoder.L_dir = 10, 4
        model = cls["NeRFModel"]()
        model.encoder, model.network = encoder, network
        torch.save(model, path)


def test_both_loaders_read_a_retired_pickle_to_the_same_arrays(tmp_path):
    params = _seeded(4)
    path = str(tmp_path / "0")
    _write_artifact(path, params)
    before = {n: getattr(sys.modules["__main__"], n, None) for n in MAIN_CLASSES}
    got = legacy.load_shipped_checkpoint(path)
    assert {n: getattr(sys.modules["__main__"], n, None) for n in MAIN_CLASSES} == before
    ref = jlegacy.load_shipped_checkpoint(path)
    assert legacy.n_params(got) == jlegacy.n_params(ref) == 543_052
    for name, _, _ in legacy.layer_dims():
        np.testing.assert_array_equal(got[name]["w"].numpy(), params[name]["w"].numpy())
        np.testing.assert_array_equal(got[name]["b"].numpy(), params[name]["b"].numpy())
    for i in range(legacy.TRUNK_DEPTH):
        for k, arr in zip("wb", ref["trunk"][i]):
            np.testing.assert_array_equal(got[f"trunk_{i}"][k].numpy(), np.asarray(arr))
    for name in ("sigma", "color"):
        for k, arr in zip("wb", ref[name]):
            np.testing.assert_array_equal(got[name][k].numpy(), np.asarray(arr))


def test_a_wrong_trunk_depth_is_refused_by_name(tmp_path):
    params = _seeded(5)
    path = str(tmp_path / "short")
    _write_artifact(path, params, depth=legacy.TRUNK_DEPTH - 1)
    for loader in (legacy.load_shipped_checkpoint, jlegacy.load_shipped_checkpoint):
        with pytest.raises(ValueError, match="expected 9 trunk linears, found 8"):
            loader(path)


class _Payload:
    """An object whose unpickling would call ``os.system``."""

    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return os.system, (self.cmd,)


def test_a_pickle_naming_another_callable_is_refused_without_running_it(tmp_path):
    marker = tmp_path / "ran"
    path = str(tmp_path / "evil")
    torch.save({"network": _Payload(f"touch {marker}")}, path)
    before = {n: getattr(sys.modules["__main__"], n, None) for n in MAIN_CLASSES}
    with pytest.raises(Exception, match="system"):
        legacy.load_shipped_checkpoint(path)
    assert not marker.exists()
    assert {n: getattr(sys.modules["__main__"], n, None) for n in MAIN_CLASSES} == before


def test_render_shipped_ckpt_tool_matches_jax(tmp_path, monkeypatch):
    """``python -m tinynerf_torch.tools.render_shipped_ckpt`` on a retired
    pickle (the sigma bias +1, for content) writes the same PNGs as
    ``tools/render_shipped_ckpt.py``, within one level of 255."""
    from PIL import Image
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import render_shipped_ckpt as jtool
    from tinynerf_torch.tools import render_shipped_ckpt as tool
    path = str(tmp_path / "6")
    _write_artifact(path, _seeded(6, sigma_bias=1.0))
    args = ["--ckpt", path, "--hw", "12", "--views", "2", "--coarse", "8", "--fine", "16"]
    tool.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["render_shipped_ckpt.py", *args,
                                      "--out", str(tmp_path / "jax")])
    jtool.main()
    for i in range(2):
        got, want = (np.asarray(Image.open(tmp_path / d / f"view_{i:03d}.png"), np.int16)
                     for d in ("port", "jax"))
        assert got.shape == (12, 12, 3) and np.abs(got - want).max() <= 1
