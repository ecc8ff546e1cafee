"""The bridge to the reference's own PyTorch checkpoints in the port
(``tinynerf_torch.ckpt.import_torch_state_dict`` / ``export_torch_state_dict``
and the tools ``python -m tinynerf_torch.tools.import_torch_ckpt`` /
``export_torch_ckpt``) against the JAX package's (``tinynerf/ckpt.py``,
``tools/import_torch_ckpt.py``, ``tools/export_torch_ckpt.py``), on the CPU.

The reference's source tree is not needed: a state dict under its names
and shapes (the transposes of the 8x256 MLP's leaves, 593,924 params) is
made with numpy from a seed, and the export tool runs against a stand-in
``nerf.py`` written to ``tmp_path`` whose ``NeRFModel(num_coarse, num_fine,
batch_ray).network`` has the reference's layer names. The tools run in this
process (``main(argv)``)."""

import importlib.util
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from tinynerf import ckpt as jckpt, eval as jeval
from tinynerf.config import Config as JConfig
from tinynerf.core.rays import make_k_inv as jmake_k_inv
from tinynerf.data.poses import load_scene as jload_scene
from tinynerf_torch import ckpt, eval as evallib
from tinynerf_torch.config import Config
from tinynerf_torch.core import mlp
from tinynerf_torch.core.rays import make_k_inv
from tinynerf_torch.tools import export_torch_ckpt, import_torch_ckpt
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_ATOL = 1e-4          # the frame bound (tests/test_torch_slice.py)
N_PARAMS = 593_924

# a stand-in for the reference's nerf.py: NeRFModel's shared Network under
# the reference's layer names (SURVEY.md §2.6), its shapes from the port's
STAND_IN = '''import torch.nn as nn

LAYERS = {layers!r}


class Network(nn.Module):
    def __init__(self):
        super().__init__()
        lin = lambda name: nn.Linear(*LAYERS[name])
        self.point_layer = nn.ModuleList(
            [nn.Sequential(lin(f"trunk_{{i}}"), nn.ReLU()) for i in range(8)])
        self.sigma_layer = nn.Sequential(lin("sigma"))
        self.point_info = lin("point_info")
        self.dir_info = nn.Sequential(lin("dir_info"), nn.ReLU())
        self.color_layer = nn.Sequential(lin("color"), nn.Sigmoid())


class NeRFModel(nn.Module):
    def __init__(self, num_coarse, num_fine, batch_ray):
        super().__init__()
        self.num_coarse, self.num_fine, self.batch_ray = num_coarse, num_fine, batch_ray
        self.network = Network()
'''


def _reference_state_dict(seed):
    """Seeded weights under the reference ``Network``'s names, torch's
    ``(out, in)`` layout: ``nn.Linear``'s uniform, the sigma bias raised by 1
    so that a rendered chunk has content."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, fan_in, fan_out in mlp.layer_dims():
        ref, bound = ckpt.REFERENCE_LAYERS[name], 1.0 / np.sqrt(fan_in)
        sd[f"{ref}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (fan_out, fan_in)).astype(np.float32))
        sd[f"{ref}.bias"] = torch.from_numpy(
            rng.uniform(-bound, bound, fan_out).astype(np.float32))
    sd["sigma_layer.0.bias"] += 1.0
    return sd


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    _jax_tool(name).main()


def _assert_same_tree(params, jparams):
    """Equal bit for bit, and each tensor float32 and contiguous (the
    kernels refuse strided weights)."""
    assert list(params) == list(jparams)
    for name in jparams:
        for k in ("w", "b"):
            assert params[name][k].dtype == torch.float32
            assert params[name][k].is_contiguous(), f"{name}.{k}"
            np.testing.assert_array_equal(params[name][k].numpy(), np.asarray(jparams[name][k]),
                                          err_msg=f"{name}.{k}")


@pytest.fixture
def stand_in_module():
    """The stand-in ``nerf`` leaves ``sys.modules`` with its test (the export
    tools keep it there for pickling)."""
    yield
    sys.modules.pop("nerf", None)


def _stand_in(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    layers = {name: (fan_in, fan_out) for name, fan_in, fan_out in mlp.layer_dims()}
    (ref / "nerf.py").write_text(STAND_IN.format(layers=layers))
    return str(ref)


# ---------------------------------------------------------------- the mapping


def test_import_matches_jax_bit_for_bit():
    """Both packages' ``import_torch_state_dict`` on one state dict: the same
    tree, bit for bit, of 593,924 params, from tensors or arrays."""
    sd = _reference_state_dict(0)
    params = ckpt.import_torch_state_dict(sd)
    jparams = jckpt.import_torch_state_dict(_numpy_sd(sd))
    _assert_same_tree(params, jparams)
    _assert_same_tree(ckpt.import_torch_state_dict(_numpy_sd(sd)), jparams)
    assert mlp.num_params(params) == N_PARAMS
    np.testing.assert_array_equal(params["trunk_0"]["w"].numpy(),
                                  sd["point_layer.0.0.weight"].numpy().T)


def test_a_chunk_rendered_from_each_import_agrees(sync_scene_dir):
    """An 8x8 view (64 rays in chunks of 24) rendered by each package from its
    own import of one state dict: every pixel within the frame bound."""
    sd = _reference_state_dict(1)
    scene = jload_scene(sync_scene_dir, "sync", "test")
    h = w = 8
    focal = scene.focal * h / scene.height
    pose = scene.poses_bounds[0].astype(np.float32)
    small = dict(n_coarse=8, n_fine=16, render_chunk=24, white_bkgd=True)
    ref = jeval.make_frame_fn(JConfig(**small), jmake_k_inv(h, w, focal), h, w)(
        jckpt.import_torch_state_dict(_numpy_sd(sd)), jnp.asarray(pose))
    got = evallib.make_frame_fn(Config(**small), make_k_inv(h, w, focal), h, w)(
        ckpt.import_torch_state_dict(sd), pose)
    assert got.shape == (h, w, 3) and np.ptp(got) > 0.01
    np.testing.assert_allclose(got, np.asarray(ref), atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("tree", ["mlp", "proposal"])
def test_export_matches_jax_bit_for_bit(tree):
    """``export_torch_state_dict`` of the MLP tree and of a ``PROPOSAL``
    ``{"net", "prop"}`` tree (its net exports) in both packages: the same
    names in the same order, the same arrays bit for bit, equal to the
    state dict the tree was imported from."""
    sd = _reference_state_dict(2)
    params = ckpt.import_torch_state_dict(sd)
    jparams = jckpt.import_torch_state_dict(_numpy_sd(sd))
    prop = {"trunk_0": {"w": torch.zeros(60, 8), "b": torch.zeros(8)}}
    if tree == "proposal":
        params, jparams = {"net": params, "prop": prop}, {"net": jparams, "prop": {}}
    got, want = ckpt.export_torch_state_dict(params), jckpt.export_torch_state_dict(jparams)
    assert list(got) == list(want) == list(sd)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], sd[k].numpy(), err_msg=k)


def test_a_grid_tree_raises_the_jax_value_error():
    grid = {"lines": {}, "decoder": {}, "extent": torch.tensor(1.5)}
    with pytest.raises(ValueError) as jerr:
        jckpt.export_torch_state_dict({"lines": {}, "decoder": {}})
    with pytest.raises(ValueError) as err:
        ckpt.export_torch_state_dict(grid)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="only the MLP family"):
        ckpt.export_torch_state_dict({"net": grid, "prop": grid})


# ---------------------------------------------------------------- the tools


def test_import_tool_writes_an_npz_both_packages_load(tmp_path, capsys):
    """A ``torch.save``d state dict, with and without ``NeRFModel``'s
    ``network.`` prefix, through the port's import tool: it loads under the
    weights-only unpickler (no warning), prints the JAX tool's line and
    writes ``imported_<iter>.npz``, which both packages load to the trees
    the mapping gives, bit for bit."""
    sd = _reference_state_dict(3)
    want = jckpt.import_torch_state_dict(_numpy_sd(sd))
    for tag, saved in (("bare", sd), ("model", {f"network.{k}": v for k, v in sd.items()})):
        src = str(tmp_path / f"{tag}.pkl")
        torch.save(saved, src)
        out_dir = str(tmp_path / f"{tag}_ckpt")
        import_torch_ckpt.main([src, out_dir, "--iter", "19999"])
        out, err = capsys.readouterr()
        path = os.path.join(out_dir, "imported_19999.npz")
        assert out == f"imported {N_PARAMS:,} params -> {path}\n" and err == ""
        with np.load(path) as archive:
            assert all(archive[k].flags["C_CONTIGUOUS"] for k in archive.files)
        iteration, params = ckpt.load_checkpoint_full(path)
        j_iter, j_params, j_opt = jckpt.load_checkpoint(path)
        assert iteration == j_iter == 19999 and j_opt is None
        _assert_same_tree(params, want)
        _assert_same_tree(params, j_params)


def _old_revision_module():
    """A whole module of the shipped checkpoints' retired layout: one nested
    ``point_layer`` Sequential and a color head straight from the trunk
    (no ``point_layer.<i>.0``, no ``point_info``)."""
    net = nn.Module()
    layers = nn.Sequential(nn.Linear(60, 8), nn.ReLU())
    net.point_layer = nn.Sequential(nn.Sequential(layers, nn.Linear(8, 8), nn.ReLU()),
                                    nn.Sequential(nn.Linear(8, 8)))
    net.sigma_layer = nn.Sequential(nn.Linear(8, 1), nn.Sigmoid())
    net.color_layer = nn.Sequential(nn.Linear(32, 3), nn.Sigmoid())
    model = nn.Module()
    model.network = net
    return model


def test_import_tool_refuses_an_old_revision_with_the_jax_message(tmp_path, capsys,
                                                                   monkeypatch):
    """A whole-module pickle of the old revision: both tools warn alike that
    it needs the full unpickler, then exit with the same message; and a
    state dict of it (no ``point_layer.<i>.0``) loads weights-only and gets
    that message from the port's tool too."""
    src = str(tmp_path / "old.pkl")
    torch.save(_old_revision_module(), src)
    exits = []
    for run in (lambda argv: import_torch_ckpt.main(argv),
                lambda argv: _run_jax_tool("import_torch_ckpt", argv, monkeypatch)):
        with pytest.raises(SystemExit) as e:
            run([src, str(tmp_path / "out")])
        exits.append((str(e.value.code), capsys.readouterr()))
    (port_msg, (port_out, port_err)), (jax_msg, (jax_out, jax_err)) = exits
    assert port_msg == jax_msg and "older, incompatible revision" in port_msg
    assert port_out == jax_out == "" and port_err == jax_err and "WARNING" in port_err
    state = str(tmp_path / "old_sd.pkl")
    torch.save(_old_revision_module().network.state_dict(), state)
    with pytest.raises(SystemExit) as e:
        import_torch_ckpt.main([state, str(tmp_path / "out")])
    assert str(e.value.code) == port_msg and capsys.readouterr().err == ""
    assert not os.path.exists(tmp_path / "out")


def test_export_tool_round_trips_through_a_stand_in_reference(tmp_path, capsys,
                                                              monkeypatch, stand_in_module):
    """A checkpoint written by the port's import tool, exported by each
    package's export tool against the stand-in ``nerf.py`` (``strict=True``):
    each writes ``exported_<iter>.pkl``, a whole ``NeRFModel`` with the
    baked-in sizes, whose network's state dict equals the one imported, bit
    for bit; both print the same line. A checkpoint directory exports its
    latest file."""
    sd = _reference_state_dict(4)
    src = str(tmp_path / "ref.pkl")
    torch.save(sd, src)
    import_torch_ckpt.main([src, str(tmp_path / "ckpt"), "--iter", "41"])
    capsys.readouterr()
    ref_path = _stand_in(tmp_path)
    lines = {}
    for who, run in (("port", lambda argv: export_torch_ckpt.main(argv)),
                     ("jax", lambda argv: _run_jax_tool("export_torch_ckpt", argv,
                                                        monkeypatch))):
        out_dir = str(tmp_path / f"out_{who}")
        run([str(tmp_path / "ckpt"), out_dir, "--ref-path", ref_path, "--batch-ray", "16"])
        lines[who] = capsys.readouterr().out
        model = torch.load(os.path.join(out_dir, "exported_41.pkl"), map_location="cpu",
                           weights_only=False)
        assert type(model).__name__ == "NeRFModel" and model.batch_ray == 16
        back = model.network.state_dict()
        assert list(back) == list(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), (who, k)
    assert lines["port"] == (f"exported {N_PARAMS:,} params (iter 41) -> "
                             f"{os.path.join(str(tmp_path / 'out_port'), 'exported_41.pkl')}\n")
    assert lines["jax"] == lines["port"].replace("out_port", "out_jax")


def test_export_tool_needs_checkpoints(tmp_path):
    with pytest.raises(SystemExit, match="no .npz checkpoints under"):
        export_torch_ckpt.main([str(tmp_path), str(tmp_path / "out"),
                                "--ref-path", str(tmp_path)])
