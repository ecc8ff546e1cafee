"""Convert a reference PyTorch checkpoint to the port's npz checkpoint.

Counterpart of ``tools/import_torch_ckpt.py``, with its arguments, lines and
messages. For the reference's current architecture (the 593,924-param
``Network``, ``nerf.py:76-99``) it maps the weights onto the MLP tree
(``ckpt.import_torch_state_dict``) and writes ``<out_dir>/imported_<iter>.npz``
in the layout both packages load, so training resumes (``CONTINUE``) or
renders run from reference-trained weights. Host only: it needs no card.

It takes a state dict (``torch.save(net.state_dict())``, with or without
``NeRFModel``'s ``network.`` prefix), which loads under torch's weights-only
unpickler, or a whole-module pickle (``torch.save(self.model, ...)``,
``nerf.py:491``), which needs the full unpickler, said loudly, and the
reference's source on the path (``--ref-path``).

The checkpoints shipped in the reference repo (``checkpoint/0..6``) hold an
older revision (543,052 params, no skip connection; SURVEY.md §2.12), which
this tool reports and refuses; ``python -m
tinynerf_torch.tools.render_shipped_ckpt`` renders them through
``core/legacy.py``.

Usage:
    python -m tinynerf_torch.tools.import_torch_ckpt ref.pkl out_dir/ --iter 19999
"""

from __future__ import annotations

import argparse
import sys

# the classes a reference training run pickles under __main__
REFERENCE_CLASSES = ("NeRFModel", "Network", "Encoder", "Activation")


def _load(src: str, ref_path):
    """The object in ``src``: weights-only first; else, loudly, the full
    unpickler with the reference's classes aliased under ``__main__``."""
    import torch
    try:
        return torch.load(src, map_location="cpu", weights_only=True)
    except Exception:
        print(f"WARNING: {src} is not a plain tensor pickle; falling back to "
              "weights_only=False (full pickle VM — only do this for "
              "checkpoints you trust)", file=sys.stderr)
    import __main__
    saved, missing = {}, object()
    if ref_path:
        sys.path.insert(0, ref_path)
        try:
            # pickles saved from a reference training run name the classes
            # under __main__; alias them so unpickling resolves
            import nerf as refnerf
            for cls in REFERENCE_CLASSES:
                if hasattr(refnerf, cls):
                    saved[cls] = getattr(__main__, cls, missing)
                    setattr(__main__, cls, getattr(refnerf, cls))
        except ImportError:
            pass
    try:
        return torch.load(src, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        sys.exit(f"cannot unpickle {src}: {e}. Whole-module reference pickles need "
                 "the reference source on the path — pass --ref-path /path/to/NeRF-tiny")
    finally:
        for cls, old in saved.items():
            if old is missing:
                delattr(__main__, cls)
            else:
                setattr(__main__, cls, old)
        if ref_path:
            sys.path.remove(ref_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="reference .pkl (torch.save'd module or state dict)")
    parser.add_argument("out_dir", help="tinynerf checkpoint directory")
    parser.add_argument("--iter", type=int, default=0,
                        help="iteration to stamp the checkpoint with")
    parser.add_argument("--ref-path", type=str, default=None,
                        help="path to the reference source tree (whole-module "
                             "pickles need the defining `nerf` module "
                             "importable to unpickle)")
    args = parser.parse_args(argv)

    import torch
    from tinynerf_torch import ckpt
    from tinynerf_torch.core import mlp

    obj = _load(args.src, args.ref_path)
    network = getattr(obj, "network", obj)  # NeRFModel or bare Network
    state = network.state_dict() if hasattr(network, "state_dict") else dict(network)
    if not any(k.startswith("point_layer.") for k in state):
        state = {k[len("network."):]: v for k, v in state.items()
                 if k.startswith("network.")}
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()
          if isinstance(v, torch.Tensor)}

    missing = [f"point_layer.{i}.0.weight" for i in range(8)
               if f"point_layer.{i}.0.weight" not in sd]
    if missing:
        sys.exit(
            "checkpoint does not match the current reference architecture "
            f"(missing {missing[:2]}...). The reference repo's shipped "
            "checkpoint/0..6 files are an older, incompatible revision "
            "(SURVEY.md §2.12) and cannot be imported.")

    params = ckpt.import_torch_state_dict(sd)
    n = mlp.num_params(params)
    path = ckpt.save_checkpoint(args.out_dir, "imported", args.iter, params)
    print(f"imported {n:,} params -> {path}")


if __name__ == "__main__":
    main()
