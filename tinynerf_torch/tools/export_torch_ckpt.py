"""Convert a tinynerf npz checkpoint to a reference-resumable PyTorch pickle.

Counterpart of ``tools/export_torch_ckpt.py`` and the inverse of
``tinynerf_torch.tools.import_torch_ckpt``. The reference resumes from
whole-module pickles (``self.model = torch.load(last_ckpt)``, reference
``nerf.py:415``), so this tool instantiates the reference's own
``NeRFModel`` (imported as ``nerf`` from ``--ref-path``, the reference source
tree), loads the checkpoint's weights into its shared ``Network``
(``ckpt.export_torch_state_dict``; ``strict=True``, so any layout drift fails
loudly), and ``torch.save``s the module as ``<out_dir>/exported_<iter>.pkl``,
the reference's ``<tag>_<iter>.pkl`` naming, which its resume scan
(``nerf.py:402-415``) picks up. It reads checkpoints of either package and
runs on the host: it needs no card.

Only the reference-architecture MLP family maps (the CP grid fields have no
torch counterpart and raise ``ValueError``); PROPOSAL checkpoints export
their full-size fine net.

Usage:
    python -m tinynerf_torch.tools.export_torch_ckpt ckpt_dir_or_npz out_dir/ \\
        --ref-path /path/to/NeRF-tiny
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="tinynerf .npz checkpoint (or a "
                                    "checkpoint dir: latest is used)")
    parser.add_argument("out_dir", help="directory for the reference .pkl")
    parser.add_argument("--ref-path", type=str, required=True,
                        help="reference source tree (defines NeRFModel)")
    parser.add_argument("--batch-ray", type=int, default=400,
                        help="reference BATCH_RAY baked into the module "
                             "(its Encoder/Network carry the batch size)")
    parser.add_argument("--n-coarse", type=int, default=64)
    parser.add_argument("--n-fine", type=int, default=128)
    args = parser.parse_args(argv)

    from tinynerf_torch import ckpt

    src = args.src
    if os.path.isdir(src):
        src = ckpt.find_latest(src)
        if src is None:
            sys.exit(f"no .npz checkpoints under {args.src}")
    iteration, params = ckpt.load_checkpoint_full(src)
    sd_np = ckpt.export_torch_state_dict(params)

    import torch

    # the module is pickled by reference to ``nerf.NeRFModel``: that name
    # must resolve to the class, so the module stays in sys.modules
    sys.path.insert(0, args.ref_path)
    sys.modules.pop("nerf", None)
    try:
        import nerf as refnerf
    finally:
        sys.path.remove(args.ref_path)

    model = refnerf.NeRFModel(num_coarse=args.n_coarse, num_fine=args.n_fine,
                              batch_ray=args.batch_ray)
    model.network.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd_np.items()}, strict=True)

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"exported_{iteration}.pkl")
    torch.save(model, out)
    n = sum(int(v.size) for v in sd_np.values())
    print(f"exported {n:,} params (iter {iteration}) -> {out}")


if __name__ == "__main__":
    main()
