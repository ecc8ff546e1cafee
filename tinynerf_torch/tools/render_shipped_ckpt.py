"""Render frames from the reference's shipped legacy checkpoints.

Counterpart of ``tools/render_shipped_ckpt.py``. The reference's
``checkpoint/0-6`` hold its retired 543,052-param field, which its own
current code cannot load. This loads one through the weights-only loader of
``core/legacy.py`` and renders orbit views of it through the port's
hierarchical renderer (``eval.make_frame_fn(..., field_fn=
legacy.field_legacy)``), on the card unless ``--device cpu``:

    python -m tinynerf_torch.tools.render_shipped_ckpt --ckpt <checkpoint/6> \\
        --out legacy_render/ --hw 200 --views 4

All seven shipped artifacts hold a collapsed field (saturated white fog), so
expect uniform frames: the tool shows that the artifacts load and render.
The PNGs are written by the port's own encoder (``data/imagefile.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# the Blender lego camera's horizontal field of view
LEGO_FOV = 0.6911112070083618


def look_at(position: np.ndarray) -> np.ndarray:
    """The (4, 4) camera-to-world matrix of a camera at ``position`` looking
    at the origin, y up."""
    back = position / np.linalg.norm(position)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, position
    return c2w


def orbit_rows(n_views: int, hw: int, focal: float, radius: float) -> np.ndarray:
    """(n_views, 17) pose rows on a tilted orbit of ``radius``, near/far 2/6."""
    hwf = np.array([[hw], [hw], [focal]])
    rows = np.empty((n_views, 17), np.float32)
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        pos = np.array([np.sin(theta) * 0.92, 0.4, np.cos(theta) * 0.92])
        c2w = look_at(pos / np.linalg.norm(pos) * radius)
        rows[i] = np.concatenate([np.concatenate([c2w[:3, :4], hwf], 1).ravel(), [2.0, 6.0]])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Render a shipped legacy checkpoint.")
    ap.add_argument("--ckpt", required=True, help="a reference checkpoint/<N> file")
    ap.add_argument("--out", default="./legacy_render/")
    ap.add_argument("--hw", type=int, default=200)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--radius", type=float, default=4.03)
    ap.add_argument("--coarse", type=int, default=16,
                    help="the retired model trained with num_coarse=16")
    ap.add_argument("--fine", type=int, default=32)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from tinynerf_torch import eval as evallib, optim
    from tinynerf_torch.config import Config
    from tinynerf_torch.core import legacy
    from tinynerf_torch.core.rays import make_k_inv
    from tinynerf_torch.data import imagefile
    from tinynerf_torch.device import resolve_device

    device = resolve_device(args.device)
    params = optim.tree_map(lambda t: t.to(device), legacy.load_shipped_checkpoint(args.ckpt))
    hw = args.hw
    focal = 0.5 * hw / np.tan(LEGO_FOV / 2)
    cfg = Config(n_coarse=args.coarse, n_fine=args.fine, use_pallas=False,
                 render_chunk=min(4096, hw * hw), white_bkgd=True)
    frame_fn = evallib.make_frame_fn(cfg, make_k_inv(hw, hw, focal, device), hw, hw,
                                     field_fn=legacy.field_legacy)
    os.makedirs(args.out, exist_ok=True)
    for i, row in enumerate(orbit_rows(args.views, hw, focal, args.radius)):
        img = frame_fn(params, row)
        path = os.path.join(args.out, f"view_{i:03d}.png")
        imagefile.write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print("wrote", path)


if __name__ == "__main__":
    main()
