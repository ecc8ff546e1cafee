"""The benchmark's scene and camera path, made from the seed on the host.

A Blender-style capture with the shape of nerf_synthetic's splits: views
on a circle of radius 4 at height 2, each looking at the origin, with
lego's horizontal field of view (0.6911 rad), near 2 and far 6. The
images are smooth random colors, blocks of ``(H / 8) x (W / 8)`` pixels
of uniform color: the work of a step or a frame depends on the shapes
alone (a fixed number of samples a ray), not on what the images show. The
camera path is an orbit at the views' radius and elevation.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

FOV_X = 0.6911112070083618
BLOCKS = 8


def _look_at(pos: np.ndarray) -> np.ndarray:
    back = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, pos], axis=1)


def _row(c2w: np.ndarray, height: int, width: int, focal: float, near: float,
         far: float) -> np.ndarray:
    hwf = np.array([[height], [width], [focal]], dtype=np.float64)
    return np.concatenate([np.concatenate([c2w, hwf], 1).ravel(), [near, far]])


def focal_of(spec: dict) -> float:
    return 0.5 * spec["width"] / math.tan(0.5 * FOV_X)


def poses(spec: dict) -> np.ndarray:
    """(views, 17) pose rows of the capture."""
    n, h, w = spec["views"], spec["height"], spec["width"]
    rows = np.zeros((n, 17))
    for i in range(n):
        theta = 2.0 * np.pi * i / n + 0.3
        pos = 4.0 * np.array([np.sin(theta), 0.5, np.cos(theta)])
        rows[i] = _row(_look_at(pos), h, w, focal_of(spec), spec["near"], spec["far"])
    return rows


def images(spec: dict, rng: np.random.Generator) -> np.ndarray:
    """(views, H, W, 3) float32 in [0, 1)."""
    n, h, w = spec["views"], spec["height"], spec["width"]
    base = rng.random((n, BLOCKS, 1, BLOCKS, 1, 3), dtype=np.float32)
    full = np.broadcast_to(base, (n, BLOCKS, h // BLOCKS, BLOCKS, w // BLOCKS, 3))
    return np.ascontiguousarray(full).reshape(n, h, w, 3)


def orbit(spec: dict, n_frames: int) -> np.ndarray:
    """(n_frames, 17) pose rows around the capture's circle."""
    radius, elev = 4.0 * math.sqrt(1.25), math.asin(0.5 / math.sqrt(1.25))
    rows = np.zeros((n_frames, 17))
    for i in range(n_frames):
        theta = 2.0 * np.pi * i / n_frames
        pos = radius * np.array([np.sin(theta) * np.cos(elev), np.sin(elev),
                                 np.cos(theta) * np.cos(elev)])
        rows[i] = _row(_look_at(pos), spec["height"], spec["width"], focal_of(spec),
                       spec["near"], spec["far"])
    return rows


def make(spec: dict, seed: Optional[int], with_images: bool = True,
         ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(images or None, poses) of ``spec`` (a traffic file's ``scene``);
    ``seed`` is a non-negative integer."""
    if spec["height"] % BLOCKS or spec["width"] % BLOCKS:
        raise ValueError(f"scene sides must be multiples of {BLOCKS}")
    imgs = images(spec, np.random.default_rng(seed)) if with_images else None
    return imgs, poses(spec)
