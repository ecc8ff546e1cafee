"""Host-side scene ingest: poses, intrinsics and images -> numpy arrays.

A copy of ``tinynerf/data/poses.py`` (the port imports nothing of the JAX
package). PNG files are read by the port's own decoder (``imagefile``), so a
Blender or downsampled LLFF capture loads without Pillow; any other image
(an LLFF ``.JPG``) is read through Pillow, imported inside ``_load_image``.

- **Blender synthetic ("sync")**: ``transforms_<mode>.json``; focal length
  ``0.5 * W / tan(0.5 * camera_angle_x)``; per-image 17-vectors
  ``[3x4 c2w | h w f column]`` flattened + ``[near, far]`` with near/far
  2.0/6.0, cached as ``<mode>.npy``; RGBA composited onto white.
- **LLFF ("llff")**: ``poses_bounds.npy`` with the rotation columns shuffled
  to ``(col1, -col0, col2)``, per-image near/far kept; cached as ``new.npy``.

``low_res`` box-averages the images by an integer factor and rescales h/w/f.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from tinynerf_torch.data import imagefile

# Reference near/far constants for Blender scenes (loader.py:9-10).
NEAR_FACTOR = 2.0
FAR_FACTOR = 6.0


@dataclasses.dataclass
class SceneData:
    """Ingested scene: images plus per-image 17-vector pose rows."""

    images: np.ndarray        # (N, H, W, 3) float32 in [0, 1]
    poses_bounds: np.ndarray  # (N, 17) float
    height: int
    width: int
    focal: float

    @property
    def num_pics(self) -> int:
        return self.images.shape[0]


def sorted_image_files(img_dir: str) -> List[str]:
    """Image paths sorted by trailing frame number — the reference's
    ``int(name.split("_")[-1][:-4])`` sort (``loader.py:112``), which a
    lexicographic sort would break past 9 frames."""
    files = [os.path.join(img_dir, f) for f in os.listdir(img_dir)]
    files.sort(key=lambda name: int(name.split("_")[-1].split(".")[0]))
    return files


def _composite_white(rgba: np.ndarray) -> np.ndarray:
    """RGBA uint8 onto white, as Pillow's ``paste`` with the alpha as mask
    rounds it: ``(255 (255 - a) + c a + 128)`` divided by 255 through
    ``(t + (t >> 8)) >> 8``."""
    alpha = rgba[..., 3:].astype(np.int32)
    t = 255 * (255 - alpha) + rgba[..., :3].astype(np.int32) * alpha + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _load_image(path: str, white_composite: bool) -> np.ndarray:
    """One image as (H, W, 3) float32 in [0, 1]; RGBA composited onto white
    for synthetic scenes (reference ``loader.py:63-73``). Pillow's rules:
    only an RGBA file (PNG colour type 6) is composited; gray and alpha, and
    a palette with transparency, are converted to RGB without it. A PNG is
    read by ``imagefile.read_png``; any other file needs Pillow."""
    if path.lower().endswith(".png"):
        image = imagefile.read_png(path)
        if white_composite and imagefile.png_header(path).color_type == 6:
            image = _composite_white(image)
        elif image.shape[-1] <= 2:   # gray, gray and alpha
            image = np.repeat(image[..., :1], 3, axis=-1)
        else:
            image = image[..., :3]
        return np.asarray(image, dtype=np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(f"reading {path} needs Pillow (the PIL package), which is "
                           "not installed; the port reads PNG files without it") from exc

    image = Image.open(path)
    image.load()
    if white_composite and image.mode == "RGBA":
        background = Image.new("RGB", image.size, (255, 255, 255))
        background.paste(image, mask=image.split()[3])
        image = background
    else:
        image = image.convert("RGB")
    return np.asarray(image, dtype=np.float32) / 255.0


def _build_sync_rows(root_dir: str, mode: str) -> np.ndarray:
    """Blender transforms_<mode>.json -> (N, 17) rows (loader.py:12-36)."""
    with open(os.path.join(root_dir, f"transforms_{mode}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    angle = meta["camera_angle_x"]

    first = frames[0]["file_path"].lstrip("./")
    width, height = imagefile.png_size(os.path.join(root_dir, first + ".png"))
    focal = 0.5 * width / np.tan(0.5 * angle)

    rows = np.zeros((len(frames), 17))
    hwf = np.array([[height], [width], [focal]], dtype=np.float64)
    for i, frame in enumerate(frames):
        c2w = np.array(frame["transform_matrix"])[:3, :4]
        rows[i] = np.concatenate(
            [np.concatenate([c2w, hwf], axis=1).flatten(),
             [NEAR_FACTOR, FAR_FACTOR]])
    return rows


def _build_llff_rows(root_dir: str) -> np.ndarray:
    """poses_bounds.npy -> (N, 17) rows with the rotation columns shuffled
    from the LLFF disk convention to [right, up, back]: new columns are
    (col1, -col0, col2) of the stored matrix (reference ``loader.py:38-53``).
    Per-image near/far from the last two entries are preserved."""
    src = np.load(os.path.join(root_dir, "poses_bounds.npy"))
    out = np.zeros_like(src)
    for i in range(src.shape[0]):
        pose = src[i, :15].reshape(3, 5)
        rot, trans, hwf = pose[:, :3], pose[:, 3:4], pose[:, 4:5]
        new_rot = np.stack([rot[:, 1], -rot[:, 0], rot[:, 2]], axis=1)
        out[i] = np.concatenate(
            [np.concatenate([new_rot, trans, hwf], axis=1).flatten(),
             src[i, 15:17]])
    return out


def _downsample(images: np.ndarray, factor: int) -> np.ndarray:
    """Box-average by an integer factor (anti-aliased, exact for factors
    dividing the frame)."""
    n, h, w, c = images.shape
    nh, nw = h // factor, w // factor
    images = images[:, : nh * factor, : nw * factor]
    return images.reshape(n, nh, factor, nw, factor, c).mean(axis=(2, 4))


def load_scene(root_dir: str, data_type: str, mode: str,
               low_res: int = 1) -> SceneData:
    """Ingest one split of a scene directory.

    Matches the reference dataset's on-disk contract (``loader.py:90-114``):
    pose rows are cached next to the data (``<mode>.npy`` for sync,
    ``new.npy`` for llff) and reused on subsequent runs; images live under
    ``<mode>/`` (sync) or ``images/`` (llff) and are sorted numerically.
    """
    if data_type == "llff":
        cache = os.path.join(root_dir, "new.npy")
        img_dir = os.path.join(root_dir, "images")
    else:
        cache = os.path.join(root_dir, f"{mode}.npy")
        img_dir = os.path.join(root_dir, mode)

    if not os.path.isfile(cache):
        rows = (_build_llff_rows(root_dir) if data_type == "llff"
                else _build_sync_rows(root_dir, mode))
        # atomic publish: on multi-process (pod) runs every host ingests the
        # same scene concurrently — a temp-file + rename means a concurrent
        # reader sees either no cache (and rebuilds identically) or a
        # complete one, never a partial write
        tmp = f"{cache}.{os.getpid()}.tmp.npy"  # .npy: np.save appends none
        np.save(tmp, rows)
        os.replace(tmp, cache)
    poses_bounds = np.load(cache)

    files = sorted_image_files(img_dir)
    images = np.stack(
        [_load_image(f, white_composite=(data_type == "sync")) for f in files])

    if low_res and low_res > 1:
        images = _downsample(images, low_res)
        # keep the h/w/f columns consistent with the downsampled frames
        poses_bounds = poses_bounds.copy()
        poses_bounds[:, 4] = images.shape[1]
        poses_bounds[:, 9] = images.shape[2]
        poses_bounds[:, 14] /= low_res

    # intrinsics live in the first row's hwf column (reference loader.py:76-78)
    height = int(poses_bounds[0][4])
    width = int(poses_bounds[0][9])
    focal = float(poses_bounds[0][14])
    return SceneData(images=images.astype(np.float32),
                     poses_bounds=poses_bounds,
                     height=height, width=width, focal=focal)


def _normalize(v: np.ndarray, fallback: Optional[np.ndarray] = None,
               eps: float = 1e-8) -> np.ndarray:
    n = np.linalg.norm(v)
    if n < eps:
        return np.array([0.0, 0.0, 1.0]) if fallback is None else fallback
    return v / n


def view_matrix(back: np.ndarray, up: np.ndarray,
                pos: np.ndarray) -> np.ndarray:
    """A [right, up, back | pos] (3, 4) camera-to-world from a look direction
    (standard LLFF construction; always orthonormal)."""
    back = _normalize(back)
    right = _normalize(np.cross(up, back), fallback=np.array([1.0, 0.0, 0.0]))
    true_up = np.cross(back, right)
    return np.stack([right, true_up, back, pos], axis=1)


def average_pose(c2ws: np.ndarray) -> np.ndarray:
    """Mean camera: mean center, mean back axis, mean up axis — with
    degeneracy fallbacks for inward-facing 360 rigs whose axis sums cancel."""
    center = c2ws[:, :, 3].mean(axis=0)
    back = _normalize(c2ws[:, :, 2].sum(axis=0))
    up = _normalize(c2ws[:, :, 1].sum(axis=0), fallback=np.array([0.0, 1.0, 0.0]))
    if abs(float(np.dot(back, up))) > 0.99:  # collinear: pick any transverse up
        up = np.array([0.0, 1.0, 0.0]) if abs(back[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    return view_matrix(back, up, center)


def recenter_and_rescale(rows: np.ndarray, bd_factor: float = 0.75) -> np.ndarray:
    """Standard LLFF pose normalisation for the NDC path: rescale so the
    nearest bound maps to ``1 / bd_factor``, then express every camera in the
    average camera's frame (cameras cluster at the origin looking down -z).

    The h/w/f column and the row layout are untouched; only the c2w block and
    the near/far bounds change. This is the preprocessing the original NeRF
    applies before its NDC warp — absent from the reference (which has no NDC
    path, SURVEY.md Q10/D1).
    """
    rows = np.array(rows, dtype=np.float64, copy=True)
    c2ws = rows[:, :15].reshape(-1, 3, 5)[:, :, :4].copy()

    scale = 1.0 / (rows[:, 15].min() * bd_factor)
    c2ws[:, :, 3] *= scale
    rows[:, 15:17] *= scale

    avg = average_pose(c2ws)                       # (3, 4)
    avg_hom = np.concatenate([avg, [[0, 0, 0, 1]]], axis=0)
    inv = np.linalg.inv(avg_hom)
    for i in range(c2ws.shape[0]):
        hom = np.concatenate([c2ws[i], [[0, 0, 0, 1]]], axis=0)
        c2ws[i] = (inv @ hom)[:3, :4]

    pose_block = rows[:, :15].reshape(-1, 3, 5)  # a copy (strided source)
    pose_block[:, :, :4] = c2ws
    rows[:, :15] = pose_block.reshape(-1, 15)
    return rows
