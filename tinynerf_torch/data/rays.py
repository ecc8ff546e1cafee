"""Pixel and pose tables of one scene split, and batch sampling from them.

Counterpart of ``tinynerf/data/rays.py``. The flattened pixel table
(N_pic*H*W, 3) and the pose table (N_pic, 17) live on the device; a training
batch is a gather of flat indices ``idx = pic * H * W + row * W + col`` (the
reference's flattening order W -> H -> N_pic), drawn uniformly with
replacement (``sample``) or given by the caller (``gather``: the epoch path,
and the way tests feed the JAX package's index stream).

``pixel_dtype="u8"`` stores the device table quantized (4x smaller) and
dequantizes at gather time. A table used only for rendering, or under
``HOST_FEED`` (``device_pixels=False``), keeps its pixels on the host, for
``image()``, the val batch and the host ray store (``data/native.py``), whose
batches ``upload`` puts on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from tinynerf_torch.data.poses import SceneData


class RayBatch(NamedTuple):
    """One training batch: the reference DataLoader's ``(row, column,
    pix_val, poses_bound, pic)`` tuple, on the device."""

    rows: torch.Tensor    # (B,) float32 pixel row
    cols: torch.Tensor    # (B,) float32 pixel column
    rgb: torch.Tensor     # (B, 3) float32 ground-truth color
    pose17: torch.Tensor  # (B, 17) float32 camera row [3x4 c2w | hwf] + [near, far]
    pic: torch.Tensor     # (B,) int32 source image index


class RayTable:
    """One split's images (host copy, flat ``pic * H * W + row * W + col``;
    and on the device unless ``device_pixels=False``) and pose rows (device)."""

    def __init__(self, scene: SceneData,
                 device: torch.device = torch.device("cpu"),
                 pixel_dtype: str = "f32", device_pixels: bool = True):
        if pixel_dtype not in ("f32", "u8"):
            raise ValueError(f"pixel_dtype must be 'f32' or 'u8', got {pixel_dtype!r}")
        self.height = int(scene.height)
        self.width = int(scene.width)
        self.focal = float(scene.focal)
        self.num_pics = int(scene.images.shape[0])
        self.pic_size = self.height * self.width
        self.num_pix = self.num_pics * self.pic_size
        self.pixel_dtype = pixel_dtype
        self.device = torch.device(device)

        flat = np.ascontiguousarray(
            scene.images.reshape(self.num_pix, 3), dtype=np.float32)
        if pixel_dtype == "u8":
            flat = np.clip(np.rint(flat * 255.0), 0, 255).astype(np.uint8)
        self.host_pixels = flat
        self.pixels: Optional[torch.Tensor] = (
            torch.from_numpy(flat).to(self.device) if device_pixels else None)
        self.poses = torch.as_tensor(
            np.asarray(scene.poses_bounds, np.float32), device=self.device)

    def _dequant(self, rgb: torch.Tensor) -> torch.Tensor:
        if self.pixel_dtype == "u8":
            return rgb.to(torch.float32) * (1.0 / 255.0)
        return rgb

    def gather(self, idx: torch.Tensor) -> RayBatch:
        """Flat pixel indices (B,) -> RayBatch."""
        if self.pixels is None:
            raise RuntimeError("RayTable was built with device_pixels=False "
                               "(a render-only table): it cannot gather batches")
        idx = idx.to(device=self.device, dtype=torch.int64)
        pic = idx // self.pic_size
        in_pic = idx % self.pic_size
        return RayBatch(rows=(in_pic // self.width).to(torch.float32),
                        cols=(in_pic % self.width).to(torch.float32),
                        rgb=self._dequant(self.pixels[idx]),
                        pose17=self.poses[pic],
                        pic=pic.to(torch.int32))

    def sample(self, generator: torch.Generator, batch: int) -> RayBatch:
        """Uniform-with-replacement draw of ``batch`` pixels; ``generator``
        lives on the table's device."""
        idx = torch.randint(0, self.num_pix, (batch,), generator=generator,
                            device=self.device)
        return self.gather(idx)

    def upload(self, host_batch: Sequence[np.ndarray]) -> RayBatch:
        """A host batch, the ray store's ``(rows, cols, rgb, pose17, pic)``
        numpy arrays, -> a RayBatch on the table's device.

        On the card each array is copied into a pinned buffer, which the
        asynchronous copy then reads, so that the host does not wait for the
        card's queue to drain. The store's ring may refill its arrays at the
        next ``next()`` because the pinned copy is taken before this returns;
        the pinned buffers come from PyTorch's caching host allocator, which
        records the copy's stream event and reuses a buffer only once it has
        completed. On the CPU the arrays are copied into new tensors."""
        if self.device.type != "cuda":
            return RayBatch(*(torch.from_numpy(np.array(a)) for a in host_batch))
        return RayBatch(*(torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                          for a in host_batch))

    def image(self, pic: int) -> np.ndarray:
        """Ground-truth view (H, W, 3) float32 from the host table."""
        flat = self.host_pixels[pic * self.pic_size:(pic + 1) * self.pic_size]
        if self.pixel_dtype == "u8":
            flat = flat.astype(np.float32) * (1.0 / 255.0)
        return flat.reshape(self.height, self.width, 3)
