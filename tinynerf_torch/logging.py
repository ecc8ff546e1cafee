"""Metric logging: JSONL scalars (and TensorBoard where installed) plus the
reference's preview canvas.

Counterpart of ``tinynerf/logging.py``. The reference writes ``loss/<mode>``
and ``lr/<mode>`` scalars every iteration (``nerf.py:478-480``), which forces
a device synchronisation per step. Here values are buffered as tensors and
read only at flush cadence. TensorBoard and ``imageio`` are imported inside
the functions that use them, so training runs where neither is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class MetricLogger:
    """Buffered scalar logger: ``metrics.jsonl`` under ``log_dir`` always,
    TensorBoard event files too where ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.path, "a")
        self._writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                self._writer = None
        self._buffer: List[Dict[str, Any]] = []

    def log(self, iteration: int, scalars: Dict[str, Any]) -> None:
        """Buffer scalars (device tensors welcome: not read yet)."""
        self._buffer.append({"iter": iteration, **scalars})

    def flush(self) -> None:
        """Read the buffered values and write them out."""
        for entry in self._buffer:
            it = int(entry.pop("iter"))
            record = {"iter": it, "ts": time.time()}
            for key, value in entry.items():
                value = _to_numpy(value)
                if value.size == 1:
                    value = float(value)
                    if self._writer is not None:
                        self._writer.add_scalar(key, value, it)
                    record[key] = value
                else:
                    record[key] = value.tolist()
            self._jsonl.write(json.dumps(record) + "\n")
        self._buffer.clear()
        self._jsonl.flush()
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._writer is not None:
            self._writer.close()


class NullLogger:
    """A MetricLogger that keeps nothing."""

    def log(self, iteration: int, scalars: Dict[str, Any]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class PreviewCanvas:
    """The reference's coverage canvas: an (H, W, 3) image of the
    ground-truth pixels of pic 0 seen so far (``nerf.py:460,482-483``),
    saved as a JPG every ``STEP`` iterations and updated only then."""

    def __init__(self, height: int, width: int):
        self.canvas = np.ones((height, width, 3), np.float32)

    def update(self, rows, cols, rgb, pic) -> None:
        rows = _to_numpy(rows).astype(np.int64)
        cols = _to_numpy(cols).astype(np.int64)
        rgb = _to_numpy(rgb)
        mask = _to_numpy(pic) < 0.5  # pic 0 only, like the reference
        self.canvas[rows[mask], cols[mask]] = rgb[mask]

    def save(self, path: str) -> None:
        import imageio
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        imageio.imwrite(path, (np.clip(self.canvas, 0, 1) * 255).astype(np.uint8))
