"""The yardstick's operation and byte counts, frozen here so that a change
to the program cannot move them. Each counts what the function needs for
its inputs: a multiply-add is two operations, each input byte is read once
and each output byte written once, and nothing an implementation computes
again (a recompute, padding) counts.

A configuration's own counts live in its plain reference,
``configs/<config>.py``: ``forward_flops_per_ray(ini)``, a ray's forward
products, and ``refresh_flops(ini)``, one occupancy refresh. This file
keeps what they and the readers share: the NeRF MLP's products a sample
(``mlp_flops_per_sample``, the same count as the program's
``kernels/mlp_kernel.flops_per_row``, 1,182,976, copied here), kernels 1
and 2's work, and the peak table.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

MLP_WIDTH = 256
MLP_POINT_IN = 60      # 3 * 2 * 10
MLP_DIR_IN = 24        # 3 * 2 * 4
MLP_PARAMS = 593_924
FLOAT = 4

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def mlp_flops_per_sample() -> int:
    """``2 * (60*256 + 6*256*256 + (256+60)*256 + 256*1 + 256*256 + (256+24)*128
    + 128*3)`` = 1,182,976: the trunk's eight layers (the fifth takes the
    encoding again), the sigma head, the feature layer, the view layer and
    the color layer."""
    w = MLP_WIDTH
    return 2 * (MLP_POINT_IN * w + 6 * w * w + (w + MLP_POINT_IN) * w + w
                + w * w + (w + MLP_DIR_IN) * (w // 2) + (w // 2) * 3)


def train_step_flops(model, ini: dict, rays: int) -> int:
    """A step's model operations: each field evaluation's forward products
    (the configuration's ``forward_flops_per_ray``) times 3, the forward
    and a backward of twice as many."""
    return 3 * rays * model.forward_flops_per_ray(ini)


def frame_flops(model, ini: dict, pixels: int) -> int:
    return pixels * model.forward_flops_per_ray(ini)


def field_rays_fwd_work(rays: int, samples: int) -> Tuple[int, int]:
    """Kernel 1, the MLP over a ray batch's samples: ``(flops, bytes)``. In:
    origins and directions (B, 3), t (B, N), the weights; out: r, g, b and
    sigma (B, N)."""
    rows = rays * samples
    return (mlp_flops_per_sample() * rows,
            FLOAT * (6 * rays + rows + MLP_PARAMS + 4 * rows))


def field_rays_bwd_work(rays: int, samples: int) -> Tuple[int, int]:
    """Kernel 2, the input and weight gradients of kernel 1: ``(flops,
    bytes)``; the operations twice the forward's. In: origins and
    directions, t, the four cotangents (B, N), the weights; out: the
    weights' gradients, those of the origins and directions, and of t."""
    rows = rays * samples
    return (2 * mlp_flops_per_sample() * rows,
            FLOAT * (6 * rays + rows + 4 * rows + MLP_PARAMS
                     + MLP_PARAMS + 6 * rays + rows))


def peaks(device_kind: str) -> Optional[dict]:
    """The peak table's entry whose ``match`` the device's name holds."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for entry in table:
        if entry["match"] in device_kind:
            return entry
    return None


def bound_s(work: Tuple[int, int], peak: dict) -> float:
    """The least time for ``(flops, bytes)`` at bf16's tensor-core peak and
    the memory's bandwidth."""
    flops, nbytes = work
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
