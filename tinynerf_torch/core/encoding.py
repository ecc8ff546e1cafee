"""Sinusoidal positional encoding with the reference's semantics.

Counterpart of ``tinynerf/core/encoding.py``:

- frequencies are ``2**linspace(0, L, L) * pi``: L fractional exponents, not
  the usual ``2**(0..L-1)``, computed in float64, cast to float32, then
  multiplied by pi in float32 (``freq_bank``);
- there is no identity term;
- the layout is channel-major with sin/cos interleaved per frequency:
  ``[sin f0·x, cos f0·x, sin f1·x, cos f1·x, ... | y-block | z-block]``.

Point dim = 3·2·10 = 60; dir dim = 3·2·4 = 24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

L_POINT = 10
L_DIR = 4
POINT_ENC_DIM = 3 * 2 * L_POINT  # 60
DIR_ENC_DIM = 3 * 2 * L_DIR      # 24


def freq_bank(num_freqs: int) -> np.ndarray:
    """``2**linspace(0, L, L) * pi`` as float32, rounded exactly as the JAX
    package rounds it: the exponent in float64, cast, then ``* pi`` in f32."""
    return np.exp2(np.linspace(0.0, num_freqs, num_freqs, dtype=np.float64)).astype(
        np.float32
    ) * np.float32(np.pi)


@functools.lru_cache(maxsize=None)
def freq_tensor(num_freqs: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``freq_bank(num_freqs)`` on ``device`` as ``dtype``, made once: a copy
    from host memory on every call would wait for the card's queue, and a
    CUDA graph cannot capture it."""
    return torch.as_tensor(freq_bank(num_freqs), dtype=dtype, device=device)


def positional_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Encode ``(..., 3)`` coordinates to ``(..., 3*2*L)`` in reference layout,
    ``L = num_freqs``.

    Per channel c: ``[sin(f_0 c), cos(f_0 c), ..., sin(f_{L-1} c), cos(f_{L-1} c)]``,
    channel blocks concatenated in x, y, z order.
    """
    L = num_freqs
    f = freq_tensor(num_freqs, x.dtype, x.device)
    scaled = x[..., :, None] * f                       # (..., 3, L)
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return enc.reshape(*x.shape[:-1], 3 * 2 * L)


def encode_points(points: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points -> (..., 60)."""
    return positional_encode(points, L_POINT)


def encode_dirs(dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) world unit directions -> (..., 24)."""
    return positional_encode(dirs, L_DIR)
