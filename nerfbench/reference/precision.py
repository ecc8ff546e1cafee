"""Roundings the reference applies where a field's values enter and leave
its products: none for the reference itself (float32, TF32 off), and for
the check's control the step below the configurations' bfloat16: float8
e4m3's precision, each value rounded (to nearest, ties to even) to four
significant bits, at any exponent, as if every tensor were scaled into
e4m3's range first, so that the control differs from bfloat16 by precision
alone. The rounding is on the values only; gradients pass through."""

from __future__ import annotations

import torch

FP8_MANTISSA_BITS = 3


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    m, e = torch.frexp(x.detach())           # x = m * 2**e, 0.5 <= |m| < 1
    scale = float(2 ** (FP8_MANTISSA_BITS + 1))
    q = torch.ldexp(torch.round(m * scale) / scale, e)
    return x + (q - x.detach())


ROUNDINGS = {"fp32": fp32, "fp8": fp8}
