"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back from one to the other. On the card it
computes in true float32: resolving the card turns TF32 off."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> a ``torch.device``. Asking
    for the card where there is none raises instead of running on the CPU.
    For the card, TF32 is turned off for matmuls and cuDNN (PyTorch allows
    it in cuDNN by default), since the plain fields refuse to run with it
    (``core/mlp.check_no_tf32``): every entry point that resolves the card
    (the CLI's Runner, the tools) then computes in true float32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
